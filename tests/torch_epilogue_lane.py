"""The classify step's epilogue: the cases it is held on, and the frozen
glue it is held to (shared by ``tests/test_torch_plane.py`` on the CPU and
``tests/test_torch_gpu.py`` on the card; no JAX, so the card's machine
imports it).

The epilogue is the plane's SVM predict and result select after the
classify kernel: the vid clamp, the handed-on partial sums, the sign code,
the SVM and tree results, the select by MID and the passthrough of every
packet that is not a REQUEST.  ``frozen_classify`` is the classify step as
it stood while that ran as plain torch glue after the kernel, kept here
verbatim; ``epilogue_case`` draws a small plane and a batch for each of
``EPI_CASES``, and ``deployment`` builds a benchmark configuration's zoo
(``portbench/configs/``) with a batch of its packets on every edge.
"""
import dataclasses
import json
from pathlib import Path

import numpy as np
import torch

from repro_torch.core import plane as tp
from repro_torch.core import translator as ttr
from repro_torch.core.packets import PacketType
from repro_torch.kernels import ops

ROOT = Path(__file__).resolve().parent.parent
FIELDS = ("rslt", "codes", "svm_acc")


def frozen_classify(packed, pb, *, n_classes, mode):
    """The classify step as it stood while its select and SVM predict ran
    as plain torch glue after the kernel, for every mode: the contract that
    the epilogue, moved into the kernel's hop entry and into
    ``ref.classify_epilogue``, is held to bit for bit."""
    V = packed.n_versions
    vid_ok = (pb.vid >= 0) & (pb.vid < V)
    vid = torch.where(vid_ok, pb.vid, 0)
    img = packed.image
    codes, tree_label, partial = ops.classify_fused_v(
        pb.codes, pb.features, vid, packed.dt_cv, packed.dt_cm,
        packed.dt_fid, packed.dt_flo, packed.dt_fhi, packed.dt_bit,
        packed.dt_valid, packed.layer_shift, packed.pred_codes,
        packed.pred_labels, packed.pred_valid, packed.vote_weights,
        packed.svm_lut, torch.zeros_like(packed.svm_bias), n_classes,
        mode=mode, prep=img.fused)
    vid_l = vid.to(torch.int64)
    tree_result = torch.where(packed.pred_enable[vid_l], tree_label, -1)
    acc = pb.svm_acc + partial
    sums = acc + packed.svm_bias[vid_l]
    signs = ((sums >= 0) & packed.svm_hvalid[vid_l]).to(torch.int64)
    weights = 1 << torch.arange(signs.shape[1], device=signs.device)
    sign_code = (signs * weights).sum(dim=1)
    svm_label = packed.svm_pred_table[vid_l, sign_code]
    svm_result = torch.where(packed.svm_pred_enable[vid_l], svm_label, -1)
    is_req = pb.ptype == PacketType.REQUEST
    codes = torch.where(is_req[:, None], codes, pb.codes)
    acc = torch.where(is_req[:, None], acc, pb.svm_acc)
    result = torch.where(pb.mid == ttr.MID_SVM, svm_result, tree_result)
    result = torch.where(vid_ok, result, -1)
    rslt = torch.where(is_req & (result >= 0), result, pb.rslt)
    return dataclasses.replace(pb, codes=codes, svm_acc=acc, rslt=rslt)


# a small plane: V, L, T, E, P, F, H, levels, classes
EPI_SHAPE = dict(V=3, L=3, T=2, E=4, P=4, F=5, H=4, levels=16, C=4)
EPI_B = 96


def i32(a):
    return torch.from_numpy(np.asarray(a).astype(np.int32))


def _vid_edges(rng, tables, pb):
    V = EPI_SHAPE["V"]
    pb["vid"][:3 * 8] = np.repeat([-1, V, V + 3], 8)


def _every_type(rng, tables, pb):
    pb["ptype"][:] = rng.choice([PacketType.FORWARD, PacketType.REQUEST,
                                 PacketType.RESPONSE], pb["ptype"].size)


def _both_mids(rng, tables, pb):
    pb["mid"][::2] = ttr.MID_SVM


def _pred_off(rng, tables, pb):
    tables["pred_enable"][1] = False


def _svm_pred_off(rng, tables, pb):
    tables["svm_pred_enable"][0] = False


def _masked_hyperplane(rng, tables, pb):
    tables["svm_hvalid"][:, 1] = False
    tables["svm_hvalid"][2, 3] = False


def _int32_wrap(rng, tables, pb):
    V, H, F = EPI_SHAPE["V"], EPI_SHAPE["H"], EPI_SHAPE["F"]
    tables["svm_lut"] = i32(rng.integers(2**29, 2**30, tables[
        "svm_lut"].shape))
    tables["svm_bias"] = i32(rng.integers(-2**31, 2**31 - 1, (V, H)))
    pb["svm_acc"][:] = rng.integers(-2**31, 2**31 - 1, pb["svm_acc"].shape)
    pb["svm_acc"][:4] = 2**31 - 1
    assert F * 2**29 > 2**31                   # every sum passes 2^31


def _sums_at_zero(rng, tables, pb):
    V, H = EPI_SHAPE["V"], EPI_SHAPE["H"]
    tables["svm_lut"] = torch.zeros_like(tables["svm_lut"])
    tables["svm_bias"] = i32(rng.integers(-1, 2, (V, H)))
    pb["svm_acc"][::2] = 0                     # sums = bias: -1, 0 or 1
    pb["mid"][:] = ttr.MID_SVM


EPI_CASES = {"vid -1, V and in range": _vid_edges,
             "every packet type": _every_type, "both mids": _both_mids,
             "pred_enable off": _pred_off,
             "svm_pred_enable off": _svm_pred_off,
             "masked hyperplane": _masked_hyperplane,
             "sums at the int32 wrap": _int32_wrap,
             "sums at 0 and -1": _sums_at_zero}


def epilogue_case(name, device="cpu"):
    """A random small plane and a batch of packets for the case ``name`` of
    ``EPI_CASES``, on ``device``: tables and packets drawn so that each
    case's edge is hit."""
    V, L, T, E, P, F, H, lv, C = EPI_SHAPE.values()
    rng = np.random.default_rng(sorted(EPI_CASES).index(name) + 11)
    prof = tp.PlaneProfile(max_features=F, max_trees=T, max_layers=L,
                           max_entries_per_layer=E, max_leaves=P,
                           max_classes=C, max_hyperplanes=H, levels=lv,
                           max_versions=V)
    shape = (V, L, T, E)
    f_lo = rng.integers(0, lv // 2, shape)
    pred_codes = np.stack([np.sort(rng.choice(2**L, P, replace=False))
                           for _ in range(V * T)]).reshape(V, T, P)
    tables = dict(
        dt_cv=i32(rng.integers(0, 2, shape)),
        dt_cm=i32(rng.integers(0, 2, shape)),
        dt_fid=i32(rng.integers(0, F, shape)), dt_flo=i32(f_lo),
        dt_fhi=i32(f_lo + rng.integers(0, lv // 2, shape)),
        dt_bit=i32(rng.integers(0, 2, shape)),
        dt_valid=torch.from_numpy(rng.random(shape) < 0.8),
        pred_codes=i32(pred_codes),
        pred_labels=i32(rng.integers(0, C, (V, T, P))),
        pred_valid=torch.from_numpy(rng.random((V, T, P)) < 0.9),
        pred_enable=torch.ones(V, dtype=torch.bool),
        vote_weights=torch.from_numpy(rng.random((V, T)).astype(np.float32)),
        svm_lut=i32(rng.integers(-2**12, 2**12, (V, H, F, lv))),
        svm_bias=i32(rng.integers(-2**12, 2**12, (V, H))),
        svm_hvalid=torch.ones((V, H), dtype=torch.bool),
        svm_pred_table=i32(rng.integers(0, C, (V, 2**H))),
        svm_pred_enable=torch.ones(V, dtype=torch.bool))
    B = EPI_B
    pb = dict(
        vid=rng.integers(0, V, B), ptype=np.full(B, PacketType.REQUEST),
        mid=rng.choice([ttr.MID_DT, ttr.MID_RF, ttr.MID_SVM], B),
        codes=rng.integers(0, 2, (B, T)),
        svm_acc=rng.integers(-2**10, 2**10, (B, H)),
        rslt=rng.integers(-1, C, B),
        features=rng.integers(0, lv, (B, F)))
    EPI_CASES[name](rng, tables, pb)
    packed = dataclasses.replace(tp.empty_program(prof, "cpu"), image=None,
                                 **tables)
    packed = tp.resident_program(packed, device)    # builds its exec image
    batch = tp.PacketBatch(
        packet_id=i32(np.arange(B)), rid=i32(np.zeros(B)),
        **{k: i32(v) for k, v in pb.items()})
    return packed, batch.to(device)


def deployment(config: str, device, seed: int = 2**31 + 29, B: int = 48):
    """The benchmark configuration ``config`` (``portbench/configs/``)
    built on ``device`` from ``seed`` (``portbench.deploy.build``: the
    models fitted, the zoo installed or planned over its path), and a
    batch of ``B`` of its packets on every edge of the epilogue: vids
    outside the zoo, FORWARD and RESPONSE packets, partial sums over the
    int32 range.  Returns (the executor, the batch, the profile)."""
    from portbench import deploy

    cfg = json.loads((ROOT / "portbench" / "configs" /
                      f"{config}.json").read_text())
    dep = deploy.build(cfg, seed, device, root=ROOT)
    rng = np.random.default_rng(seed % 2**32)
    prof = dep.profile
    vid = rng.integers(0, prof.max_versions, B).astype(np.int32)
    pb = tp.PacketBatch.make_request(
        deploy.rows_for(dep, rng, vid),
        mid=np.asarray([dep.mids[v] for v in vid], np.int32), vid=vid,
        max_features=prof.max_features, n_trees=prof.max_trees,
        n_hyperplanes=prof.max_hyperplanes)
    vid[:4] = [-1, prof.max_versions, -7, prof.max_versions + 1]
    ptype = rng.choice([PacketType.FORWARD, PacketType.REQUEST,
                        PacketType.RESPONSE], B, p=[0.15, 0.7, 0.15])
    pb = dataclasses.replace(
        pb, vid=i32(vid), ptype=i32(ptype),
        svm_acc=i32(rng.integers(-2**31, 2**31 - 1, pb.svm_acc.shape)),
        rslt=i32(rng.integers(-1, 4, B)))
    return dep.zoo.runtime.executor, pb.to(device), prof
