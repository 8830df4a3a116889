#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one card and check it.

    python3 chip_smoke.py [--seed N]

Runs from the repository root (it puts ``src`` on ``sys.path`` itself) and
needs one CUDA card; without one, or without the port's sources beside it,
it exits non-zero and prints no result.  It imports nothing of JAX or of the
JAX package.  Phases, each fatal on failure:

1. build   — ``nvcc`` compiles ``src/repro_torch/csrc/classify_fused.cu``
             for sm_90a; prints the seconds and the ``-Xptxas -v`` summary.
2. kernel  — random full-width tables for four zoo slots (one empty) at
             B in {1, 300, 4096}: the kernel's codes, labels and SVM sums
             must equal the torch twin's bit for bit.
3. path    — a zoo at the paper's profile (``PlaneProfile(max_versions=4)``)
             built with the port's own models and translator: an 8-tree
             random forest and a deeper decision tree on the cicids-17
             stand-in, a one-vs-rest linear SVM on the digits stand-in, and
             an empty slot.  4096 requests (10% FORWARD passthrough with
             intermediates) through ``ZooServer`` on the card, and ragged
             batches through ``classify`` and ``classify_coalesced``; all
             bit-identical to ``SwitchEngine(mode="ref")``, DT/RF equal to
             ``predict``, SVM within the fixed-point slack, the empty slot
             answers -1, passthrough untouched, one launch per classify.
4. timing  — CUDA events over many launches at B = 4096: the kernel, the
             twin, the bound from the bytes this run's data touches, and
             requests/s end to end through ``ZooServer.classify``.

Output: a ``kernels`` JSON line, the card's name and power limit, and last
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src"
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
FULL = dict(max_versions=4)      # the paper's default profile, four slots
FEATURES = 60
SVM_KW = dict(multi_class="ovr", C=1e4, lr=0.01, epochs=400)


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


# ----------------------------------------------------------------- phases
def build_phase():
    from repro_torch.kernels.build import build
    from repro_torch.kernels.classify_fused import SOURCE

    lib = build(SOURCE)[SOURCE]
    print(f"built {lib.path.name} in {lib.build_seconds:.2f} s")
    for line in lib.log.splitlines():
        if "ptxas" in line:
            print("  " + line.strip())
    return lib


def random_tables(rng, prof, torch, device, empty_slot):
    """Random full-width source tables (uint32 as int32 bits)."""
    import numpy as np

    V, L, T = prof.max_versions, prof.max_layers, prof.max_trees
    E, P, F = prof.max_entries_per_layer, prof.max_leaves, prof.max_features
    H, C, lv = prof.max_hyperplanes, prof.max_classes, prof.levels
    shape = (V, L, T, E)

    def t(a, dtype=None):
        return torch.from_numpy(a if dtype is None else a.astype(dtype)).to(device)

    flo = rng.integers(0, lv - 1, shape)
    valid = rng.random(shape) < 0.9
    pred_valid = rng.random((V, T, P)) < 0.9
    lut = rng.integers(-60_000, 60_000, (V, H, F, lv))
    valid[empty_slot] = False
    pred_valid[empty_slot] = False
    lut[empty_slot] = 0
    pc = np.sort(rng.choice(2**16, size=V * T * P, replace=False)
                 .reshape(V, T, P), axis=2)
    return dict(
        code_value=t(rng.integers(0, 2**6, shape), np.int32),
        code_mask=t(rng.integers(0, 2**6, shape), np.int32),
        fid=t(rng.integers(0, F, shape), np.int32),
        f_lo=t(flo, np.int32),
        f_hi=t(flo + rng.integers(0, lv // 2, shape), np.int32),
        set_bit=t(rng.integers(0, 2, shape), np.int32),
        valid=t(valid), layer_shift=t(rng.permutation(L), np.int32),
        pred_codes=t(pc, np.int32), pred_labels=t(rng.integers(0, C, (V, T, P)), np.int32),
        pred_valid=t(pred_valid), weights=t(rng.random((V, T)), np.float32),
        lut=t(lut, np.int32), bias=t(np.zeros((V, H)), np.int32))


def kernel_phase(prof, seed, device):
    import numpy as np
    import torch
    from repro_torch.kernels import ref, tiling
    from repro_torch.kernels.classify_fused import classify_fused

    rng = np.random.default_rng(seed)
    tabs = random_tables(rng, prof, torch, device, empty_slot=2)
    ops_ = tiling.prep_classify_fused(*(tabs[k] for k in (
        "code_value", "code_mask", "fid", "f_lo", "f_hi", "set_bit", "valid",
        "pred_codes", "pred_labels", "pred_valid", "weights", "lut", "bias")))
    C = prof.max_classes
    for B in (1, 300, 4096):
        codes = torch.from_numpy(rng.integers(0, 2**12, (B, prof.max_trees))
                                 .astype(np.int32)).to(device)
        feats = torch.from_numpy(rng.integers(0, prof.levels, (B, prof.max_features))
                                 .astype(np.int32)).to(device)
        vid = torch.from_numpy(rng.integers(0, prof.max_versions, B)
                               .astype(np.int32)).to(device)
        got = classify_fused(codes, feats, vid, tabs["layer_shift"], ops_, C)
        want = ref.classify_fused_v(
            codes, feats, vid, tabs["code_value"], tabs["code_mask"],
            tabs["fid"], tabs["f_lo"], tabs["f_hi"], tabs["set_bit"],
            tabs["valid"], tabs["layer_shift"], tabs["pred_codes"],
            tabs["pred_labels"], tabs["pred_valid"], tabs["weights"],
            tabs["lut"], tabs["bias"], C)
        torch.cuda.synchronize()
        for name, g, w in zip(("codes", "label", "sums"), got, want):
            if not torch.equal(g, w):
                bad = int((g != w).sum())
                raise AssertionError(f"kernel != twin at B={B}: {name} "
                                     f"differs in {bad} places")
        hits = int((got[0] != codes).any(dim=1).sum())
        print(f"B={B}: kernel == twin bit for bit "
              f"({hits} packets changed codes, {int((vid == 2).sum())} "
              "on the empty slot)")


def make_zoo(seed):
    """Host side: datasets, the port's models and their programs."""
    from repro_torch.core.mlmodels import (
        DecisionTree,
        LinearSVM,
        Quantizer,
        RandomForest,
    )
    from repro_torch.core.translator import translate
    from repro_torch.data import load_dataset

    Xtr, ytr, Xte, _ = load_dataset("cicids-17", scale=0.05)
    q = Quantizer(8).fit(Xtr)
    Xtr, Xte = q.transform(Xtr)[:, :FEATURES], q.transform(Xte)[:, :FEATURES]
    Dtr, dytr, Dte, _ = load_dataset("digits")
    qd = Quantizer(8).fit(Dtr)
    Dtr, Dte = qd.transform(Dtr)[:, :FEATURES], qd.transform(Dte)[:, :FEATURES]
    models = {
        0: RandomForest(n_estimators=8, max_depth=12, max_leaf_nodes=64,
                        random_state=seed).fit(Xtr, ytr),
        1: DecisionTree(max_depth=32, max_leaf_nodes=250).fit(Xtr, ytr),
        2: LinearSVM(random_state=seed, **SVM_KW).fit(Dtr, dytr),
    }
    programs = {v: translate(m, vid=v) for v, m in models.items()}
    for v, p in programs.items():
        if p.kind == "svm":
            print(f"vid {v}: svm, {p.n_hyperplanes} hyperplanes x "
                  f"{p.n_features} features")
        else:
            print(f"vid {v}: {p.kind}, {p.n_trees} trees, layers "
                  f"{p.tree_depths}, max entries/layer "
                  f"{max(l.n_entries for ls in p.dt_layers for l in ls)}, "
                  f"leaves {max(d.n_entries for d in p.dt_predicts)}")
    print("vid 3: empty")
    return models, programs, {0: Xte, 1: Xte, 2: Dte}


def traffic(rng, zoo, test_sets, B):
    """B requests over all four slots, 10% FORWARD passthrough packets
    carrying nonzero intermediates and rslt."""
    import numpy as np
    import torch
    from repro_torch.core.packets import PacketType

    mids = {0: 1, 1: 0, 2: 2, 3: 0}
    vid = rng.integers(0, 4, B).astype(np.int32)
    X = np.zeros((B, FEATURES), np.int64)
    for v, Xs in test_sets.items():
        sel = vid == v
        X[sel] = Xs[rng.integers(0, Xs.shape[0], int(sel.sum()))]
    sel = vid == 3
    X[sel] = rng.integers(0, 256, (int(sel.sum()), FEATURES))
    mid = np.asarray([mids[v] for v in vid], np.int32)
    pb = zoo.make_request(X, mid=mid, vid=vid)
    fwd = torch.from_numpy(rng.random(B) < 0.1)
    pb = dataclasses.replace(
        pb,
        ptype=torch.where(fwd, PacketType.FORWARD, PacketType.REQUEST).to(torch.int32),
        codes=torch.where(fwd[:, None], torch.from_numpy(
            rng.integers(1, 2**20, pb.codes.shape).astype(np.int32)), pb.codes),
        svm_acc=torch.where(fwd[:, None], torch.from_numpy(
            rng.integers(-99, 99, pb.svm_acc.shape).astype(np.int32)), pb.svm_acc),
        rslt=torch.where(fwd, torch.from_numpy(
            rng.integers(0, 9, B).astype(np.int32)), pb.rslt))
    return pb, X, vid, fwd.numpy()


def main_path_phase(prof, seed, device, models, programs, test_sets):
    """The main path through the port's entry points; returns what timing
    needs.  Launch counts are checked per call here and read as a whole by
    the caller."""
    import numpy as np
    import torch
    from repro_torch.core.plane import SwitchEngine
    from repro_torch.kernels.classify_fused import classify_fused
    from repro_torch.serving import ZooServer

    fields = ("rslt", "codes", "svm_acc")
    rng = np.random.default_rng(seed + 1)
    zoo = ZooServer(prof, device=device)
    for v, p in programs.items():
        zoo.install(p, vid=v)
    oracle = SwitchEngine(prof, mode="ref", device=device)

    def checked(fn, n_expected=1):
        before = classify_fused.launches
        out = fn()
        torch.cuda.synchronize()
        got = classify_fused.launches - before
        if got != n_expected:
            raise AssertionError(f"{got} kernel launches, expected {n_expected}")
        return out

    B = 4096
    pb, X, vid, fwd = traffic(rng, zoo, test_sets, B)
    out = checked(lambda: zoo.runtime.run(pb))
    want = oracle.classify(zoo.packed, pb)
    for f in fields:
        if not torch.equal(getattr(out, f), getattr(want, f)):
            raise AssertionError(f"ZooServer != mode ref on {f}")
    rslt = out.rslt.cpu().numpy()
    req = ~fwd
    for v, model in models.items():
        sel = req & (vid == v)
        agree = (rslt[sel] == model.predict(X[sel])).mean()
        print(f"vid {v}: {int(sel.sum())} requests, agree with predict "
              f"{agree:.4f}")
        # the SVM's fixed-point LUTs may flip a sign near zero
        if not (agree > 0.97 if v == 2 else agree == 1.0):
            raise AssertionError(f"vid {v} disagrees with predict: {agree}")
    if not (rslt[req & (vid == 3)] == -1).all():
        raise AssertionError("the empty slot answered")
    for f in fields:
        if not torch.equal(getattr(out, f).cpu()[torch.from_numpy(fwd)],
                           getattr(pb, f)[torch.from_numpy(fwd)]):
            raise AssertionError(f"passthrough packets changed {f}")
    print(f"B={B}: ZooServer == mode ref on {', '.join(fields)}; "
          f"{int(fwd.sum())} passthrough packets untouched")

    for n in (1, 7, 300, 4097):
        pbn, Xn, vn, _ = traffic(rng, zoo, test_sets, n)
        mids = pbn.mid.numpy()
        got = checked(lambda: zoo.classify(Xn, mid=mids, vid=vn))
        want = oracle.classify(zoo.packed, zoo.make_request(Xn, mid=mids,
                                                            vid=vn))
        if not np.array_equal(got, want.rslt.cpu().numpy()):
            raise AssertionError(f"classify != mode ref at B={n}")
    reqs = []
    for n in (1, 7, 300, 4097):
        pbn, Xn, vn, _ = traffic(rng, zoo, test_sets, n)
        reqs.append((Xn, pbn.mid.numpy(), vn))
    got = checked(lambda: zoo.classify_coalesced(reqs))
    for (Xn, mn, vn), g in zip(reqs, got):
        w = oracle.classify(zoo.packed, zoo.make_request(Xn, mid=mn, vid=vn))
        if not np.array_equal(g, w.rslt.cpu().numpy()):
            raise AssertionError("classify_coalesced != mode ref")
    print("ragged B in (1, 7, 300, 4097): classify and classify_coalesced "
          "== mode ref, one launch per call")
    return zoo, pb


def bytes_touched(zoo, pb, prof, torch):
    """The least bytes the classify kernel must move on these inputs: each
    input byte it needs read once, each output written once.  Walk records
    count up to the furthest entry any packet of a version reads in each
    (layer, tree) row; leaves count the entries found; the LUT counts the
    (feature, level) cells the packets select."""
    from repro_torch.kernels import ref, tiling

    packed, dev = zoo.packed, zoo.engine.device
    pbd = pb.to(dev)
    V, L, T, E = packed.dt_cv.shape
    B, F = pbd.features.shape
    H, lv = packed.svm_lut.shape[1], packed.svm_lut.shape[3]
    vid = torch.where((pbd.vid >= 0) & (pbd.vid < V), pbd.vid, 0).long()
    ops_ = packed.image.fused
    cv, cm, fid, flo, fhi, bit, valid = tiling.unpack_classify_fused(ops_)[:7]
    codes = pbd.codes.clone()
    rows = torch.zeros((V, L, T), dtype=torch.int64, device=dev)
    for l in range(L):
        f = torch.gather(pbd.features, 1,
                         fid[vid, l].long().reshape(B, T * E)).reshape(B, T, E)
        ok = (((codes[:, :, None] & cm[vid, l]) == cv[vid, l])
              & (f >= flo[vid, l]) & (f <= fhi[vid, l]) & valid[vid, l])
        read = torch.where(ok.any(-1), ok.int().argmax(-1).long() + 1,
                           ops_.n_entries[vid, l].long())
        rows[:, l].scatter_reduce_(0, vid[:, None].expand(B, T), read,
                                   reduce="amax")
        codes = ref.tcam_match_v(codes, pbd.features, vid, cv[:, l], cm[:, l],
                                 fid[:, l], flo[:, l], fhi[:, l], bit[:, l],
                                 valid[:, l], packed.layer_shift[l])
    used = torch.unique(vid)
    walk = int(rows.sum()) * 16 + len(used) * L * T * 4
    pc = ops_.pred_codes[vid]
    found = (pc == codes[..., None]).any(-1)
    leaves = int(torch.unique(torch.stack(
        [vid[:, None].expand(B, T), torch.arange(T, device=dev).expand(B, T),
         codes], -1)[found], dim=0).shape[0]) * 8 + len(used) * T * 4
    x = pbd.features.long()
    inr = (x >= 0) & (x < lv)
    cells = torch.stack([vid[:, None].expand(B, F),
                         torch.arange(F, device=dev).expand(B, F), x], -1)[inr]
    lut = int(torch.unique(cells, dim=0).shape[0]) * H * 4 + len(used) * H * 4
    io = B * (8 * T + 4 * F + 4 + 4 + 4 * H) + 4 * L
    return walk + leaves + lut + io


def where_the_time_goes(step, torch, n=10):
    """``torch.profiler`` over ``n`` end-to-end steps: the device's busy
    share of the wall time (under the profiler) and the top ops by host and
    by device time."""
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = p.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))
    busy = sum(dev_us(e) for e in events)
    if busy == 0:
        print("profiler: no device time recorded; busy share not measured")
    else:
        print(f"profiler over {n} steps: wall {wall_us / n:.1f} us/step, "
              f"device busy {busy / n:.1f} us/step "
              f"({100 * busy / wall_us:.1f}% of the wall)")
    for key in ("self_cpu_time_total", "self_device_time_total"
                if hasattr(events[0], "self_device_time_total")
                else "self_cuda_time_total"):
        rows = sorted(events, key=lambda e: getattr(e, key), reverse=True)
        print(f"top ops by {key} (us per step, calls per step):")
        for e in rows[:8]:
            print(f"  {getattr(e, key) / n:10.1f}  {e.count / n:6.1f}  "
                  f"{e.key[:70]}")


def timing_phase(zoo, pb, prof, torch, n_iter=50):
    from repro_torch.kernels import ref
    from repro_torch.kernels.classify_fused import classify_fused

    packed, dev = zoo.packed, zoo.engine.device
    pbd = pb.to(dev)
    V = packed.n_versions
    vid = torch.where((pbd.vid >= 0) & (pbd.vid < V), pbd.vid, 0)
    C = prof.max_classes
    zero_bias = torch.zeros_like(packed.svm_bias)

    def kernel():
        return classify_fused(pbd.codes, pbd.features, vid,
                              packed.layer_shift, packed.image.fused, C)

    def twin():
        return ref.classify_fused_v(
            pbd.codes, pbd.features, vid, packed.dt_cv, packed.dt_cm,
            packed.dt_fid, packed.dt_flo, packed.dt_fhi, packed.dt_bit,
            packed.dt_valid, packed.layer_shift, packed.pred_codes,
            packed.pred_labels, packed.pred_valid, packed.vote_weights,
            packed.svm_lut, zero_bias, C)

    def ms(fn, n):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / n

    got, want = kernel(), twin()
    err = max(int((g.long() - w.long()).abs().max()) for g, w in zip(got, want))
    k_ms = ms(kernel, n_iter)
    t_ms = ms(twin, max(n_iter // 10, 3))
    k_ms2 = ms(kernel, n_iter)
    nbytes = bytes_touched(zoo, pb, prof, torch)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    B = pb.batch
    X = pb.features.numpy()
    mid, vids = pb.mid.numpy(), pb.vid.numpy()
    zoo.classify(X, mid=mid, vid=vids)
    n_req = 20
    t0 = time.perf_counter()
    for _ in range(n_req):
        zoo.classify(X, mid=mid, vid=vids)
    dt = time.perf_counter() - t0
    rps = n_req * B / dt
    print(f"B={B}: kernel {k_ms:.4f} ms and {k_ms2:.4f} ms (two runs of "
          f"{n_iter}), twin {t_ms:.4f} ms, bound {bound_ms:.6f} ms "
          f"({nbytes} bytes at 3.35 TB/s), max abs err {err}")
    print(f"ZooServer.classify end to end: {rps:.0f} requests/s "
          f"({dt / n_req * 1e3:.3f} ms per {B}-request batch)")
    where_the_time_goes(lambda: zoo.classify(X, mid=mid, vid=vids), torch)
    print("library_ms: null (no single PyTorch call computes this function)")
    return dict(ms=min(k_ms, k_ms2), plain_ms=t_ms, bound_ms=bound_ms,
                max_abs_err=err, bytes=nbytes, requests_per_s=rps)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are not under {SRC}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.core.plane import PlaneProfile
    from repro_torch.kernels.classify_fused import classify_fused

    t_start = time.perf_counter()
    device = torch.device("cuda")
    prof = PlaneProfile(**FULL)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    phase("1 build")
    build_phase()
    phase("2 kernel vs twin, random full-width tables, V=4 with an empty slot")
    kernel_phase(prof, args.seed, device)
    phase("3 main path: the zoo through ZooServer on the card")
    models, programs, test_sets = make_zoo(args.seed)
    classify_fused.launches = 0
    zoo, pb = main_path_phase(prof, args.seed, device, models, programs,
                              test_sets)
    launches = classify_fused.launches
    print(f"main path: classify_fused launched {launches} times")
    if launches < 1:
        raise AssertionError("the main path never launched classify_fused")
    phase("4 timing at B = 4096")
    t = timing_phase(zoo, pb, prof, torch)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [{
        "name": "classify_fused", "route": "cuda",
        "source": "src/repro_torch/csrc/classify_fused.cu",
        "replaces": "src/repro/kernels/classify_fused.py:166",
        "launches": launches, "max_abs_err": t["max_abs_err"],
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": "bytes", "library_ms": None,
        "matched_twin": t["max_abs_err"] == 0,
        "requests_per_s": t["requests_per_s"]}]}))
    print(smi[0] if smi else "nvidia-smi: no answer")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
