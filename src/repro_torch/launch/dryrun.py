"""Device-less dry run: every (arch x shape x mesh) cell built on ``meta``.

Port of ``src/repro/launch/dryrun.py``, with its CLI.  The reference lowers
and compiles each cell's jitted step under the 16 x 16 and 2 x 16 x 16
meshes; torch has no XLA to lower to, so here each cell is built on
``torch.device("meta")`` (the weights, the optimizer's moments, the
gradients, the decode state and the inputs, with no memory) and every
leaf's spec is held to its leaf on the mesh (``check_specs``).  A record
holds:

* ``status``: ``ok``, ``skip`` (the reference's reason) or ``error``;
* ``meta``: arch, shape, multi_pod, chips, kind; train cells ``n_micro``
  (``microbatch_plan`` at the reference's tokens-per-device rule),
  ``state_dtype`` (bf16 above 150e9 parameters), ``tokens_per_device`` and
  ``q_chunk``; prefill cells ``q_chunk``; the inputs' shapes; and
  ``analytic_bytes_per_device``, the reference's formula
  (``_analytic_param_bytes_per_device``, :95) on the port's specs: train
  the parameters x 2 (weights and gradients) and the two AdamW moments,
  prefill the parameters, decode the parameters and the decode state;
* ``fits``: those bytes within one card's HBM (``hbm_bytes``,
  ``HW().hbm_bytes``), the counterpart of the reference's
  ``memory_analysis()``;
* ``model_flops_total`` (``analysis.roofline.model_flops``) and a
  ``roofline`` (``roofline_terms`` at ``HW()``) fed by ``model_flops /
  chips`` and the analytic bytes, labelled so; its collective term is not
  available;
* the fields the reference reads from XLA's HLO (``hlo_*``,
  ``collectives``, ``collective_wire_bytes``, ``useful_flops_ratio``,
  ``memory`` and the probes' corrections): ``null``, with the reason in
  ``not_available``.

``cell_leaves`` gives one card's shard of every leaf a cell's analytic
bytes count, so that a run on the card can allocate device (0, 0)'s
share (``chip_smoke.py`` phase 17).

Usage (any machine, no card, no network):
  python -m repro_torch.launch.dryrun --arch internlm2-1.8b --shape train_4k
  python -m repro_torch.launch.dryrun --all --both-meshes [--set k=v]

Results land in ``dryrun_out/<arch>__<shape>__<pods>pod[__tag].json`` at
the root of the checkout (``--out`` elsewhere).
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from pathlib import Path

import torch

from repro_torch.analysis.roofline import HW, model_flops, roofline_terms
from repro_torch.configs import ARCH_IDS, SHAPES, applicable, get_config
from repro_torch.distributed.sharding import (
    batch_spec,
    check_specs,
    dp_axes,
    opt_specs,
    param_specs,
    shard_shape,
    stacked_shapes,
    state_specs,
    tree_leaves,
)
from repro_torch.launch.mesh import make_production_mesh, mesh_chip_count
from repro_torch.models.common import ArchConfig
from repro_torch.models.moe import check_impl
from repro_torch.models.transformer import init_decode_state, init_params_shape
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.train.step import microbatch_plan

__all__ = ["RESULTS_DIR", "NOT_AVAILABLE", "input_specs", "build_cell",
           "cell_leaves", "run_cell", "main"]

RESULTS_DIR = str(Path(__file__).resolve().parents[3] / "dryrun_out")
NOT_AVAILABLE = "no XLA HLO in torch"
# the reference's record fields that come from XLA's HLO
HLO_FIELDS = ("hlo_flops_raw", "hlo_bytes_raw", "hlo_flops_per_device",
              "hlo_bytes_per_device", "collectives", "collective_wire_bytes",
              "useful_flops_ratio", "memory", "probe_corrections")


def _i32(*shape) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.int32, device="meta")


def input_specs(cfg: ArchConfig, shape_name: str, *, n_micro: int = 1,
                global_batch: int | None = None) -> dict:
    """``meta`` stand-ins for every model input (no allocation)."""
    sp = SHAPES[shape_name]
    S, B = sp.seq_len, global_batch or sp.global_batch
    enc = (cfg.enc_seq, cfg.d_model)
    if sp.kind == "train":
        B_mb = B // n_micro
        batch = {"tokens": _i32(n_micro, B_mb, S),
                 "labels": _i32(n_micro, B_mb, S)}
        if cfg.family == "encdec":
            batch["enc_inputs"] = torch.empty((n_micro, B_mb, *enc),
                                              dtype=cfg.tdtype, device="meta")
        return batch
    if sp.kind == "prefill":
        batch = {"tokens": _i32(B, S)}
        if cfg.family == "encdec":
            batch["enc_inputs"] = torch.empty((B, *enc), dtype=cfg.tdtype,
                                              device="meta")
        return batch
    # decode: one token against a cache of S
    return {"tokens": _i32(B, 1), "pos": _i32()}


def _bytes_per_device(shapes: dict, specs: dict, mesh) -> int:
    """The reference's ``_analytic_param_bytes_per_device``: each leaf's
    bytes over the cards its spec splits it across (whole numbers once
    ``check_specs`` holds)."""
    spec_of = dict(tree_leaves(specs))
    total = 0
    for path, leaf in tree_leaves(shapes):
        n = 1
        for d in shard_shape(leaf.shape, spec_of[path], mesh):
            n *= d
        total += n * leaf.element_size()
    return total


def _config(arch: str, overrides: dict) -> ArchConfig:
    """The cell's config with the reference's overrides applied
    (``dryrun.py:122-133``)."""
    cfg = get_config(arch)
    kw = {}
    if "moe_impl" in overrides:
        kw["moe_impl"] = str(overrides["moe_impl"])
    if "attn_k_chunk" in overrides:
        kw["attn_k_chunk"] = int(overrides["attn_k_chunk"])
    if "capacity_factor" in overrides:
        kw["capacity_factor"] = float(overrides["capacity_factor"])
    if "attn_mxu_native" in overrides:
        kw["attn_mxu_native"] = bool(int(overrides["attn_mxu_native"]))
    return cfg.scaled(**kw) if kw else cfg


def build_cell(arch: str, shape_name: str, *, multi_pod: bool,
               overrides: dict | None = None):
    """Returns (meta, groups) for one cell, built on ``meta``: ``groups``
    maps what a card holds ("params", "grads", "opt_m", "opt_v", "state")
    to (leaf tree, spec tree), each spec held to its leaf on the mesh.
    Raises what the port would raise running the cell (an unported
    ``moe_impl``, a spec that does not divide)."""
    overrides = overrides or {}
    cfg = _config(arch, overrides)
    if cfg.family == "moe":
        check_impl(cfg.moe_impl)
    sp = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    chips = mesh_chip_count(mesh)
    dp_total = 1
    for a in dp_axes(multi_pod):
        dp_total *= mesh.shape.get(a, 1)

    model = init_params_shape(cfg)
    pshapes = stacked_shapes(model.named_parameters())
    pspecs = param_specs(cfg, mesh)
    groups = {"params": (pshapes, pspecs)}
    meta = {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
            "chips": chips, "kind": sp.kind}

    if sp.kind == "train":
        tpd = int(overrides.get("tokens_per_device",
                                8192 if cfg.d_model <= 4096 else 4096))
        n_micro = int(overrides.get(
            "n_micro", microbatch_plan(cfg, sp.seq_len, sp.global_batch,
                                       dp_total, tokens_per_device=tpd)))
        state_dtype = overrides.get(
            "state_dtype",
            "bfloat16" if cfg.param_count() > 150e9 else "float32")
        opt = adamw_init(model, AdamWConfig(state_dtype=state_dtype))
        ospecs = opt_specs(pspecs)
        groups.update(grads=(pshapes, pspecs),
                      opt_m=(stacked_shapes(opt["m"].items()), ospecs["m"]),
                      opt_v=(stacked_shapes(opt["v"].items()), ospecs["v"]))
        inputs = input_specs(cfg, shape_name, n_micro=n_micro)
        bspecs = {k: batch_spec(multi_pod, n_micro=True) for k in inputs}
        meta.update(n_micro=n_micro, state_dtype=state_dtype,
                    tokens_per_device=tpd,
                    q_chunk=int(overrides.get("q_chunk", 0)))
    elif sp.kind == "prefill":
        inputs = input_specs(cfg, shape_name)
        dp = batch_spec(multi_pod)[0]
        bspecs = {"tokens": (dp, None), "enc_inputs": (dp, None, None)}
        bspecs = {k: bspecs[k] for k in inputs}
        meta.update(q_chunk=int(overrides.get("q_chunk", 1024)))
    else:
        sshapes = init_decode_state(cfg, sp.global_batch, sp.seq_len,
                                    device="meta")
        sspecs = state_specs(cfg, mesh, multi_pod, batch=sp.global_batch,
                             cache_len=sp.seq_len,
                             split_kv=bool(int(overrides.get("split_kv", 1))))
        groups["state"] = (sshapes, sspecs)
        inputs = input_specs(cfg, shape_name)
        dp_ok = sp.global_batch % dp_total == 0 and sp.global_batch > 1
        bspecs = {"tokens": (batch_spec(multi_pod)[0] if dp_ok else None,
                             None), "pos": ()}
    for what, (shapes, specs) in groups.items():
        check_specs(shapes, specs, mesh, what)
    check_specs(inputs, bspecs, mesh, "inputs")
    meta["inputs"] = {k: list(v.shape) for k, v in inputs.items()}
    meta["analytic_bytes_per_device"] = float(sum(
        _bytes_per_device(shapes, specs, mesh)
        for shapes, specs in groups.values()))
    return meta, groups


def cell_leaves(arch: str, shape_name: str, *, multi_pod: bool = False,
                overrides: dict | None = None):
    """(meta, [(group, leaf path, one card's shard shape, dtype)]): every
    leaf a card holds in the cell, as its analytic bytes count it."""
    meta, groups = build_cell(arch, shape_name, multi_pod=multi_pod,
                              overrides=overrides)
    mesh = make_production_mesh(multi_pod=multi_pod)
    out = []
    for what, (shapes, specs) in groups.items():
        spec_of = dict(tree_leaves(specs))
        for path, leaf in tree_leaves(shapes):
            out.append((what, "/".join(path),
                        shard_shape(leaf.shape, spec_of[path], mesh),
                        leaf.dtype))
    return meta, out


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             overrides: dict | None = None, out_dir: str = RESULTS_DIR,
             hw: HW = HW(), tag: str = "") -> dict:
    cfg = _config(arch, overrides or {})
    ok, why = applicable(cfg, shape_name)
    pods = 2 if multi_pod else 1
    rec: dict = {"arch": arch, "shape": shape_name, "pods": pods}
    if not ok:
        rec.update(status="skip", reason=why)
    else:
        try:
            t0 = time.perf_counter()
            meta, _ = build_cell(arch, shape_name, multi_pod=multi_pod,
                                 overrides=overrides)
            t_build = time.perf_counter() - t0
            sp = SHAPES[shape_name]
            chips = meta["chips"]
            mf = model_flops(cfg, sp.seq_len, sp.global_batch, sp.kind)
            nbytes = meta["analytic_bytes_per_device"]
            rl = roofline_terms(hlo_flops=mf / chips, hlo_bytes=nbytes,
                                collective_wire_bytes=0.0, chips=chips, hw=hw)
            rl.update(collective_s=None, fed_by={
                "flops": "model_flops_total / chips",
                "bytes": "meta.analytic_bytes_per_device",
                "collective": f"not available: {NOT_AVAILABLE}"})
            rec.update(
                status="ok", meta=meta, t_build_s=round(t_build, 3),
                fits=nbytes <= hw.hbm_bytes, hbm_bytes=hw.hbm_bytes,
                roofline=rl, model_flops_total=mf,
                **dict.fromkeys(HLO_FIELDS),
                not_available={"fields": list(HLO_FIELDS),
                               "reason": NOT_AVAILABLE},
                overrides=overrides or {},
            )
        except Exception as e:  # a cell's fault is its record, not the run's
            rec.update(status="error", error=f"{type(e).__name__}: {e}",
                       traceback=traceback.format_exc()[-2000:])
    os.makedirs(out_dir, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    path = os.path.join(out_dir, f"{arch}__{shape_name}__{pods}pod{suffix}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, default=str)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=RESULTS_DIR)
    ap.add_argument("--tag", default="")
    ap.add_argument("--set", action="append", default=[],
                    help="override key=value (tokens_per_device, q_chunk, "
                         "n_micro, state_dtype, split_kv, moe_impl, "
                         "attn_k_chunk, capacity_factor, attn_mxu_native)")
    args = ap.parse_args(argv)
    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        overrides[k] = v if not v.replace(".", "").lstrip("-").isdigit() else (
            float(v) if "." in v else int(v))

    if args.all:
        cells = [(a, s) for a in ARCH_IDS for s in SHAPES]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("--all or (--arch and --shape)")
    meshes = [args.multi_pod] if not args.both_meshes else [False, True]
    for arch, shape in cells:
        for mp in meshes:
            t0 = time.perf_counter()
            rec = run_cell(arch, shape, multi_pod=mp, overrides=overrides,
                           out_dir=args.out, tag=args.tag)
            status = rec["status"]
            extra = rec.get("reason", rec.get("error", ""))
            if status == "ok":
                gb = rec["meta"]["analytic_bytes_per_device"] / 1e9
                extra = (f"{gb:.3f} GB a card, "
                         f"{'fits' if rec['fits'] else 'does NOT fit'} "
                         f"{rec['hbm_bytes'] / 1e9:g} GB")
            dom = rec.get("roofline", {}).get("dominant", "")
            print(f"[{time.strftime('%H:%M:%S')}] {arch:24s} {shape:12s} "
                  f"{'2pod' if mp else '1pod'} -> {status:5s} {dom:10s} "
                  f"({time.perf_counter()-t0:.1f}s) {extra[:90]}", flush=True)


if __name__ == "__main__":
    main()
