"""Device-less dry run: every (arch x shape x mesh) cell's real step, run
on ``meta`` DTensors over a fake process group, and counted.

Port of ``src/repro/launch/dryrun.py``, with its CLI.  The reference lowers
and compiles each cell's jitted step on 512 placeholder devices and reads
its costs from the compiled HLO.  Here each cell's step is the port's own
(``make_train_step``, ``make_prefill_step``, ``make_decode_step``), built
on ``torch.device("meta")`` (no memory) with the weights, moments, decode
state and inputs laid out by the specs as DTensors on a ``DeviceMesh``
over a fake process group of 256 or 512 ranks
(``launch.mesh.fake_device_mesh``), and run once under
``analysis.cost.CostCounter``, which counts what device (0, 0) does.  The
reference's probes (``_probe_cfg``, ``_scan_units``, ``_probe_costs``:
2 and 3 layer units, 1 and 2 microbatches) give the full depth: eager
runs every layer and microbatch alike, so the extrapolation is exact.  A
decode step sits at the cache's last row.  A record holds:

* ``status``: ``ok``, ``skip`` (the reference's reason) or ``error`` (with
  its traceback);
* ``meta``: arch, shape, multi_pod, chips, kind; train cells ``n_micro``
  (``microbatch_plan`` at the reference's tokens-per-device rule),
  ``state_dtype`` (bf16 above 150e9 parameters), ``tokens_per_device`` and
  ``q_chunk``; prefill cells ``q_chunk``; the inputs' shapes; and
  ``analytic_bytes_per_device``, the reference's formula
  (``_analytic_param_bytes_per_device``, :95) on the port's specs: train
  the parameters x 2 (weights and gradients) and the two AdamW moments,
  prefill the parameters, decode the parameters and the decode state
  (device (0, 0)'s shards add up to it exactly: ``device_shards``);
* ``fits``: those bytes within one card's HBM (``HW().hbm_bytes``);
* ``model_flops_total`` (``analysis.roofline.model_flops``);
* the counted fields, under the reference's names:
  ``hlo_flops_per_device`` (matmul flops), ``hlo_bytes_per_device``
  (eager's traffic), ``collectives`` and ``collective_wire_bytes``
  (``analysis.roofline.collective_bytes``), ``memory`` (argument,
  output, temp and peak bytes), ``useful_flops_ratio``, a three-term
  ``roofline`` (``roofline_terms`` at ``HW()``) and ``decode_attn_ops``;
  ``hlo_flops_raw`` and ``hlo_bytes_raw`` are ``null``, with the reason
  in ``not_available``.  ``run_cell(count=False)`` stops at the layout.

``cell_leaves`` gives one card's shard of every leaf a cell's analytic
bytes count, so that a run on the card can allocate device (0, 0)'s
share (``chip_smoke.py`` phase 17); ``count_step`` counts any step on any
mesh (``chip_smoke.py`` phase 18 holds the card's counts to it).

Usage (any machine, no card, no network):
  python -m repro_torch.launch.dryrun --arch internlm2-1.8b --shape train_4k
  python -m repro_torch.launch.dryrun --all --both-meshes [--set k=v]

Results land in ``dryrun_out/<arch>__<shape>__<pods>pod[__tag].json`` at
the root of the checkout (``--out`` elsewhere).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback
from pathlib import Path

import torch

from repro_torch.analysis.cost import CostCounter
from repro_torch.analysis.roofline import (
    HW,
    collective_bytes,
    model_flops,
    roofline_terms,
)
from repro_torch.configs import (
    ARCH_IDS,
    SHAPES,
    ShapeSpec,
    applicable,
    get_config,
)
from repro_torch.distributed.sharding import (
    batch_spec,
    check_specs,
    distribute,
    distribute_model,
    distribute_named,
    dp_axes,
    local_bytes,
    one_card_mesh,
    opt_specs,
    param_specs,
    shard_shape,
    stacked_shapes,
    state_specs,
    tree_leaves,
)
from repro_torch.launch.mesh import (
    fake_device_mesh,
    make_production_mesh,
    mesh_chip_count,
)
from repro_torch.models.common import ArchConfig, rope
from repro_torch.models.moe import check_impl
from repro_torch.models.transformer import init_decode_state, init_params_shape
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.train.step import microbatch_plan

__all__ = ["RESULTS_DIR", "NOT_AVAILABLE", "COUNTED_FIELDS", "input_specs",
           "build_cell", "cell_leaves", "count_step", "count_cell",
           "device_shards", "run_cell", "main"]

RESULTS_DIR = str(Path(__file__).resolve().parents[3] / "dryrun_out")
NOT_AVAILABLE = ("eager has no scan body counted once: every layer and "
                 "microbatch runs, and the probes count them all")
# the reference's fields of the step as compiled, scan bodies counted once
RAW_FIELDS = ("hlo_flops_raw", "hlo_bytes_raw")
# the fields the counter fills
COUNTED_FIELDS = RAW_FIELDS + (
    "hlo_flops_per_device", "hlo_bytes_per_device", "collectives",
    "collective_wire_bytes", "memory", "roofline", "decode_attn_ops",
    "useful_flops_ratio")


def _i32(*shape) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.int32, device="meta")


def input_specs(cfg: ArchConfig, shape_name: str, *, n_micro: int = 1,
                global_batch: int | None = None) -> dict:
    """``meta`` stand-ins for every model input (no allocation);
    ``shape_name`` a name of ``SHAPES`` or a ``ShapeSpec``."""
    sp = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
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


# ---------------------------------------------------------------- counting
def _distribute_tree(tree: dict, specs: dict, device_mesh) -> dict:
    """A nested dict of stacked leaves as DTensors by their specs."""
    if isinstance(tree, dict):
        return {k: _distribute_tree(v, specs[k], device_mesh)
                for k, v in tree.items()}
    return distribute(tree, specs, device_mesh)


def _step(cfg: ArchConfig, sp: ShapeSpec, mesh, *, overrides: dict,
          device_mesh, n_micro: int = 1, global_batch: int | None = None):
    """The step of ``sp``'s kind, the port's own, built on ``meta``
    tensors laid out by the specs for ``mesh`` as DTensors on
    ``device_mesh`` (None: plain tensors, one device): (run, arguments,
    shards), ``run()`` running it once and returning its outputs,
    ``shards`` the local tensors ``analytic_bytes_per_device`` counts
    (weights x 2 and the moments for a train step, the weights and the
    decode state for a decode step)."""
    from repro_torch.models.transformer import new_model
    from repro_torch.serving.serve import make_decode_step, make_prefill_step
    from repro_torch.train.step import make_train_step

    def empty(shape, dtype, spec):
        t = torch.empty(shape, dtype=dtype, device="meta")
        return t if device_mesh is None else distribute(t, spec, device_mesh)

    multi_pod = "pod" in mesh.axis_names
    B = global_batch or sp.global_batch
    pspecs = param_specs(cfg, mesh)
    model = new_model(cfg, device="meta")
    if device_mesh is not None:
        distribute_model(model, pspecs, device_mesh)
    params = [p for _, p in model.named_parameters()]
    inputs = input_specs(cfg, sp, n_micro=n_micro, global_batch=B)
    dp = batch_spec(multi_pod)[0]
    if sp.kind == "train":
        opt_cfg = AdamWConfig(state_dtype=overrides.get(
            "state_dtype",
            "bfloat16" if cfg.param_count() > 150e9 else "float32"))
        opt = adamw_init(model, opt_cfg)
        if device_mesh is not None:
            opt.update(m=distribute_named(opt["m"], pspecs, device_mesh),
                       v=distribute_named(opt["v"], pspecs, device_mesh))
        bspec = batch_spec(multi_pod, n_micro=True)
        batch = {k: empty(v.shape, v.dtype, bspec)
                 for k, v in inputs.items()}
        step = make_train_step(
            cfg, opt_cfg, n_micro=n_micro,
            q_chunk=int(overrides.get("q_chunk", 0)),
            remat=bool(overrides.get("remat", True)),
            has_enc=cfg.family == "encdec",
            grad_specs=None if device_mesh is None else pspecs,
            mesh=device_mesh)
        shards = params * 2 + list(opt["m"].values()) + list(
            opt["v"].values())
        return ((lambda: step(model, opt, batch)), [params, opt, batch],
                shards)
    if sp.kind == "prefill":
        args = [empty(v.shape, v.dtype, (dp,) + (None,) * (v.dim() - 1))
                for v in inputs.values()]
        fn = make_prefill_step(cfg, q_chunk=int(overrides.get("q_chunk",
                                                              1024)))
        return (lambda: fn(model, *args)), [params, args], list(params)
    state = init_decode_state(cfg, B, sp.seq_len, device="meta")
    if device_mesh is not None:
        sspecs = state_specs(cfg, mesh, multi_pod, batch=B,
                             cache_len=sp.seq_len,
                             split_kv=bool(int(overrides.get("split_kv", 1))))
        state = _distribute_tree(state, sspecs, device_mesh)
    dp_total = 1
    for a in dp_axes(multi_pod):
        dp_total *= mesh.shape.get(a, 1)
    tokens = empty((B, 1), torch.int32,
                   (dp if B % dp_total == 0 and B > 1 else None, None))
    fn = make_decode_step(cfg)
    # the cache's last row: the attention reads every row, as the
    # reference's einsum spans them
    pos = sp.seq_len - 1
    leaves = [t for _, t in tree_leaves(state)]
    return ((lambda: fn(model, state, tokens, pos)), [params, state, tokens],
            list(params) + leaves)


def _count(run, arguments) -> dict:
    """Run the step once under a ``CostCounter``: its flops, bytes,
    collectives (wire bytes by kind), memory and ops."""
    from torch.distributed.tensor.experimental import implicit_replication

    counter = CostCounter(device="meta")
    counter.track(arguments)
    with counter, implicit_replication():
        out = run()
    mem = counter.memory(out)
    del out
    return {"flops": counter.matmul_flops, "bytes": counter.traffic_bytes,
            "collectives": collective_bytes(counter.collectives),
            "memory": mem, "ops": dict(counter.ops)}


def _probe_cfg(cfg: ArchConfig, units: int) -> ArchConfig:
    """Reduced-layer same-width config for the probes (the reference's
    ``_probe_cfg``, ``dryrun.py:232``)."""
    if cfg.family == "hybrid":
        return cfg.scaled(n_layers=3 * units)
    if cfg.family == "encdec":
        return cfg.scaled(n_layers=units, n_enc_layers=units)
    return cfg.scaled(n_layers=units)


def _scan_units(cfg: ArchConfig) -> float:
    """The reference's ``_scan_units`` (``dryrun.py:241``)."""
    if cfg.family == "hybrid":
        return cfg.n_layers / 3.0   # 26 layers ~ 8.67 superblock units
    return float(cfg.n_layers)


def _flat(c: dict) -> dict:
    """The extrapolated quantities of one count, by name."""
    out = {"flops": c["flops"], "bytes": c["bytes"],
           "collective": c["collectives"]["total"]}
    out.update({f"coll:{k}": v for k, v in c["collectives"].items()
                if k != "total"})
    out.update({f"mem:{k}": v for k, v in c["memory"].items()})
    out["ops:decode_attn"] = c["ops"].get("decode_attn", 0)
    return out


def _probe_costs(cfg: ArchConfig, sp: ShapeSpec, mesh, overrides: dict,
                 n_micro_real: int, device_mesh) -> dict:
    """The reference's ``_probe_costs`` (``dryrun.py:247-297``): count the
    step at 2 and 3 layer units (and, for a train step of more than one
    microbatch, at 1 and 2 microbatches of the real microbatch's batch)
    and extrapolate to the cell's depth and ``n_micro``.  The reference
    fits T(u, m) = f_opt + m * (f_fix + u * f_layer) to three probes, which
    repeats the optimizer's per-layer work once a microbatch; the fourth
    corner (3, 2) here fits T(u, m) = a + b u + c m + d u m, the optimizer
    in b.  Eager runs every layer and microbatch alike, so the fit is exact
    for flops, bytes, collectives and arguments.  The peak follows the
    units at the real microbatch count capped at 2: a further microbatch
    adds only its batch to what is live.  A prefill is probed at its own
    ``q_chunk``: the reference probes it unchunked because XLA would count
    the chunk loop once (the same flops), where eager runs every chunk, so
    the peak here is the cell's."""
    B_mb = sp.global_batch // max(n_micro_real, 1)

    def one(units, n_micro):
        run, args, _ = _step(_probe_cfg(cfg, units), sp, mesh,
                             overrides=overrides, device_mesh=device_mesh,
                             n_micro=n_micro,
                             global_batch=B_mb * n_micro
                             if sp.kind == "train" else None)
        return _flat(_count(run, args))

    U, M = _scan_units(cfg), n_micro_real
    t21, t31 = one(2, 1), one(3, 1)
    if sp.kind != "train" or M == 1:
        out = {k: t21[k] + (U - 2.0) * (t31[k] - t21[k]) for k in t21}
        return out
    t22, t32 = one(2, 2), one(3, 2)
    out = {}
    for k in t21:
        d = (t32[k] - t22[k]) - (t31[k] - t21[k])
        b = (t31[k] - t21[k]) - d
        c = (t22[k] - t21[k]) - 2.0 * d
        a = t21[k] - 2.0 * b - c - 2.0 * d
        out[k] = a + b * U + c * M + d * U * M
    # the peak at two microbatches, and each further one's batch
    args_2 = t22["mem:argument_bytes"] + (U - 2.0) * (
        t32["mem:argument_bytes"] - t22["mem:argument_bytes"])
    out["mem:peak_bytes"] = (
        t22["mem:peak_bytes"] + (U - 2.0) * (t32["mem:peak_bytes"]
                                             - t22["mem:peak_bytes"])
        + out["mem:argument_bytes"] - args_2)
    out["mem:temp_bytes"] = out["mem:peak_bytes"] - out["mem:argument_bytes"]
    return out


def count_step(cfg: ArchConfig, sp: ShapeSpec, mesh=None, *,
               n_micro: int = 1, overrides: dict | None = None,
               probes: bool = True) -> dict:
    """What device (0, 0) of ``mesh`` (the port's ``Mesh``) does in one
    step of ``sp``'s kind for ``cfg``, the port's real step run on
    ``meta`` tensors on a fake process group of the mesh's size (``mesh``
    None: on plain ``meta`` tensors, one device with no mesh):
    ``flops``, ``bytes``, ``collective`` (wire bytes), ``collectives``
    (the reference's dict), ``memory`` (the reference's dict) and
    ``decode_attn_ops``.  ``probes``: extrapolate from the reduced-layer
    probes (``_probe_costs``), else count the whole step at ``cfg``'s
    depth."""
    overrides = overrides or {}
    # RoPE's frequencies reach a device once a process (models.common's
    # _rope_freqs): copied here, before any count, no probe counts them
    rope(torch.zeros(1, device="meta"), cfg.hd, cfg.rope_theta)
    on = one_card_mesh() if mesh is None else mesh
    with (contextlib.nullcontext() if mesh is None
          else fake_device_mesh(mesh)) as dm:
        if probes:
            flat = _probe_costs(cfg, sp, on, overrides, n_micro, dm)
        else:
            run, args, _ = _step(cfg, sp, on, overrides=overrides,
                                 device_mesh=dm, n_micro=n_micro)
            flat = _flat(_count(run, args))
    coll = {k[5:]: flat[k] for k in flat if k.startswith("coll:")}
    coll["n_ops"] = int(round(coll["n_ops"]))
    coll["total"] = flat["collective"]
    return {"flops": flat["flops"], "bytes": flat["bytes"],
            "collective": flat["collective"], "collectives": coll,
            "memory": {k[4:]: flat[k] for k in flat if k.startswith("mem:")},
            "decode_attn_ops": int(round(flat["ops:decode_attn"]))}


def count_cell(arch: str, shape_name: str, *, multi_pod: bool,
               overrides: dict | None = None, cfg: ArchConfig | None = None,
               probes: bool = True) -> dict:
    """``count_step`` of one cell on its production mesh, at its
    ``n_micro``; ``cfg`` replaces the arch's config (a reduced cell)."""
    overrides = overrides or {}
    meta, _ = build_cell(arch, shape_name, multi_pod=multi_pod,
                         overrides=overrides)
    return count_step(cfg or _config(arch, overrides), SHAPES[shape_name],
                      make_production_mesh(multi_pod=multi_pod),
                      n_micro=meta.get("n_micro", 1), overrides=overrides,
                      probes=probes)


def device_shards(arch: str, shape_name: str, *, multi_pod: bool,
                  overrides: dict | None = None) -> int:
    """Bytes of device (0, 0)'s local shards of what
    ``analytic_bytes_per_device`` counts, the cell built at full depth as
    DTensors on the fake mesh."""
    overrides = overrides or {}
    mesh = make_production_mesh(multi_pod=multi_pod)
    with fake_device_mesh(mesh) as dm:
        _, _, shards = _step(_config(arch, overrides), SHAPES[shape_name],
                             mesh, overrides=overrides, device_mesh=dm)
        return local_bytes(shards)


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             overrides: dict | None = None, out_dir: str = RESULTS_DIR,
             hw: HW = HW(), tag: str = "", probes: bool = True,
             count: bool = True) -> dict:
    """One cell's record (see the module's docstring), written to
    ``out_dir``.  ``count=False`` stops at the layout (``meta``, ``fits``):
    the counted fields are null, with the reason."""
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
            rec.update(status="ok", meta=meta, t_build_s=round(t_build, 3),
                       fits=nbytes <= hw.hbm_bytes, hbm_bytes=hw.hbm_bytes,
                       model_flops_total=mf, overrides=overrides or {})
            if count:
                t0 = time.perf_counter()
                c = count_cell(arch, shape_name, multi_pod=multi_pod,
                               overrides=overrides, probes=probes)
                rec["t_count_s"] = round(time.perf_counter() - t0, 3)
                rec.update(_counted(c, mf, chips, hw, probes))
            else:
                rec.update(dict.fromkeys(COUNTED_FIELDS),
                           not_available={"fields": list(COUNTED_FIELDS),
                                          "reason": "not counted "
                                                    "(count=False)"})
        except Exception as e:  # a cell's fault is its record, not the run's
            rec.update(status="error", error=f"{type(e).__name__}: {e}",
                       traceback=traceback.format_exc()[-2000:])
    os.makedirs(out_dir, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    path = os.path.join(out_dir, f"{arch}__{shape_name}__{pods}pod{suffix}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, default=str)
    return rec


def _counted(c: dict, mf: float, chips: int, hw: HW, probes: bool) -> dict:
    """A record's counted fields from ``count_cell``'s counts."""
    rl = roofline_terms(hlo_flops=c["flops"], hlo_bytes=c["bytes"],
                        collective_wire_bytes=c["collective"], chips=chips,
                        hw=hw)
    how = "probes" if probes else "the whole step"
    rl["fed_by"] = {k: f"analysis.cost.CostCounter ({what}), {how}"
                    for k, what in (("flops", "matmul_flops"),
                                    ("bytes", "traffic_bytes"),
                                    ("collective", "collectives, wire "
                                                   "bytes"))}
    return dict(hlo_flops_raw=None, hlo_bytes_raw=None,
                hlo_flops_per_device=c["flops"],
                hlo_bytes_per_device=c["bytes"],
                collectives=c["collectives"],
                collective_wire_bytes=c["collective"],
                memory=c["memory"], roofline=rl,
                decode_attn_ops=c["decode_attn_ops"],
                useful_flops_ratio=(mf / (c["flops"] * chips)
                                    if c["flops"] else None),
                not_available={"fields": list(RAW_FIELDS),
                               "reason": NOT_AVAILABLE})


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
                         f"{rec['hbm_bytes'] / 1e9:g} GB; "
                         f"{rec['hlo_flops_per_device']:.3g} flops, peak "
                         f"{rec['memory']['peak_bytes'] / 1e9:.2f} GB")
            dom = (rec.get("roofline") or {}).get("dominant", "")
            print(f"[{time.strftime('%H:%M:%S')}] {arch:24s} {shape:12s} "
                  f"{'2pod' if mp else '1pod'} -> {status:5s} {dom:10s} "
                  f"({time.perf_counter()-t0:.1f}s) {extra[:90]}", flush=True)


if __name__ == "__main__":
    main()
