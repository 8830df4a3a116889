"""The JAX package's side of ``tests/test_torch_dryrun.py``, run as a child
process: ``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512 host devices
when it is imported, which the test process must not do.

For every (arch, shape, mesh) cell it prints one JSON line with what the
reference's ``build_lowered`` puts in a record's ``meta`` and
``run_cell``'s status, skip reason and ``model_flops_total``, computed with
the reference's own ``applicable``, ``microbatch_plan``, ``input_specs``,
specs and ``_analytic_param_bytes_per_device``.  It never lowers.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_dryrun_lane.py
"""
import json
import types

import numpy as np

from repro.launch import dryrun  # noqa: F401  (sets XLA_FLAGS first)

import jax  # noqa: E402

from repro.analysis.roofline import model_flops  # noqa: E402
from repro.configs import ARCH_IDS, SHAPES, applicable, get_config  # noqa: E402
from repro.distributed.sharding import (  # noqa: E402
    dp_axes,
    param_specs,
    state_specs,
)
from repro.models.transformer import init_decode_state, init_params_shape  # noqa: E402
from repro.optim.adamw import AdamWConfig, adamw_init  # noqa: E402
from repro.train.step import microbatch_plan  # noqa: E402


def mesh(multi_pod: bool):
    """The production mesh's axes and shape, with no devices."""
    if multi_pod:
        return types.SimpleNamespace(axis_names=("pod", "data", "model"),
                                     devices=np.empty((2, 16, 16)))
    return types.SimpleNamespace(axis_names=("data", "model"),
                                 devices=np.empty((16, 16)))


def cell(arch: str, shape_name: str, multi_pod: bool) -> dict:
    cfg = get_config(arch)
    ok, why = applicable(cfg, shape_name)
    rec = {"arch": arch, "shape": shape_name, "pods": 2 if multi_pod else 1}
    if not ok:
        return dict(rec, status="skip", reason=why)
    sp = SHAPES[shape_name]
    m = mesh(multi_pod)
    mesh_shape = dict(zip(m.axis_names, m.devices.shape))
    dp_total = 1
    for a in dp_axes(multi_pod):
        dp_total *= mesh_shape.get(a, 1)
    pspecs = param_specs(cfg, m)
    pshapes = init_params_shape(cfg)
    analytic = dryrun._analytic_param_bytes_per_device
    meta = {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
            "chips": int(m.devices.size), "kind": sp.kind}
    n_micro = 1
    if sp.kind == "train":
        tpd = 8192 if cfg.d_model <= 4096 else 4096
        n_micro = microbatch_plan(cfg, sp.seq_len, sp.global_batch, dp_total,
                                  tokens_per_device=tpd)
        state_dtype = ("bfloat16" if cfg.param_count() > 150e9
                       else "float32")
        oshapes = jax.eval_shape(
            lambda p: adamw_init(p, AdamWConfig(state_dtype=state_dtype)),
            pshapes)
        meta.update(n_micro=n_micro, state_dtype=state_dtype,
                    tokens_per_device=tpd, q_chunk=0)
        meta["analytic_bytes_per_device"] = (
            analytic(pshapes, pspecs, m) * 2
            + analytic(oshapes["m"], pspecs, m) * 2)
    elif sp.kind == "prefill":
        meta.update(q_chunk=1024)
        meta["analytic_bytes_per_device"] = analytic(pshapes, pspecs, m)
    else:
        sshapes = jax.eval_shape(
            lambda: init_decode_state(cfg, sp.global_batch, sp.seq_len))
        sspecs = state_specs(cfg, m, multi_pod, batch=sp.global_batch,
                             cache_len=sp.seq_len)
        meta["analytic_bytes_per_device"] = (
            analytic(pshapes, pspecs, m) + analytic(sshapes, sspecs, m))
    inputs = dryrun.input_specs(cfg, shape_name, n_micro=n_micro)
    meta["inputs"] = {k: list(v.shape) for k, v in inputs.items()}
    return dict(rec, status="ok", meta=meta, model_flops_total=model_flops(
        cfg, sp.seq_len, sp.global_batch, sp.kind))


if __name__ == "__main__":
    for arch in ARCH_IDS:
        for shape_name in SHAPES:
            for multi_pod in (False, True):
                print(json.dumps(cell(arch, shape_name, multi_pod)))
