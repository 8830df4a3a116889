"""The shared body of ``tests/test_torch_dryrun_cost.py`` (train steps) and
``tests/test_torch_dryrun_cost_serve.py`` (prefill and decode steps): the
dry run's counted matmul flops on one device held to the JAX package's
``parse_hlo_cost`` (``src/repro/analysis/hlocost.py``) on the CPU.  Also
``check_record``, what every counted record of the dry run holds
(``tests/test_torch_dryrun_mesh.py``, ``tests/test_torch_dryrun_train*``).

At ``smoke_config``, B 4, S 32: the port's train step (n_micro 2, remat),
prefill step and decode step, counted by ``launch.dryrun.count_step`` on
plain ``meta`` tensors, one device (the whole step, no probes), against
the reference's same step jitted unrolled on one CPU device, its optimized
HLO parsed.  The two are equal exactly but where they compute a different
matmul, each difference pinned exactly (``PERF.md`` lists them):

* rwkv6-7b and whisper-tiny decode: the reference's ``decode_step`` scans
  these families' layers with ``lax.scan`` whatever ``unroll`` says
  (``src/repro/models/transformer.py:506``, ``:523``), and
  ``parse_hlo_cost`` counts a while body once: the difference is one
  layer's flops, the port's count at 3 layers less its count at 2;
* rwkv6-7b prefill: the state after the last chunk, which a prefill never
  reads (XLA drops its update, eager runs it): one chunk's state update a
  layer, 2 B H K K chunk;
* rwkv6-7b train: the current-token bonus, ``einsum("bhck,bhck->bhc")``,
  has no free axis, so its two gradients contract nothing; XLA rewrites
  those into multiplies, torch runs them as ``bmm``: 2 x 2 B_mb H chunk K a
  layer and microbatch.
"""
import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.analysis.hlocost import parse_hlo_cost
from repro.models.transformer import init_decode_state, init_params_shape
from repro.optim.adamw import AdamWConfig as JAdamW
from repro.optim.adamw import adamw_init
from repro.serving.serve import make_decode_step as j_decode
from repro.serving.serve import make_prefill_step as j_prefill
from repro.train.step import make_train_step as j_train
from repro_torch import configs as tconfigs
from repro_torch.configs import ShapeSpec
from repro_torch.launch import dryrun

ARCHS = ["internlm2-1.8b", "qwen3-moe-235b-a22b", "rwkv6-7b", "whisper-tiny"]
B, S, N_MICRO = 4, 32, 2


def _reference(arch: str, kind: str) -> float:
    """``parse_hlo_cost``'s matmul flops of the reference's step, jitted
    unrolled on one CPU device."""
    cfg = jconfigs.smoke_config(arch)
    params = init_params_shape(cfg)
    enc = cfg.family == "encdec"

    def i32(*shape):
        return jax.ShapeDtypeStruct(shape, jnp.int32)

    def frames(*lead):
        return jax.ShapeDtypeStruct((*lead, cfg.enc_seq, cfg.d_model),
                                    cfg.jdtype)

    if kind == "train":
        opt = jax.eval_shape(lambda p: adamw_init(p, JAdamW()), params)
        batch = {"tokens": i32(N_MICRO, B // N_MICRO, S),
                 "labels": i32(N_MICRO, B // N_MICRO, S)}
        if enc:
            batch["enc_inputs"] = frames(N_MICRO, B // N_MICRO)
        fn = j_train(cfg, JAdamW(), n_micro=N_MICRO, unroll=True,
                     has_enc=enc)
        args = (params, opt, batch)
    elif kind == "prefill":
        fn = j_prefill(cfg, q_chunk=0, unroll=True)
        args = (params, i32(B, S)) + ((frames(B),) if enc else ())
    else:
        state = jax.eval_shape(lambda: init_decode_state(cfg, B, S))
        fn = j_decode(cfg, unroll=True)
        args = (params, state, i32(B, 1), jax.ShapeDtypeStruct((),
                                                                jnp.int32))
    txt = jax.jit(fn).lower(*args).compile().as_text()
    return parse_hlo_cost(txt)["matmul_flops"]


def _port(arch: str, kind: str, n_layers: int | None = None) -> float:
    cfg = tconfigs.smoke_config(arch)
    if n_layers is not None:
        cfg = cfg.scaled(n_layers=n_layers)
    c = dryrun.count_step(cfg, ShapeSpec("smoke", S, B, kind),
                          n_micro=N_MICRO if kind == "train" else 1,
                          probes=False)
    assert c["collective"] == 0.0       # one card: nothing on the wire
    return c["flops"]


def _explained(arch: str, kind: str) -> float:
    """The pinned difference port - reference (see the module's
    docstring)."""
    cfg = tconfigs.smoke_config(arch)
    if kind == "decode" and cfg.family in ("rwkv", "encdec"):
        return _port(arch, kind, cfg.n_layers + 1) - _port(arch, kind)
    if arch != "rwkv6-7b":
        return 0.0
    H = cfg.n_heads
    K, chunk = cfg.d_model // H, 64
    if kind == "prefill":
        return cfg.n_layers * 2.0 * B * H * K * K * chunk
    if kind == "train":
        return cfg.n_layers * N_MICRO * 2 * (2.0 * (B // N_MICRO) * H
                                             * chunk * K)
    return 0.0


def check_record(rec: dict) -> None:
    """An ``ok`` record of ``dryrun.run_cell``: every counted field filled,
    ``hlo_*_raw`` null with the reason, the memory dict the reference's,
    a three-term roofline naming what fed it."""
    assert rec["status"] == "ok", rec.get("error")
    for k in dryrun.COUNTED_FIELDS:
        assert (rec[k] is None) == k.endswith("_raw"), k
    assert rec["not_available"] == {"fields": ["hlo_flops_raw",
                                               "hlo_bytes_raw"],
                                    "reason": dryrun.NOT_AVAILABLE}
    mem = rec["memory"]
    assert set(mem) == {"argument_bytes", "output_bytes", "temp_bytes",
                        "peak_bytes"}
    assert mem["peak_bytes"] == mem["argument_bytes"] + mem["temp_bytes"]
    assert mem["temp_bytes"] > 0 and mem["argument_bytes"] > 0
    rl = rec["roofline"]
    assert all(rl[k] > 0 for k in ("compute_s", "memory_s", "collective_s"))
    assert set(rl["fed_by"]) == {"flops", "bytes", "collective"}
    assert rec["useful_flops_ratio"] == rec["model_flops_total"] / (
        rec["hlo_flops_per_device"] * rec["meta"]["chips"])
    kinds = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
             "collective-permute")
    coll = rec["collectives"]
    assert coll["total"] == rec["collective_wire_bytes"] > 0
    assert abs(coll["total"] - sum(coll[k] for k in kinds)) <= 1e-9 * coll[
        "total"]
