"""The dry run's probes (``launch.dryrun._probe_costs``, the reference's
method at 2 and 3 layer units and 1 and 2 microbatches) against a count of
the whole step, on reduced cells at their real widths.

Eager runs every layer and microbatch alike, so the extrapolation equals
the whole step's count: flops, bytes, every collective kind and the
arguments to a relative 1e-9, the peak within 1%.  The cells: internlm2-1.8b
``train_4k`` at 4 layers and 4 microbatches, qwen3-moe ``decode_32k`` at 4
layers, whisper-tiny ``prefill_32k`` at 4 encoder and 4 decoder layers,
recurrentgemma-2b ``decode_32k`` at 12 layers (4 superblocks: the hybrid's
unit), rwkv6-7b ``long_500k`` at 4 layers, and internlm2-1.8b
``decode_32k`` at 4 layers on the two-pod mesh.
"""
import pytest

from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from torch_train_lane import one_torch_thread  # noqa: F401 (autouse)

CELLS = [("internlm2-1.8b", "train_4k", 4, {"n_micro": 4}, False),
         ("qwen3-moe-235b-a22b", "decode_32k", 4, {}, False),
         ("whisper-tiny", "prefill_32k", 4, {}, False),
         ("recurrentgemma-2b", "decode_32k", 12, {}, False),
         ("rwkv6-7b", "long_500k", 4, {}, False),
         ("internlm2-1.8b", "decode_32k", 4, {}, True)]


def _reduced(arch: str, layers: int):
    cfg = get_config(arch)
    if cfg.family == "encdec":
        return cfg.scaled(n_layers=layers, n_enc_layers=layers)
    return cfg.scaled(n_layers=layers)


@pytest.mark.parametrize(
    "arch,shape,layers,overrides,multi_pod", CELLS,
    ids=[f"{a}-{s}-{n}{'-2pod' if mp else ''}" for a, s, n, _, mp in CELLS])
def test_probes_equal_the_whole_step(arch, shape, layers, overrides,
                                     multi_pod):
    cfg = _reduced(arch, layers)
    got, want = (dryrun.count_cell(arch, shape, multi_pod=multi_pod,
                                   overrides=overrides, cfg=cfg,
                                   probes=probes)
                 for probes in (True, False))
    pairs = [(k, got[k], want[k]) for k in ("flops", "bytes", "collective")]
    pairs += [(k, got["collectives"][k], want["collectives"][k])
              for k in want["collectives"]]
    pairs += [(k, got["memory"][k], want["memory"][k])
              for k in ("argument_bytes", "output_bytes")]
    for k, a, b in pairs:
        assert a == pytest.approx(b, rel=1e-9, abs=1e-6), k
    assert want["flops"] > 0 and want["collective"] > 0
    assert got["memory"]["peak_bytes"] == pytest.approx(
        want["memory"]["peak_bytes"], rel=0.01)
    assert got["decode_attn_ops"] == want["decode_attn_ops"]


def test_moe_slots_on_a_shard_are_the_whole_batchs():
    """``models.moe.dispatch_slots`` for one shard's rows, from every
    token's experts, is the whole batch's dispatch on those rows (drops
    included), and the shards' expert buffers sum to the whole batch's:
    what ``distributed.dtensor.moe_ffn`` computes on each device."""
    import torch

    from repro_torch.models import moe

    gen = torch.Generator().manual_seed(0)
    T, E, k, C, D, shards = 24, 8, 2, 4, 16, 4
    logits = torch.randn(T, E, generator=gen)
    x = torch.randn(T, D, generator=gen)
    dispatch, combine, _ = moe.router_dispatch(logits, k, C)
    assert dispatch.sum() < T * k                  # some tokens dropped
    _, _, experts = moe._route(logits, k)
    buffers = 0
    for j in range(shards):
        rows = slice(j * T // shards, (j + 1) * T // shards)
        _, gates, _ = moe._route(logits[rows], k)
        d, c = moe.dispatch_slots(experts, gates, E, C, rows.start)
        assert torch.equal(d, dispatch[rows]) and torch.equal(c,
                                                             combine[rows])
        buffers = buffers + torch.einsum("tec,td->ecd", d, x[rows])
    torch.testing.assert_close(buffers, torch.einsum("tec,td->ecd",
                                                     dispatch, x))
