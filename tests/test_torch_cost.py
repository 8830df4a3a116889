"""The port's cost counter (``repro_torch.analysis.cost``) and
``collective_bytes`` held to the JAX package's HLO parsers on the CPU.

The same jnp and torch functions, a matmul, a batched einsum and a chain,
on one CPU device: the counter's ``matmul_flops`` equals
``parse_hlo_cost``'s on the jitted function's optimized HLO, exactly, and a
lone matmul's ``traffic_bytes`` equals its ``traffic_bytes``.
``collective_bytes`` equals ``collective_bytes_from_hlo`` on HLO lines of
``tests/test_roofline.py``'s form of the same kind, bytes and group size,
including the collectives the counter records from DTensors redistributed
on a fake process group.  Beside: live bytes and their peak (a softmax
backward's buffers among them), the ``memory`` dict, an opaque op
(``decode_attn``), ops DTensor's sharding propagation runs left
uncounted, and the hook doing nothing with no counter.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis.hlocost import parse_hlo_cost
from repro.analysis.roofline import collective_bytes_from_hlo
from repro_torch.analysis import collective_bytes
from repro_torch.analysis.cost import ACTIVE, CostCounter
from repro_torch.kernels import ops
from repro_torch.kernels.decode_attn import work
from repro_torch.launch.mesh import fake_device_mesh, make_mesh

FUNCS = {
    "matmul": (lambda x, w: x @ w, [(64, 128), (128, 256)]),
    "batched_einsum": (lambda x, w: (jnp if isinstance(x, jax.Array)
                                     else torch).einsum("bij,bjk->bik", x, w),
                       [(4, 64, 128), (4, 128, 32)]),
    "chain": (lambda x, w1, w2: (jnp if isinstance(x, jax.Array)
                                 else torch).tanh(x @ w1) @ w2,
              [(64, 128), (128, 256), (256, 32)]),
    "gqa_scores": (lambda q, k: (jnp if isinstance(q, jax.Array)
                                 else torch).einsum("bshgd,bthd->bhgst",
                                                    q, k),
                   [(2, 16, 4, 2, 32), (2, 24, 4, 32)]),
}


def _jax_cost(fn, shapes):
    args = [jnp.zeros(s, jnp.float32) for s in shapes]
    return parse_hlo_cost(jax.jit(fn).lower(*args).compile().as_text())


def _counted(fn, shapes):
    rng = np.random.default_rng(0)
    args = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in shapes]
    with CostCounter() as c:
        fn(*args)
    return c


@pytest.mark.parametrize("name", FUNCS)
def test_matmul_flops_equal_parse_hlo_cost(name):
    fn, shapes = FUNCS[name]
    want = _jax_cost(fn, shapes)["matmul_flops"]
    assert want > 0
    assert _counted(fn, shapes).matmul_flops == want


@pytest.mark.parametrize("name", FUNCS)
def test_fake_and_meta_tensors_count_as_real_ones(name):
    """The same function on fake tensors (``FakeTensorMode``) and on
    ``meta`` tensors counts the real tensors' flops, bytes and ops."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    fn, shapes = FUNCS[name]
    real = _counted(fn, shapes)
    with FakeTensorMode():
        fake_args = [torch.empty(s) for s in shapes]
        with CostCounter() as fake:
            fn(*fake_args)
    meta_args = [torch.empty(s, device="meta") for s in shapes]
    with CostCounter() as meta:
        fn(*meta_args)
        fn(*meta_args)          # a second call: the meta outputs cached
    for c, times in ((fake, 1), (meta, 2)):
        assert c.matmul_flops == times * real.matmul_flops
        assert c.traffic_bytes == times * real.traffic_bytes
        assert c.ops == {k: times * v for k, v in real.ops.items()}


def test_a_lone_matmul_moves_the_references_bytes():
    fn, shapes = FUNCS["matmul"]
    want = _jax_cost(fn, shapes)["traffic_bytes"]
    c = _counted(fn, shapes)
    assert c.traffic_bytes == want == 4 * (64 * 128 + 128 * 256 + 64 * 256)
    assert dict(c.ops) == {"mm": 1}


_HLO_LINE = {
    "all-reduce": "  %c = {t} all-reduce(%x), replica_groups={{{g}}}, "
                  "to_apply=%add",
    "all-gather": "  %c = {t} all-gather(%x), replica_groups={{{g}}}, "
                  "dimensions={{0}}",
    "reduce-scatter": "  %c = {t} reduce-scatter(%x), replica_groups="
                      "{{{g}}}, dimensions={{0}}, to_apply=%add",
    "all-to-all": "  %c = {t} all-to-all(%x), replica_groups={{{g}}}, "
                  "dimensions={{0}}",
    "collective-permute": "  %c = {t} collective-permute(%x), "
                          "source_target_pairs={{0,1}}",
}


def _hlo(records) -> str:
    """HLO text of ``tests/test_roofline.py``'s form, a line a record
    (results in f32)."""
    lines = [_HLO_LINE[kind].format(
        t=f"f32[{size // 4}]{{0}}", g=",".join(map(str, range(n))))
        for kind, size, n in records]
    return "ENTRY %main () -> f32[] {\n" + "\n".join(lines) + "\n}\n"


@pytest.mark.parametrize("records", [
    [("all-reduce", 4096, 4), ("all-gather", 4096, 2),
     ("collective-permute", 2048, 2)],          # tests/test_roofline.py's
    [("reduce-scatter", 1 << 20, 16), ("all-to-all", 65536, 16),
     ("all-reduce", 256, 2), ("all-gather", 12288, 16),
     ("all-reduce", 1 << 22, 256)],
    [],
], ids=["test_roofline", "mixed", "none"])
def test_collective_bytes_equal_collective_bytes_from_hlo(records):
    assert collective_bytes(records) == collective_bytes_from_hlo(
        _hlo(records))


def test_a_group_of_one_moves_nothing():
    got = collective_bytes([("all-reduce", 4096, 1), ("all-gather", 0, 4)])
    assert got["total"] == 0.0 and got["n_ops"] == 0
    with pytest.raises(ValueError, match="unknown collective"):
        collective_bytes([("broadcast", 8, 2)])


def test_dtensor_collectives_and_local_flops_on_a_fake_mesh():
    """A DTensor matmul on a 4 x 2 fake mesh: the counter sees device
    (0, 0)'s local mm (not the global one sharding propagation runs) and
    the collectives redistributing its operands, whose wire bytes equal
    the HLO parser's on the same lines."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    with fake_device_mesh(make_mesh((4, 2), ("data", "model"))) as dm:
        x = distribute_tensor(torch.empty(64, 128, device="meta"), dm,
                              [Shard(0), Replicate()], src_data_rank=None)
        w = distribute_tensor(torch.empty(128, 256, device="meta"), dm,
                              [Shard(0), Shard(1)], src_data_rank=None)
        with CostCounter() as c, implicit_replication():
            y = x @ w
        local = y.to_local()
        k = 128 // (4 if y.placements[0].is_partial() else 1) // (
            2 if y.placements[1].is_partial() else 1)
        assert c.ops["mm"] == 1 and local.numel() < 64 * 256
        assert c.matmul_flops == 2 * local.numel() * k < 2 * 64 * 256 * 128
        assert c.collectives and {k for k, *_ in c.collectives} <= {
            "all-gather", "all-to-all"}
        assert collective_bytes(c.collectives) == collective_bytes_from_hlo(
            _hlo(c.collectives))
    with pytest.raises(RuntimeError, match="default process group"):
        with fake_device_mesh(make_mesh((2, 1), ("data", "model"))):
            with fake_device_mesh(make_mesh((2, 1), ("data", "model"))):
                pass


def test_live_bytes_and_the_memory_dict():
    a = torch.zeros(1000)                       # 4000 bytes, an argument
    c = CostCounter()
    assert c.track([a, {"again": a}]) == 4000   # one storage, once
    with c:
        b = a * 2                               # live 8000
        d = b.view(10, 100) + 1                 # live 12000 (the peak)
        del b                                   # live 8000
        e = d.sum()                             # 4 bytes more
    assert c.peak_bytes == 12000
    assert c.live_bytes == 8004
    assert c.memory([d, e, a]) == {"argument_bytes": 4000,
                                   "output_bytes": 4004, "temp_bytes": 8000,
                                   "peak_bytes": 12000}
    # views move no bytes; the ops that write count operands and results
    assert c.ops["view"] == 1 and c.traffic_bytes == (
        8000 + 8000 + 4000 + 4)


@pytest.mark.parametrize("contiguous", [True, False])
def test_a_softmax_backward_holds_two_gradients_while_it_runs(contiguous):
    """The CUDA softmax backward copies a non-contiguous gradient and
    writes through a proxy output: the peak takes two gradient-sized
    buffers beside the inputs and the output, and nothing for a contiguous
    gradient."""
    out = torch.softmax(torch.randn(64, 32), -1)
    g = torch.randn(64, 32) if contiguous else torch.randn(32, 64).t()
    c = CostCounter()
    c.track([out, g])
    with c:
        grad = torch.ops.aten._softmax_backward_data(g, out, -1,
                                                     torch.float32)
    n = 64 * 32 * 4
    assert grad.shape == (64, 32)
    assert c.peak_bytes == 3 * n + (0 if contiguous else 2 * n)


def test_decode_attn_is_one_op_of_its_own_work():
    """On the CPU ``ops.decode_attn`` runs the plain version in tile order;
    counted, it is one op of 4 Hq D flops a row read and its q, K/V rows
    and output, whatever it runs inside."""
    rng = np.random.default_rng(1)
    B, Hq, Hkv, D, S = 2, 8, 2, 32, 40

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32))

    q, k, v = t(B, Hq, D), t(B, S, Hkv, D), t(B, S, Hkv, D)
    kv_len = torch.tensor([40, 13], dtype=torch.int32)
    want = ops.decode_attn(q, k, v, kv_len)
    with CostCounter() as c:
        got = ops.decode_attn(q, k, v, kv_len)
    assert torch.equal(got, want)
    rows = 40 + 13
    assert c.ops == {"decode_attn": 1}
    assert c.matmul_flops == 4 * Hq * D * rows
    assert c.traffic_bytes == 4 * (2 * B * Hq * D + 2 * rows * Hkv * D)
    meta = [x.to("meta") for x in (q, k, kv_len)]
    assert work(*meta) == (4.0 * Hq * D * B * S,
                           4.0 * (2 * B * Hq * D + 2 * B * S * Hkv * D))
    assert not ACTIVE and not c._opaque


def test_nothing_is_counted_without_a_counter():
    q = torch.zeros(1, 4, 16)
    k = torch.zeros(1, 8, 2, 16)
    c = CostCounter()
    ops.decode_attn(q, k, k, torch.tensor([8], dtype=torch.int32))
    assert c.matmul_flops == 0 and not c.ops and not ACTIVE
