"""The training substrate of the port held to the JAX package on the CPU:
the token pipeline (``repro_torch.data.tokens``, a copy), the AdamW pieces
(``repro_torch.optim.adamw``) and the int8 gradient compression
(``repro_torch.distributed.compression``), each on the same numpy inputs
as the reference, plus the port's own runs of ``tests/test_train.py``'s
substrate cases and ``tests/test_compression.py``.

Tolerances: the pipeline, the quantizer's int8 codes and scales exact;
``lr_schedule`` rtol 1e-6 (``cos`` in the last f32 bit); AdamW 1e-6 on
identical gradients (bf16 moments within one bf16 unit in the last place:
each package rounds an f32 moment that may differ in its last bit).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import TokenPipeline as JPipeline
from repro.distributed import compression as jcomp
from repro.optim import adamw as jadamw
from repro_torch.data import TokenPipeline
from repro_torch.distributed import compression as tcomp
from repro_torch.optim import adamw as tadamw
from torch_train_lane import one_torch_thread  # noqa: F401 (autouse)

SHAPES = {"b": (1000,), "a": (64, 33), "c": (3, 7, 5)}


# ------------------------------------------------------------ token pipeline
@pytest.mark.parametrize("kw", [
    dict(vocab_size=256, seq_len=16, global_batch=8),
    dict(vocab_size=92544, seq_len=64, global_batch=4, seed=1),
    dict(vocab_size=100, seq_len=8, global_batch=8, shard=2, num_shards=4),
    dict(vocab_size=65536, seq_len=5, global_batch=6, shard=1, num_shards=3,
         seed=1, cursor=7),
])
def test_pipeline_batches_equal_jax(kw):
    mine, ref = TokenPipeline(**kw), JPipeline(**kw)
    assert mine.local_batch == ref.local_batch
    for _ in range(3):
        a, b = mine.next_batch(), ref.next_batch()
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k])
    assert mine.state_dict() == ref.state_dict()
    np.testing.assert_array_equal(mine.batch_at(123)["tokens"],
                                  ref.batch_at(123)["tokens"])


def test_pipeline_seed_past_one_overflows_in_both():
    """The copy keeps the reference's generator as it is: ``seed *
    0x9E3779B97F4A7C15`` leaves uint64 from seed 2 on, and both raise."""
    for cls in (TokenPipeline, JPipeline):
        with pytest.raises(OverflowError):
            cls(vocab_size=100, seq_len=4, global_batch=2, seed=2).batch_at(0)


def test_pipeline_resumes_from_its_cursor():
    """``tests/test_train.py:100-103``: a new pipeline given the state
    continues the stream where the old one stands."""
    tp = TokenPipeline(vocab_size=256, seq_len=16, global_batch=8)
    for _ in range(3):
        tp.next_batch()
    state = tp.state_dict()
    assert state == {"cursor": 3, "seed": 0}
    tp2 = TokenPipeline(vocab_size=256, seq_len=16, global_batch=8, seed=1)
    tp2.load_state_dict(state)
    ref = JPipeline(vocab_size=256, seq_len=16, global_batch=8)
    ref.load_state_dict(state)
    want = tp.next_batch()["tokens"]
    np.testing.assert_array_equal(tp2.next_batch()["tokens"], want)
    np.testing.assert_array_equal(ref.next_batch()["tokens"], want)


def test_pipeline_elastic_resharding():
    """``tests/test_train.py:117``: the same global stream under another
    shard layout, and ``reshard`` equal to the reference's."""
    full = TokenPipeline(vocab_size=100, seq_len=8,
                         global_batch=8).batch_at(5)["tokens"]
    shards = [TokenPipeline(vocab_size=100, seq_len=8, global_batch=8,
                            shard=i, num_shards=4).batch_at(5)["tokens"]
              for i in range(4)]
    np.testing.assert_array_equal(full, np.concatenate(shards, axis=0))
    mine = TokenPipeline(vocab_size=100, seq_len=8, global_batch=8, cursor=4)
    ref = JPipeline(vocab_size=100, seq_len=8, global_batch=8, cursor=4)
    a, b = mine.reshard(1, 2), ref.reshard(1, 2)
    assert (a.shard, a.num_shards, a.cursor, a.local_batch) == (
        b.shard, b.num_shards, b.cursor, b.local_batch) == (1, 2, 4, 4)
    np.testing.assert_array_equal(a.next_batch()["labels"],
                                  b.next_batch()["labels"])
    with pytest.raises(ValueError, match="divide"):
        TokenPipeline(vocab_size=100, seq_len=8, global_batch=6,
                      num_shards=4)


# ------------------------------------------------------------------ AdamW
@pytest.mark.parametrize("warmup,total", [(0, 150), (10, 100), (100, 10000),
                                          (3, 20)])
def test_lr_schedule_equals_jax(warmup, total):
    steps = np.arange(0, 201, dtype=np.int32)
    kw = dict(lr=3e-4, warmup_steps=warmup, total_steps=total)
    want = np.asarray(jadamw.lr_schedule(jadamw.AdamWConfig(**kw),
                                         jnp.asarray(steps)))
    got = tadamw.lr_schedule(tadamw.AdamWConfig(**kw),
                             torch.from_numpy(steps))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


@pytest.mark.parametrize("clip", [0.5, 1e9])
@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_update_equals_jax(state_dtype, clip):
    """Five updates on the same gradients (clipping active at 0.5), the
    port's state set to JAX's before each, so every update starts from
    identical inputs."""
    rng = np.random.default_rng(0)
    kw = dict(lr=1e-2, warmup_steps=3, total_steps=20, clip_norm=clip,
              state_dtype=state_dtype)
    jcfg, tcfg = jadamw.AdamWConfig(**kw), tadamw.AdamWConfig(**kw)
    p = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    jo, to = jadamw.adamw_init(jp, jcfg), tadamw.adamw_init(tp, tcfg)
    moment_tol = (dict(atol=1e-6, rtol=1e-6) if state_dtype == "float32"
                  else dict(atol=1e-6, rtol=2 ** -8))
    for _ in range(5):
        g = {k: (rng.normal(size=s) * 3).astype(np.float32)
             for k, s in SHAPES.items()}
        jp, jo, jm = jadamw.adamw_update(
            {k: jnp.asarray(v) for k, v in g.items()}, jo, jp, jcfg)
        _, to, tm = tadamw.adamw_update(
            {k: torch.from_numpy(v) for k, v in g.items()}, to, tp, tcfg)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        if clip < 1:
            assert float(jm["grad_norm"]) > clip
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        assert int(to["step"]) == int(jo["step"])
        for k in p:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       atol=1e-6, rtol=1e-6)
            for part in ("m", "v"):
                got = to[part][k]
                assert str(got.dtype) == f"torch.{state_dtype}"
                np.testing.assert_allclose(
                    got.float().numpy(),
                    np.asarray(jo[part][k]).astype(np.float32), **moment_tol)
                with torch.no_grad():
                    got.copy_(torch.from_numpy(
                        np.asarray(jo[part][k]).astype(np.float32)))
            with torch.no_grad():
                tp[k].copy_(torch.from_numpy(np.array(jp[k])))


def test_adamw_update_writes_in_place():
    cfg = tadamw.AdamWConfig()
    p = {"w": torch.ones(4), "u": torch.zeros(2, 3)}
    opt = tadamw.adamw_init(p, cfg)
    ptrs = [t.data_ptr() for t in (*p.values(), *opt["m"].values(),
                                   *opt["v"].values(), opt["step"])]
    out, opt2, _ = tadamw.adamw_update(
        {"w": torch.full((4,), 0.5), "u": torch.ones(2, 3)}, opt, p, cfg)
    assert out is p and opt2 is opt
    assert [t.data_ptr() for t in (*p.values(), *opt["m"].values(),
                                   *opt["v"].values(), opt["step"])] == ptrs
    assert int(opt["step"]) == 1 and float(p["w"][0]) < 1.0


def test_adamw_matches_reference_math():
    """``tests/test_train.py:60`` on the port."""
    ocfg = tadamw.AdamWConfig(lr=0.1, weight_decay=0.0, clip_norm=1e9)
    p = {"w": torch.tensor([1.0, -2.0])}
    opt = tadamw.adamw_init(p, ocfg)
    tadamw.adamw_update({"w": torch.tensor([0.5, 0.5])}, opt, p, ocfg)
    m = 0.1 * 0.5 / (1 - 0.9)
    v = 0.05 * 0.25 / (1 - 0.95)
    lr = float(tadamw.lr_schedule(ocfg, torch.tensor(1, dtype=torch.int32)))
    want = 1.0 - lr * (m / (np.sqrt(v) + ocfg.eps))
    np.testing.assert_allclose(float(p["w"][0]), want, rtol=1e-5)


def test_bf16_state_halves_memory():
    """``tests/test_train.py:76`` on the port, over a smoke model."""
    from repro_torch.configs import smoke_config
    from repro_torch.models.transformer import init_params

    model = init_params(smoke_config("internlm2-1.8b"),
                        torch.Generator().manual_seed(0), device="cpu")
    size = {}
    for dt in ("float32", "bfloat16"):
        o = tadamw.adamw_init(model, tadamw.AdamWConfig(state_dtype=dt))
        size[dt] = sum(t.numel() * t.element_size() for t in o["m"].values())
    assert size["bfloat16"] * 2 == size["float32"]


# ------------------------------------------------------------- compression
@pytest.mark.parametrize("n,scale", [(1000, 3.0), (256, 0.01), (4097, 10.0),
                                     (7, 1.0)])
def test_quantizer_equals_jax(n, scale):
    x = (np.random.default_rng(n).normal(size=(n,)) * scale).astype(
        np.float32)
    x[:3] = [0.0, scale * 2.5, -scale * 2.5]        # zeros and the max
    jq, js = jcomp.quantize_int8(jnp.asarray(x))
    tq, ts = tcomp.quantize_int8(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and tuple(tq.shape) == jq.shape
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tcomp.dequantize_int8(tq, ts, (n,), n).numpy(),
        np.asarray(jcomp.dequantize_int8(jq, js, (n,), n)))


def test_quantizer_rounds_half_to_even():
    """A chunk whose max is 127 has scale 1: 0.5, 1.5, 2.5 and -0.5 land
    on 0, 2, 2 and -0, as ``jnp.round`` puts them."""
    x = np.zeros(256, np.float32)
    x[:5] = [127.0, 0.5, 1.5, 2.5, -0.5]
    tq, _ = tcomp.quantize_int8(torch.from_numpy(x))
    jq, _ = jcomp.quantize_int8(jnp.asarray(x))
    assert tq[0, :5].tolist() == [127, 0, 2, 2, 0]
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))


def test_compress_decompress_with_error_feedback_equals_jax():
    """Ten steps of a two-leaf tree, the error feedback carried by each
    package: the sent gradients and the residuals equal JAX's."""
    rng = np.random.default_rng(5)
    shapes = {"w": (300,), "b": (4, 65)}
    jef = jcomp.init_error_feedback(
        {k: jnp.zeros(s) for k, s in shapes.items()})
    tef = tcomp.init_error_feedback(
        {k: torch.zeros(s) for k, s in shapes.items()})
    for _ in range(10):
        g = {k: rng.normal(size=s).astype(np.float32)
             for k, s in shapes.items()}
        jout, jef = jcomp.compress_decompress(
            {k: jnp.asarray(v) for k, v in g.items()}, jef)
        tout, tef = tcomp.compress_decompress(
            {k: torch.from_numpy(v) for k, v in g.items()}, tef)
        for k in shapes:
            np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]),
                                       atol=1e-6, rtol=1e-6)
            np.testing.assert_allclose(tef[k].numpy(), np.asarray(jef[k]),
                                       atol=1e-6, rtol=1e-6)


def test_quantize_roundtrip_bounded_error():
    """``tests/test_compression.py:15`` on the port."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(1000,)) * rng.uniform(0.01, 10))
    q, s = tcomp.quantize_int8(x)
    y = tcomp.dequantize_int8(q, s, x.shape, x.numel())
    err = (x.float() - y).abs()
    assert float(err.max()) <= float(s.max()) / 2 + 1e-7
    assert q.dtype == torch.int8


def test_error_feedback_unbiased_over_time():
    """``tests/test_compression.py:27`` on the port."""
    g_true = torch.from_numpy(np.random.default_rng(1).normal(size=(512,)))
    ef = torch.zeros(512)
    sent = torch.zeros(512)
    for _ in range(50):
        out, ef_tree = tcomp.compress_decompress({"g": g_true}, {"g": ef})
        sent = sent + out["g"]
        ef = ef_tree["g"]
    assert float((sent / 50 - g_true).abs().max()) < 1e-3
    assert float(ef.abs().max()) < float(g_true.abs().max())


def test_training_converges_with_compression():
    """``tests/test_compression.py:41`` on the port: compressed-gradient
    SGD on a tiny least-squares problem reaches the same loss."""
    rng = np.random.default_rng(2)
    A = torch.from_numpy(rng.normal(size=(64, 8)).astype(np.float32))
    y = A @ torch.from_numpy(rng.normal(size=(8,)).astype(np.float32))
    for compressed in (False, True):
        w = torch.zeros(8, requires_grad=True)
        ef = tcomp.init_error_feedback({"w": w.detach()})
        for _ in range(300):
            (g,) = torch.autograd.grad(torch.mean((A @ w - y) ** 2), w)
            if compressed:
                out, ef = tcomp.compress_decompress({"w": g}, ef)
                g = out["w"]
            with torch.no_grad():
                w -= 0.05 * g
        final = float(torch.mean((A @ w.detach() - y) ** 2))
        assert final < 1e-3, (compressed, final)


def test_wire_bytes_ratio():
    q, s = tcomp.quantize_int8(torch.ones(4096))
    assert q.numel() + s.numel() * 4 < 4096 * 4 / 3.8
