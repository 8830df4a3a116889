"""The port's checkpointer (``repro_torch.train.checkpoint``) and train
launcher (``repro_torch.launch.train``) on the CPU.

The reference's own cases on the port: round trip and retention
(``tests/test_train.py:85``), no ``.tmp`` left (``:106``); async saves are
one-deep.  Across packages, on the smoke internlm2-1.8b in f32 with bf16
AdamW moments: a checkpoint the JAX package wrote restores into the port
and one the port wrote into the JAX package, every leaf of the parameters
and of the optimizer state bit equal as f32, and one train step after each
restore equals the other package's step (loss and ``grad_norm`` at 1e-4,
the weights at 1e-4 where the gradient is not at its leaf's noise: the
third hold of ``torch_train_lane.py``).  In the port: a run checkpointed
and restored mid-way into a model of other weights equals the
uninterrupted run bit for bit (weights, moments, step and the data
cursor), no weight's ``data_ptr`` moves across ``restore``, and the
launcher resumed from its checkpoint ends where an uninterrupted launcher
run ends.
"""
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.models import init_params as j_init_params
from repro.optim import adamw as jadamw
from repro.train.checkpoint import Checkpointer as JCheckpointer
from repro.train.step import loss_fn as j_loss_fn
from repro.train.step import make_train_step as j_make_train_step
from repro_torch.configs import smoke_config
from repro_torch.data import TokenPipeline
from repro_torch.launch import train as launcher
from repro_torch.models import transformer as T
from repro_torch.optim import adamw as tadamw
from repro_torch.train import Checkpointer, make_train_step
from torch_train_lane import one_torch_thread  # noqa: F401 (autouse)

ARCH = "internlm2-1.8b"
CPU = torch.device("cpu")
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=40, state_dtype="bfloat16")
TOL = dict(atol=1e-4, rtol=1e-4)
MASK, LEFT_OUT = 1e-3, 0.05


def _cfg(dtype="float32"):
    return smoke_config(ARCH).scaled(dtype=dtype)


def _port_run(seed=0, dtype="float32"):
    cfg = _cfg(dtype)
    model = T.init_params(cfg, torch.Generator().manual_seed(seed),
                          device=CPU)
    ocfg = tadamw.AdamWConfig(**OPT)
    return (cfg, model, tadamw.adamw_init(model, ocfg),
            make_train_step(cfg, ocfg, n_micro=2))


def _batch(pipe, n_micro=2):
    b = pipe.next_batch()
    return {k: torch.from_numpy(b[k]).reshape(n_micro, -1, pipe.seq_len)
            for k in ("tokens", "labels")}


def _pipe():
    return TokenPipeline(vocab_size=256, seq_len=16, global_batch=4)


def _state_tensors(model, opt):
    return ([p for _, p in model.named_parameters()]
            + list(opt["m"].values()) + list(opt["v"].values())
            + [opt["step"]])


def _assert_bit_equal(a, b):
    for x, y in zip(a, b, strict=True):
        assert x.dtype == y.dtype
        assert torch.equal(x, y)


# ------------------------------------------------------------ the port alone
def test_checkpoint_roundtrip_and_retention(tmp_path):
    cfg, model, opt, _ = _port_run()
    tp = _pipe()
    ck = Checkpointer(str(tmp_path), keep=2, async_save=False)
    for s in (1, 2, 3):
        tp.next_batch()
        ck.save(s, model, opt, extra={"data": tp.state_dict()})
    assert ck.all_steps() == [2, 3]                  # retention
    _, model2, opt2, _ = _port_run(seed=5)
    step, _, _, extra = ck.restore(model2, opt2)
    assert step == 3 and extra["data"]["cursor"] == 3
    _assert_bit_equal(_state_tensors(model2, opt2),
                      _state_tensors(model, opt))
    tp2 = _pipe()
    tp2.load_state_dict(extra["data"])
    np.testing.assert_array_equal(tp2.next_batch()["tokens"],
                                  tp.next_batch()["tokens"])
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "empty")).restore(model2, opt2)


def test_checkpoint_atomic_no_partial(tmp_path):
    _, model, opt, _ = _port_run()
    ck = Checkpointer(str(tmp_path), async_save=True)
    ck.save(7, model, opt)
    ck.wait()
    names = os.listdir(tmp_path)
    assert "step_0000000007" in names
    assert not any(n.endswith(".tmp") for n in names)
    assert sorted(os.listdir(tmp_path / "step_0000000007")) == [
        "meta.json", "opt.npz", "params.npz"]


def test_async_saves_are_one_deep(tmp_path, monkeypatch):
    """A save returns while its writer runs; the next save waits for that
    writer before it starts its own; the payload was copied before the
    first returned (weights written after it do not reach the file)."""
    _, model, opt, _ = _port_run()
    ck = Checkpointer(str(tmp_path), async_save=True)
    release, started = threading.Event(), []
    write = ck._write

    def slow_write(step, payload, meta):
        started.append(step)
        assert release.wait(timeout=30)
        write(step, payload, meta)

    monkeypatch.setattr(ck, "_write", slow_write)
    first = model.embed.detach().clone()
    ck.save(1, model, opt)
    with torch.no_grad():
        model.embed.add_(1.0)                      # after save(1) returned
    second = threading.Thread(target=ck.save, args=(2, model, opt))
    second.start()
    second.join(timeout=0.5)
    assert second.is_alive() and started == [1]    # waits for the writer
    release.set()
    second.join(timeout=30)
    assert not second.is_alive()
    ck.wait()
    assert started == [1, 2] and ck.all_steps() == [1, 2]
    with np.load(tmp_path / "step_0000000001" / "params.npz") as z:
        np.testing.assert_array_equal(z["embed"], first.numpy())


def test_midrun_restore_resumes_bit_for_bit(tmp_path):
    """4 steps straight, against 2 steps, a save, a restore into a model of
    other weights and a new pipeline, and 2 more."""
    _, model, opt, step = _port_run()
    tp = _pipe()
    for _ in range(4):
        step(model, opt, _batch(tp))

    _, model_a, opt_a, step_a = _port_run()
    tp_a = _pipe()
    for _ in range(2):
        step_a(model_a, opt_a, _batch(tp_a))
    ck = Checkpointer(str(tmp_path), keep=1)
    ck.save(2, model_a, opt_a, extra={"data": tp_a.state_dict()})
    ck.wait()

    _, model_b, opt_b, step_b = _port_run(seed=9)
    ptrs = [t.data_ptr() for t in _state_tensors(model_b, opt_b)]
    s0, _, _, extra = ck.restore(model_b, opt_b)
    assert [t.data_ptr() for t in _state_tensors(model_b, opt_b)] == ptrs
    tp_b = _pipe()
    tp_b.load_state_dict(extra["data"])
    assert s0 == 2 and tp_b.cursor == 2
    for _ in range(2):
        step_b(model_b, opt_b, _batch(tp_b))
    _assert_bit_equal(_state_tensors(model_b, opt_b),
                      _state_tensors(model, opt))
    assert tp_b.state_dict() == tp.state_dict() == {"cursor": 4, "seed": 0}


def test_launcher_resume_equals_an_uninterrupted_run(tmp_path, capsys):
    """``python -m repro_torch.launch.train --smoke --device cpu`` for 20
    steps, then ``--resume`` to 30, against 30 steps at once: the losses
    of steps 21-30 and the last checkpoint equal."""
    common = ["--smoke", "--device", "cpu", "--ckpt-every", "10"]
    straight = launcher.main(common + ["--steps", "30", "--ckpt-dir",
                                       str(tmp_path / "a")])
    first = launcher.main(common + ["--steps", "20", "--ckpt-dir",
                                    str(tmp_path / "b")])
    second = launcher.main(common + ["--steps", "30", "--ckpt-dir",
                                     str(tmp_path / "b"), "--resume"])
    out = capsys.readouterr().out
    assert "resumed from step 20" in out
    assert len(straight) == 30 and len(first) == 20 and len(second) == 10
    assert first + second == straight
    assert straight[-1] < straight[0]
    last = "step_0000000030"
    for name in ("params.npz", "opt.npz"):
        with np.load(tmp_path / "a" / last / name) as a, \
                np.load(tmp_path / "b" / last / name) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert sorted(os.listdir(tmp_path / "b")) == [
        "step_0000000010", "step_0000000020", "step_0000000030"]


def test_launcher_cold_start_when_nothing_to_resume(tmp_path, capsys):
    launcher.main(["--smoke", "--device", "cpu", "--steps", "1",
                   "--ckpt-dir", str(tmp_path), "--resume"])
    assert "no checkpoint found; cold start" in capsys.readouterr().out


def test_launcher_keeps_the_references_state_dtype_rule():
    from repro_torch.configs import get_config

    small = launcher.opt_config(get_config("internlm2-1.8b"), smoke=False,
                                steps=50)
    big = launcher.opt_config(get_config("grok-1-314b"), smoke=False,
                              steps=500)
    assert (small.state_dtype, small.lr, small.total_steps) == (
        "float32", 3e-4, 100)
    assert (big.state_dtype, big.total_steps) == ("bfloat16", 500)
    assert launcher.opt_config(smoke_config("internlm2-1.8b"), smoke=True,
                               steps=5).lr == 3e-3


# ----------------------------------------------------------- across packages
def _jax_side():
    """JAX's smoke model in f32 after one step (bf16 moments), its step
    function, and the next batch."""
    jc = j_smoke(ARCH).scaled(dtype="float32")
    ocfg = jadamw.AdamWConfig(**OPT)
    params = j_init_params(jc, jax.random.key(0))
    opt = jadamw.adamw_init(params, ocfg)
    step = jax.jit(j_make_train_step(jc, ocfg, n_micro=2))
    tp = _pipe()
    params, opt, _ = step(params, opt, {k: jnp.asarray(v.numpy()) for k, v
                                        in _batch(tp).items()})
    return jc, params, opt, step, tp


def _f32_leaves(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path):
            np.asarray(leaf).astype(np.float32) for path, leaf in
            jax.tree_util.tree_leaves_with_path(tree)}


def _port_leaves(model, opt):
    out = {k: v for k, v in _f32_leaves(model.tree()).items()}
    for part in ("m", "v"):
        for k, v in _f32_leaves(T.tree_of(opt[part].items())).items():
            out[f"{part}/{k}"] = v
    out["step"] = np.asarray(int(opt["step"]), np.float32)
    return out


def _jax_leaves(params, opt):
    return {**_f32_leaves(params), **_f32_leaves(opt)}


def _hold_step(jc, jparams, jopt, jstep, model, opt, batch):
    """One step of each package from equal states: hold 3 of the lane."""
    jp, jo, jm = jstep(jparams, jopt, {k: jnp.asarray(v.numpy())
                                       for k, v in batch.items()})
    tstep = make_train_step(_cfg(), tadamw.AdamWConfig(**OPT), n_micro=2)
    _, _, tm = tstep(model, opt, batch)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), **TOL)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), **TOL)
    flat = {k: v.reshape(-1, *v.shape[2:]) for k, v in batch.items()}
    g = jax.grad(lambda p: j_loss_fn(p, jnp.asarray(flat["tokens"].numpy()),
                                     jnp.asarray(flat["labels"].numpy()), jc,
                                     remat=False))(jparams)
    grads, got = _f32_leaves(g), _f32_leaves(model.tree())
    left = total = 0
    for k, w in _f32_leaves(jp).items():
        a = np.abs(grads[k])
        keep = (a == 0) | (a > MASK * a.max())
        np.testing.assert_allclose(got[k][keep], w[keep], err_msg=k, **TOL)
        left, total = left + int((~keep).sum()), total + keep.size
    assert left <= LEFT_OUT * total
    assert int(opt["step"]) == int(jo["step"]) == 2


def test_a_jax_checkpoint_restores_into_the_port(tmp_path):
    jc, jparams, jopt, jstep, tp = _jax_side()
    JCheckpointer(str(tmp_path), async_save=False).save(
        1, jparams, jopt, extra={"data": tp.state_dict()})
    _, model, opt, _ = _port_run(seed=4)
    ptrs = [t.data_ptr() for t in _state_tensors(model, opt)]
    step, _, _, extra = Checkpointer(str(tmp_path)).restore(model, opt)
    assert step == 1 and extra == {"data": {"cursor": 1, "seed": 0}}
    assert [t.data_ptr() for t in _state_tensors(model, opt)] == ptrs
    assert opt["m"]["embed"].dtype == torch.bfloat16
    want, got = _jax_leaves(jparams, jopt), _port_leaves(model, opt)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    tp2 = _pipe()
    tp2.load_state_dict(extra["data"])
    _hold_step(jc, jparams, jopt, jstep, model, opt, _batch(tp2))


def test_a_port_checkpoint_restores_into_jax(tmp_path):
    jc, jparams, jopt, jstep, tp = _jax_side()
    _, model, opt, step = _port_run()
    step(model, opt, _batch(_pipe()))
    Checkpointer(str(tmp_path), async_save=False).save(
        1, model, opt, extra={"data": tp.state_dict()})
    s, rp, ro, extra = JCheckpointer(str(tmp_path)).restore(jparams, jopt)
    assert s == 1 and extra == {"data": {"cursor": 1, "seed": 0}}
    assert ro["m"]["embed"].dtype == jnp.bfloat16
    want, got = _port_leaves(model, opt), _jax_leaves(rp, ro)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    tp2 = _pipe()
    tp2.load_state_dict(extra["data"])
    _hold_step(jc, rp, ro, jstep, model, opt, _batch(tp2))
