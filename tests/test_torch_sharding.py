"""The port's sharding specs and mesh (``repro_torch.distributed.sharding``,
``repro_torch.launch.mesh``) held to the JAX package's on the CPU, and the
specs taken by ``make_train_step(grad_specs=...)`` and
``Checkpointer.restore(shardings=...)``.

``param_specs`` and ``opt_specs`` equal the JAX package's leaf for leaf
(JAX's ``PartitionSpec`` turned into a tuple) for all 10 archs on both
production meshes; ``state_specs`` at ``tests/test_sharding.py``'s shapes
(B 128 x 32768, and B 1 x 16); ``batch_spec`` and ``dp_axes``; the stacked
leaves the specs are written for equal ``init_params_shape``'s in shape
and dtype.  The JAX side gets the duck-typed mesh ``tests/test_sharding.py``
uses; nothing touches a device.  On one card a spec tree is the identity;
a spec that does not divide its leaf raises ``ValueError`` naming the leaf,
a mesh of more than one card ``NotImplementedError``.
"""
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import configs as jconfigs
from repro.distributed import sharding as js
from repro.launch import mesh as jmesh
from repro.models.transformer import init_params_shape as j_init_params_shape
from repro_torch import configs as tconfigs
from repro_torch.data import TokenPipeline
from repro_torch.distributed import sharding as ts
from repro_torch.launch import mesh as tmesh
from repro_torch.models import transformer as T
from repro_torch.optim import adamw as tadamw
from repro_torch.train import Checkpointer, make_train_step
from torch_train_lane import one_torch_thread  # noqa: F401 (autouse)

ARCHS = jconfigs.ARCH_IDS
CPU = torch.device("cpu")
MESHES = {"1pod": False, "2pod": True}
STATE_SHAPES = [(128, 32768), (1, 16)]   # tests/test_sharding.py's


def _jax_mesh(multi_pod):
    """``tests/test_sharding.py``'s duck-typed mesh."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return types.SimpleNamespace(axis_names=axes, devices=np.empty(shape))


def _jax_flat(tree) -> dict:
    """{key path: the spec as a tuple} of a JAX spec tree."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {tuple(str(getattr(k, "key", k)) for k in path): tuple(spec)
            for path, spec in leaves}


def _flat(tree) -> dict:
    return dict(ts.tree_leaves(tree))


# ----------------------------------------------------------------- mesh
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_production_mesh_keeps_the_references_axes(mesh):
    mp = MESHES[mesh]
    m = tmesh.make_production_mesh(multi_pod=mp)
    j = _jax_mesh(mp)
    assert m.axis_names == j.axis_names
    assert m.devices.shape == j.devices.shape
    assert tmesh.mesh_chip_count(m) == jmesh.mesh_chip_count(j) == (
        512 if mp else 256)
    # every card once, model innermost: a 16-way model axis spans two
    # 8-card hosts
    assert sorted(m.devices.ravel()) == list(range(m.devices.size))
    assert m.devices[(0,) * (m.devices.ndim - 1)].tolist() == list(range(16))
    assert m.shape == dict(zip(j.axis_names, j.devices.shape))
    assert not torch.cuda.is_initialized()


def test_make_mesh_refuses_axes_of_another_length():
    with pytest.raises(ValueError):
        tmesh.make_mesh((2, 2), ("data",))


# ---------------------------------------------------- specs against JAX
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_opt_specs_equal_jax(arch, mesh):
    mp = MESHES[mesh]
    want = js.param_specs(jconfigs.get_config(arch), _jax_mesh(mp))
    got = ts.param_specs(tconfigs.get_config(arch),
                         tmesh.make_production_mesh(multi_pod=mp))
    assert _flat(got) == _jax_flat(want)
    assert _flat(ts.opt_specs(got)) == _jax_flat(js.opt_specs(want))
    assert any(s for s in _flat(got).values())   # something shards


@pytest.mark.parametrize("arch", ARCHS)
def test_stacked_leaves_equal_init_params_shape(arch):
    """The leaves the specs are written for: the port's per-layer
    parameters stacked as the reference's tree, shape and dtype."""
    want = {path: (tuple(sd.shape), str(sd.dtype)) for path, sd in
            _jax_items(j_init_params_shape(jconfigs.get_config(arch)))}
    got = {path: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
           for path, t in ts.tree_leaves(ts.stacked_shapes(
               T.init_params_shape(tconfigs.get_config(arch))
               .named_parameters()))}
    assert got == want
    assert all(t.device.type == "meta" for _, t in ts.tree_leaves(
        ts.stacked_shapes(T.init_params_shape(
            tconfigs.get_config(arch)).named_parameters())))


def _jax_items(tree):
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return [(tuple(str(getattr(k, "key", k)) for k in path), leaf)
            for path, leaf in leaves]


@pytest.mark.parametrize("batch,cache_len", STATE_SHAPES,
                         ids=["B128x32768", "B1x16"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_state_specs_equal_jax(arch, mesh, batch, cache_len):
    """Every state key of the five families, RWKV's ``S`` among them (the
    reference tests ``"S" in str(DictKey)``), the KV rule then the S rule,
    split-KV where the heads do not divide."""
    mp = MESHES[mesh]
    want = js.state_specs(jconfigs.get_config(arch), _jax_mesh(mp), mp,
                          batch=batch, cache_len=cache_len)
    got = ts.state_specs(tconfigs.get_config(arch),
                         tmesh.make_production_mesh(multi_pod=mp), mp,
                         batch=batch, cache_len=cache_len)
    assert _flat(got) == _jax_flat(want)
    m = tmesh.make_production_mesh(multi_pod=mp)
    ts.check_specs(T.init_decode_state(tconfigs.get_config(arch), batch,
                                       cache_len, device="meta"), got, m)


@pytest.mark.parametrize("split_kv", [False, True])
def test_state_specs_split_kv_equal_jax(split_kv):
    """granite-20b's one KV head: the cache's sequence axis over model, or
    nothing."""
    want = js.state_specs(jconfigs.get_config("granite-20b"),
                          _jax_mesh(False), False, batch=128,
                          cache_len=32768, split_kv=split_kv)
    got = ts.state_specs(tconfigs.get_config("granite-20b"),
                         tmesh.make_production_mesh(), False, batch=128,
                         cache_len=32768, split_kv=split_kv)
    assert _flat(got) == _jax_flat(want)


@pytest.mark.parametrize("n_micro", [False, True])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_batch_spec_and_dp_axes_equal_jax(mesh, n_micro):
    mp = MESHES[mesh]
    assert ts.dp_axes(mp) == js.dp_axes(mp)
    assert ts.batch_spec(mp, n_micro=n_micro) == tuple(
        js.batch_spec(mp, n_micro=n_micro))


# ------------------------------------------------------ specs on a mesh
def test_shard_shape_divides_by_the_named_axes():
    m = tmesh.make_production_mesh(multi_pod=True)
    assert ts.shard_shape((64, 64, 48), (("pod", "data"), "model"), m) == (
        2, 4, 48)
    assert ts.shard_shape((5,), (), m) == (5,)


@pytest.mark.parametrize("spec,match", [
    (("model", None), "splits an axis of 50 3 ways"),
    (("pod", None), "not an axis of the mesh"),
    (("data", "data"), "names an axis twice"),
    ((None, None, None), "does not fit"),
])
def test_check_specs_names_the_leaf(spec, match):
    m = tmesh.make_mesh((2, 3), ("data", "model"))
    tree = {"layers": {"wq": torch.empty(50, 8, device="meta")}}
    with pytest.raises(ValueError, match=f"leaf layers/wq.*{match}"):
        ts.check_specs(tree, {"layers": {"wq": spec}}, m)


def test_check_specs_wants_a_spec_for_every_leaf():
    with pytest.raises(ValueError, match="leaf embed: no spec"):
        ts.check_specs({"embed": torch.empty(4, 4, device="meta")}, {},
                       ts.one_card_mesh())


# ------------------------------------- grad_specs and restore(shardings=)
ARCH = "internlm2-1.8b"
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=40)


def _run(seed=0, **kw):
    cfg = tconfigs.smoke_config(ARCH).scaled(dtype="float32")
    model = T.init_params(cfg, torch.Generator().manual_seed(seed),
                          device=CPU)
    ocfg = tadamw.AdamWConfig(**OPT)
    return (cfg, model, tadamw.adamw_init(model, ocfg),
            make_train_step(cfg, ocfg, n_micro=2, **kw))


def _batch(cfg):
    pipe = TokenPipeline(vocab_size=cfg.vocab, seq_len=8, global_batch=4)
    b = pipe.next_batch()
    return {k: torch.from_numpy(b[k]).reshape(2, 2, -1)
            for k in ("tokens", "labels")}


def test_grad_specs_on_one_card_are_the_identity():
    cfg, model, opt, step = _run()
    _, model2, opt2, step2 = _run(
        grad_specs=ts.param_specs(cfg, ts.one_card_mesh()))
    batch = _batch(cfg)
    _, _, m1 = step(model, opt, batch)
    _, _, m2 = step2(model2, opt2, batch)
    assert torch.equal(m1["loss"], m2["loss"])
    for (n, a), (_, b) in zip(model.named_parameters(),
                              model2.named_parameters()):
        assert torch.equal(a, b), n


def test_grad_specs_refuse_a_multi_card_mesh():
    cfg = tconfigs.smoke_config(ARCH).scaled(dtype="float32")
    mesh = tmesh.make_production_mesh()
    _, model, opt, step = _run(grad_specs=ts.param_specs(cfg, mesh),
                               mesh=mesh)
    with pytest.raises(NotImplementedError, match="Queue 1 item 12"):
        step(model, opt, _batch(cfg))


def test_grad_specs_refuse_a_spec_that_does_not_divide():
    cfg = tconfigs.smoke_config(ARCH).scaled(dtype="float32")
    mesh = tmesh.make_mesh((1, 7), ("data", "model"))
    specs = ts.param_specs(cfg, mesh)
    specs["layers"]["wo"] = (None, None, "model")
    _, model, opt, step = _run(grad_specs=specs, mesh=mesh)
    assert cfg.d_model % 7
    with pytest.raises(ValueError, match="grad_specs leaf layers/wo"):
        step(model, opt, _batch(cfg))


def test_restore_with_shardings(tmp_path):
    """One card: the restore with the specs equals the one without, in
    place; a multi-card mesh and a spec that does not divide are refused
    before anything is read."""
    cfg, model, opt, step = _run()
    step(model, opt, _batch(cfg))
    ck = Checkpointer(str(tmp_path), async_save=False)
    ck.save(1, model, opt)
    one = ts.one_card_mesh()
    pspecs = ts.param_specs(cfg, one)
    _, other, oopt, _ = _run(seed=5)
    ptrs = [p.data_ptr() for p in other.parameters()]
    ck.restore(other, oopt, shardings=(pspecs, ts.opt_specs(pspecs)))
    assert [p.data_ptr() for p in other.parameters()] == ptrs
    for (n, a), (_, b) in zip(model.named_parameters(),
                              other.named_parameters()):
        assert torch.equal(a, b), n
    assert torch.equal(oopt["step"], opt["step"])

    mesh = tmesh.make_production_mesh()
    big = ts.param_specs(cfg, mesh)
    with pytest.raises(NotImplementedError, match="Queue 1 item 12"):
        ck.restore(other, oopt, shardings=(big, ts.opt_specs(big)),
                   mesh=mesh)
    bad = ts.param_specs(cfg, one)
    bad["embed"] = ("data", "pod")
    with pytest.raises(ValueError, match="params leaf embed"):
        ck.restore(other, oopt, shardings=(bad, ts.opt_specs(pspecs)))
    bad_opt = ts.opt_specs(pspecs)
    bad_opt["step"] = ("data",)
    with pytest.raises(ValueError, match="opt_state leaf step"):
        ck.restore(other, oopt, shardings=(pspecs, bad_opt))
