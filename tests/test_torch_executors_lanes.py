"""The port's ``ShardedExecutor`` and ``PipelinedExecutor`` against the JAX
package's, on the CPU: the lane layouts and the conformance draws.

rslt, codes and svm_acc must be bit-identical (integer outputs: the
tolerance is exact) on

* the multi-lane layouts of ``tests/test_runtime.py``'s multi-device story
  (pipe 4x1, shard 2x2, shard 1x4) on repeated ``"cpu"`` lanes, against the
  JAX ``SwitchEngine(mode="ref")`` on the full program and the JAX
  ``SequentialPathExecutor`` on the same split, with ragged re-admission;
* ``run`` on pre-split microbatches, in the input's packet order;
* a ``swap`` to a second zoo and back (no resident ``data_ptr`` moves);
* every eighth conformance draw of each zoo width V through the port's
  ``PipelinedExecutor(n_micro=2)`` and ``ShardedExecutor(n_ports=1,
  n_micro=2)``, reprogrammed by ``swap``, as ``tests/test_conformance.py``
  runs the JAX package's two (the draws mix versions, invalid VIDs and
  FORWARD/RESPONSE passthrough).

The executors' parity, cache and guards are ``test_torch_executors.py``.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import test_conformance as conf
from repro.core import mlmodels as jml
from repro.core.packets import PacketBatch as JaxBatch
from repro.core.plane import SwitchEngine as JaxEngine
from repro.core.plane import empty_program as jax_empty
from repro.core.plane import install_program as jax_install
from repro.core.translator import translate as jax_translate
from repro.runtime import SequentialPathExecutor as JaxSequential
from repro.runtime import ShardedExecutor as JaxSharded
from repro_torch.core.packets import PacketType
from repro_torch.core.plane import program_tensors
from repro_torch.runtime import (
    DataplaneRuntime,
    PipelinedExecutor,
    ShardedExecutor,
)
from test_runtime import _profile, _split_stages
from test_torch_plane import (
    assert_batches_equal,
    port_batch,
    port_packed,
    port_profile,
)

CPU4 = ["cpu"] * 4


def _port(dps, jprof):
    return [port_packed(p, jprof) for p in dps]


def _rows(pb, n):
    """The first ``n`` packets of a JAX batch (numpy fields)."""
    return jax.tree.map(lambda x: np.asarray(x)[:n], pb)


# ------------------------------------------------- multi-lane layouts
@pytest.fixture(scope="module")
def story(satdap):
    """``tests/test_runtime.py``'s multi-device story at the parity zoo's
    profile (V 4, 6 layers): an RF at vid 0 and a DT at vid 1, 192 packets
    with a FORWARD fifth."""
    Xtr, ytr, Xte, _ = satdap
    jprof = _profile(4)
    rf = jml.RandomForest(n_estimators=4, max_depth=5, max_leaf_nodes=30,
                          random_state=0).fit(Xtr, ytr)
    d1 = jml.DecisionTree(max_depth=5, max_leaf_nodes=40).fit(Xtr, ytr)
    progs = [jax_translate(rf, vid=0), jax_translate(d1, vid=1)]
    full = jax_empty(jprof)
    for prog in progs:
        full = jax_install(full, prog, jprof, vid=prog.vid)
    B = 192
    X = np.tile(Xte, (B // Xte.shape[0] + 1, 1))[:B]
    rng = np.random.default_rng(5)
    vids = rng.integers(0, 2, B)
    mids = np.where(vids == 0, progs[0].mid, progs[1].mid)
    pb = JaxBatch.make_request(X, mid=mids, vid=vids, max_features=36,
                               n_trees=4, n_hyperplanes=8, max_versions=4)
    ptype = np.where(rng.random(B) < 0.2, PacketType.FORWARD,
                     PacketType.REQUEST).astype(np.int32)
    pb = dataclasses.replace(pb, ptype=ptype)
    oracle = JaxEngine(jprof, mode="ref")
    want = {B: oracle.classify(full, _rows(pb, B)) for B in SIZES}
    path = {n: JaxSequential(_split_stages(progs, jprof, n),
                             n_classes=8).classify(pb) for n in (4, 2)}
    return jprof, progs, full, pb, want, path


SIZES = (192, 100, 7)   # the story's batch, its ragged re-admission, a few
LAYOUTS = {   # name: (switches, n_ports, n_micro), as the reference's story
    "pipe4x1": (4, 1, 4),
    "shard2x2": (2, 2, 2),
    "shard1x4": (1, 4, 1),
}


@pytest.mark.parametrize("mode", ["cuda", "layerwise"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_lane_layouts_equal_jax(story, layout, mode):
    """Each layout on four repeated CPU lanes, at B 192 and re-admitted at
    B 100 and 7: == JAX ``mode="ref"`` on the full program, and at B 192
    == the JAX sequential path over the same split (the full program is
    1x4's)."""
    jprof, progs, full, pb, want, path = story
    n_switch, n_ports, n_micro = LAYOUTS[layout]
    dps = [full] if n_switch == 1 else _split_stages(progs, jprof, n_switch)
    ex = ShardedExecutor(_port(dps, jprof), n_classes=8, mode=mode,
                         n_ports=n_ports, n_micro=n_micro, devices=CPU4)
    assert ex.lanes == ((torch.device("cpu"),) * n_ports,) * n_switch
    rt = DataplaneRuntime(ex)
    for B in SIZES:
        out = rt.run(port_batch(_rows(pb, B)))
        assert out.batch == B
        assert_batches_equal(out, want[B], what=f"{layout} B={B} vs ref")
        if B == pb.batch:
            assert_batches_equal(out, path.get(n_switch, want[B]),
                                 what=f"{layout} vs the JAX path")
    assert rt.cache_size() == len({rt.bucket(B) for B in SIZES})


def test_run_keeps_the_packet_order_of_the_microbatches(story):
    """``run`` on ``[n_micro, B_mb]`` microbatches of mixed traffic (two
    versions, passthrough): for every (n_micro, n_ports) the flat answer
    equals the JAX ``ShardedExecutor.run`` on four microbatches, packet
    for packet; microbatch views are staged field by field."""
    jprof, progs, full, pb, _, _ = story

    def split(x, n_micro):
        return x.reshape((n_micro, -1) + tuple(x.shape[1:]))
    want = JaxSharded([full], n_classes=8, n_ports=1, n_micro=4).run(
        jax.tree.map(lambda x: split(np.asarray(x), 4), pb))
    dps = _port(_split_stages(progs, jprof, 2), jprof)
    for n_micro, n_ports in ((4, 1), (4, 2), (2, 4), (8, 2)):
        ex = ShardedExecutor(dps, n_classes=8, n_ports=n_ports,
                             n_micro=n_micro, devices=["cpu"] * (2 * n_ports))
        out = ex.run(port_batch(pb).map(lambda x: split(x, n_micro)))
        assert out.batch == pb.batch
        assert_batches_equal(out, want, what=f"n_micro={n_micro} "
                             f"n_ports={n_ports}")
        assert_batches_equal(out, pb, fields=("packet_id", "vid", "ptype"))


def test_swap_writes_every_lane_in_place(story, satdap):
    """A swap to a second zoo shows in the next run on every lane, adds no
    cache entry and moves no resident ``data_ptr``; swapping back restores
    the first answers."""
    jprof, progs, full, pb, want, _ = story
    Xtr, ytr, _, _ = satdap
    rf2 = jml.RandomForest(n_estimators=4, max_depth=5, max_leaf_nodes=30,
                           random_state=9).fit(Xtr, ytr)
    progs2 = [jax_translate(rf2, vid=0), progs[1]]
    full2 = jax_empty(jprof)
    for prog in progs2:
        full2 = jax_install(full2, prog, jprof, vid=prog.vid)
    ex = ShardedExecutor(_port(_split_stages(progs, jprof, 2), jprof),
                         n_classes=8, n_ports=2, n_micro=2, devices=CPU4)
    rt = DataplaneRuntime(ex)
    ptrs = [[t.data_ptr() for t in program_tensors(p)] for p in ex.programs]
    assert len(ex.programs) == 2        # one copy a switch on one device
    tpb = port_batch(pb)
    want2 = JaxEngine(jprof, mode="ref").classify(full2, pb)
    assert_batches_equal(rt.run(tpb), want[pb.batch])
    for zoo_progs, zoo_want in ((progs2, want2), (progs, want[pb.batch])):
        rt.swap(_port(_split_stages(zoo_progs, jprof, 2), jprof))
        assert_batches_equal(rt.run(tpb), zoo_want, what="after swap")
    assert rt.cache_size() == 1
    assert [[t.data_ptr() for t in program_tensors(p)]
            for p in ex.programs] == ptrs


# ------------------------------------------------- conformance draws
@pytest.mark.parametrize("V", sorted(conf.N_CASES))
def test_every_eighth_conformance_draw(V):
    """Draws 0, 8, 16, ... of V through the two executors.  The oracle classifies each draw padded
    with FORWARD packets to the largest ragged size (one trace per V:
    padding is invisible, the reference's admission invariant) and is
    trimmed back."""
    jprof = conf._profile(V)
    prof = port_profile(jprof)
    empty = port_packed(jax_empty(jprof), jprof)
    runtimes = {
        "pipelined": DataplaneRuntime(PipelinedExecutor(
            [empty], n_classes=prof.max_classes, n_micro=2)),
        "sharded": DataplaneRuntime(ShardedExecutor(
            [empty], n_classes=prof.max_classes, n_ports=1, n_micro=2)),
    }
    oracle = JaxEngine(jprof, mode="ref")
    top = max(conf.SIZES)
    for case in range(0, conf.N_CASES[V], 8):
        _, _, packed, pb = conf._draw_case(V, case, jprof)
        padded = jax.tree.map(lambda x: np.concatenate(
            [np.asarray(x), np.zeros((top - pb.batch,) + np.shape(x)[1:],
                                     np.asarray(x).dtype)]), pb)
        want = _rows(oracle.classify(packed, padded), pb.batch)
        for name, rt in runtimes.items():
            rt.swap([port_packed(packed, jprof)])
            assert_batches_equal(rt.run(port_batch(pb)), want,
                                 what=f"V={V} case={case} {name}")
