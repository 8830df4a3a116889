"""The port's ``ShardedExecutor`` and ``PipelinedExecutor`` against the JAX
package's, on the CPU: the executors themselves.

The same numpy inputs (zoos installed by the JAX package and carried over
with ``port_packed``, traffic with FORWARD/RESPONSE passthrough and mixed
versions) go through both packages; rslt, codes and svm_acc must be
bit-identical (integer outputs: the tolerance is exact):

* the four-executor parity of ``tests/test_runtime.py``, the JAX
  executors built in process on one device as its harness builds them;
* one cache entry per (bucket, ``n_micro``) across alternating microbatch
  counts;
* the guards, with the reference's messages;
* an autoscaled ``ContinuousZooServer`` over a lane pool of
  ``ShardedExecutor``s at 1, 2 and 4 ports.

The lane layouts, ``run``'s packet order, swaps and the conformance draws
are ``test_torch_executors_lanes.py``.  On the CPU the graph cache runs
its classify eagerly on its static buffers and the lanes run in order; the
lane streams and the capture are the card's (``tests/test_torch_gpu.py``,
``chip_smoke.py`` phase 13).
"""
import asyncio

import numpy as np
import pytest

from repro.core import mlmodels as jml
from repro.core.plane import empty_program as jax_empty
from repro.core.plane import install_program as jax_install
from repro.core.translator import translate as jax_translate
from repro.runtime import DataplaneRuntime as JaxRuntime
from repro.runtime import PipelinedExecutor as JaxPipelined
from repro.runtime import SequentialPathExecutor as JaxSequential
from repro.runtime import ShardedExecutor as JaxSharded
from repro.runtime import SingleSwitchExecutor as JaxSingle
from repro.serving import ZooServer as JaxZooServer
from repro_torch.runtime import (
    DataplaneRuntime,
    PipelinedExecutor,
    SequentialPathExecutor,
    ShardedExecutor,
    SingleSwitchExecutor,
    SizeOrDeadlinePolicy,
    SloAutoscaler,
    bucket_ladder,
)
from repro_torch.serving import ContinuousZooServer, ZooServer
from test_runtime import _mixed_traffic, _profile, _split_stages
from test_torch_plane import (
    assert_batches_equal,
    port_batch,
    port_packed,
    port_profile,
)

CPU4 = ["cpu"] * 4


def _port(dps, jprof):
    return [port_packed(p, jprof) for p in dps]


# ------------------------------------------------ four-executor parity
@pytest.fixture(scope="module", params=[1, 4], ids=["V1", "V4"])
def zoo(request, satdap):
    """``tests/test_runtime.py``'s zoo fixture: the JAX programs, full
    install and mixed traffic, and each JAX executor's answer to it."""
    V = request.param
    Xtr, ytr, Xte, _ = satdap
    jprof = _profile(V)
    trees = [jml.DecisionTree(max_depth=3 + v % 3, max_leaf_nodes=8 + 8 * v)
             .fit(Xtr, ytr) for v in range(V)]
    svms = [jml.LinearSVM(epochs=30 + 20 * v).fit(Xtr, ytr)
            for v in range(max(1, min(V, 2)))]
    progs = ([jax_translate(m, vid=v) for v, m in enumerate(trees)]
             + [jax_translate(m, vid=v) for v, m in enumerate(svms)])
    packed = jax_empty(jprof)
    for prog in progs:
        packed = jax_install(packed, prog, jprof, vid=prog.vid)
    pb, passthru = _mixed_traffic(Xte[:96], V, jprof.max_trees,
                                  jprof.max_hyperplanes, progs[0].mid)
    split3 = _split_stages(progs, jprof, 3)
    n = jprof.max_classes
    jax_outs = {name: JaxRuntime(ex).run(pb) for name, ex in {
        "single": JaxSingle(jprof, packed=packed, mode="ref"),
        "sequential": JaxSequential(split3, n_classes=n),
        "pipelined": JaxPipelined([packed], n_classes=n, n_micro=4),
        "sharded": JaxSharded([packed], n_classes=n, n_ports=1, n_micro=2),
    }.items()}
    # the single switch in mode ref is the oracle
    return jprof, packed, split3, pb, passthru, jax_outs, jax_outs["single"]


@pytest.mark.parametrize("name", ["single", "sequential", "pipelined",
                                  "sharded"])
def test_four_executor_parity_with_jax(zoo, name):
    """Each port executor equals the same JAX executor and the JAX oracle;
    the passthrough cohort keeps its rslt."""
    jprof, packed, split3, pb, passthru, jax_outs, want = zoo
    prof, full, n = port_profile(jprof), port_packed(packed, jprof), \
        jprof.max_classes
    ex = {
        "single": lambda: SingleSwitchExecutor(prof, packed=full,
                                               device="cpu"),
        "sequential": lambda: SequentialPathExecutor(_port(split3, jprof),
                                                     n_classes=n),
        "pipelined": lambda: PipelinedExecutor([full], n_classes=n,
                                               n_micro=4),
        "sharded": lambda: ShardedExecutor([full], n_classes=n, n_ports=1,
                                           n_micro=2),
    }[name]()
    out = DataplaneRuntime(ex).run(port_batch(pb))
    assert_batches_equal(out, jax_outs[name], what=f"{name} vs JAX {name}")
    assert_batches_equal(out, want, what=f"{name} vs JAX ref")
    np.testing.assert_array_equal(out.rslt.numpy()[passthru],
                                  np.asarray(pb.rslt)[passthru])


def test_one_cache_entry_per_n_micro(satdap):
    """``tests/test_runtime.py::test_pipelined_memoizes_per_n_micro`` on the
    port: alternating microbatch counts reuse each entry."""
    Xtr, ytr, Xte, _ = satdap
    jprof = _profile(1)
    dt = jml.DecisionTree(max_depth=4, max_leaf_nodes=16).fit(Xtr, ytr)
    packed = jax_install(jax_empty(jprof), jax_translate(dt), jprof)
    ex = PipelinedExecutor([port_packed(packed, jprof)],
                           n_classes=jprof.max_classes)
    zoo = ZooServer(port_profile(jprof), executor=ex)
    X = Xte[:32]
    pb = zoo.make_request(X, mid=0)
    want = dt.predict(X)
    for n_micro in (2, 4, 2, 4, 2):
        out = ex.run(pb.map(lambda x: x.reshape(
            (n_micro, X.shape[0] // n_micro) + tuple(x.shape[1:]))))
        np.testing.assert_array_equal(out.rslt.numpy(), want)
    assert sorted(ex._caches) == [2, 4]
    assert ex.cache_size() == 2, \
        "revisiting an n_micro must reuse its entry, not add one"
    assert ex.granularity == 1 and ex.n_micro == 1


def test_guards():
    """The reference's refusals, with its messages."""
    jprof = _profile(1)
    dps = _port([jax_empty(jprof)] * 2, jprof)
    ex = ShardedExecutor(dps, n_classes=8, n_ports=2, n_micro=2,
                         devices=CPU4)
    zoo = ZooServer(port_profile(jprof), executor=ex)
    pb = zoo.make_request(np.zeros((8, jprof.max_features), np.int32))
    assert ex.granularity == 4
    with pytest.raises(ValueError, match="not a multiple of granularity 4"):
        ex.classify(pb.map(lambda x: x[:6]))
    with pytest.raises(ValueError, match="not divisible by 2 port lanes"):
        ex.run(pb.map(lambda x: x[:6].reshape((2, 3) + tuple(x.shape[1:]))))
    with pytest.raises(ValueError, match="device count changed"):
        ex.swap(dps[:1])
    with pytest.raises(ValueError, match=r"need 4 devices \(2 switches x 2 "
                       r"ports\), have 3"):
        ShardedExecutor(dps, n_classes=8, n_ports=2, devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="on the CPU and on a card"):
        PipelinedExecutor(dps, n_classes=8, devices=["cpu", "cuda:0"])
    for kw in (dict(n_ports=0), dict(n_micro=0)):
        with pytest.raises(ValueError):
            ShardedExecutor(dps, n_classes=8, **kw)
    with pytest.raises(ValueError, match="at least one device program"):
        PipelinedExecutor([], n_classes=8)
    assert ex.cache_size() == 0          # no refusal reached the cache


def test_autoscaled_lane_pool_of_sharded_executors(satdap):
    """``ContinuousZooServer`` over a lane pool of ``ShardedExecutor``s at
    1, 2 and 4 ports under an impossible SLO widens to 4 lanes, pre-warming
    each incoming ladder at its granularity; every answer before, across
    and after the scale events equals the JAX zoo's."""
    Xtr, ytr, Xte, _ = satdap
    jprof = _profile(1)
    jzoo = JaxZooServer(jprof)
    jzoo.install(jml.DecisionTree(max_depth=4, max_leaf_nodes=16)
                 .fit(Xtr, ytr), vid=0)
    full = port_packed(jzoo.packed, jprof)
    pool = {k: ShardedExecutor([full], n_classes=8, n_ports=k, n_micro=1,
                               devices=["cpu"] * k) for k in (1, 2, 4)}
    zoo = ZooServer(port_profile(jprof), executor=pool[1])
    scaler = SloAutoscaler(slo_p99_ms=1e-6, lanes=(1, 2, 4), window=4,
                           patience=1, cooldown=0)

    async def main():
        async with ContinuousZooServer(
                zoo, policy=SizeOrDeadlinePolicy(max_batch=8,
                                                 max_wait_us=200.0),
                n_slots=2, lane_pool=pool, autoscaler=scaler) as srv:
            outs = [await srv.submit(Xte[i:i + 3], mid=0, vid=0)
                    for i in range(20)]
            return outs, srv.lanes, srv.latency_stats()

    outs, lanes, stats = asyncio.run(
        asyncio.wait_for(main(), timeout=60), debug=True)
    assert lanes == 4 and stats["engine"]["scale_ups"] == 2
    for i, out in enumerate(outs):
        np.testing.assert_array_equal(
            out.rslt, jzoo.classify(Xte[i:i + 3], mid=0, vid=0))
    for k, ex in pool.items():
        assert ex.cache_size() == len(bucket_ladder(8, k))
