"""The port's planner-placed multi-switch path against the JAX package's.

``repro_torch.core.topology`` and ``core.planner`` are copies of the JAX
package's modules; their plans for DT, RF and SVM programs on a fat tree
must equal the originals (path, assignment, objective) with both solvers.
The hop programs ``build_zoo_device_programs`` makes, run in path order by
the port's ``SequentialPathExecutor`` behind a ``DataplaneRuntime``, must
equal the JAX ``SequentialPathExecutor`` on rslt, codes and svm_acc, in the
fused mode (the kernel's plain version on the CPU) and in the layerwise
mode, and equal the single switch; hops before the one holding dt_predict
leave rslt at -1.  Integer outputs: the tolerance is exact.
"""
import dataclasses

import numpy as np
import pytest
import torch

import test_conformance as conf
from repro.core import distributed_plane as jdp
from repro.core import mlmodels as jml
from repro.core import planner as jpl
from repro.core import topology as jtopo
from repro.core import translator as jtr
from repro.core.packets import PacketBatch as JaxBatch
from repro.core.plane import PlaneProfile as JaxProfile
from repro.core.plane import SwitchEngine as JaxEngine
from repro.runtime.executors import SequentialPathExecutor as JaxSequential
from repro_torch.core import distributed_plane as tdp
from repro_torch.core import mlmodels as tml
from repro_torch.core import planner as tpl
from repro_torch.core import topology as ttopo
from repro_torch.core import translator as ttr
from repro_torch.core.packets import PacketBatch, PacketType
from repro_torch.core import plane as tp
from repro_torch.core.plane import (
    SwitchEngine,
    install_program,
    program_tensors,
)
from repro_torch.runtime import DataplaneRuntime, SequentialPathExecutor
from test_torch_plane import (
    assert_batches_equal,
    port_batch,
    port_packed,
    port_profile,
)

JPROF = JaxProfile(max_features=36, max_trees=4, max_layers=8,
                   max_entries_per_layer=64, max_leaves=64, max_classes=8,
                   max_hyperplanes=8, max_versions=4)
PROF = port_profile(JPROF)
MODELS = {
    "dt": ("DecisionTree", dict(max_depth=6, max_leaf_nodes=40)),
    "rf": ("RandomForest", dict(n_estimators=4, max_depth=5,
                                max_leaf_nodes=30, random_state=1)),
    "svm": ("LinearSVM", dict(epochs=30, multi_class="ovr", random_state=2)),
}
VIDS = {"rf": 0, "dt": 1, "svm": 2}
# stage slots per switch: small enough that every plan spans several
# switches of the 5-switch path, large enough to be feasible
N_STAGES = {"dt": 4, "rf": 4, "svm": 6}
ZOO_STAGES = 9


@pytest.fixture(scope="module")
def programs(satdap):
    """The same DT, RF and SVM trained and translated by each package."""
    Xtr, ytr, Xte, _ = satdap
    out = {}
    for kind, (cls, kw) in MODELS.items():
        jm = getattr(jml, cls)(**kw).fit(Xtr, ytr)
        tm = getattr(tml, cls)(**kw).fit(Xtr, ytr)
        out[kind] = (jtr.translate(jm, vid=VIDS[kind]),
                     ttr.translate(tm, vid=VIDS[kind]), tm)
    return Xte, out


def _plan_fields(plan):
    return plan.path, plan.assignment, plan.objective, plan.breakdown


@pytest.mark.parametrize("kind", sorted(MODELS))
@pytest.mark.parametrize("solver", ["dp", "milp"])
def test_plan_program_equals_jax(programs, kind, solver):
    _X, progs = programs
    jp, tp_, _m = progs[kind]
    kw = dict(solver=solver)
    jnet, tnet = jtopo.fat_tree(4), ttopo.fat_tree(4)
    h = jnet.hosts()
    assert h == tnet.hosts()
    n = N_STAGES[kind]
    want = jpl.plan_program(jp, jnet, h[0], h[-1],
                            default_device=jpl.DeviceModel(n_stages=n), **kw)
    got = tpl.plan_program(tp_, tnet, h[0], h[-1],
                           default_device=tpl.DeviceModel(n_stages=n), **kw)
    assert _plan_fields(got) == _plan_fields(want)
    assert len(got.device_stages()) >= 2


@pytest.mark.parametrize("solver", ["dp", "milp"])
def test_plan_zoo_equals_jax(programs, solver):
    _X, progs = programs
    order = sorted(progs, key=VIDS.get)
    jnet, tnet = jtopo.fat_tree(4), ttopo.fat_tree(4)
    h = jnet.hosts()
    want = jpl.plan_zoo([progs[k][0] for k in order], jnet, h[0], h[-1],
                        default_device=jpl.DeviceModel(n_stages=ZOO_STAGES),
                        solver=solver)
    got = tpl.plan_zoo([progs[k][1] for k in order], tnet, h[0], h[-1],
                       default_device=tpl.DeviceModel(n_stages=ZOO_STAGES),
                       solver=solver)
    assert [_plan_fields(p) for p in got] == [_plan_fields(p) for p in want]
    # a failed switch: both replan around it to the same deployment
    dead = {got[0].path[2]}
    got = tpl.replan_zoo([progs[k][1] for k in order], tnet, h[0], h[-1],
                         dead, default_device=tpl.DeviceModel(
                             n_stages=ZOO_STAGES), solver=solver)
    want = jpl.replan_zoo([progs[k][0] for k in order], jnet, h[0], h[-1],
                          dead, default_device=jpl.DeviceModel(
                              n_stages=ZOO_STAGES), solver=solver)
    assert [_plan_fields(p) for p in got] == [_plan_fields(p) for p in want]
    assert not dead & set(got[0].path)


@pytest.mark.parametrize("name,args", [("fat_tree", (4,)),
                                       ("dcell", (4, 1)), ("bcube", (4, 1)),
                                       ("jellyfish", (12, 3))])
def test_topology_copy_equals_jax(name, args):
    jn, tn = getattr(jtopo, name)(*args), getattr(ttopo, name)(*args)
    assert jn.kind == tn.kind and jn.programmable == tn.programmable
    h = jn.hosts()
    assert jn.k_shortest_paths(h[0], h[-1], 4) == \
        tn.k_shortest_paths(h[0], h[-1], 4)
    dead = {jn.k_shortest_paths(h[0], h[-1], 1)[0][1]}
    assert jn.without(dead).k_shortest_paths(h[0], h[-1], 3) == \
        tn.without(dead).k_shortest_paths(h[0], h[-1], 3)


@pytest.fixture(scope="module")
def zoo_path(programs):
    """plan_zoo over fat_tree(4) with 9-stage switches; hop programs built
    by each package."""
    Xte, progs = programs
    order = sorted(progs, key=VIDS.get)
    jnet, tnet = jtopo.fat_tree(4), ttopo.fat_tree(4)
    h = jnet.hosts()
    dev = ZOO_STAGES
    jplans = jpl.plan_zoo([progs[k][0] for k in order], jnet, h[0], h[-1],
                          default_device=jpl.DeviceModel(n_stages=dev))
    tplans = tpl.plan_zoo([progs[k][1] for k in order], tnet, h[0], h[-1],
                          default_device=tpl.DeviceModel(n_stages=dev))
    jdevs, jdps = jdp.build_zoo_device_programs(
        [progs[k][0] for k in order], jplans, JPROF)
    tdevs, tdps = tdp.build_zoo_device_programs(
        [progs[k][1] for k in order], tplans, PROF, "cpu")
    assert jdevs == tdevs and len(tdevs) >= 3
    return Xte, progs, jdps, tdps


def _traffic(Xte, progs, B, seed):
    """Requests over the three versions, 10% FORWARD passthrough packets
    carrying intermediates, and a few out-of-range vids."""
    rng = np.random.default_rng(seed)
    kinds = sorted(progs)
    pick = rng.integers(0, len(kinds), B)
    X = Xte[rng.integers(0, Xte.shape[0], B)]
    mid = np.asarray([progs[kinds[i]][1].mid for i in pick], np.int32)
    vid = np.asarray([VIDS[kinds[i]] for i in pick], np.int32)
    vid[rng.random(B) < 0.05] = 7
    pb = PacketBatch.make_request(
        X, mid=mid, vid=vid, max_features=PROF.max_features,
        n_trees=PROF.max_trees, n_hyperplanes=PROF.max_hyperplanes)
    fwd = torch.from_numpy(rng.random(B) < 0.1)
    return dataclasses.replace(
        pb,
        ptype=torch.where(fwd, PacketType.FORWARD, PacketType.REQUEST)
        .to(torch.int32),
        codes=torch.where(fwd[:, None], torch.from_numpy(rng.integers(
            1, 2**20, pb.codes.shape).astype(np.int32)), pb.codes),
        rslt=torch.where(fwd, 3, pb.rslt).to(torch.int32))


def _jax_batch(pb):
    import jax.numpy as jnp
    from repro_torch.core.packets import batch_to_arrays
    return JaxBatch(**{k: jnp.asarray(v)
                       for k, v in batch_to_arrays(pb).items()})


def test_hop_programs_equal_jax(zoo_path):
    _X, _progs, jdps, tdps = zoo_path
    for j, t in zip(jdps, tdps):
        want = port_packed(j, JPROF)
        for f in dataclasses.fields(t):
            if f.name != "image":
                assert torch.equal(getattr(t, f.name), getattr(want, f.name))
        for x, y in zip(t.image.fused, want.image.fused):
            assert torch.equal(x, y)


@pytest.mark.parametrize("mode,jmode", [
    (None, "ref"), ("cuda", "ref"), ("unfused-cuda", "unfused-ref"),
    ("layerwise", "layerwise-ref"), ("layerwise-cuda", "layerwise-ref")])
def test_sequential_path_equals_jax_and_single_switch(zoo_path, mode, jmode):
    Xte, progs, jdps, tdps = zoo_path
    jax_seq = JaxSequential(jdps, n_classes=JPROF.max_classes, mode=jmode,
                            jit=False)
    rt = DataplaneRuntime(SequentialPathExecutor(
        tdps, n_classes=PROF.max_classes, mode=mode))
    eng = SwitchEngine(PROF, device="cpu", mode="ref")
    single = eng.empty()
    for k in sorted(progs):
        single = eng.install(single, progs[k][1])
    for B in (1, 33, 300):
        pb = _traffic(Xte, progs, B, seed=B)
        want = jax_seq.classify(_jax_batch(pb))
        got = rt.run(pb)
        assert_batches_equal(got, want, what=f"B={B} mode={mode}")
        assert torch.equal(rt.run_host(pb).rslt, got.rslt)
        assert torch.equal(got.rslt, eng.classify(single, pb).rslt)
    req = [_traffic(Xte, progs, n, seed=n) for n in (3, 17, 64)]
    for r, out in zip(req, rt.run_coalesced(req)):
        assert torch.equal(out.rslt, rt.run(r).rslt)


def test_models_agree_through_the_path(zoo_path):
    Xte, progs, _jdps, tdps = zoo_path
    rt = DataplaneRuntime(SequentialPathExecutor(
        tdps, n_classes=PROF.max_classes))
    for kind in ("dt", "rf"):
        prog, model = progs[kind][1], progs[kind][2]
        pb = PacketBatch.make_request(
            Xte, mid=prog.mid, vid=prog.vid, max_features=PROF.max_features,
            n_trees=PROF.max_trees, n_hyperplanes=PROF.max_hyperplanes)
        assert (rt.run(pb).rslt.numpy() == model.predict(Xte)).all()


def test_hops_before_dt_predict_leave_rslt_unset(programs):
    """Until the switch holding dt_predict is reached, rslt stays -1: the
    packet carries only intermediates (paper App. A;
    tests/test_distributed_plane.py:44)."""
    Xte, progs = programs
    prog = progs["rf"][1]
    net = ttopo.fat_tree(4)
    h = net.hosts()
    plan = tpl.plan_program(prog, net, h[0], h[-1],
                            default_device=tpl.DeviceModel(
                                n_stages=N_STAGES["rf"]))
    devs, dps = tdp.build_device_programs(prog, plan, PROF, "cpu")
    assert len(devs) >= 3
    pb = PacketBatch.make_request(
        Xte[:32], mid=prog.mid, vid=prog.vid, max_features=PROF.max_features,
        n_trees=PROF.max_trees, n_hyperplanes=PROF.max_hyperplanes)
    for mode in (None, "layerwise-cuda"):
        head = SequentialPathExecutor(dps[:-1], n_classes=PROF.max_classes,
                                      mode=mode)
        out = head.classify(pb)
        assert (out.rslt == -1).all()
        assert not torch.equal(out.codes, pb.codes)   # intermediates ride
        full = SequentialPathExecutor(dps, n_classes=PROF.max_classes,
                                      mode=mode).classify(pb)
        assert (full.rslt.numpy() == progs["rf"][2].predict(Xte[:32])).all()


def test_sequential_executor_guards(zoo_path):
    _X, _progs, _jdps, tdps = zoo_path
    with pytest.raises(ValueError, match="at least one"):
        SequentialPathExecutor([], n_classes=8)
    ex = SequentialPathExecutor(tdps, n_classes=8)
    assert ex.granularity == 1 and ex.mode == "ref"
    with pytest.raises(ValueError, match="replan"):
        ex.swap(tdps[:-1])
    ptrs = [x.data_ptr() for p in ex.programs for x in program_tensors(p)]
    ex.swap(list(reversed(tdps)))
    # swap writes the executor's resident programs in place
    for got, want in zip(ex.programs, reversed(tdps)):
        assert all(torch.equal(x, y) for x, y in
                   zip(program_tensors(got), program_tensors(want)))
    assert ptrs == [x.data_ptr() for p in ex.programs
                    for x in program_tensors(p)]
    with pytest.raises(ValueError, match="unknown classify mode"):
        SequentialPathExecutor(tdps, n_classes=8, mode="interpret")


def _port_programs(V, case):
    """``conf._draw_zoo``'s programs rerun with the port's models and
    translator: the same rng stream, so the same programs."""
    with pytest.MonkeyPatch.context() as mp:
        for name in ("DecisionTree", "RandomForest", "LinearSVM"):
            mp.setattr(conf, name, getattr(tml, name))
        mp.setattr(conf, "translate", ttr.translate)
        mp.setattr(conf, "empty_program",
                   lambda prof: tp.empty_program(prof, "cpu"))
        mp.setattr(conf, "install_program", tp.install_program)
        rng = np.random.default_rng(conf._seed(V, case))
        progs, _packed = conf._draw_zoo(rng, V, conf._seed(V, case),
                                        port_profile(conf._profile(V)))
    return progs


def _port_split(progs, prof, n_dev):
    """``conf._split_stages`` with the port's install, on the CPU."""
    eng = SwitchEngine(prof, device="cpu")
    dps = []
    for d in range(n_dev):
        packed = eng.empty()
        for prog in progs:
            chunks = np.array_split(np.arange(len(prog.stages())), n_dev)
            stages = set(chunks[d].tolist())
            if stages:
                packed = install_program(packed, prog, prof, stages=stages,
                                         vid=prog.vid)
        dps.append(packed)
    return dps


@pytest.mark.parametrize("V", sorted(conf.N_CASES))
def test_conformance_draws_sequential_path(V):
    """Every eighth conformance draw, split over three hops in stage order
    by each package: the port's sequential path (fused and layerwise)
    equals the JAX one and the JAX single-switch oracle."""
    jprof = conf._profile(V)
    prof = port_profile(jprof)
    oracle = JaxEngine(jprof, mode="ref")
    for case in range(0, conf.N_CASES[V], 8):
        _seed, jprogs, jpacked, jpb = conf._draw_case(V, case, jprof)
        jdps = conf._split_stages(jprogs, jprof, conf.N_SEQ_DEV)
        want = JaxSequential(jdps, n_classes=jprof.max_classes, mode="ref",
                             jit=False).classify(jpb)
        single = oracle.classify(jpacked, jpb)
        tdps = _port_split(_port_programs(V, case), prof, conf.N_SEQ_DEV)
        for j, t in zip(jdps, tdps):
            for x, y in zip(t.image.fused, port_packed(j, jprof).image.fused):
                assert torch.equal(x, y)
        pb = port_batch(jpb)
        for mode in ("cuda", "layerwise-cuda", "layerwise"):
            got = SequentialPathExecutor(tdps, n_classes=prof.max_classes,
                                         mode=mode).classify(pb)
            what = f"V={V} case={case} mode={mode}"
            assert_batches_equal(got, want, what=what)
            assert_batches_equal(got, single, fields=("rslt",), what=what)
