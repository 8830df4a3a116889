"""The plain reference against the program's plain path on both
configurations, the control that must fail, and the work count by hand."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from portbench import checks, deploy, drivers, reference, spec, trainers
from portbench.calibrate import control_answers
from portbench.harness import expected
from portbench.tests.helpers import (  # noqa: F401
    fitted,
    one_torch_thread,
    with_planned,
)
from portbench.workcount import ENTRY_BYTES, LEAF_BYTES, RESULT_BYTES, count

# every configuration the benchmark keeps, in a cell or planned for one
BENCH = with_planned(spec.load())
CONFIGS = [c["name"] for c in BENCH["configs"]]


@pytest.fixture(scope="module")
def deployments(fitted):  # noqa: F811
    return {name: deploy.build(spec.config(BENCH, name), 2**32 + 5, "cpu")
            for name in CONFIGS}


def _pool(dep, seed, n=3, size=200):
    rng = np.random.default_rng(seed)
    return [drivers.make_packets(dep, rng, size, 0.1) for _ in range(n)]


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_equals_switch_engine_ref(deployments, name):
    """The reference's answer for every packet equals the program's own
    plain path (``SwitchEngine(mode="ref")`` on the zoo's program, and the
    deployment's executor, hop by hop on the path), and passthrough
    packets come back untouched."""
    from repro_torch.core.plane import SwitchEngine, build_exec_image

    dep = deployments[name]
    pool = _pool(dep, 17)
    want = expected(dep, pool)
    single = deployments["acorn-zoo4"].zoo
    engine = SwitchEngine(dep.profile, mode="ref", device="cpu")
    packed = dataclasses.replace(single.packed,
                                 image=build_exec_image(single.packed))
    answers = []
    for i, p in enumerate(pool):
        pb = p.request(dep.zoo)
        ref = engine.classify(packed, pb)
        assert np.array_equal(ref.rslt.numpy(), want[i])
        out = dep.zoo.runtime.run(pb)
        answers.append((i, out.rslt.numpy(), out.codes.numpy(),
                        out.svm_acc.numpy()))
    found = checks.compare(pool, want, answers, 0)
    assert checks.passed(found), found
    req = np.concatenate([p.ptype for p in pool]) == reference.REQUEST
    answered = np.concatenate(want)[req]
    assert (answered >= 0).mean() > 0.6      # the empty slot's share is -1
    assert len(set(answered.tolist())) > 3


@pytest.mark.parametrize("name", CONFIGS)
def test_control_at_seven_bits_fails(deployments, name):
    """The reference at the precision below the configuration's (7-bit
    features) in the program's place: ``correct`` comes out false."""
    dep = deployments[name]
    pool = _pool(dep, 23, n=4, size=512)
    want = expected(dep, pool)
    answers = [(i, w, p.codes, p.acc) for i, (p, w) in
               enumerate(zip(pool, want))]
    assert checks.passed(checks.compare(pool, want, answers, 0))
    ctl = control_answers(dep, pool, answers, dep.feature_width - 1)
    found = checks.compare(pool, want, ctl, 0)
    assert not checks.passed(found)
    assert found["wrong_rslt"]["value"] > 0


def test_svm_products_equal_the_translators(deployments):
    """The reference works the SVM's fixed-point products out again; they
    are the ones the program installs."""
    from repro_torch.core.translator import translate

    dep = deployments["acorn-zoo4"]
    svm = dep.models[2]
    prog = translate(spec.model_kind("svm").port(svm), vid=2,
                     frac_bits=dep.frac_bits)
    lut, bias = reference.svm_luts(svm, dep.frac_bits)
    for m in prog.svm_muls:
        assert np.array_equal(lut[m.hyperplane, m.feature], m.lut)
    assert np.array_equal(bias, prog.svm_bias)


def _hand_tree():
    """x0 <= 5 ? (x1 <= 2 ? A : B) : C, with labels 0, 1, 2."""
    tree = trainers.DecisionTree(max_depth=2)
    tree.tree_ = trainers.TreeArrays(
        feature=np.array([0, 1, -1, -1, -1], np.int32),
        threshold=np.array([5, 2, 0, 0, 0], np.int32),
        left=np.array([1, 3, -1, -1, -1], np.int32),
        right=np.array([2, 4, -1, -1, -1], np.int32),
        label=np.array([0, 0, 2, 0, 1], np.int32),
        depth=np.array([0, 1, 1, 2, 2], np.int32),
        path=np.array([0, 0, 1, 0, 2], np.uint64),
        n_node_samples=np.ones(5, np.int64), value=np.zeros((5, 3)))
    tree.n_classes_, tree.n_features_ = 3, 2
    return tree


def test_work_count_on_a_hand_built_tree():
    """Three requests and a passthrough packet through the tree above: the
    count by hand."""
    tree = _hand_tree()
    X = np.array([[1, 1], [1, 9], [9, 0], [0, 0]], np.int64)
    ptype = np.array([1, 1, 1, 0])
    mid, vid = np.zeros(4, np.int32), np.zeros(4, np.int32)
    w = count({0: tree}, ptype, mid, vid, X)
    # compares: 2 + 2 + 1; both internal nodes reached; leaves 3, 4 and 2
    assert w.ops == 5
    assert w.nbytes == (4 + 3 * (2 + 2 + RESULT_BYTES)
                        + 2 * ENTRY_BYTES + 3 * LEAF_BYTES)
    assert w.bound == "memory"
    got = reference.classify({0: tree}, ptype, mid, vid, X,
                             np.array([-1, -1, -1, 7]), frac_bits=12)
    assert got.tolist() == [0, 1, 2, 7]
