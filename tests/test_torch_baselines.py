"""The port's copy of the paper's comparison systems against the JAX
package's: SwitchTree, LEO, DINC and ACORN's own footprint.

Every model of ``tests/test_baselines.py`` is trained twice on the same
numpy data, once by each package's ``DecisionTree`` / ``RandomForest``
(the port's copies train the same trees, ``tests/test_torch_translator.py``),
and each system's ``BaselineReport`` from the port must equal the JAX
package's field for field; ``MAX_FEATURES`` (paper Table 3) is equal too.
"""
import dataclasses
import functools

import numpy as np
import pytest

from repro.core import baselines as jb
from repro.core import mlmodels as jml
from repro.data import load_dataset
from repro_torch.core import baselines as tb
from repro_torch.core import mlmodels as tml

SYSTEMS = ["acorn_resources", "switchtree_resources", "leo_resources",
           "dinc_resources"]


@functools.lru_cache(maxsize=None)
def _nsl(n_feat):
    Xtr, ytr, _, _ = load_dataset("nsl-kdd", scale=0.03, max_train=4000)
    return jml.Quantizer(8).fit(Xtr).transform(Xtr)[:, :n_feat], ytr


@functools.lru_cache(maxsize=None)
def _models(kind, n_feat, leaves):
    """The same model trained by each package: (JAX's, the port's)."""
    Xq, y = _nsl(n_feat)
    if kind == "dt":
        kw = dict(max_depth=12, max_leaf_nodes=leaves, random_state=0)
        return (jml.DecisionTree(**kw).fit(Xq, y),
                tml.DecisionTree(**kw).fit(Xq, y))
    kw = dict(n_estimators=3, max_depth=8, max_leaf_nodes=leaves,
              random_state=0)
    return (jml.RandomForest(**kw).fit(Xq, y),
            tml.RandomForest(**kw).fit(Xq, y))


def _same(a, b):
    assert type(a).__name__ == type(b).__name__ == "BaselineReport"
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


# tests/test_baselines.py's models: a 46-feature tree of 200 leaves, one of
# 300 leaves, a 4-feature tree of 8 leaves, a 5-feature tree of 200 leaves;
# and a forest, which SwitchTree and LEO refuse
MODELS = [("dt", 46, 200), ("dt", 46, 300), ("dt", 4, 8), ("dt", 5, 200),
          ("rf", 46, 60)]


@pytest.mark.parametrize("system", SYSTEMS)
@pytest.mark.parametrize("model", MODELS, ids=lambda m: "%s-%df-%dl" % m)
def test_report_equals_jax(model, system):
    jm, tm = _models(*model)
    _same(getattr(tb, system)(tm), getattr(jb, system)(jm))


@pytest.mark.parametrize("kw", [dict(feature_width=10),
                                dict(entry_cap=1 << 20)], ids=str)
def test_dinc_options_equal_jax(kw):
    jm, tm = _models("dt", 46, 300)
    want = jb.dinc_resources(jm, **kw)
    _same(tb.dinc_resources(tm, **kw), want)


def test_leo_subtree_size_equals_jax():
    jm, tm = _models("dt", 46, 200)
    for size in (1, 3, 7):
        _same(tb.leo_resources(tm, subtree_size=size),
              jb.leo_resources(jm, subtree_size=size))


def test_dinc_shrink_to_fit_equals_jax():
    """Paper §7.3: DINC's table budget forces a smaller model; both
    packages stop at the same leaf count with the same report."""
    Xtr, ytr, _, _ = load_dataset("digits")
    Xq = jml.Quantizer(8).fit(Xtr).transform(Xtr)
    jm, jrep, jl = jb.dinc_shrink_to_fit(
        lambda L: jml.DecisionTree(max_depth=12, max_leaf_nodes=L),
        Xq, ytr, entry_cap=1 << 20)
    tm, trep, tl = tb.dinc_shrink_to_fit(
        lambda L: tml.DecisionTree(max_depth=12, max_leaf_nodes=L),
        Xq, ytr, entry_cap=1 << 20)
    assert tl == jl and trep.feasible
    _same(trep, jrep)
    np.testing.assert_array_equal(tm.predict(Xq), jm.predict(Xq))


def test_table3_feature_limits_equal_jax():
    assert tb.MAX_FEATURES == jb.MAX_FEATURES
    assert tb.MAX_FEATURES["acorn"]["dt"] == 46
    assert tb.MAX_FEATURES["dinc"]["rf"] == 20


def test_trees_of_refuses_an_svm():
    with pytest.raises(TypeError):
        tb.switchtree_resources(tml.LinearSVM())
