"""The port's numpy copies against their sources in the JAX package.

``repro_torch.core.mlmodels``, ``core.translator`` and ``data.synth`` are
copies of the JAX package's modules with only their imports changed; these
tests hold them to the originals field for field: the same datasets, the
same trained models and the same ``TableProgram``s for DT, RF and SVM.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import mlmodels as jml
from repro.core import translator as jtr
from repro.data import synth as jsynth
from repro_torch.core import mlmodels as tml
from repro_torch.core import translator as ttr
from repro_torch.data import synth as tsynth


def assert_deep_equal(a, b, path="program"):
    """Field-for-field equality across the two packages' classes."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            assert_deep_equal(getattr(a, f.name), getattr(b, f.name),
                              f"{path}.{f.name}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_deep_equal(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


@pytest.mark.parametrize("name,scale", [("satdap", 0.1), ("digits", 0.2),
                                        ("cicids-17", 0.005), ("iris", 1.0)])
def test_synth_datasets_identical(name, scale):
    for a, b in zip(jsynth.load_dataset(name, scale=scale),
                    tsynth.load_dataset(name, scale=scale)):
        np.testing.assert_array_equal(a, b)
    assert dataclasses.asdict(tsynth.DATASETS[name]) == \
        dataclasses.asdict(jsynth.DATASETS[name])


@pytest.fixture(scope="module")
def quantized():
    Xtr, ytr, Xte, _ = jsynth.load_dataset("satdap", scale=0.1)
    jq = jml.Quantizer(8).fit(Xtr)
    tq = tml.Quantizer(8).fit(Xtr)
    np.testing.assert_array_equal(jq.transform(Xte), tq.transform(Xte))
    return jq.transform(Xtr), ytr, jq.transform(Xte)


@pytest.mark.parametrize("kind,kw", [
    ("DecisionTree", dict(max_depth=8, max_leaf_nodes=60)),
    ("RandomForest", dict(n_estimators=4, max_depth=6, max_leaf_nodes=30,
                          random_state=3)),
    ("LinearSVM", dict(epochs=20, random_state=5)),
    ("LinearSVM", dict(epochs=20, multi_class="ovr", random_state=5)),
])
def test_models_and_programs_identical(quantized, kind, kw):
    Xtr, ytr, Xte = quantized
    jm = getattr(jml, kind)(**kw).fit(Xtr, ytr)
    tm = getattr(tml, kind)(**kw).fit(Xtr, ytr)
    np.testing.assert_array_equal(jm.predict(Xte), tm.predict(Xte))
    jp, tp = jtr.translate(jm, vid=2), ttr.translate(tm, vid=2)
    assert_deep_equal(jp, tp)
    assert [dataclasses.astuple(s) for s in jp.stages()] == \
        [dataclasses.astuple(s) for s in tp.stages()]
    assert jp.total_tcam_entries() == tp.total_tcam_entries()


def test_metrics_identical(quantized):
    rng = np.random.default_rng(3)
    y, p = rng.integers(0, 4, 200), rng.integers(0, 4, 200)
    for fn in ("accuracy", "macro_f1", "cohen_kappa"):
        assert getattr(jml, fn)(y, p) == getattr(tml, fn)(y, p)
    np.testing.assert_array_equal(jml.confusion_matrix(y, p, 4),
                                  tml.confusion_matrix(y, p, 4))
