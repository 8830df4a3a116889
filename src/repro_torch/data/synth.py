"""Seeded synthetic stand-ins for the paper's datasets (Table 9).

The container is offline, so NSL-KDD / UNSW-IoT / CICIDS-17 / ... are
regenerated as gaussian-cluster classification problems with the *same
(n_train, n_test, n_features, n_classes)* and a per-dataset class-imbalance
profile.  System-level results (table entry counts, pipeline stages, planner
time, latency/overhead) depend only on these shapes and on model structure, so
they reproduce faithfully; absolute accuracies are proxies (EXPERIMENTS.md
flags this next to every accuracy table).

``make_classification`` is our own: informative dims get per-class means on a
seeded hypercube, redundant dims are random linear combinations of informative
ones, the rest is noise — close in spirit to sklearn's generator.

Copied from ``src/repro/data/synth.py`` of the JAX package; only the import
paths differ (the port imports nothing from ``repro``).
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["make_classification", "DATASETS", "DatasetSpec", "load_dataset"]


def make_classification(
    n_samples: int,
    n_features: int,
    n_classes: int,
    *,
    n_informative: int | None = None,
    n_redundant: int | None = None,
    class_sep: float = 1.6,
    imbalance: float = 0.0,
    label_noise: float = 0.02,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Gaussian-cluster classification data.

    ``imbalance`` in [0, 1): 0 = balanced; larger values skew class priors
    geometrically (class k gets prior ∝ (1-imbalance)^k) — used to mimic IDS
    datasets with rare attack classes (paper §7.3 "datasets with multiple
    small classes").
    """
    rng = np.random.default_rng(seed)
    if n_informative is None:
        n_informative = max(2, min(n_features, int(np.ceil(np.log2(max(n_classes, 2)) + 3))))
    n_informative = min(n_informative, n_features)
    if n_redundant is None:
        n_redundant = min(n_features - n_informative, n_informative)

    # Class priors.
    pri = (1.0 - imbalance) ** np.arange(n_classes)
    pri = pri / pri.sum()
    y = rng.choice(n_classes, size=n_samples, p=pri)

    # Per-class means: 2 clusters per class for non-linearly-separable structure.
    n_clusters = 2
    means = rng.uniform(-1, 1, size=(n_classes, n_clusters, n_informative))
    means *= class_sep / np.maximum(np.linalg.norm(means, axis=-1, keepdims=True), 1e-9) * np.sqrt(n_informative)
    cluster = rng.integers(0, n_clusters, size=n_samples)
    Xi = means[y, cluster] + rng.normal(size=(n_samples, n_informative))

    blocks = [Xi]
    if n_redundant > 0:
        A = rng.normal(size=(n_informative, n_redundant))
        blocks.append(Xi @ A + 0.1 * rng.normal(size=(n_samples, n_redundant)))
    n_noise = n_features - n_informative - n_redundant
    if n_noise > 0:
        blocks.append(rng.normal(size=(n_samples, n_noise)))
    X = np.concatenate(blocks, axis=1)
    # Column shuffle so informative dims aren't a prefix.
    X = X[:, rng.permutation(n_features)]
    # Label noise.
    flip = rng.random(n_samples) < label_noise
    y[flip] = rng.choice(n_classes, size=int(flip.sum()), p=pri)
    return X, y.astype(np.int64)


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    n_train: int
    n_test: int
    n_features: int
    n_classes: int
    imbalance: float = 0.0
    class_sep: float = 1.6
    seed: int = 0


# Paper Table 9 shapes, verbatim.
DATASETS: dict[str, DatasetSpec] = {
    s.name: s
    for s in [
        DatasetSpec("nsl-kdd", 125_948, 22_544, 119, 2, imbalance=0.15, seed=101),
        DatasetSpec("unsw-iot", 626_463, 143_141, 30, 25, imbalance=0.12, class_sep=1.9, seed=102),
        DatasetSpec("cicids-17", 102_996, 34_333, 78, 2, imbalance=0.3, seed=103),
        DatasetSpec("unsw-nb15", 175_341, 75_641, 166, 2, imbalance=0.2, seed=104),
        DatasetSpec("iscxvpn16", 2_357, 590, 23, 2, seed=105),
        DatasetSpec("vcaml", 10_011, 3_371, 14, 2, imbalance=0.4, seed=106),
        DatasetSpec("iris", 120, 30, 4, 3, class_sep=2.6, seed=107),
        DatasetSpec("digits", 1_437, 360, 64, 10, class_sep=2.0, seed=108),
        DatasetSpec("mnist", 20_000, 10_000, 784, 10, class_sep=2.0, seed=109),
        DatasetSpec("satdap", 3_539, 885, 36, 3, imbalance=0.2, seed=110),
    ]
}


def load_dataset(
    name: str,
    *,
    scale: float = 1.0,
    max_train: int | None = None,
    max_test: int | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Return (X_train, y_train, X_test, y_test) floats + int labels.

    ``scale`` shrinks sample counts (1 CPU core in this container); feature
    and class counts — which drive every system-level result — are never
    scaled.
    """
    spec = DATASETS[name.lower()]
    n_tr = int(spec.n_train * scale)
    n_te = int(spec.n_test * scale)
    if max_train is not None:
        n_tr = min(n_tr, max_train)
    if max_test is not None:
        n_te = min(n_te, max_test)
    n_tr = max(n_tr, 8 * spec.n_classes)
    n_te = max(n_te, 2 * spec.n_classes)
    X, y = make_classification(
        n_tr + n_te,
        spec.n_features,
        spec.n_classes,
        imbalance=spec.imbalance,
        class_sep=spec.class_sep,
        seed=spec.seed,
    )
    return X[:n_tr], y[:n_tr], X[n_tr:], y[n_tr:]
