"""A configuration made real: the models fitted, the program's zoo built.

The models are the benchmark's inputs: ``portbench.trainers`` fits them
from the seed, and they are handed to the program as the program's own
model objects, which its translator accepts.  The reference and the work
count read the fitted models; the program reads only what it is handed.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from portbench import spec, trainers

__all__ = ["Deployment", "EMPTY", "fit_models", "port_tree", "build",
           "rows_for"]

# the kind of a slot that holds no model
EMPTY = "empty"


@dataclasses.dataclass
class Deployment:
    """A configuration's zoo, built for one seed."""

    zoo: object                 # the program's ZooServer
    models: dict                # vid -> fitted model (benchmark's), or None
    mids: dict                  # vid -> the MID its packets carry
    rows: dict                  # vid -> quantised rows its packets draw, or None
    profile: object             # the program's PlaneProfile
    frac_bits: int
    feature_width: int


def fit_models(config: dict, seed: int, root: Path = spec.ROOT):
    """The configuration's models fitted from ``seed`` by their kinds'
    modules (``portbench/models/<kind>.py``) with the benchmark's trainers,
    and the quantised test rows each slot's packets draw from.  A slot of
    kind ``empty`` holds no model."""
    width = config["profile"]["feature_width"]
    n_feat = config["profile"]["max_features"]
    data = {}
    models, mids, rows = {}, {}, {}
    for m in config["models"]:
        v = m["vid"]
        mids[v] = m["mid"]
        if m["kind"] == EMPTY:
            models[v], rows[v] = None, None
            continue
        name = m["dataset"]
        if name not in data:
            Xtr, ytr, Xte, _ = trainers.load_dataset(
                name, scale=config["train_scale"].get(name, 1.0))
            q = trainers.Quantizer(width).fit(Xtr)
            data[name] = (q.transform(Xtr)[:, :n_feat], ytr,
                          q.transform(Xte)[:, :n_feat])
        Xtr, ytr, Xte = data[name]
        kind = spec.model_kind(m["kind"], root)
        models[v], rows[v] = kind.fit(dict(m["params"]), Xtr, ytr, seed), Xte
    return models, mids, rows


def port_tree(tree):
    """The program's ``DecisionTree`` holding ``tree``'s fitted arrays."""
    from repro_torch.core.mlmodels import DecisionTree, TreeArrays

    out = DecisionTree(max_depth=tree.max_depth, levels=tree.levels)
    out.tree_ = TreeArrays(**{f.name: getattr(tree.tree_, f.name).copy()
                              for f in dataclasses.fields(TreeArrays)})
    out.n_classes_, out.n_features_ = tree.n_classes_, tree.n_features_
    return out


def build(config: dict, seed: int, device, root: Path = spec.ROOT) -> Deployment:
    """Fit the models, translate each as the program's own model object,
    and build the program's zoo on ``device`` with the deployment's builder
    (``portbench/deployments/<executor>.py``)."""
    from repro_torch.core.plane import PlaneProfile
    from repro_torch.core.translator import translate

    models, mids, rows = fit_models(config, seed, root)
    profile = PlaneProfile(**config["profile"])
    width = profile.feature_width
    kinds = {m["vid"]: m["kind"] for m in config["models"]}
    programs = {}
    for v, model in models.items():
        if model is None:
            continue
        kind = spec.model_kind(kinds[v], root)
        programs[v] = translate(kind.port(model), vid=v, feature_width=width,
                                **kind.translate_kw(config))
    dep = config["deployment"]
    zoo = spec.deployment(dep["executor"], root).build(dep, profile, programs,
                                                       device)
    return Deployment(zoo=zoo, models=models, mids=mids, rows=rows,
                      profile=profile, frac_bits=config["svm_frac_bits"],
                      feature_width=width)


def rows_for(dep: Deployment, rng, vid: np.ndarray) -> np.ndarray:
    """Feature rows for packets of slots ``vid``: test rows of each slot's
    dataset, uniform random levels for an empty slot."""
    n_feat = dep.profile.max_features
    X = np.zeros((vid.size, n_feat), np.int32)
    for v, Xs in dep.rows.items():
        sel = vid == v
        k = int(sel.sum())
        if Xs is None:
            X[sel] = rng.integers(0, 1 << dep.feature_width, (k, n_feat))
        else:
            X[sel] = Xs[rng.integers(0, Xs.shape[0], k)]
    return X
