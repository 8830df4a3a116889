"""Model kind ``rf``: a bagged random forest voted by tree weights (Table 2
workloads 2, 3)."""
from portbench import trainers
from portbench.deploy import port_tree


def fit(params: dict, X, y, seed: int):
    return trainers.RandomForest(random_state=seed, **params).fit(X, y)


def port(model):
    from repro_torch.core.mlmodels import RandomForest

    out = RandomForest(n_estimators=len(model.trees_),
                       max_depth=model.max_depth, levels=model.levels,
                       tree_weights=model.tree_weights)
    out.trees_ = [port_tree(t) for t in model.trees_]
    out.n_classes_, out.n_features_ = model.n_classes_, model.n_features_
    return out


def translate_kw(config: dict) -> dict:
    return {}
