"""Model kind ``svm``: a linear SVM, one-vs-rest or one-vs-one, whose
products the switch sums in fixed point (Table 2 workload 5)."""
from portbench import trainers


def fit(params: dict, X, y, seed: int):
    return trainers.LinearSVM(random_state=seed, **params).fit(X, y)


def port(model):
    from repro_torch.core.mlmodels import LinearSVM

    out = LinearSVM(model.C, multi_class=model.multi_class,
                    levels=model.levels)
    out.W_, out.b_ = model.W_.copy(), model.b_.copy()
    out.pairs_ = list(model.pairs_)
    out.n_classes_, out.n_features_ = model.n_classes_, model.n_features_
    return out


def translate_kw(config: dict) -> dict:
    return {"frac_bits": config["svm_frac_bits"]}
