"""Model kind ``dt``: one CART decision tree (Table 2 workloads 1, 4)."""
from portbench import trainers
from portbench.deploy import port_tree


def fit(params: dict, X, y, seed: int):
    return trainers.DecisionTree(**params).fit(X, y)


def port(model):
    return port_tree(model)


def translate_kw(config: dict) -> dict:
    return {}
