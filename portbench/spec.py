"""Finds what a cell is made of by the names in ``BENCHMARK.json``.

A configuration is the JSON file its entry names; its deployment's
builder is ``portbench/deployments/<executor>.py`` and each of its models'
kind ``portbench/models/<kind>.py``.  A traffic mix is
``portbench/traffic/<traffic>.json``, whose ``kind`` names its driver,
``portbench/traffic/<kind>.py``.  A per-layer metric's reader is
``portbench/metrics/<metric>.py``.  Adding a configuration, a cell, a
traffic kind, a deployment, a model kind or a metric adds files and entries
and edits none.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

__all__ = ["ROOT", "NAME", "UNIT", "load", "workload", "config", "traffic",
           "end_to_end", "per_layer", "module", "reader", "driver",
           "deployment", "model_kind"]

ROOT = Path(__file__).resolve().parent.parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


def _name(name: str) -> str:
    if not NAME.fullmatch(name):
        raise ValueError(f"not a name: {name!r}")
    return name


def load(root: Path = ROOT) -> dict:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            with open(Path(root) / c["file"]) as f:
                return json.load(f)
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str, root: Path = ROOT) -> dict:
    with open(Path(root) / "portbench" / "traffic" / f"{_name(name)}.json") as f:
        return json.load(f)


def _for(metrics: list, cell: str) -> list:
    return [m for m in metrics if cell in m.get("workloads", [cell])]


def end_to_end(bench: dict, cell: str) -> list:
    """The end-to-end metrics ``cell`` reports."""
    return _for(bench["end_to_end"], cell)


def per_layer(bench: dict, cell: str) -> list:
    """The per-layer metrics ``cell`` reports in a traced run."""
    return _for(bench["per_layer"], cell)


def module(folder: str, name: str, root: Path = ROOT):
    """The module ``portbench/<folder>/<name>.py`` of the checkout at
    ``root``, loaded from its file."""
    path = Path(root) / "portbench" / folder / f"{_name(name)}.py"
    if not path.is_file():
        raise KeyError(f"no {folder} module {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{folder}_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str, root: Path = ROOT):
    """The module of the per-layer metric ``name``: its ``read(reading)``
    returns the metric's value, or None where it finds nothing to read."""
    return module("metrics", name, root)


def driver(kind: str, root: Path = ROOT):
    """The traffic driver ``kind``: its ``Driver(dep, mix, seed)`` makes
    the mix's requests at set-up, ``warm()``s and runs ``window(seconds,
    tracer)``."""
    return module("traffic", kind, root)


def deployment(executor: str, root: Path = ROOT):
    """The deployment builder ``executor``: its ``build(deployment,
    profile, programs, device)`` returns the program's ``ZooServer``."""
    return module("deployments", executor, root)


def model_kind(kind: str, root: Path = ROOT):
    """The model kind ``kind``: its ``fit(params, X, y, seed)`` fits the
    benchmark's model, ``port(model)`` hands it to the program as the
    program's own model object, and ``translate_kw(config)`` gives the
    translator's options."""
    return module("models", kind, root)
