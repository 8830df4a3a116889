"""``BENCHMARK.json`` against its files, its rules, and a cell, a
configuration and a metric added as files alone."""
from __future__ import annotations

import json
import re

import pytest

from portbench import deploy, harness, spec
from portbench.tests.helpers import (  # noqa: F401
    one_torch_thread,
    small_root,
    with_planned,
)

BENCH = spec.load()
CELLS = [w["name"] for w in BENCH["workloads"]]
# the cells of BENCHMARK.json and those whose files are kept for later
ALL = with_planned(BENCH)
E2E = {m["name"]: m for m in BENCH["end_to_end"]}
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|proj|"
                   r"head|expansion|experts_per_tok")


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("cell", [w["name"] for w in ALL["workloads"]])
def test_workload_names_config_and_traffic(cell):
    w = spec.workload(ALL, cell)
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["chips"] == 1
    cfg = spec.config(ALL, w["config"])
    assert cfg["name"] == w["config"]
    assert hasattr(spec.driver(spec.traffic(w["traffic"])["kind"]), "Driver")
    for m in cfg["models"]:
        if m["kind"] != deploy.EMPTY:
            assert callable(spec.model_kind(m["kind"]).fit)
    assert callable(spec.deployment(cfg["deployment"]["executor"]).build)
    assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    names = {m["name"] for m in spec.end_to_end(ALL, cell)}
    assert "setup_s" in names and len(names) >= 2
    assert spec.per_layer(ALL, cell)


def test_configs_files_and_reduced():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    assert len({c["source"] for c in BENCH["configs"]}) == len(files)
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("portbench/")
        cfg = spec.config(BENCH, c["name"])
        assert cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"] and len(c["source"]) <= 200
        for key in c["reduced"]:
            assert key in cfg and not WIDTH.search(key)


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_moves_layer_and_cells(metric):
    moved = E2E[metric["moves"]]
    for cell in metric["workloads"]:
        assert cell in CELLS
        assert cell in moved.get("workloads", CELLS)
    mod = spec.reader(metric["name"])
    assert (mod.LAYER, mod.UNIT, mod.MOVES) == (
        metric["layer"], metric["unit"], metric["moves"])
    assert metric["source"] in ("device_trace", "program_span",
                                "program_counter", "host_clock")


def test_names_and_units():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    groups = [metrics, BENCH["workloads"], BENCH["configs"]]
    for group in groups:
        names = [x["name"] for x in group]
        assert len(set(names)) == len(names)
        for n in names:
            assert spec.NAME.fullmatch(n), n
    for w in BENCH["workloads"]:
        assert spec.NAME.fullmatch(w["config"])
        assert spec.NAME.fullmatch(w["traffic"])
    for m in metrics:
        assert spec.UNIT.fullmatch(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for bad in ("a b", "x,y", "a/b", "-lead", "ü", "a" * 65):
        assert not spec.NAME.fullmatch(bad)


TINY_CONFIG = {
    "name": "tiny-iris",
    "source": "a throwaway configuration",
    "profile": {"max_features": 4, "feature_width": 8, "max_trees": 2,
                "max_layers": 8, "max_entries_per_layer": 32,
                "max_leaves": 16, "max_classes": 4, "max_hyperplanes": 3,
                "levels": 256, "max_versions": 2},
    "svm_frac_bits": 12, "train_scale": {},
    "models": [
        {"vid": 0, "kind": "rf", "mid": 1, "dataset": "iris",
         "params": {"n_estimators": 2, "max_depth": 4}},
        {"vid": 1, "kind": "svm", "mid": 2, "dataset": "iris",
         "params": {"multi_class": "ovr", "epochs": 50}}],
    "deployment": {"executor": "single_switch", "mode": "fused"},
    "assumed": [], "reduced": []}

READER = '''LAYER = "classify step"
UNIT = "calls"
MOVES = "packets_per_s"


def read(reading):
    sl = reading.slice
    return None if sl is None else sl.classifies
'''


def test_new_config_cell_and_metric_are_files_only(tmp_path):
    """A configuration, a traffic mix, a cell and a per-layer metric added
    as new files and entries: the harness runs the cell and reports the
    metric, with no file of the benchmark edited."""
    root = small_root(tmp_path)
    pb = root / "portbench"
    (pb / "configs" / "tiny-iris.json").write_text(json.dumps(TINY_CONFIG))
    (pb / "traffic" / "b16.json").write_text(json.dumps(
        {"kind": "closed_bulk", "batch": 16, "pool": 2}))
    (pb / "metrics" / "classifies.tiny.py").write_text(READER)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-iris", "source": "throwaway",
                             "file": "portbench/configs/tiny-iris.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny-b16", "config": "tiny-iris",
                               "traffic": "b16", "chips": 1, "why": "a test"})
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    e2e["packets_per_s"]["workloads"].append("tiny-b16")
    bench["per_layer"].append({
        "name": "classifies.tiny", "unit": "calls", "better": "higher",
        "source": "host_clock", "layer": "classify step",
        "moves": "packets_per_s", "workloads": ["tiny-b16"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    res, _ = harness.run_cell("tiny-b16", 2**31 + 99, 0.5, False,
                              device="cpu", root=root, log=lambda s: None)
    assert res["correct"] and res["failed"] == 0
    assert set(res["metrics"]) == {"packets_per_s", "setup_s"}
    res, _ = harness.run_cell("tiny-b16", 2**31 + 99, 0.5, True,
                              device="cpu", root=root, log=lambda s: None)
    assert res["correct"]
    assert res["metrics"]["classifies.tiny"]["value"] >= 1


KIND = """import time

import numpy as np

from portbench import drivers


class Driver:
    def __init__(self, dep, mix, seed):
        self.dep, self.mix = dep, mix
        rng = np.random.default_rng(seed)
        self.pool = [drivers.make_packets(dep, rng, mix["batch"], 0.0)]

    def warm(self):
        pass

    def window(self, seconds, tracer):
        p, n = self.pool[0], 0
        answers = []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            rslt = self.dep.zoo.classify(p.X, mid=p.mid, vid=p.vid)
            answers.append((0, rslt, None, None))
            n += 1
        return drivers.Outcome(
            t_start=t0, seconds=time.perf_counter() - t0, attempted=n,
            failed=0, packets=n * p.n, answers=answers)
"""

DEPLOYMENT = """def build(deployment, profile, programs, device):
    from repro_torch.serving import ZooServer

    zoo = ZooServer(profile, device=device)
    for v, prog in sorted(programs.items(), reverse=True):
        zoo.install(prog, vid=v)
    return zoo
"""

MODEL = """from portbench import trainers
from portbench.deploy import port_tree


def fit(params, X, y, seed):
    return trainers.DecisionTree(max_depth=params["depth"]).fit(X, y)


def port(model):
    return port_tree(model)


def translate_kw(config):
    return {}
"""


def test_new_traffic_kind_deployment_and_model_kind_are_files_only(tmp_path):
    """A traffic kind, a deployment builder and a model kind added as new
    files under a checkout's benchmark, with a configuration, a mix and a
    cell that use them: the harness finds each by its name and the run is
    correct, with no file of the benchmark edited."""
    root = small_root(tmp_path)
    pb = root / "portbench"
    (pb / "traffic" / "one_batch.py").write_text(KIND)
    (pb / "deployments" / "reversed_install.py").write_text(DEPLOYMENT)
    (pb / "models" / "stump.py").write_text(MODEL)
    cfg = json.loads(json.dumps(TINY_CONFIG))
    cfg["name"] = "tiny-stump"
    cfg["models"] = [{"vid": 0, "kind": "stump", "mid": 0,
                      "dataset": "iris", "params": {"depth": 2}},
                     {"vid": 1, "kind": "empty", "mid": 0}]
    cfg["deployment"] = {"executor": "reversed_install", "mode": "fused"}
    (pb / "configs" / "tiny-stump.json").write_text(json.dumps(cfg))
    (pb / "traffic" / "one32.json").write_text(json.dumps(
        {"kind": "one_batch", "batch": 32}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-stump", "source": "throwaway",
                             "file": "portbench/configs/tiny-stump.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny-one32", "config": "tiny-stump",
                               "traffic": "one32", "chips": 1,
                               "why": "a test"})
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    e2e["packets_per_s"]["workloads"].append("tiny-one32")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    res, found = harness.run_cell("tiny-one32", 2**31 + 5, 0.2, False,
                                  device="cpu", root=root, log=lambda s: None)
    assert res["correct"], found
    assert found["packets_compared"]["value"] >= 32
    assert res["metrics"]["packets_per_s"]["value"] > 0
    with pytest.raises(KeyError):
        spec.driver("no_such_kind", root)
