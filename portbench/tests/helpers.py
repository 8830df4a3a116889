"""Shared pieces of the benchmark's CPU tests: a copy of the benchmark's
data at test sizes, and fitted models kept across the runs of a session."""
from __future__ import annotations

import functools
import json
import shutil
from pathlib import Path

import pytest

from portbench import deploy, spec

DATA = ("configs", "deployments", "models", "traffic", "metrics")
# the traffic mixes at sizes the CPU's plain kernels get through in seconds
SMALL = {"b4096": {"batch": 64, "pool": 2}, "b64": {"pool": 4},
         "open": {"rate_rps": 30.0, "pool": 32,
                  "front": {"n_slots": 2, "max_batch": 256,
                            "max_wait_us": 500.0}}}


# cells whose files the benchmark keeps for a later PR, and which the tests
# run beside those of BENCHMARK.json: the zoo over a path of switches, and
# the smallest batch
PLANNED_CONFIGS = [{
    "name": "acorn-zoo4-fattree4", "source": "a planned configuration",
    "file": "portbench/configs/acorn-zoo4-fattree4.json",
    "reduced": ["train_scale"], "why": "the zoo over 5 hops of a fat tree"}]
PLANNED_CELLS = [
    {"name": "fattree4-b4096", "config": "acorn-zoo4-fattree4",
     "traffic": "b4096", "chips": 1, "why": "the path executor"},
    {"name": "zoo4-b64", "config": "acorn-zoo4", "traffic": "b64",
     "chips": 1, "why": "the per-call cost"}]


def with_planned(bench: dict) -> dict:
    """``bench`` with the planned configurations and cells added, each cell
    reporting ``packets_per_s`` and the bulk cells' per-layer metrics."""
    bench = json.loads(json.dumps(bench))
    names = {c["name"] for c in bench["configs"]}
    bench["configs"] += [c for c in PLANNED_CONFIGS if c["name"] not in names]
    cells = {w["name"] for w in bench["workloads"]}
    for w in PLANNED_CELLS:
        if w["name"] in cells:
            continue
        bench["workloads"].append(dict(w))
        for m in bench["end_to_end"] + bench["per_layer"]:
            if (m["name"] == "packets_per_s" or m["name"].endswith(".bulk")) \
                    and "workloads" in m:
                m["workloads"].append(w["name"])
    return bench


def small_root(tmp_path: Path) -> Path:
    """A checkout's benchmark data in ``tmp_path``, traffic cut to test
    sizes, the planned cells added: the same files the harness reads,
    found by the same names."""
    root = tmp_path / "root"
    (root / "portbench").mkdir(parents=True)
    (root / "BENCHMARK.json").write_text(json.dumps(with_planned(spec.load())))
    for d in DATA:
        shutil.copytree(spec.ROOT / "portbench" / d, root / "portbench" / d)
    for name, change in SMALL.items():
        p = root / "portbench" / "traffic" / f"{name}.json"
        p.write_text(json.dumps(dict(json.loads(p.read_text()), **change)))
    return root


@pytest.fixture(scope="session")
def fitted():
    """``deploy.fit_models`` memoised for the session: the zoo's models are
    fitted once, however many runs build them."""
    cache = {}
    real = deploy.fit_models

    @functools.wraps(real)
    def fit(config, seed, root=spec.ROOT):
        key = (json.dumps([config[k] for k in (
            "models", "train_scale", "profile")],
            sort_keys=True), seed)
        if key not in cache:
            cache[key] = real(config, seed, root)
        return cache[key]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(deploy, "fit_models", fit)
        yield fit


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread, as the benchmark runs: the suite's workers
    share the machine's cores."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
