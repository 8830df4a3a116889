"""The per-layer metrics that read the program's spans and dispatch
records: each reader on a hand-made slice or ``latency_stats()`` dict
against the hand count, None where its input is absent (as on a program
without the spans), and a traced run on the CPU reporting every one of
them in its cell."""
from __future__ import annotations

import pytest

from portbench import harness, spec
from portbench.devtrace import Slice
from portbench.tests.helpers import fitted, one_torch_thread, small_root  # noqa: F401

BENCH = spec.load()
BULK = ["request_us.bulk", "admit_us.bulk", "executor_us.bulk",
        "copy_out_us.bulk", "classify_self_us.bulk"]
OPEN = ["slot_wait_ms.open", "to_thread_ms.open", "on_thread_ms.open",
        "lock_wait_ms.open", "to_loop_ms.open", "pad_share.open"]
ME, OTHER = 1, 2


def _slice(host, classifies=2) -> Slice:
    return Slice(lo=0.0, hi=1000.0, device=[("k", "kernel", 0.0, 1.0)],
                 host=host, runtime_calls={}, thread=ME,
                 classifies=classifies)


# two classifies on the benchmark's thread (us): the spans nest as the
# program's do; another thread's span and torch's ops count for nothing
HOST = [("portbench.classify", 0, 100, ME), ("acorn.classify", 0, 100, ME),
        ("acorn.request", 5, 15, ME), ("aten::arange", 6, 8, ME),
        ("acorn.admit", 20, 30, ME), ("acorn.executor", 30, 70, ME),
        ("acorn.lock", 31, 33, ME), ("cudaGraphLaunch", 40, 45, ME),
        ("acorn.copy_out", 75, 95, ME), ("acorn.gc", 80, 85, ME),
        ("portbench.classify", 200, 260, ME),
        ("acorn.classify", 200, 260, ME), ("acorn.request", 200, 210, ME),
        ("acorn.admit", 210, 215, ME), ("acorn.executor", 220, 240, ME),
        ("acorn.copy_out", 245, 250, ME),
        ("acorn.request", 300, 400, OTHER), ("acorn.classify", 300, 500, OTHER)]
STATS = {"p50_wait_ms": 9.0, "mean_dispatch_ms": 9.0,
         "mean_slot_wait_ms": 1.5, "mean_to_thread_ms": 2.0,
         "mean_on_thread_ms": 3.0, "mean_lock_wait_ms": 0.5,
         "mean_to_loop_ms": 4.0, "pad_share": 0.25}
WANT = {"request_us.bulk": (10 + 10) / 2, "admit_us.bulk": (10 + 5) / 2,
        "executor_us.bulk": (40 + 20) / 2, "copy_out_us.bulk": (20 + 5) / 2,
        # 100 less the 80 its children cover, and 60 less 40
        "classify_self_us.bulk": (20 + 20) / 2,
        "slot_wait_ms.open": 1.5, "to_thread_ms.open": 2.0,
        "on_thread_ms.open": 3.0, "lock_wait_ms.open": 0.5,
        "to_loop_ms.open": 4.0, "pad_share.open": 25.0}


def _read(name, stats=None, sl=None):
    return spec.reader(name).read(harness.Reading(stats=stats, slice=sl))


@pytest.mark.parametrize("name", BULK + OPEN)
def test_reader_gives_the_hand_count(name):
    assert _read(name, STATS, _slice(HOST)) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", BULK + OPEN)
def test_reader_is_none_without_its_input(name):
    assert _read(name) is None
    assert _read(name, {}, _slice([], classifies=0)) is None
    # a program without the spans and the record's keys
    old = {k: STATS[k] for k in ("p50_wait_ms", "mean_dispatch_ms")}
    assert _read(name, old, _slice([h for h in HOST
                                    if not h[0].startswith("acorn.")])) \
        is None


@pytest.mark.parametrize("name", BULK + OPEN)
def test_entry_names_its_reader_cell_and_source(name):
    (m,) = [m for m in BENCH["per_layer"] if m["name"] == name]
    assert m["workloads"] == ["zoo4-open" if name in OPEN else "zoo4-b4096"]
    assert m["better"] == "lower"
    assert m["source"] == ("program_counter" if name == "pad_share.open"
                           else "program_span")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return small_root(tmp_path_factory.mktemp("spans"))


@pytest.mark.parametrize("cell,names", [("zoo4-b4096", BULK),
                                        ("zoo4-open", OPEN)])
def test_traced_run_reports_the_span_metrics(root, fitted, cell,  # noqa: F811
                                             names):
    res, _ = harness.run_cell(cell, 2**31 + 11, 1.0, True, device="cpu",
                              root=root, log=lambda s: None)
    assert res["correct"]
    got = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(names) <= set(got)
    assert all(got[n] >= 0.0 for n in names)
    if cell == "zoo4-b4096":
        parts = sum(got[n] for n in BULK if n != "classify_self_us.bulk")
        assert got["classify_self_us.bulk"] < parts
