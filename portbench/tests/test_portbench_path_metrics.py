"""The per-layer metrics of the path cell, ``fattree4-b4096``: each reader
on a hand-made slice of two 5-hop replays against the hand count, None
where the slice has no classifies or no device activity, its entry in
``BENCHMARK.json``, and a traced run of the cell on the CPU reporting the
one it can read there."""
from __future__ import annotations

import pytest

from portbench import harness, spec
from portbench.devtrace import Slice
from portbench.tests.helpers import fitted, one_torch_thread, small_root  # noqa: F401
from portbench.workcount import PEAK_BYTES_S, Work

BENCH = spec.load()
CELL = "fattree4-b4096"
DEVICE = ["hops_per_classify.path", "hop_kernel_us.path", "hop_glue_us.path",
          "kernels_roofline.path", "device_idle.path"]
SPAN = ["executor_us.path"]
ME, OTHER = 1, 2
HOPS = 5
FUSED = "(anonymous namespace)::classify_fused_kernel<int const, 8>"
GLUE = "void at::native::elementwise_kernel<128, 2>"


def _replay(t0: float) -> list:
    """One classify on the card from ``t0`` (us), back to back: the stage's
    copy (10), then a hop's ``classify_fused`` (6) and its glue (3) five
    times, then CUDA's own copy kernel (1): 56 busy."""
    ev = [("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", t0, t0 + 10)]
    t = t0 + 10
    for _ in range(HOPS):
        ev += [(FUSED, "kernel", t, t + 6), (GLUE, "kernel", t + 6, t + 9)]
        t += 9
    return ev + [("memcpy32_post", "kernel", t, t + 1)]


DEVICE_EVENTS = _replay(0.0) + _replay(200.0)
HOST = [("acorn.executor", 0, 60, ME), ("acorn.hop", 1, 2, ME),
        ("acorn.executor", 200, 240, ME), ("acorn.executor", 300, 400, OTHER),
        ("cudaGraphLaunch", 5, 8, ME)]
# the least time of the slice's work: 1 us at the card's bandwidth
WORK = Work(0, int(PEAK_BYTES_S * 1e-6))
WANT = {"hops_per_classify.path": 5.0,
        "hop_kernel_us.path": 30.0,
        "hop_glue_us.path": 15.0,
        # 1 us of work over the kernels' 2 x 46 us (the copy kernel counts)
        "kernels_roofline.path": 100.0 * 1.0 / 92.0,
        # 2 x 56 us busy of 1000
        "device_idle.path": 100.0 * (1.0 - 112.0 / 1000.0),
        "executor_us.path": (60 + 40) / 2}


def _slice(device=DEVICE_EVENTS, host=HOST, classifies=2, work=WORK):
    return Slice(lo=0.0, hi=1000.0, device=list(device), host=list(host),
                 runtime_calls={"cudaGraphLaunch": classifies}, thread=ME,
                 classifies=classifies, work=work if classifies else None)


def _read(name, sl):
    return spec.reader(name).read(harness.Reading(stats=None, slice=sl))


@pytest.mark.parametrize("name", DEVICE + SPAN)
def test_reader_gives_the_hand_count(name):
    assert _read(name, _slice()) == pytest.approx(WANT[name], rel=1e-12)


@pytest.mark.parametrize("name", DEVICE + SPAN)
def test_reader_is_none_without_classifies_or_device(name):
    assert _read(name, None) is None
    assert _read(name, _slice(device=[], host=[], classifies=0)) is None
    if name in DEVICE:
        assert _read(name, _slice(device=[])) is None
    else:                               # a program without the span
        assert _read(name, _slice(host=[h for h in HOST
                                        if h[0] != "acorn.executor"])) is None


@pytest.mark.parametrize("name", ["hops_per_classify.path",
                                  "hop_kernel_us.path", "hop_glue_us.path"])
def test_hop_readers_split_the_kernels_by_name(name):
    """Only ``classify_fused`` is a hop's kernel; copies, by the copy
    engine or CUDA's own copy kernels, are neither a hop nor glue."""
    fused_only = [e for e in DEVICE_EVENTS if "classify_fused" in e[0]]
    got = _read(name, _slice(device=fused_only))
    assert got == pytest.approx(0.0 if name == "hop_glue_us.path"
                                else WANT[name])
    no_copies = [e for e in DEVICE_EVENTS if "emcpy" not in e[0]]
    assert _read(name, _slice(device=no_copies)) == \
        pytest.approx(WANT[name])


@pytest.mark.parametrize("name", DEVICE + SPAN)
def test_entry_names_its_reader_cell_and_source(name):
    (m,) = [m for m in BENCH["per_layer"] if m["name"] == name]
    assert m["workloads"] == [CELL]
    assert m["moves"] == "packets_per_s"
    assert m["better"] == ("higher" if name == "kernels_roofline.path"
                           else "lower")
    assert m["source"] == ("program_span" if name in SPAN
                           else "device_trace")
    (e2e,) = [e for e in BENCH["end_to_end"] if e["name"] == m["moves"]]
    assert CELL in e2e["workloads"]


def test_traced_run_reports_what_the_cpu_can_read(tmp_path, fitted):  # noqa: F811
    """On the CPU the slice holds host spans and no device activity: the
    span metric is reported and the device metrics are left out, none
    raising."""
    root = small_root(tmp_path)
    res, _ = harness.run_cell(CELL, 2**31 + 13, 1.0, True, device="cpu",
                              root=root, log=lambda s: None)
    assert res["correct"]
    got = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(got) & set(DEVICE + SPAN) == set(SPAN)
    assert got["executor_us.path"] > 0.0
