"""One run of one cell: set up, measure, compare with the reference.

``run_cell`` is the whole run but for the look for a card, which
``run.py`` makes; the tests drive it on the CPU.
"""
from __future__ import annotations

import dataclasses
import gc
import sys
import time
from pathlib import Path

import numpy as np

from portbench import checks, deploy, devtrace, drivers, reference, spec
from portbench.workcount import Work, count

__all__ = ["Reading", "setup", "measure", "run_cell", "expected",
           "FORBIDDEN"]

# top-level module names no run may have loaded: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Reading:
    """What a per-layer metric's reader reads."""

    stats: dict | None              # the front's latency_stats()
    slice: devtrace.Slice | None    # the traced slice


def expected(dep: deploy.Deployment, pool: list) -> list:
    """The reference's ``rslt`` for each batch of ``pool``, worked out over
    the pool as one batch."""
    cat = {f: np.concatenate([getattr(p, f) for p in pool])
           for f in ("ptype", "mid", "vid", "X", "rslt")}
    want = reference.classify(dep.models, cat["ptype"], cat["mid"],
                              cat["vid"], cat["X"], cat["rslt"],
                              frac_bits=dep.frac_bits)
    return np.split(want, np.cumsum([p.n for p in pool])[:-1])


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _device_info(device, chips: int) -> dict:
    import torch

    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": int(max(torch.cuda.max_memory_allocated(d)
                                         for d in range(chips)))}


def setup(root: Path, name: str, seed: int, device, log=print):
    """The cell's deployment and its driver, warmed."""
    t = time.perf_counter()
    bench = spec.load(root)
    cell = spec.workload(bench, name)
    dep = deploy.build(spec.config(bench, cell["config"], root), seed, device,
                       root)
    t1 = time.perf_counter()
    mix = spec.traffic(cell["traffic"], root)
    driver = spec.driver(mix["kind"], root).Driver(dep, mix, seed)
    t2 = time.perf_counter()
    driver.warm()
    log(f"set-up: models fitted and the zoo built in {t1 - t:.3f} s, "
        f"traffic made in {t2 - t1:.3f} s, warmed in "
        f"{time.perf_counter() - t2:.3f} s")
    return bench, cell, dep, driver


def measure(driver, seconds: float, tracer=None) -> drivers.Outcome:
    """One window of ``driver``.  What set-up left alive is collected and
    then frozen out of Python's collector first, so that the window's
    collections scan only what the window makes: the same set-up heap would
    otherwise cost each full collection a time that varies from run to
    run."""
    gc.collect()
    gc.freeze()
    try:
        return driver.window(seconds, tracer)
    finally:
        gc.unfreeze()


def _drift(marks: list, every: int = 5) -> str:
    """Calls a second over each ``every`` seconds of the window."""
    pts = [(0.0, 0)] + marks[every - 1::every]
    return " ".join(f"{(c1 - c0) / (t1 - t0):.1f}"
                    for (t0, c0), (t1, c1) in zip(pts, pts[1:]))


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             device="cuda", root: Path = spec.ROOT,
             t_process: float | None = None, log=print) -> tuple[dict, dict]:
    """Run cell ``name`` once; returns the result line and the checks."""
    t_process = time.perf_counter() if t_process is None else t_process
    log(f"imports done at {time.perf_counter() - t_process:.3f} s")
    bench, cell, dep, driver = setup(root, name, seed, device, log)
    tracer = devtrace.Tracer(seconds) if trace else None
    if tracer is not None:
        tracer.warm()
    out = measure(driver, seconds, tracer)
    setup_s = out.t_start - t_process
    dev = _device_info(device, cell["chips"])

    want = expected(dep, driver.pool)
    found = checks.compare(driver.pool, want, out.answers, out.failed)
    result = {"correct": checks.passed(found), "attempted": out.attempted,
              "failed": out.failed}
    if trace:
        metrics = _per_layer(bench, name, root, dep, driver, out)
        sl = out.slice
        if sl is not None and sl.device:
            dev.update(busy_s=sl.busy_s, window_s=sl.window_s)
            result["breakdown"] = {"device_ops": sl.device_ops(),
                                   "idle_gaps": sl.idle_gaps()}
    else:
        values = dict(drivers.summary(out), setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in spec.end_to_end(bench, name)}
    result["metrics"] = metrics
    result["device"] = dev
    if out.late_ms is not None:
        log(f"open loop: {out.attempted} arrivals in {out.seconds:.3f} s; the "
            f"generator fired late by p50 "
            f"{np.percentile(out.late_ms, 50):.3f} ms, p99 "
            f"{np.percentile(out.late_ms, 99):.3f} ms")
        result["generator_late_p99_ms"] = float(np.percentile(out.late_ms, 99))
    full = [ms for g, ms in out.gc_pauses if g == 2]
    log(f"window: {out.seconds:.3f} s, {out.attempted} attempted; Python's "
        f"collector ran {len(out.gc_pauses)} times ({len(full)} full), "
        f"{sum(ms for _, ms in out.gc_pauses):.1f} ms in all, longest "
        f"{max((ms for _, ms in out.gc_pauses), default=0.0):.1f} ms")
    if out.marks:
        log(f"calls a second, by 5-s stretch of the window: "
            f"{_drift(out.marks)}")
    result["setup_s"] = setup_s
    result["checks"] = found
    return result, found


def _per_layer(bench, name, root, dep, driver, out) -> dict:
    sl = out.slice
    if sl is not None and out.slice_calls is not None:
        sl.classifies = int(out.slice_calls.sum())
        work = Work(0, 0)
        for p, k in zip(driver.pool, out.slice_calls):
            if k:
                w = count(dep.models, p.ptype, p.mid, p.vid, p.X)
                work += Work(w.ops * int(k), w.nbytes * int(k))
        sl.work = work if sl.classifies else None
    reading = Reading(stats=out.stats, slice=sl)
    metrics = {}
    for m in spec.per_layer(bench, name):
        v = spec.reader(m["name"], root).read(reading)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return metrics
