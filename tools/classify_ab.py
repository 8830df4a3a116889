#!/usr/bin/env python3
"""Two trees of the port's bulk classify path, alternated in one process
on one CUDA card.

    python3 tools/classify_ab.py --other DIR [--rounds 24] [--calls 1000]
        [--workload zoo4-b4096]

Loads the port from this tree's ``src/`` and from ``DIR/src`` (an unpacked
older commit) as two sets of modules, and makes one of them the process's
``repro_torch`` at a time.  Each builds the zoo of the benchmark cell
``--workload`` (``zoo4-b4096`` by default, or ``fattree4-b4096``) from
``--seed`` (``portbench.deploy.build``) and warms the cell's pool of 32
batches (``portbench`` traffic ``b4096``); both trees must answer every
batch alike.  Then ``--rounds`` rounds, the trees' order
alternating (ABBA), each ``--calls`` back-to-back ``ZooServer.classify``
calls of a tree timed by the host clock.  Last, one warmed window of
``--window`` s through the benchmark's own closed loop, per tree, with the
staging pool's and the request paths' counters read around it where the
tree has them (``DataplaneRuntime.staging_stats``, ``request_stats``), and
the program's spans summed over it, untraced (``runtime/trace.py``
``recording``).  Prints one JSON line: us a call per round and tree, the
pairs' differences, the counters and the spans' us a call.  Needs one card;
imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import gc
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PREFIX = "repro_torch"


def _ours(name: str) -> bool:
    return name == PREFIX or name.startswith(PREFIX + ".")


def _activate(mods: dict) -> None:
    for k in [k for k in sys.modules if _ours(k)]:
        del sys.modules[k]
    sys.modules.update(mods)


def _load(src: Path) -> dict:
    """The port's modules imported from ``src``, as a set to swap in."""
    _activate({})
    sys.path.insert(0, str(src))
    try:
        import repro_torch.serving  # noqa: F401
    finally:
        sys.path.remove(str(src))
    return {k: m for k, m in sys.modules.items() if _ours(k)}


def _quartiles(xs):
    q = statistics.quantiles(xs, n=4)
    return [q[0], statistics.median(xs), q[2]]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", required=True)
    ap.add_argument("--rounds", type=int, default=24)
    ap.add_argument("--calls", type=int, default=1000)
    ap.add_argument("--window", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=2147483901)
    ap.add_argument("--workload", default="zoo4-b4096",
                    choices=("zoo4-b4096", "fattree4-b4096"))
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("classify_ab: needs a CUDA card", file=sys.stderr)
        return 3
    torch.set_num_threads(1)
    sys.path.insert(0, str(ROOT))
    from portbench import deploy, spec

    bench = spec.load(ROOT)
    cell = spec.workload(bench, args.workload)
    config = spec.config(bench, cell["config"], ROOT)
    mix = spec.traffic(cell["traffic"], ROOT)
    trees = {"this": ROOT / "src", "other": Path(args.other) / "src"}
    side = {}
    for name, src in trees.items():
        mods = _load(src)
        dep = deploy.build(config, args.seed, "cuda", ROOT)
        drv = spec.driver(mix["kind"], ROOT).Driver(dep, mix, args.seed)
        drv.warm()
        side[name] = (mods, dep, drv)
        _activate({})
    for i, p in enumerate(side["this"][2].pool):
        outs = []
        for name in trees:
            mods, dep, _ = side[name]
            _activate(mods)
            outs.append(dep.zoo.classify(p.X, mid=p.mid, vid=p.vid))
        if not np.array_equal(*outs):
            print(f"classify_ab: the trees answer batch {i} apart",
                  file=sys.stderr)
            return 1
    gc.collect()
    gc.freeze()
    us = {name: [] for name in trees}
    order = list(trees)
    for r in range(args.rounds):
        for name in (order if r % 2 == 0 else order[::-1]):
            mods, dep, drv = side[name]
            _activate(mods)
            zoo, pool = dep.zoo, drv.pool
            t0 = time.perf_counter()
            for j in range(args.calls):
                p = pool[j % len(pool)]
                zoo.classify(p.X, mid=p.mid, vid=p.vid)
            us[name].append((time.perf_counter() - t0) / args.calls * 1e6)
    diff = [a - b for a, b in zip(us["this"], us["other"])]
    counters = {}
    for name in trees:
        mods, dep, drv = side[name]
        _activate(mods)
        reads = {k: getattr(dep.zoo.runtime, f"{k}_stats", None)
                 for k in ("staging", "request")}
        before = {k: f() for k, f in reads.items() if f}
        spans = {}
        with mods[PREFIX + ".runtime.trace"].recording(spans):
            out = drv.window(args.window, None)
        counters[name] = {
            "calls": out.attempted, "failed": out.failed,
            "packets_per_s": out.packets / out.seconds,
            "span_us_per_call": {k: v / out.attempted * 1e6
                                 for k, v in sorted(spans.items())},
            **{f"{k}_before": v for k, v in before.items()},
            **{f"{k}_after": f() for k, f in reads.items() if f}}
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "workload": args.workload,
        "rounds": args.rounds, "calls": args.calls,
        "us_per_call": us,
        "quartiles_us": {k: _quartiles(v) for k, v in us.items()},
        "this_minus_other_us": _quartiles(diff),
        "this_faster_rounds": sum(d < 0 for d in diff),
        "window": counters}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
