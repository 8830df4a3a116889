"""Find an open-loop cell's knee: the highest offered rate the front
sustains with no growing backlog.

    python3 portbench/sweep.py --workload zoo4-open --seed 11 --seconds 10 \
        --rates 2000 3000 3500 4000 4500

One set-up, then one window a rate, each through a fresh front.  A line a
rate: offered and completed requests/s, p50 and p99 ms, and the median
latency of the last quarter of the arrivals over that of the first (a
backlog that grows shows as a ratio well above 1).  The knee is the
highest rate whose completed rate is within 3% of the offered and whose
ratio stays under 1.5.  Needs a CUDA card.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path[:] = [p for p in sys.path
                   if Path(p or ".").resolve() != Path(__file__).resolve().parent]
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    import numpy as np
    import torch

    from portbench import harness, stats

    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("sweep: no CUDA card: the readings are the card's, and there "
              "is no CPU fallback", file=sys.stderr)
        return 3
    _, _, _, driver = harness.setup(ROOT, args.workload, args.seed,
                                    "cuda")
    knee = None
    for rate in args.rates:
        driver.mix = dict(driver.mix, rate_rps=rate)
        out = harness.measure(driver, args.seconds)
        lat = out.latencies_ms
        done = int(np.isfinite(lat).sum())
        q = max(lat.size // 4, 1)
        trend = (float(np.median(lat[-q:])) / float(np.median(lat[:q]))
                 if done == lat.size else float("inf"))
        completed = np.count_nonzero(np.isfinite(lat) & (
            np.asarray(driver._schedule(args.seconds)[0]) + lat / 1e3
            <= args.seconds)) / args.seconds
        row = {"offered_rps": rate, "completed_rps": completed,
               "p50_ms": stats.percentile(lat, 50),
               "p99_ms": stats.percentile(lat, 99), "trend": trend,
               "failed": out.failed,
               "gc_full": sum(g == 2 for g, _ in out.gc_pauses),
               "gc_longest_ms": max((ms for _, ms in out.gc_pauses),
                                    default=0.0),
               "late_p99_ms": stats.percentile(out.late_ms, 99),
               "stats": {
                   k: out.stats.get(k) for k in ("p50_wait_ms",
                                                 "mean_batch_packets",
                                                 "mean_dispatch_ms")}}
        print(json.dumps(row), flush=True)
        if completed >= 0.97 * rate and trend < 1.5 and not out.failed:
            knee = rate
    print(json.dumps({"knee_rps": knee}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
