"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload zoo4-b4096 --seed 7 --seconds 20 --trace 0

Set-up (fitting the cell's models, building the program's zoo, warming
every shape the cell uses), then ``--seconds`` of measurement, then the
comparison with the plain reference.  The last line of standard output is
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device`` and, traced, ``breakdown``; the numbers compared come last, under
``checks``, and again as the last lines of standard error.  Without a CUDA
card, or with fewer than the cell asks for, it exits 3 and prints no result.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _power_limit_w():
    """The card's power limit in watts, as nvidia-smi reads it (None where
    it cannot)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def fail(msg: str) -> int:
    print(f"portbench: {msg}", file=sys.stderr)
    return 3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # the script's own directory must not shadow the standard library
    sys.path[:] = [p for p in sys.path
                   if Path(p or ".").resolve() != Path(__file__).resolve().parent]
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    # kernel caches stay inside the checkout, at fixed paths
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / ".portbench_cache"
                                                  / "triton"))

    import torch

    from portbench import checks, harness, spec

    # one intra-op thread: the program's host work is small ops, and a pool
    # of threads on a shared host stalls calls by a scheduler tick at random
    torch.set_num_threads(1)

    try:
        cell = spec.workload(spec.load(ROOT), args.workload)
    except (OSError, KeyError) as e:
        return fail(str(e))
    if not torch.cuda.is_available():
        return fail("no CUDA card: the benchmark measures the card and has "
                    "no CPU fallback")
    if torch.cuda.device_count() < cell["chips"]:
        return fail(f"{args.workload} needs {cell['chips']} cards, "
                    f"{torch.cuda.device_count()} found")
    if not (ROOT / "src" / "repro_torch").is_dir():
        return fail("the program (src/repro_torch) is not in this checkout")

    result, found = harness.run_cell(
        args.workload, args.seed, args.seconds, bool(args.trace),
        device="cuda", root=ROOT, t_process=T_PROCESS,
        log=lambda s: print(s, file=sys.stderr))
    bad = harness.forbidden_modules()
    if bad:
        return fail("the run loaded " + ", ".join(bad)
                    + ": nothing the benchmark runs may import JAX or the "
                    "JAX package")
    result["device"]["power_limit_w"] = _power_limit_w()
    checks_last = result.pop("checks")
    result["checks"] = checks_last
    for line in checks.text(found):
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
