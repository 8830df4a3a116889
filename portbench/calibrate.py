"""The readings the limits of ``correct`` are set from, on the card.

    python3 portbench/calibrate.py --workload zoo4-b4096 --seconds 3 \
        --seeds 11 12 13

For each seed, in one process: the cell's set-up and a short window at its
own size and load, then the numbers ``correct`` compares, read twice: once
for the program's answers, and once for the control's, the reference put in
the program's place at the precision below the configuration's (features
of 7 bits for 8: the low bit dropped).  One JSON line a seed.  The control
must fail at least one number on every seed; the program none.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def control_answers(dep, pool: list, answers: list, bits: int) -> list:
    """The kept answers as the control gives them: the reference on
    features coarsened to ``bits``, forwarding what it does not classify."""
    from portbench import reference

    out = []
    coarse = {}
    for i, _, _, _ in answers:
        if i not in coarse:
            p = pool[i]
            coarse[i] = reference.classify(
                dep.models, p.ptype, p.mid, p.vid,
                reference.coarsen(p.X, dep.feature_width, bits), p.rslt,
                frac_bits=dep.frac_bits)
        p = pool[i]
        out.append((i, coarse[i], p.codes, p.acc))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    sys.path[:] = [p for p in sys.path
                   if Path(p or ".").resolve() != Path(__file__).resolve().parent]
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    import torch

    from portbench import checks, harness

    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card: the readings are the card's, and there "
              "is no CPU fallback", file=sys.stderr)
        return 3
    for seed in args.seeds:
        _, _, dep, driver = harness.setup(ROOT, args.workload, seed,
                                          "cuda", log=lambda s: None)
        out = harness.measure(driver, args.seconds)
        want = harness.expected(dep, driver.pool)
        program = checks.compare(driver.pool, want, out.answers, out.failed)
        ctl = control_answers(dep, driver.pool, out.answers,
                              dep.feature_width - 1)
        control = checks.compare(driver.pool, want, ctl, 0)
        print(json.dumps({
            "workload": args.workload, "seed": seed,
            "program": {k: v["value"] for k, v in program.items()},
            "program_correct": checks.passed(program),
            "control": {k: v["value"] for k, v in control.items()},
            "control_correct": checks.passed(control)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
