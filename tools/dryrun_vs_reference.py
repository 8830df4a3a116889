"""The port's counted dry run beside the JAX package's, cell by cell, on
the CPU: flops, bytes, collective wire bytes and peak bytes a device, and
their ratios (port / reference), as a markdown table.

The reference's records come from ``tests/torch_dryrun_cost_lane.py`` in a
child process (``repro.launch.dryrun`` sets 512 host devices when it is
imported): its ``run_cell`` with probes, one pod.  By default the cells
the reference compiles under its installed jax (its ``decode_32k``,
``prefill_32k`` and applicable ``long_500k`` cells; its ``train_4k`` cells
fail to lower, ``ROADMAP.md`` Queue 3 item 7).  No time is measured: both
sides are counts.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/dryrun_vs_reference.py \\
        [--cells arch:shape ...] [--json out.json]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def default_cells() -> list[str]:
    from repro_torch.configs import all_cells, applicable, get_config

    return [f"{a}:{s}" for a, s in all_cells()
            if s != "train_4k" and applicable(get_config(a), s)[0]]


def reference(cells: list[str]) -> dict:
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO / "src"), os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run(
        [sys.executable, str(REPO / "tests" / "torch_dryrun_cost_lane.py"),
         *cells], capture_output=True, text=True, env=env, check=True).stdout
    recs = [json.loads(line) for line in out.splitlines() if line]
    return {f"{r['arch']}:{r['shape']}": r for r in recs}


def port(cells: list[str]) -> dict:
    from repro_torch.launch import dryrun

    out = {}
    with tempfile.TemporaryDirectory() as d:
        for cell in cells:
            arch, shape = cell.split(":")
            r = dryrun.run_cell(arch, shape, multi_pod=False, out_dir=d)
            out[cell] = r if r["status"] != "ok" else dict(
                status="ok", flops=r["hlo_flops_per_device"],
                bytes=r["hlo_bytes_per_device"],
                collective=r["collective_wire_bytes"],
                peak=r["memory"]["peak_bytes"],
                useful_flops_ratio=r["useful_flops_ratio"])
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cells", nargs="*", help="arch:shape (default: the "
                    "reference's compiling cells)")
    ap.add_argument("--json", help="write both sides' numbers here")
    args = ap.parse_args(argv)
    cells = args.cells or default_cells()
    ref, got = reference(cells), port(cells)
    keys = ("flops", "bytes", "collective", "peak")
    print("| cell | " + " | ".join(
        f"{k} port / ref (ratio)" for k in keys) + " | useful port / ref |")
    print("|---" * (len(keys) + 2) + "|")
    for cell in cells:
        r, p = ref[cell], got[cell]
        if r["status"] != "ok" or p["status"] != "ok":
            print(f"| {cell} | reference {r['status']}, port {p['status']} |")
            continue
        row = [f"{p[k]:.4g} / {r[k]:.4g} ({p[k] / r[k]:.3g})" for k in keys]
        print(f"| {cell} | " + " | ".join(row) + f" | "
              f"{p['useful_flops_ratio']:.3g} / "
              f"{r['useful_flops_ratio']:.3g} |")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"reference": ref, "port": got}, f, indent=1)


if __name__ == "__main__":
    main()
