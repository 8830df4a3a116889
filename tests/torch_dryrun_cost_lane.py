"""The JAX package's side of ``tests/test_torch_dryrun_mesh.py`` and
``tools/dryrun_vs_reference.py``, run as a child process:
``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512 host devices when it is
imported, which the test process must not do.

For each cell named on the command line (``arch:shape``, one pod) it runs
the reference's ``run_cell`` with its probes (the step lowered and compiled
on the 16 x 16 mesh of placeholder devices, costed by ``parse_hlo_cost``,
``collective_bytes_from_hlo`` and ``memory_analysis()``) and prints one
JSON line of the record's numbers.  Records go to a temporary directory.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_dryrun_cost_lane.py \\
        internlm2-1.8b:decode_32k rwkv6-7b:long_500k
"""
import json
import sys
import tempfile

from repro.launch import dryrun  # noqa: F401  (sets XLA_FLAGS first)


def cell(arch: str, shape: str, out_dir: str) -> dict:
    rec = dryrun.run_cell(arch, shape, multi_pod=False, out_dir=out_dir)
    out = {"arch": arch, "shape": shape, "status": rec["status"]}
    if rec["status"] == "ok":
        mem = rec["memory"]
        out.update(flops=rec["hlo_flops_per_device"],
                   bytes=rec["hlo_bytes_per_device"],
                   collective=rec["collective_wire_bytes"],
                   peak=mem.get("peak_bytes"),
                   argument=mem.get("argument_bytes"),
                   useful_flops_ratio=rec["useful_flops_ratio"],
                   model_flops=rec["model_flops_total"])
    else:
        out["error"] = rec.get("error", rec.get("reason"))
    return out


if __name__ == "__main__":
    with tempfile.TemporaryDirectory() as d:
        for name in sys.argv[1:]:
            arch, shape = name.split(":")
            print(json.dumps(cell(arch, shape, d)), flush=True)
