"""The dry run's counted cells on the 16 x 16 fake mesh held to the JAX
package's dry run on the CPU (``launch.dryrun.run_cell``, one pod).

Four cells: internlm2-1.8b ``decode_32k`` and ``prefill_32k``, qwen3-moe
``decode_32k`` and rwkv6-7b ``long_500k``.  For each: device (0, 0)'s local
shards, the step's weights, moments and decode state laid out as DTensors
by the specs, add up to ``analytic_bytes_per_device`` exactly; its counted
matmul flops lie between a 256th of the one-device count (the same step on
a 1 x 1 mesh) and that count; its collectives move bytes (none on one
card); its flops are within a factor of 2 of the reference's, whose record
comes from ``tests/torch_dryrun_cost_lane.py`` in a child process
(``repro.launch.dryrun`` sets 512 host devices when it is imported).
rwkv6-7b's decode is held against the port's count of one layer: the
reference's ``decode_step`` scans that family's layers whatever ``unroll``
says (``src/repro/models/transformer.py:506``), so its probes at 2 and 3
layers see one layer body each and its extrapolation counts one
(``ROADMAP.md`` Queue 3 item 8).  Every record's counted fields are filled,
``hlo_*_raw`` null with the reason.
"""
import functools
import json
import os
import pathlib
import subprocess
import sys

import pytest

from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from torch_dryrun_one_device import check_record
from torch_train_lane import one_torch_thread  # noqa: F401 (autouse)

REPO = pathlib.Path(__file__).resolve().parent.parent
CELLS = [("internlm2-1.8b", "decode_32k"), ("internlm2-1.8b", "prefill_32k"),
         ("qwen3-moe-235b-a22b", "decode_32k"), ("rwkv6-7b", "long_500k")]
IDS = [f"{a}-{s}" for a, s in CELLS]
ONE = make_mesh((1, 1), ("data", "model"))


@functools.lru_cache(maxsize=None)
def _reference() -> dict:
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO / "src"), os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run(
        [sys.executable, str(REPO / "tests" / "torch_dryrun_cost_lane.py"),
         *(f"{a}:{s}" for a, s in CELLS)],
        capture_output=True, text=True, env=env, timeout=600,
        check=True).stdout
    recs = [json.loads(line) for line in out.splitlines() if line]
    return {(r["arch"], r["shape"]): r for r in recs}


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """arch, shape -> the port's record, counted once a cell."""
    out, got = str(tmp_path_factory.mktemp("dryrun")), {}

    def record(arch, shape):
        if (arch, shape) not in got:
            got[arch, shape] = dryrun.run_cell(arch, shape, multi_pod=False,
                                               out_dir=out)
        return got[arch, shape]
    return record


@pytest.mark.parametrize("arch,shape", CELLS, ids=IDS)
def test_device_shards_equal_the_analytic_bytes(arch, shape, records):
    rec = records(arch, shape)
    assert dryrun.device_shards(arch, shape, multi_pod=False) == rec[
        "meta"]["analytic_bytes_per_device"]


@pytest.mark.parametrize("arch,shape", CELLS, ids=IDS)
def test_a_device_does_its_share(arch, shape, records):
    rec = records(arch, shape)
    one = dryrun.count_step(get_config(arch), SHAPES[shape], ONE)
    per = rec["hlo_flops_per_device"]
    assert one["flops"] / 256 <= per <= one["flops"]
    assert rec["collective_wire_bytes"] > 0 and rec["collectives"]["n_ops"]
    assert one["collective"] == 0.0 and one["collectives"]["n_ops"] == 0


@pytest.mark.parametrize("arch,shape", CELLS, ids=IDS)
def test_flops_within_twice_the_references(arch, shape, records):
    want = _reference()[(arch, shape)]
    assert want["status"] == "ok"
    got = records(arch, shape)["hlo_flops_per_device"]
    if arch == "rwkv6-7b":
        got = dryrun.count_step(get_config(arch).scaled(n_layers=1),
                                SHAPES[shape], make_production_mesh(),
                                probes=False)["flops"]
    assert 0.5 <= got / want["flops"] <= 2.0, (got, want["flops"])


@pytest.mark.parametrize("arch,shape", CELLS, ids=IDS)
def test_every_counted_field_is_filled(arch, shape, records):
    rec = records(arch, shape)
    check_record(rec)
    assert rec["memory"]["argument_bytes"] >= rec["meta"][
        "analytic_bytes_per_device"]
    assert rec["decode_attn_ops"] == (
        get_config(arch).n_layers if arch != "rwkv6-7b" and SHAPES[
            shape].kind == "decode" else 0)
