"""The port's device-less dry run (``repro_torch.launch.dryrun``) held to
the JAX package's on the CPU, cell by cell.

For every (arch, shape, mesh) cell of the 80 (10 archs x 4 shapes x the
16 x 16 and 2 x 16 x 16 meshes) the port's record equals the reference's:
status, skip reason, ``n_micro``, ``state_dtype``, ``tokens_per_device``,
``q_chunk``, the inputs' shapes, ``analytic_bytes_per_device`` (exact
``==``) and ``model_flops_total``.  The JAX side runs in one child process
(``tests/torch_dryrun_lane.py``): ``repro.launch.dryrun`` sets ``XLA_FLAGS``
to 512 host devices when imported, which this process must not do.  It
computes the bytes with the reference's own
``_analytic_param_bytes_per_device``, ``input_specs`` and
``microbatch_plan`` and never lowers.  The records here stop at the layout
(``count=False``: the counted fields ``null``, with the reason); the
counted records are held in ``tests/test_torch_dryrun_mesh.py``.  The
port's own fields (``fits``), its overrides, its CLI (which counts) and
``cell_leaves`` are checked beside.
"""
import functools
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch.analysis.roofline import HW
from repro_torch.configs import all_cells, applicable, get_config
from repro_torch.launch import dryrun

REPO = pathlib.Path(__file__).resolve().parent.parent
CELLS = [(a, s, mp) for a, s in all_cells() for mp in (False, True)]
META_KEYS = ("arch", "shape", "multi_pod", "chips", "kind", "n_micro",
             "state_dtype", "tokens_per_device", "q_chunk", "inputs",
             "analytic_bytes_per_device")


@functools.lru_cache(maxsize=None)
def _jax_records() -> dict:
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO / "src"), os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run([sys.executable,
                          str(REPO / "tests" / "torch_dryrun_lane.py")],
                         capture_output=True, text=True, env=env, timeout=300,
                         check=True).stdout
    recs = [json.loads(line) for line in out.splitlines() if line]
    return {(r["arch"], r["shape"], r["pods"] == 2): r for r in recs}


@pytest.fixture(scope="module")
def port_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("dryrun"))


def test_all_cells_and_applicable_are_the_references():
    from repro.configs import all_cells as j_all_cells
    from repro.configs import applicable as j_applicable
    from repro.configs import get_config as j_get_config

    assert all_cells() == j_all_cells()
    assert len(CELLS) == 80 and set(_jax_records()) == set(CELLS)
    for arch, shape in all_cells():
        assert applicable(get_config(arch), shape) == j_applicable(
            j_get_config(arch), shape)


@pytest.mark.parametrize("arch,shape,multi_pod", CELLS,
                         ids=[f"{a}-{s}-{2 if mp else 1}pod"
                              for a, s, mp in CELLS])
def test_cell_equals_the_references(arch, shape, multi_pod, port_dir):
    want = _jax_records()[(arch, shape, multi_pod)]
    got = dryrun.run_cell(arch, shape, multi_pod=multi_pod, out_dir=port_dir,
                          count=False)
    assert got["status"] == want["status"], got.get("error")
    if want["status"] == "skip":
        assert got["reason"] == want["reason"]
        return
    assert {k: got["meta"].get(k) for k in META_KEYS} == {
        k: want["meta"].get(k) for k in META_KEYS}
    assert got["model_flops_total"] == want["model_flops_total"]
    # the port's own fields
    nbytes = got["meta"]["analytic_bytes_per_device"]
    assert got["fits"] == (nbytes <= HW().hbm_bytes)
    assert got["hbm_bytes"] == HW().hbm_bytes
    assert all(got[k] is None for k in dryrun.COUNTED_FIELDS)
    assert got["not_available"] == {"fields": list(dryrun.COUNTED_FIELDS),
                                    "reason": "not counted (count=False)"}
    path = os.path.join(port_dir, f"{arch}__{shape}__"
                                  f"{2 if multi_pod else 1}pod.json")
    with open(path) as f:
        assert json.load(f)["status"] == "ok"


@pytest.mark.parametrize("arch,shape", [("grok-1-314b", "train_4k"),
                                        ("qwen3-moe-235b-a22b", "decode_32k"),
                                        ("whisper-tiny", "train_4k"),
                                        ("rwkv6-7b", "long_500k")])
def test_cell_leaves_add_up_to_the_analytic_bytes(arch, shape):
    """One card's shards of every leaf a card holds, as ``chip_smoke.py``
    phase 17 allocates them on the H100: their bytes are the record's."""
    meta, leaves = dryrun.cell_leaves(arch, shape)
    total = 0
    for _, _, shard, dtype in leaves:
        total += torch.empty(shard, dtype=dtype, device="meta").nbytes
    assert total == meta["analytic_bytes_per_device"]
    assert meta["analytic_bytes_per_device"] <= HW().hbm_bytes


def test_overrides_reach_the_cell(tmp_path):
    """The reference's overrides: ``attn_mxu_native``, ``moe_impl``,
    ``attn_k_chunk``, ``capacity_factor`` reach the config; ``n_micro``,
    ``state_dtype``, ``tokens_per_device``, ``q_chunk`` and ``split_kv``
    the record; ``moe_impl=sort_sharded`` is refused by the port's moe (no
    JAX mesh), and the record says so."""
    cfg = dryrun._config("qwen3-moe-235b-a22b", {
        "attn_mxu_native": 1, "moe_impl": "sort", "attn_k_chunk": 512,
        "capacity_factor": 2.0})
    assert (cfg.attn_mxu_native, cfg.moe_impl, cfg.attn_k_chunk,
            cfg.capacity_factor) == (True, "sort", 512, 2.0)
    rec = dryrun.run_cell("internlm2-20b", "train_4k", multi_pod=False,
                          out_dir=str(tmp_path), count=False,
                          overrides=dict(n_micro=4, state_dtype="bfloat16",
                                         q_chunk=256, tokens_per_device=4096))
    assert {k: rec["meta"][k] for k in ("n_micro", "state_dtype", "q_chunk",
                                        "tokens_per_device")} == dict(
        n_micro=4, state_dtype="bfloat16", q_chunk=256, tokens_per_device=4096)
    base = dryrun.run_cell("internlm2-20b", "train_4k", multi_pod=False,
                           out_dir=str(tmp_path), count=False)
    assert (rec["meta"]["analytic_bytes_per_device"]
            < base["meta"]["analytic_bytes_per_device"])  # bf16 moments
    split = [dryrun.run_cell("granite-20b", "decode_32k", multi_pod=False,
                             out_dir=str(tmp_path), overrides={"split_kv": s},
                             count=False)
             for s in (0, 1)]
    assert (split[1]["meta"]["analytic_bytes_per_device"]
            < split[0]["meta"]["analytic_bytes_per_device"])
    bad = dryrun.run_cell("qwen3-moe-235b-a22b", "decode_32k",
                          multi_pod=False, out_dir=str(tmp_path),
                          overrides={"moe_impl": "sort_sharded"}, count=False)
    assert bad["status"] == "error"
    assert "sort_sharded" in bad["error"] and "needs a JAX mesh" in bad[
        "error"]
    dense = dryrun.run_cell("internlm2-1.8b", "decode_32k", multi_pod=False,
                            out_dir=str(tmp_path),
                            overrides={"moe_impl": "sort_sharded"},
                            count=False)
    assert dense["status"] == "ok"   # a dense arch never reads moe_impl


def test_cli_writes_one_record_a_cell(tmp_path, capsys):
    dryrun.main(["--arch", "rwkv6-7b", "--shape", "long_500k",
                 "--both-meshes", "--out", str(tmp_path), "--tag", "t",
                 "--set", "split_kv=0"])
    names = sorted(os.listdir(tmp_path))
    assert names == ["rwkv6-7b__long_500k__1pod__t.json",
                     "rwkv6-7b__long_500k__2pod__t.json"]
    out = capsys.readouterr().out
    assert out.count(" -> ok ") == 2 and "fits 80 GB" in out
    with open(tmp_path / names[0]) as f:
        assert json.load(f)["overrides"] == {"split_kv": 0}
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "rwkv6-7b"])
    assert not torch.cuda.is_initialized()


def test_default_output_is_ignored_by_git():
    assert pathlib.Path(dryrun.RESULTS_DIR) == REPO / "dryrun_out"
    assert "dryrun_out/" in (REPO / ".gitignore").read_text().splitlines()
