"""What a run may load, and what it does without a card."""
from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

import pytest

from portbench import spec

SRC = str(spec.ROOT / "src")


def _python(code: str, timeout: float = 240) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([SRC, str(spec.ROOT)]))
    env.pop("JAX_PLATFORMS", None)
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          capture_output=True, text=True, env=env,
                          timeout=timeout, cwd=spec.ROOT)


def _top_level(modules) -> set:
    return {m.split(".")[0] for m in modules}


def test_a_run_loads_no_jax_and_no_jax_package(tmp_path):
    """The harness, every traffic driver and metric reader, the reference,
    the tools, and a whole run of a cell on the CPU: afterwards no module
    whose top-level name is ``jax``, ``jaxlib``, ``flax`` or ``repro``
    is loaded (``repro_torch`` is the program, and is)."""
    r = _python(f"""
        import json, sys
        from pathlib import Path
        import torch
        torch.set_num_threads(1)
        from portbench import (calibrate, checks, deploy, devtrace, drivers,
                               harness, reference, spec, stats, sweep,
                               workcount)
        import portbench.run
        from portbench.tests.helpers import small_root
        for m in spec.load()["per_layer"]:
            spec.reader(m["name"])
        root = small_root(Path({str(tmp_path)!r}))
        res, _ = harness.run_cell("zoo4-b64", 3, 0.2, False, device="cpu",
                                  root=root, log=lambda s: None)
        print(json.dumps([res["correct"], sorted(sys.modules)]))
        """)
    assert r.returncode == 0, r.stderr[-3000:]
    correct, modules = json.loads(r.stdout.strip().splitlines()[-1])
    assert correct
    top = _top_level(modules)
    assert not top & {"jax", "jaxlib", "flax", "repro"}, top & {"jax", "repro"}
    assert "repro_torch" in top


def test_reference_loads_nothing_of_the_program():
    r = _python("""
        import json, sys
        import portbench.reference, portbench.workcount, portbench.trainers
        print(json.dumps(sorted(sys.modules)))
        """)
    assert r.returncode == 0, r.stderr[-3000:]
    top = _top_level(json.loads(r.stdout.strip().splitlines()[-1]))
    assert not top & {"repro_torch", "repro", "jax", "jaxlib", "torch"}


def test_harness_names_forbidden_modules_whole():
    r = _python("""
        import sys, types
        from portbench import harness
        sys.modules["repro_torch_x"] = types.ModuleType("repro_torch_x")
        sys.modules["jaxfoo"] = types.ModuleType("jaxfoo")
        assert harness.forbidden_modules() == [], harness.forbidden_modules()
        sys.modules["repro.core"] = types.ModuleType("repro.core")
        assert harness.forbidden_modules() == ["repro"]
        """)
    assert r.returncode == 0, r.stderr[-3000:]


def test_run_without_a_card_fails_and_prints_no_result():
    """No CUDA card here: the run exits 3 with a reason and prints no
    result line; there is no fallback to the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    r = subprocess.run(
        [sys.executable, str(spec.ROOT / "portbench" / "run.py"),
         "--workload", "zoo4-b4096", "--seed", str(2**31 + 3), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=240,
        cwd=spec.ROOT)
    assert r.returncode == 3
    assert r.stdout.strip() == ""
    assert "portbench:" in r.stderr
