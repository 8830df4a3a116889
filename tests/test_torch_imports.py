"""The port stands alone: ``repro_torch``, its examples
(``examples/torch_port/``) and ``chip_smoke.py`` import neither JAX nor the
JAX package ``repro``.

Two checks: an AST scan of every source file for an ``import`` of ``jax``
or ``repro`` (``repro_torch`` itself is fine), and a subprocess that blocks
both in ``sys.modules`` and then imports every module of the port, every
example and ``chip_smoke.py``.  Importing also proves that no module builds a kernel or
touches a card at import time.
"""
import ast
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"
EXAMPLES = sorted((REPO / "examples" / "torch_port").glob("*.py"))
SCRIPTS = EXAMPLES + [REPO / "chip_smoke.py"]
SOURCES = sorted(PORT.rglob("*.py")) + SCRIPTS
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_repro_import(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_port_imports_with_jax_and_repro_blocked():
    modules = sorted(
        ".".join(p.relative_to(PORT.parent).with_suffix("").parts)
        .removesuffix(".__init__") for p in PORT.rglob("*.py"))
    code = "\n".join([
        "import importlib, importlib.util, sys",
        "for name in ('jax', 'jaxlib', 'repro'):",
        "    sys.modules[name] = None",
        f"for m in {modules!r}:",
        "    importlib.import_module(m)",
        f"for path in {[str(p) for p in SCRIPTS]!r}:",
        "    spec = importlib.util.spec_from_file_location('script', path)",
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))",
        "leaked = [m for m in sys.modules if m.split('.')[0] in",
        "          ('jax', 'jaxlib', 'repro') and sys.modules[m] is not None]",
        "assert not leaked, leaked",
        "print('imported', len(sys.modules))",
    ])
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=120,
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"})
    assert res.returncode == 0, res.stderr
    assert "imported" in res.stdout
