"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exports a plain C function, compiled for Hopper
(``sm_90a``) into ``_build/lib<name>-<hash>.so`` beside the package, at first
use.  The hash covers the source, the headers in ``csrc/`` and the flags, so
an edited source rebuilds and an unchanged one loads from the cache.  A plain
C interface keeps the build to seconds: nothing includes PyTorch's headers.

Nothing here runs at import: the CPU tests import every module, and this
machine class has no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

__all__ = ["BuiltLibrary", "build", "nvcc_path", "CSRC", "BUILD_DIR"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo")


@dataclasses.dataclass
class BuiltLibrary:
    name: str
    lib: ctypes.CDLL
    path: Path
    build_seconds: float   # 0.0 when loaded from an earlier build
    log: str               # nvcc's output, the -Xptxas -v summary included


_LOADED: dict[str, BuiltLibrary] = {}   # a process loads each library once


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under CUDA_HOME or
    /usr/local/cuda.  Raises if there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _target(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


def build(*names: str) -> dict[str, BuiltLibrary]:
    """Compile (all at once, one ``nvcc`` each) and load the named sources;
    already-loaded and already-built ones are reused."""
    todo = [n for n in names if n not in _LOADED and not _target(n).exists()]
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = nvcc_path()
        procs = {}
        for n in todo:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp,
                   str(CSRC / f"{n}.cu")]
            procs[n] = (tmp, time.perf_counter(), subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        failed = []
        for n, (tmp, t0, proc) in procs.items():
            out, _ = proc.communicate()
            seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                os.unlink(tmp)
                failed.append(f"{n}:\n{out}")
                continue
            target = _target(n)
            target.with_suffix(".log").write_text(f"{seconds}\n{out}")
            os.replace(tmp, target)
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
    for n in names:
        if n not in _LOADED:
            target = _target(n)
            seconds, _, log = target.with_suffix(".log").read_text() \
                .partition("\n")
            _LOADED[n] = BuiltLibrary(
                n, ctypes.CDLL(str(target)), target,
                float(seconds) if n in todo else 0.0, log)
    return {n: _LOADED[n] for n in names}
