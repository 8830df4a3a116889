"""What every kernel wrapper shares: where a call runs, operand checks, and
the launch of a ``csrc/`` function on PyTorch's current stream.

A wrapper runs its kernel on CUDA tensors and its plain torch version on CPU
tensors (``on_card``), and raises for any other device or a mix of devices.
It never falls back: a kernel that does not build or whose launch is
refused raises (``launch``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import build

__all__ = ["on_card", "check", "launch", "current_stream"]


def on_card(kernel: str, **tensors: torch.Tensor) -> bool:
    """True when the (first-named) tensors lie on a CUDA device, so the
    kernel launches; False on the CPU, where the plain version runs."""
    (name0, x0), *rest = tensors.items()
    dev = x0.device
    for name, x in rest:
        if x.device != dev:
            raise ValueError(f"{name} on {x.device}, {name0} on {dev}")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"no {kernel} kernel for {dev}")
    return True


def check(name: str, x: torch.Tensor, dtype: torch.dtype, shape) -> None:
    """Raise unless ``x`` has the dtype, shape and contiguity the kernel
    reads."""
    if x.dtype != dtype:
        raise TypeError(f"{name}: dtype {x.dtype}, kernel takes {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _c_type(arg):
    """The C type ``arg`` is passed as: a tensor as its device pointer, a
    Python int as ``int``, a Python float as ``float``."""
    for kind, ctype in ((torch.Tensor, ctypes.c_void_p),
                        (int, ctypes.c_int), (float, ctypes.c_float)):
        if isinstance(arg, kind):
            return ctype
    raise TypeError(f"no C type for a kernel argument of {type(arg)}")


def current_stream(device: torch.device) -> int:
    """The handle of PyTorch's current stream on ``device``: where
    ``launch`` puts a kernel unless it is given another."""
    return torch.cuda.current_stream(device).cuda_stream


def launch(source: str, symbol: str, device: torch.device, *args,
           stream: int | None = None) -> None:
    """Build ``csrc/<source>.cu`` (once) and launch its C function
    ``symbol`` on ``stream`` (a handle; by default the current stream of
    ``device``).  ``args`` are tensors, passed as device pointers, ints,
    passed as C ``int``, and floats, passed as C ``float``; the stream goes
    last.  Raises if the launch is refused (too many threads, too much
    shared memory)."""
    fn = getattr(build(source)[source].lib, symbol)
    if fn.argtypes is None:
        fn.argtypes = [_c_type(a) for a in args] + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        if stream is None:
            stream = current_stream(device)
        err = fn(*(a.data_ptr() if isinstance(a, torch.Tensor) else a
                   for a in args), stream)
    if err != 0:
        raise RuntimeError(f"{symbol} launch failed: CUDA error {err}")
