"""ACORN on PyTorch and CUDA: the port of the JAX package ``repro`` to one
NVIDIA H100.

The package mirrors ``repro``'s layout (``core/``, ``kernels/``,
``runtime/``, ``serving/``, ``data/``) and imports nothing from it: modules
it needs that are plain numpy are copied, each naming its source file.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; on
the CPU the kernel wrappers run their plain torch versions.
"""
