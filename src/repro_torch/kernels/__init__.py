"""Hopper kernels and their plain torch versions.

    classify_fused.py  wrapper of the CUDA kernel in ``csrc/classify_fused.cu``
    ref.py             plain torch twins of the JAX package's oracles
    tiling.py          install-time operand prep (the exec image)
    ops.py             mode dispatch between kernel and twin
    build.py           nvcc build + ctypes load of ``csrc/``
"""
