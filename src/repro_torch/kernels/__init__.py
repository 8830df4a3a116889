"""Hopper kernels and their plain torch versions.

    classify_fused.py  wrapper of the CUDA kernel in ``csrc/classify_fused.cu``
    tree_walk.py       wrapper of ``csrc/tree_walk.cu`` (unfused stage 1)
    tcam_match.py      wrapper of ``csrc/tcam_match.cu`` (one layer)
    forest_vote.py     wrapper of ``csrc/forest_vote.cu`` (stage 2)
    svm_lookup.py      wrapper of ``csrc/svm_lookup.cu`` (stage 3)
    request_record.py  a request staged as a byte record: the host's
                       native write and ``expand_request``, the wrapper of
                       ``csrc/request_record.cu`` (no TPU counterpart)
    ref.py             plain torch twins of the JAX package's oracles
    tiling.py          install-time operand prep (the exec image)
    ops.py             mode dispatch between kernels and twins
    launch.py          device routing, operand checks, the ctypes launch
    build.py           nvcc build + ctypes load of ``csrc/``
"""
