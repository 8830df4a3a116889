"""The ``classify_fused`` kernels a classify, in the traced slice: one a
hop on the path executor's graph, so it reads the hops each replay runs
(5 on ``acorn-zoo4-fattree4``), fewer where hops are fused or skipped."""
LAYER = "path executor"
UNIT = "calls"
MOVES = "packets_per_s"
KERNEL = "classify_fused"


def read(reading):
    sl = reading.slice
    if sl is None or not sl.classifies or not sl.device:
        return None
    n = sum(1 for name, cat, _, _ in sl.device
            if cat == "kernel" and KERNEL in name)
    return n / sl.classifies
