"""Every other kernel of the classify step, in microseconds of device time
a classify: the hops' select, SVM predict and ``where`` ops around each
``classify_fused``, summed over the traced slice, over its classifies.
Copies are left out, whether the copy engine's or CUDA's own copy
kernels (``memcpy*``, ``memset*``)."""
LAYER = "classify step"
UNIT = "us"
MOVES = "packets_per_s"
KERNEL = "classify_fused"
COPIES = ("memcpy", "memset")


def read(reading):
    sl = reading.slice
    if sl is None or not sl.classifies or not sl.device:
        return None
    return sum(e - s for name, cat, s, e in sl.device
               if cat == "kernel" and KERNEL not in name
               and not name.lower().startswith(COPIES)) / sl.classifies
