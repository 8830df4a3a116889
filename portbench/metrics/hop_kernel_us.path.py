"""The hops' ``classify_fused`` kernels, in microseconds of device time a
classify: their summed time in the traced slice over the slice's
classifies."""
LAYER = "kernels"
UNIT = "us"
MOVES = "packets_per_s"
KERNEL = "classify_fused"


def read(reading):
    sl = reading.slice
    if sl is None or not sl.classifies or not sl.device:
        return None
    return sum(e - s for name, cat, s, e in sl.device
               if cat == "kernel" and KERNEL in name) / sl.classifies
