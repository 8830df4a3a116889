"""The least time of the slice's work (``portbench.workcount``: the
models' own walks, votes and sums, whichever hops hold them; the bytes
handed from hop to hop are no part of it) over the summed device time of
every kernel in the slice, in percent."""
LAYER = "kernels"
UNIT = "%"
MOVES = "packets_per_s"


def read(reading):
    sl = reading.slice
    if sl is None or sl.work is None or sl.kernel_s <= 0:
        return None
    return 100.0 * sl.work.least_s / sl.kernel_s
