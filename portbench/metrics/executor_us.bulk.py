"""The executor's classify (its lock, the stage into the graph's buffer,
the replay and the result's clone), in microseconds a classify: the
program's ``acorn.executor`` span, summed on the benchmark's thread over
the traced slice, over the slice's classifies."""
LAYER = "serving front, admission and executor"
UNIT = "us"
MOVES = "packets_per_s"
SPAN = "acorn.executor"


def read(reading):
    sl = reading.slice
    if sl is None or not sl.classifies:
        return None
    t = [e - s for n, s, e, th in sl.host if n == SPAN and th == sl.thread]
    return sum(t) / sl.classifies if t else None
