"""Host time inside ``ZooServer.classify`` that no span of the program
names, in microseconds a classify: each ``acorn.classify`` span on the
benchmark's thread less the part of it the program's other spans cover
(its self time), summed over the traced slice, over the slice's
classifies."""
import bisect

from portbench import stats

LAYER = "serving front, admission and executor"
UNIT = "us"
MOVES = "packets_per_s"
SPAN = "acorn.classify"
PREFIX = "acorn."


def read(reading):
    sl = reading.slice
    if sl is None or not sl.classifies:
        return None
    mine = sorted((s, e, n) for n, s, e, th in sl.host
                  if th == sl.thread and n.startswith(PREFIX))
    starts = [s for s, _, _ in mine]
    total, found = 0.0, False
    for s, e, n in mine:
        if n != SPAN:
            continue
        found = True
        lo, hi = bisect.bisect_left(starts, s), bisect.bisect_right(starts, e)
        inner = [(a, b) for a, b, m in mine[lo:hi] if m != SPAN and b <= e]
        total += (e - s) - stats.union_length(inner)
    return total / sl.classifies if found else None
