"""The least time of the slice's work over the slice's wall time, in
percent: the whole classify step's share of the card's peak."""
LAYER = "classify step"
UNIT = "%"
MOVES = "packets_per_s"


def read(reading):
    sl = reading.slice
    if sl is None or sl.work is None or not sl.device or sl.window_s <= 0:
        return None
    return 100.0 * sl.work.least_s / sl.window_s
