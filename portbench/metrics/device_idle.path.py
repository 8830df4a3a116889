"""The share of the traced slice in which nothing ran on the card, in
percent: one less the union of its activity intervals over the slice."""
LAYER = "device"
UNIT = "%"
MOVES = "packets_per_s"


def read(reading):
    sl = reading.slice
    if sl is None or not sl.device or sl.window_s <= 0:
        return None
    return 100.0 * (1.0 - sl.busy_s / sl.window_s)
