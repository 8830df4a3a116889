"""A cut's mean wait for a free dispatch slot: from the cut handed to the
slot queue to a slot worker picking it up
(``latency_stats()["mean_slot_wait_ms"]``, over the window)."""
LAYER = "async front"
UNIT = "ms"
MOVES = "p99_ms"
KEY = "mean_slot_wait_ms"


def read(reading):
    s = reading.stats
    return None if not s or KEY not in s else s[KEY]
