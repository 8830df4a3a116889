"""The share of the admitted packets that are admission's padding, in
percent: the buckets' packets less the requests' over the buckets', summed
over the dispatches (``latency_stats()["pad_share"]``, over the window)."""
LAYER = "serving front, admission and executor"
UNIT = "%"
MOVES = "p99_ms"
KEY = "pad_share"


def read(reading):
    s = reading.stats
    return None if not s or KEY not in s else 100.0 * s[KEY]
