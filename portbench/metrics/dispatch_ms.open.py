"""A dispatch's mean time, from its start to its results on the host: the
serving front, admission and the executor as the front sees them
(``latency_stats()["mean_dispatch_ms"]``, over the window)."""
LAYER = "serving front, admission and executor"
UNIT = "ms"
MOVES = "p99_ms"


def read(reading):
    s = reading.stats
    return None if not s or "mean_dispatch_ms" not in s \
        else s["mean_dispatch_ms"]
