"""The front's median queue wait: from a request's submit to the dispatch
that carries it (``latency_stats()["p50_wait_ms"]``, over the window)."""
LAYER = "async front"
UNIT = "ms"
MOVES = "p99_ms"


def read(reading):
    s = reading.stats
    return None if not s or "p50_wait_ms" not in s else s["p50_wait_ms"]
