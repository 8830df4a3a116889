"""A dispatch's mean handoff to the thread pool: from a slot's pickup to
``_classify_flat`` starting on a pool thread
(``latency_stats()["mean_to_thread_ms"]``, over the window)."""
LAYER = "async front"
UNIT = "ms"
MOVES = "p99_ms"
KEY = "mean_to_thread_ms"


def read(reading):
    s = reading.stats
    return None if not s or KEY not in s else s[KEY]
