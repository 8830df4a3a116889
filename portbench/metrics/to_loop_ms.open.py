"""A dispatch's mean hop back to the event loop: from ``_classify_flat``
returning on its thread to the slot coroutine resuming
(``latency_stats()["mean_to_loop_ms"]``, over the window)."""
LAYER = "async front"
UNIT = "ms"
MOVES = "p99_ms"
KEY = "mean_to_loop_ms"


def read(reading):
    s = reading.stats
    return None if not s or KEY not in s else s[KEY]
