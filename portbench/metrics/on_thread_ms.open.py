"""A dispatch's mean time on its pool thread, ``_classify_flat`` from
start to return: the executor's lock, admission, the replay and the copy
out (``latency_stats()["mean_on_thread_ms"]``, over the window)."""
LAYER = "serving front, admission and executor"
UNIT = "ms"
MOVES = "p99_ms"
KEY = "mean_on_thread_ms"


def read(reading):
    s = reading.stats
    return None if not s or KEY not in s else s[KEY]
