"""A dispatch's mean wait for the executor's lock on its pool thread: the
program's ``lock`` span, which the two slots' dispatches share
(``latency_stats()["mean_lock_wait_ms"]``, over the window)."""
LAYER = "serving front, admission and executor"
UNIT = "ms"
MOVES = "p99_ms"
KEY = "mean_lock_wait_ms"


def read(reading):
    s = reading.stats
    return None if not s or KEY not in s else s[KEY]
