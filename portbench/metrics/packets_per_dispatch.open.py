"""Packets the front coalesces into one dispatch, on average
(``latency_stats()["mean_batch_packets"]``, over the window)."""
LAYER = "async front"
UNIT = "packets"
MOVES = "p99_ms"


def read(reading):
    s = reading.stats
    return None if not s or "mean_batch_packets" not in s \
        else s["mean_batch_packets"]
