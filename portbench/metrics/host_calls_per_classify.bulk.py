"""The host's calls that put work on the card (``cudaGraphLaunch``,
``cudaLaunchKernel``, ``cudaMemcpyAsync``) a classify, in the traced
slice."""
LAYER = "serving front, admission and executor"
UNIT = "calls"
MOVES = "packets_per_s"


def read(reading):
    sl = reading.slice
    if sl is None or not sl.classifies or not sl.device:
        return None
    return sl.host_calls() / sl.classifies
