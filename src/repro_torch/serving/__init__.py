from repro_torch.serving.async_server import AsyncResult, AsyncZooServer
from repro_torch.serving.engine import ContinuousZooServer
from repro_torch.serving.fleet import FleetExecutor, FleetRuntime
from repro_torch.serving.loadgen import LoadReport, arrival_times, open_loop
from repro_torch.serving.serve import (
    ZooServer,
    greedy_decode,
    make_decode_step,
    make_prefill_step,
)

__all__ = ["AsyncResult", "AsyncZooServer", "ContinuousZooServer",
           "FleetExecutor", "FleetRuntime", "LoadReport", "ZooServer",
           "arrival_times", "greedy_decode", "make_decode_step",
           "make_prefill_step", "open_loop"]
