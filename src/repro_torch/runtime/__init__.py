"""The runtime layer: one front door to the classify substrate (port of
``repro.runtime``: admission, the executor protocol, the single-switch
executor, the sequential-path executor, the ``DataplaneRuntime`` facade and
the batching policies, and ``control.py``, the self-healing control loop
over a fleet: ``ControlLoop``, ``ControlCounters``, ``DeviceFailure``).
``graphs.py`` is the port's own: the captured CUDA graph per admission
bucket that stands in for the reference's jit cache.  The reference's
multi-card executors are not ported yet."""
from repro_torch.runtime.admission import (
    bucket_ladder,
    bucket_size,
    coalesce,
    pad_to_bucket,
    split,
    trim,
)
from repro_torch.runtime.control import (
    ControlCounters,
    ControlLoop,
    DeviceFailure,
)
from repro_torch.runtime.executors import (
    Executor,
    SequentialPathExecutor,
    SingleSwitchExecutor,
)
from repro_torch.runtime.facade import DataplaneRuntime
from repro_torch.runtime.policies import (
    AdaptiveBucketPolicy,
    BatchingPolicy,
    ImmediatePolicy,
    SizeOrDeadlinePolicy,
    SloAutoscaler,
)

__all__ = [
    "DataplaneRuntime",
    "Executor",
    "SingleSwitchExecutor",
    "SequentialPathExecutor",
    "BatchingPolicy",
    "ImmediatePolicy",
    "SizeOrDeadlinePolicy",
    "AdaptiveBucketPolicy",
    "SloAutoscaler",
    "ControlLoop",
    "ControlCounters",
    "DeviceFailure",
    "bucket_size",
    "bucket_ladder",
    "pad_to_bucket",
    "trim",
    "coalesce",
    "split",
]
