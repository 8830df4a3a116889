"""The runtime layer: one front door to the classify substrate (port of
``repro.runtime``: admission, the executor protocol, the single-switch
executor, the sequential-path executor and the ``DataplaneRuntime``
facade)."""
from repro_torch.runtime.admission import (
    bucket_ladder,
    bucket_size,
    coalesce,
    pad_to_bucket,
    split,
    trim,
)
from repro_torch.runtime.executors import (
    Executor,
    SequentialPathExecutor,
    SingleSwitchExecutor,
)
from repro_torch.runtime.facade import DataplaneRuntime

__all__ = ["DataplaneRuntime", "Executor", "SequentialPathExecutor",
           "SingleSwitchExecutor",
           "bucket_ladder", "bucket_size", "coalesce", "pad_to_bucket",
           "split", "trim"]
