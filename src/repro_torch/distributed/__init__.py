"""The training side's distributed pieces.  Port of ``src/repro/distributed``:
``compression`` (int8 gradient compression with error feedback) and
``sharding`` (the FSDP x TP partition specs over the production mesh,
imported from ``repro_torch.distributed.sharding``)."""
from repro_torch.distributed.compression import (
    compress_decompress,
    dequantize_int8,
    init_error_feedback,
    quantize_int8,
)

__all__ = ["quantize_int8", "dequantize_int8", "compress_decompress",
           "init_error_feedback"]
