"""The training side's distributed pieces.  Port of ``src/repro/distributed``
so far: ``compression`` (int8 gradient compression with error feedback).
The sharding specs (``sharding.py``) come with the mesh and the dry run
(Queue 1 item 9c)."""
from repro_torch.distributed.compression import (
    compress_decompress,
    dequantize_int8,
    init_error_feedback,
    quantize_int8,
)

__all__ = ["quantize_int8", "dequantize_int8", "compress_decompress",
           "init_error_feedback"]
