from repro_torch.serving.serve import (
    ZooServer,
    greedy_decode,
    make_decode_step,
    make_prefill_step,
)

__all__ = ["ZooServer", "greedy_decode", "make_decode_step",
           "make_prefill_step"]
