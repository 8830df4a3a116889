"""The train step and the checkpointer.  Port of ``src/repro/train``."""
from repro_torch.train.checkpoint import Checkpointer
from repro_torch.train.step import loss_fn, make_train_step, microbatch_plan

__all__ = ["loss_fn", "make_train_step", "microbatch_plan", "Checkpointer"]
