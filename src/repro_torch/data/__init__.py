"""Dataset substrate: seeded synthetic stand-ins for the paper's datasets
(``synth``, copied from ``repro.data.synth``).  The LM token pipeline of the
JAX package waits for the LM slice."""
from repro_torch.data.synth import DATASETS, load_dataset, make_classification

__all__ = ["DATASETS", "load_dataset", "make_classification"]
