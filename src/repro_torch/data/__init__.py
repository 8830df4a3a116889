"""Dataset substrate: seeded synthetic stand-ins for the paper's datasets
(``synth``, copied from ``repro.data.synth``) and the deterministic,
resumable LM token pipeline of the training loop (``tokens``, copied from
``repro.data.tokens``)."""
from repro_torch.data.synth import DATASETS, load_dataset, make_classification
from repro_torch.data.tokens import TokenPipeline

__all__ = ["DATASETS", "load_dataset", "make_classification", "TokenPipeline"]
