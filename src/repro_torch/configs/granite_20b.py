"""granite-20b [dense] — llama-arch, MQA (kv=1), code [arXiv:2405.04324; hf]. Copied from
src/repro/configs/granite_20b.py."""
from repro_torch.models.common import ArchConfig

ARCH = ArchConfig(
    name="granite-20b", family="dense",
    n_layers=52, d_model=6144, n_heads=48, n_kv=1, d_ff=24576, vocab=49152,
)
SMOKE = ARCH.scaled(n_layers=2, d_model=64, n_heads=4, n_kv=1, d_ff=128, vocab=256)
