"""starcoder2-15b [dense] — GQA kv=4, RoPE [arXiv:2402.19173; hf]. Copied from
src/repro/configs/starcoder2_15b.py."""
from repro_torch.models.common import ArchConfig

ARCH = ArchConfig(
    name="starcoder2-15b", family="dense",
    n_layers=40, d_model=6144, n_heads=48, n_kv=4, d_ff=24576, vocab=49152,
)
SMOKE = ARCH.scaled(n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=128, vocab=256)
