"""rwkv6-7b [ssm] — Finch, data-dependent decay [arXiv:2404.05892; hf].

Attention-free; 64 heads of size 64.  Constant-size state => runs long_500k.
Copied from src/repro/configs/rwkv6_7b.py.
"""
from repro_torch.models.common import ArchConfig

ARCH = ArchConfig(
    name="rwkv6-7b", family="rwkv",
    n_layers=32, d_model=4096, n_heads=64, n_kv=64, d_ff=14336, vocab=65536,
    subquadratic=True,
)
SMOKE = ARCH.scaled(n_layers=2, d_model=64, n_heads=4, n_kv=4, d_ff=128, vocab=256)
