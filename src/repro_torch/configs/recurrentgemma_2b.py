"""recurrentgemma-2b [hybrid] — RG-LRU + local attn, 1:2 [arXiv:2402.19427; hf].

26 layers = 8 (rec, rec, attn) superblocks + 2 trailing recurrent layers;
local-attention window 2048; RG-LRU width = d_model.  Sub-quadratic =>
runs long_500k.
Copied from src/repro/configs/recurrentgemma_2b.py.
"""
from repro_torch.models.common import ArchConfig

ARCH = ArchConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv=1, d_ff=7680, vocab=256000,
    head_dim=256, window=2048, lru_dim=2560, subquadratic=True,
)
SMOKE = ARCH.scaled(n_layers=5, d_model=64, n_heads=4, n_kv=1, d_ff=128,
                    vocab=256, head_dim=16, window=8, lru_dim=64)
