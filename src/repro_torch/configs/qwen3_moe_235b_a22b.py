"""qwen3-moe-235b-a22b [moe] — 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B; hf].

head_dim=128 per the HF config (q/k/v projections are decoupled from
d_model in qwen3).
Copied from src/repro/configs/qwen3_moe_235b_a22b.py.
"""
from repro_torch.models.common import ArchConfig

ARCH = ArchConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv=4, d_ff=1536, vocab=151936,
    head_dim=128, n_experts=128, top_k=8, moe_d_ff=1536,
)
SMOKE = ARCH.scaled(n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=128,
                    vocab=256, head_dim=16, n_experts=8, top_k=2, moe_d_ff=64)
