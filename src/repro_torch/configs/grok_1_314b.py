"""grok-1-314b [moe] — 8 experts top-2 [hf:xai-org/grok-1; unverified]. Copied from
src/repro/configs/grok_1_314b.py."""
from repro_torch.models.common import ArchConfig

ARCH = ArchConfig(
    name="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv=8, d_ff=32768, vocab=131072,
    n_experts=8, top_k=2, moe_d_ff=32768,
)
SMOKE = ARCH.scaled(n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=128,
                    vocab=256, n_experts=4, top_k=2, moe_d_ff=128)
