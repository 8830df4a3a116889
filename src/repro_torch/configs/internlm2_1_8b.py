"""internlm2-1.8b [dense] — GQA kv=8 [arXiv:2403.17297; hf]. Copied from
src/repro/configs/internlm2_1_8b.py."""
from repro_torch.models.common import ArchConfig

ARCH = ArchConfig(
    name="internlm2-1.8b", family="dense",
    n_layers=24, d_model=2048, n_heads=16, n_kv=8, d_ff=8192, vocab=92544,
)
SMOKE = ARCH.scaled(n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=128, vocab=256)
