"""chameleon-34b [vlm] — early-fusion, VQ image tokens [arXiv:2405.09818; unverified].

Early fusion means image patches arrive as ordinary token ids from a frozen
VQ tokenizer — the modality frontend is a STUB; the backbone is a dense GQA
decoder whose vocab already contains the VQ codes.
Copied from src/repro/configs/chameleon_34b.py.
"""
from repro_torch.models.common import ArchConfig

ARCH = ArchConfig(
    name="chameleon-34b", family="dense",
    n_layers=48, d_model=8192, n_heads=64, n_kv=8, d_ff=22016, vocab=65536,
)
SMOKE = ARCH.scaled(n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=128, vocab=256)
