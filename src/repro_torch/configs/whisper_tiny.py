"""whisper-tiny [audio] — enc-dec; conv frontend STUB [arXiv:2212.04356; unverified].

input_specs() provides precomputed frame embeddings [B, 1500, 384] — the
modality frontend is a stub per the assignment; the transformer backbone
(4L encoder + 4L decoder with cross-attention) is real.
Copied from src/repro/configs/whisper_tiny.py.
"""
from repro_torch.models.common import ArchConfig

ARCH = ArchConfig(
    name="whisper-tiny", family="encdec",
    n_layers=4, d_model=384, n_heads=6, n_kv=6, d_ff=1536, vocab=51865,
    n_enc_layers=4, enc_seq=1500, rope_theta=10_000.0,
)
SMOKE = ARCH.scaled(n_layers=2, d_model=64, n_heads=4, n_kv=4, d_ff=128,
                    vocab=256, n_enc_layers=2, enc_seq=16)
