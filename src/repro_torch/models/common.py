"""Shared pieces of the LM: the arch config, RMS norm, RoPE, initializers.

Port of ``src/repro/models/common.py``.  ``ArchConfig`` is copied field for
field (``tdtype`` takes the place of ``jdtype``); the functions work on
torch tensors with the JAX package's layouts and dtypes:

* ``rope`` builds its inverse frequencies in float64 numpy and multiplies
  them in float32, as JAX does with x64 off (torch would promote
  f32 x f64 to f64, so the frequencies are cast first);
* ``apply_rope`` rotates the two halves of the head dim, not interleaved
  pairs;
* ``rms_norm`` scales by ``1 + scale`` (zeros at init).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

__all__ = ["ArchConfig", "rms_norm", "rope", "apply_rope", "dense_init",
           "DTYPES"]

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """One architecture = one instance of this config
    (``src/repro_torch/configs/``)."""

    name: str
    family: str                 # dense | moe | hybrid | rwkv | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int | None = None
    rope_theta: float = 1_000_000.0
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    # --- hybrid (RecurrentGemma): layer i is attention iff i % 3 == 2 ---
    window: int = 0             # local-attention window (0 = full causal)
    lru_dim: int = 0            # RG-LRU recurrence width
    conv_width: int = 4
    # --- enc-dec (whisper): frontend is a STUB; encoder sees frame embeds ---
    n_enc_layers: int = 0
    enc_seq: int = 0
    # --- compute / perf levers ---
    moe_impl: str = "onehot"     # "sort" = sort-based dispatch
    attn_k_chunk: int = 0        # >0 = online-softmax (flash) attention
    attn_mxu_native: bool = False  # bf16 matmul inputs + f32 accumulation
    dtype: str = "bfloat16"
    # long_500k applicability: sub-quadratic families only
    subquadratic: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def tdtype(self) -> torch.dtype:
        return DTYPES[self.dtype]

    def scaled(self, **kw) -> "ArchConfig":
        """Reduced config of the same family (per-arch smoke tests)."""
        return dataclasses.replace(self, **kw)

    # -------- parameter count (MODEL_FLOPS = 6*N*D in the roofline) --------
    def param_count(self) -> int:
        D, V = self.d_model, self.vocab
        hd, Hq, Hkv = self.hd, self.n_heads, self.n_kv
        n = V * D  # embedding
        n += V * D  # lm head (untied)
        per_layer_attn = D * (Hq * hd) + 2 * D * (Hkv * hd) + (Hq * hd) * D
        if self.family == "dense" or self.family == "encdec":
            per_layer = per_layer_attn + 3 * D * self.d_ff + 2 * D
            n += self.n_layers * per_layer
            if self.family == "encdec":
                # encoder layers + decoder cross-attention
                n += self.n_enc_layers * (per_layer_attn + 3 * D * self.d_ff + 2 * D)
                n += self.n_layers * per_layer_attn  # cross-attn blocks
        elif self.family == "moe":
            per_layer = per_layer_attn + 3 * D * self.moe_d_ff * self.n_experts
            per_layer += D * self.n_experts + 2 * D  # router + norms
            n += self.n_layers * per_layer
        elif self.family == "hybrid":
            n_attn = self.n_layers // 3
            n_rec = self.n_layers - n_attn
            rec_layer = 2 * D * self.lru_dim + self.lru_dim * D  # in gate(x2) + out
            rec_layer += self.conv_width * self.lru_dim + 2 * self.lru_dim * self.lru_dim  # conv + gates
            n += n_attn * per_layer_attn + n_rec * rec_layer
            n += self.n_layers * (3 * D * self.d_ff + 2 * D)
        elif self.family == "rwkv":
            tm = 5 * D * D + 2 * D * (D // 16)  # wr,wk,wv,wg,wo + decay lora
            cm = D * D + 2 * D * self.d_ff      # cr + ck + cv
            n += self.n_layers * (tm + cm + 2 * D)
        return int(n)

    def active_param_count(self) -> int:
        """MoE: experts replaced by top_k-worth of FFN compute."""
        if self.family != "moe":
            return self.param_count()
        D = self.d_model
        dense_like = self.param_count()
        dense_like -= self.n_layers * 3 * D * self.moe_d_ff * self.n_experts
        dense_like += self.n_layers * 3 * D * self.moe_d_ff * self.top_k
        return int(dense_like)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + scale.float())).to(dt)


@functools.lru_cache(maxsize=None)
def _rope_freqs(head_dim: int, theta: float,
                device: torch.device) -> torch.Tensor:
    """RoPE's frequencies [head_dim/2], built in float64 as JAX builds them
    and kept in float32 on ``device``: copied there once, not per step."""
    freqs = 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))
    return torch.from_numpy(freqs.astype(np.float32)).to(device)


def rope(positions: torch.Tensor, head_dim: int,
         theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """positions [..., S] -> (sin, cos) [..., S, head_dim/2], float32."""
    freqs = _rope_freqs(head_dim, theta, positions.device)
    ang = positions[..., None].float() * freqs
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor,
               cos: torch.Tensor) -> torch.Tensor:
    """x [..., S, H, D]; sin/cos [..., S, D/2] broadcast over heads."""
    x1, x2 = x.float().chunk(2, dim=-1)
    s, c = sin[..., None, :], cos[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def dense_init(generator: torch.Generator, shape, dtype: torch.dtype,
               scale: float | None = None) -> torch.Tensor:
    """Normal draws scaled by ``fan_in ** -0.5`` (or ``scale``), on the
    generator's device, in ``dtype``.  The draws are torch's, not
    ``jax.random``'s: carry JAX weights across with
    ``transformer.params_from_numpy``."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    s = scale if scale is not None else fan_in ** -0.5
    return (torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device) * s).to(dtype)
