"""GQA decode attention (one new token against a ``kv_len``-masked KV
cache) in one launch: the LM decode step's attention, once per layer.

Replaces the Pallas TPU kernel ``decode_attn_pallas``
(``src/repro/kernels/decode_attn.py:82``).  The kernel is CUDA C++ in
``csrc/decode_attn.cu``; the note at its top says what bounds it on an H100
and what its design does about that (split-KV in one launch, a cp.async
ring, tensor cores in bf16).  This module holds:

* ``decode_attn`` — the wrapper.  On CUDA tensors it launches the kernel or
  raises; on CPU tensors it runs ``decode_attn_plain``.
  ``decode_attn.launches`` counts launches, ``decode_attn.mxu_launches``
  those of the ``mxu_native`` variant.  ``mxu_native=True`` (the
  reference's ``attn_mxu_native`` lever) keeps the softmax P in bf16 for
  P.V, as the reference casts it; in f32 it changes nothing.
* ``decode_attn_plain`` — the kernel's plain torch version on the same
  operands, the twin ``ref.decode_attn``.
* ``mxu_bound`` — how far two bf16-P attentions (the ``mxu_native``
  kernel and its plain version) may differ, element by element.
* ``work`` — one call's matmul flops and bytes, how a cost counter
  (``analysis.cost``) counts the call: a ``ctypes`` launch is invisible to
  a dispatch mode.
* ``plan`` — the launch geometry: query rows a block, keys a ring stage,
  how the cache splits into spans, shared memory.  Plain Python, so the CPU
  tests check it.

The scale ``D ** -0.5`` goes to the kernel as a C ``float`` argument.  Like
the TPU kernel, a row with ``kv_len <= 0`` gives zeros; ``kv_len`` past the
cache length reads the whole cache.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.launch import check, current_stream, launch, on_card

__all__ = ["decode_attn", "decode_attn_plain", "mxu_bound", "plan", "Plan",
           "work",
           "HEAD_DIMS", "SOURCE"]

SOURCE = "decode_attn"           # csrc/decode_attn.cu
HEAD_DIMS = (16, 32, 64, 128, 256)   # the kernel's instantiations
_DTYPES = {torch.bfloat16: 1, torch.float32: 0}
_ALIGN = 16                      # bytes: the kernel's widest vector load
# csrc/decode_attn.cu's constants (the C entry refuses a geometry it would
# not choose)
STAGES = 3                       # cp.async ring depth
PAD = 16                         # bytes after each staged row
TILE = {torch.bfloat16: 64, torch.float32: 32}   # keys a ring stage
# H100 SXM: SMs; shared memory an SM holds and a block may take; resident
# blocks by registers at <= 128 a thread
SMS = 132
SMEM_PER_SM = 233_472
SMEM_PER_BLOCK = 232_448
BLOCK_RESERVED = 1024            # shared memory the card keeps per block
MAX_RESIDENT = 4
WAVES = 2                        # the grid: two whole waves of resident blocks
MIN_SPLIT = 128                  # rows a span reads at least: a span's f32
                                 # partial stays small beside its K/V


class Plan(NamedTuple):
    """One launch's geometry (see ``plan``)."""

    qc: int            # query rows a block (a chunk of a KV head's G)
    n_chunks: int      # chunks per KV head, ceil(G / qc)
    tile: int          # keys a ring stage
    n_split: int       # spans the cache range [0, S) is cut into
    split_len: int     # rows a span, a multiple of ``tile``
    ws_rows: int       # query rows a span's partial holds, min(G, qc)
    smem: int          # dynamic shared memory a block, bytes
    resident: int      # blocks an SM holds at once (shared memory, registers)
    blocks: int        # the grid: B * Hkv * n_chunks * n_split


def plan(B: int, Hq: int, Hkv: int, D: int, S: int,
         dtype: torch.dtype) -> Plan:
    """The kernel's geometry for q [B, Hq, D] over a cache of S rows.

    bf16 runs on tensor cores with 16 query rows a block (G padded to 16,
    or cut into chunks of 16; at D above 128 the rows are staged in shared
    memory after the ring), f32 on CUDA cores with 1, 2, 4 or 8.  The cache splits
    into spans so that the grid holds at most ``WAVES`` times the blocks the
    card keeps resident (a whole number of waves), with no span shorter than ``MIN_SPLIT`` rows (or one
    tile), none starting past the cache, and no more than the merging block
    can weigh in shared memory."""
    G = Hq // Hkv
    bf16 = dtype == torch.bfloat16
    esize = 2 if bf16 else 4
    if bf16:
        qc, parts = 16, 4                       # 4 warps over the keys
    else:
        qc = 8 if G > 4 else 4 if G > 2 else G
        parts = 4 * (2 if D == 16 else 1)       # row groups
    n_chunks = -(-G // qc)
    tile = TILE[dtype]
    smem = max(STAGES * 2 * tile * (D * esize + PAD),
               parts * qc * (D + 2) * 4)
    if bf16 and D > 128:
        smem += qc * (D * esize + PAD)
    resident = max(1, min(SMEM_PER_SM // (smem + BLOCK_RESERVED),
                          MAX_RESIDENT))
    groups = B * Hkv * n_chunks
    # whole waves: a last, part-filled wave of blocks costs as much as a
    # full one
    want = WAVES * SMS * resident // max(groups, 1)
    most = max(1, -(-S // max(MIN_SPLIT, tile)))
    # the merging block holds each span's m and l per row in shared memory
    most = min(most, (smem // 4 - min(G, qc)) // (2 * min(G, qc)))
    n = max(1, min(want, most, 65535))
    split_len = max(tile, -(-math.ceil(S / n) // tile) * tile)
    n_split = max(1, -(-S // split_len))
    return Plan(qc, n_chunks, tile, n_split, split_len, min(G, qc), smem,
                resident, groups * n_split)


# (device, stream handle) -> int32 arrival counters, zeroed
_COUNTERS: dict = {}


def _counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """At least ``n`` zeroed int32 counters for the launches on ``stream``
    (a handle, the current stream of ``device``), kept across calls: the
    kernel leaves them zero, so they are filled once, by ``torch.zeros`` on
    that same current stream, ahead of the launch that reads them.  Each
    (device, stream) has its own: the last span block of a group is the one
    whose ``atomicAdd`` on its group's counter sees ``n_split - 1``, so two
    launches in flight at once on two streams must not count on the same
    counters.  Launches on one stream run in order and share them."""
    key = (device, stream)
    c = _COUNTERS.get(key)
    if c is None or c.numel() < n:
        c = _COUNTERS[key] = torch.zeros(max(n, 1024), dtype=torch.int32,
                                         device=device)
    return c


def work(q: torch.Tensor, k: torch.Tensor,
         kv_len: torch.Tensor) -> tuple[float, float]:
    """(matmul flops, bytes) of one call: QK and PV over each row's
    ``kv_len`` cache rows, 4 * Hq * D a row, and q, the K and V rows read
    and the output.  On fake or ``meta`` tensors ``kv_len``'s values are
    unknown, and every row counts the whole cache (the dry run's decode
    sits at the cache's last row, where that is exact); on real ones
    reading them waits for the card."""
    B, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    from torch._subclasses.fake_tensor import is_fake
    if kv_len.device.type == "meta" or is_fake(kv_len):
        rows = B * S
    else:
        rows = int(kv_len.clamp(0, S).sum())
    esize = q.element_size()
    return (4.0 * Hq * D * rows,
            float(2 * q.numel() * esize + 2 * rows * Hkv * D * k.element_size()))


def decode_attn_plain(q, k, v, kv_len, *, mxu_native=False):
    """The kernel's function in plain torch, on the kernel's operands."""
    return ref.decode_attn(q, k, v, kv_len, mxu_native=mxu_native)


def mxu_bound(q, k, v, kv_len, want) -> torch.Tensor:
    """The bound, element by element, of an ``mxu_native`` attention (bf16)
    against ``want``, another one on the same inputs: one bf16 ulp of
    ``want`` (each rounds its f32 output once) plus 2^-7 sum_t P_t |V_t|
    (each rounds every weight P_t to bf16 once, within 2^-8 of it, bf16's
    unit roundoff: the kernel the online softmax's unnormalised exp(s - m),
    the plain version, like the reference, the normalised P).  float32,
    ``want``'s shape."""
    w = want.float().abs()
    ulp = (torch.nextafter(w, torch.full_like(w, float("inf"))) - w) * 2.0 ** 16
    pv = ref.decode_attn(q.float(), k.float(), v.float().abs(), kv_len)
    return ulp + 2.0 ** -7 * pv


def decode_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                kv_len: torch.Tensor, *,
                mxu_native: bool = False) -> torch.Tensor:
    """Attention of q [B, Hq, D] over the cache k/v [B, S, Hkv, D] (all
    bfloat16 or all float32, contiguous), row b over its first
    ``kv_len[b]`` positions (int32 [B]); query head h reads KV head
    ``h // (Hq // Hkv)``.  Returns [B, Hq, D] in q's dtype.
    ``mxu_native``: P in bf16 for P.V (bfloat16 only; a no-op in f32)."""
    if not on_card("decode_attn", q=q, k=k, v=v, kv_len=kv_len):
        return decode_attn_plain(q, k, v, kv_len, mxu_native=mxu_native)
    if q.dtype not in _DTYPES:
        raise TypeError(f"q: dtype {q.dtype}, kernel takes bfloat16 or "
                        "float32")
    if q.dim() != 3 or k.dim() != 4:
        raise ValueError(f"q {tuple(q.shape)} must be [B, Hq, D] and k "
                         f"{tuple(k.shape)} [B, S, Hkv, D]")
    B, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D}: the kernel takes {HEAD_DIMS}")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"{Hq} query heads are not a multiple of {Hkv} KV "
                         "heads")
    for name, x, dtype, shape in (
            ("q", q, q.dtype, (B, Hq, D)),
            ("k", k, q.dtype, (B, S, Hkv, D)),
            ("v", v, q.dtype, (B, S, Hkv, D)),
            ("kv_len", kv_len, torch.int32, (B,))):
        check(name, x, dtype, shape)
    out = torch.empty_like(q)
    for name, x in (("q", q), ("k", k), ("v", v), ("out", out)):
        if x.data_ptr() % _ALIGN:
            raise ValueError(f"{name} is not {_ALIGN}-byte aligned")
    if B == 0:
        return out
    p = plan(B, Hq, Hkv, D, S, q.dtype)
    if p.smem > SMEM_PER_BLOCK:
        raise ValueError(f"{p.smem} bytes of shared memory a block")
    groups = B * Hkv * p.n_chunks
    ws = torch.empty(groups * p.n_split * p.ws_rows * (D + 4)
                     if p.n_split > 1 else 1, dtype=torch.float32,
                     device=q.device)
    stream = current_stream(q.device)
    launch(SOURCE, "acorn_decode_attn", q.device, q, k, v, kv_len, out, ws,
           _counters(q.device, stream, groups), B, S, Hq, Hkv, D,
           _DTYPES[q.dtype], int(mxu_native and q.dtype == torch.bfloat16),
           p.qc, p.tile, p.n_split, p.split_len, p.ws_rows,
           p.smem, D ** -0.5, stream=stream)
    decode_attn.launches += 1
    if mxu_native and q.dtype == torch.bfloat16:
        decode_attn.mxu_launches += 1
    return out


decode_attn.launches = 0
decode_attn.mxu_launches = 0     # of those, the mxu_native variant's
