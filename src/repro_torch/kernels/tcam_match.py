"""One layer of the tree walk per launch (``mode="layerwise"``: L launches
per classify).

Replaces the Pallas TPU kernel ``tcam_match_pallas_v``
(``src/repro/kernels/tcam_match.py:81``).  The kernel is CUDA C++ in
``csrc/tcam_match.cu``; the note at its top says what bounds it on an H100
and what its design does about that: eight lanes walk each (packet, tree)
and find the first match by ballot.  This module holds:

* ``tcam_match`` — the wrapper.  It takes the whole ``[V, L, T, E]`` walk
  record tensor and a layer index, so the layerwise walk copies no layer,
  and the kernel reads ``layer_shift[layer]`` on the device, so the host
  never waits for it.  On CUDA tensors it launches the kernel or raises; on
  CPU tensors it runs ``tcam_match_plain``.  ``tcam_match.launches`` counts
  launches.
* ``tcam_match_plain`` — the kernel's plain torch version on the same
  operands: layer ``layer`` of the decoded records through the twin
  ``ref.tcam_match_v``.
* ``geometry`` — the launch's shape, plain Python; the C entry refuses any
  other.
* ``empty_launch`` — an empty kernel launched the same way, the card's
  floor per launch (timed beside the kernels; it counts no launch).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.launch import launch, on_card
from repro_torch.kernels.tiling import WalkOperands, unpack_walk
from repro_torch.kernels.tree_walk import check_walk

__all__ = ["tcam_match", "tcam_match_plain", "geometry", "Geometry",
           "empty_launch", "SOURCE"]

SOURCE = "tcam_match"            # csrc/tcam_match.cu

# csrc/tcam_match.cu's constants
LANES = 8                        # lanes that walk one (packet, tree)
THREADS = 256                    # threads a block


class Geometry(NamedTuple):
    """One launch's shape (see ``geometry``)."""

    packets: int       # packets a block
    blocks: int        # the grid
    threads: int       # threads a block


def geometry(B: int, T: int) -> Geometry:
    """The kernel's launch for B packets of T trees: a group of ``LANES``
    lanes per (packet, tree), as many packets a block as give each of its
    ``THREADS // LANES`` groups a tree (at least one packet; a group walks
    more than one tree when T is larger); no shared memory."""
    if T < 1:
        raise ValueError(f"need a tree, got T {T}")
    pb = max(1, THREADS // LANES // T)
    return Geometry(pb, -(-B // pb), THREADS)


def tcam_match_plain(codes, features, vid, layer_shift, ops: WalkOperands,
                     layer: int):
    """The kernel's function in plain torch, on the kernel's operands."""
    tables = (x[:, layer] for x in unpack_walk(ops))
    return ref.tcam_match_v(codes, features, vid, *tables, layer_shift[layer])


def tcam_match(codes: torch.Tensor, features: torch.Tensor,
               vid: torch.Tensor, layer_shift: torch.Tensor,
               ops: WalkOperands, layer: int) -> torch.Tensor:
    """Layer ``layer`` of the walk for every tree, in one launch.

    codes int32 [B, T] (uint32 bits), features int32 [B, F], vid int32 [B],
    layer_shift int32 [L], ``ops`` the ``[V, L, T, E]`` walk records
    (``tiling.prep_walk``, or ``ExecImage.fused.walk``).  Returns the codes
    int32 [B, T] after that layer.
    """
    L = ops.entries.shape[1]
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} outside the records' [0, {L})")
    if not on_card("tcam_match", codes=codes, features=features, vid=vid,
                   layer_shift=layer_shift, **ops._asdict()):
        return tcam_match_plain(codes, features, vid, layer_shift, ops, layer)
    B, F, V, L, T, E = check_walk(codes, features, vid, layer_shift, ops)
    out = torch.empty((B, T), dtype=torch.int32, device=codes.device)
    if B == 0:
        return out
    launch(SOURCE, "acorn_tcam_match", codes.device, codes, features, vid,
           layer_shift, ops.entries, ops.n_entries, out, B, F, V, L, T, E,
           layer, geometry(B, T).packets)
    tcam_match.launches += 1
    return out


tcam_match.launches = 0


def empty_launch(device: torch.device, blocks: int = 1,
                 threads: int = 32) -> None:
    """Launch an empty kernel of ``blocks`` x ``threads`` on ``device``'s
    current stream, through the kernels' own launch path."""
    launch(SOURCE, "acorn_noop", device, blocks, threads)
