#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one card and check them.

    python3 chip_smoke.py [--seed N]

Runs from the repository root (it puts ``src`` on ``sys.path`` itself) and
needs one CUDA card; without one, or without the port's sources beside it,
it exits non-zero and prints no result.  It imports nothing of JAX or of the
JAX package.  Phases, each fatal on failure:

1. build   — ``nvcc`` compiles the seven ``src/repro_torch/csrc/*.cu``
             sources for sm_90a, all at once; prints the seconds and the
             ``-Xptxas -v`` summary of each.
2. kernel  — random full-width tables for four zoo slots (one empty) at
             B in {1, 300, 4096}: the fused kernel's codes, labels and SVM
             sums must equal the torch twin's bit for bit.
3. stages  — random full-width tables at the same batches, then at the
             staged kernels' geometry edges (B 1, B just past a block's
             packets, T 1, 3 and 33, H 1 and 16, L 13, P 1 and 9, C 33):
             ``tree_walk``,
             ``tcam_match`` (at the first, a middle and the last layer),
             ``forest_vote`` (on codes that hit leaves) and ``svm_lookup``
             (with a bias and features outside [0, levels)) each equal
             their plain version bit for bit; ``tcam_match`` also on rows
             of length 0, 1, 8, 9 and 20 (a hit at the last valid entry or
             none, matching records past the row), shifts 3, 31 and 32.
4. attn    — ``decode_attn`` against its plain version on the
             ``tests/test_kernels.py`` sweep and at internlm2-1.8b's full
             width (B 16, 16 query and 8 KV heads of 128, S 4096), each in
             bf16 and f32, within the JAX package's tolerances on the sweep
             and one bf16 ulp at full width, a bound that two wrong
             attentions must fail; at granite-20b's heads (48 query, 1 KV)
             at B 16 and internlm2-1.8b's at B 4 over a 32768 cache; at
             kv_len on and beside the kernel's tile and span edges, 0 and
             S; rows with ``kv_len = 0`` give zeros; at the LM families'
             decode shapes (``ATTN_FAMILIES``: recurrentgemma-2b's D 256
             over its window of 2048 and over 96, qwen3-moe's G 16 over
             4096 and 96, grok-1's G 6 over 4096, whisper-tiny's G 1 over
             96 and over its 1500-row encoder cache), random and on the
             edges, bf16 and f32; then
             at the two further shapes on two streams at once (launches of
             both in flight together, each holding its own arrival
             counters), every output within the full-width bound; last,
             the ``mxu_native`` variant (P in bf16 for P.V, the
             reference's ``attn_mxu_native``) against its plain version
             within ``mxu_bound`` (one bf16 ulp + 2^-7 sum P|V|) at the
             full width (the two wrong attentions refused), on its edges,
             at the two further shapes and the families' shapes, each
             output unlike the default kernel's; in f32 the flag changes
             nothing, bit for bit.
5. path    — a zoo at the paper's profile (``PlaneProfile(max_versions=4)``)
             built with the port's own models and translator: an 8-tree
             random forest and a deeper decision tree on the cicids-17
             stand-in, a one-vs-rest linear SVM on the digits stand-in, and
             an empty slot.  4096 requests (10% FORWARD passthrough with
             intermediates) through ``ZooServer`` on the card, and ragged
             batches through ``classify`` and ``classify_coalesced``; all
             bit-identical to ``SwitchEngine(mode="ref")``, DT/RF equal to
             ``predict``, SVM within the fixed-point slack, the empty slot
             answers -1, passthrough untouched, one launch per classify
             and, where ``classify`` stages the request as a byte record,
             one ``expand_request`` launch ahead of it.
6. staged  — the same zoo and traffic through ``ZooServer(mode="unfused")``
             (3 launches per classify: walk, vote, SVM sums) and
             ``ZooServer(mode="layerwise")`` (L + 2: one ``tcam_match`` per
             layer), held to ``mode="ref"`` the same way.
7. multi   — ``plan_zoo`` places the three versions over ``fat_tree(4)``,
             host to host, on switches of 40 stage slots; the hop programs
             (``build_zoo_device_programs``) run in path order through
             ``DataplaneRuntime(SequentialPathExecutor(...))`` in the fused
             and the layerwise mode: rslt, codes and svm_acc equal the
             single switch in ``mode="ref"``, with hops x 1 and
             hops x (L + 2) launches.
8. lm      — LM decode serving through ``repro_torch.launch.serve.serve``
             at internlm2-1.8b's full width (seeded random weights): B 16,
             a 64-token prompt fed through decode steps, 32 greedy tokens,
             2 tenant swaps written in place; 24 ``decode_attn`` launches
             per step.  Then, per tenant and teacher-forced over the same
             tokens, every step's logits against the same steps with the
             twin attention (``mode="ref"``) and against the port's
             ``forward`` in bf16, and (last tenant) the f32 model's decode
             against its f32 ``forward`` and the bf16 decode against it;
             wrong attentions held to the same bounds must fail them.
9. timing  — CUDA events over many launches at B = 4096: each classify
             kernel and ``expand_request`` (phase 5's request as a record,
             F 60, T 8, H 12; equal to its plain version bit for bit), its
             plain version, one PyTorch library call where one
             computes the same function, and the bound from the bytes this
             run's data touches; requests/s end to end through
             ``ZooServer`` in the three modes and through the multi-switch
             runtime.  The full-width decode step with the cache filled to
             ``kv_len`` 4096 at B 16: ms per step, tokens/s, ``decode_attn``
             per launch against its bound, plain version and
             ``scaled_dot_product_attention`` (and the same for the
             ``mxu_native`` variant), and a profiler table; the
             same for ``decode_attn`` at the two further shapes of phase 4;
             each kernel's gap to its bound, launch geometry, and every
             kernel's registers and shared memory; the card's
             floor per launch (``launch_floor_ms``: an empty kernel at
             ``tcam_match``'s grid, at ``forest_vote``'s and at one block,
             launched and timed the same way).  Every classify step twice:
             through the graph path (the executors' default: a captured
             CUDA graph per admission bucket) and through executors built
             with ``graphs=False``; per step the wall time, requests/s,
             busy time and ``cudaLaunchKernel`` / ``cudaMemcpyAsync`` /
             ``cudaGraphLaunch`` calls under the profiler with the host
             time of each of the program's spans (``acorn.*``), and one
             in-place slot install and evict in ms.
10. graphs — the graph path held on the card: replay == eager ==
             ``SwitchEngine(mode="ref")`` on rslt, codes and svm_acc for
             all 204 conformance draws (``repro_torch.data.conformance``)
             in the fused, unfused and layerwise modes, every draw a replay
             of a warmed bucket with exactly the mode's launches; the same
             for the planned path (fused, layerwise) at B 4096 and B 1, 7,
             63, 64, 65, 4095; one replay under the profiler runs exactly
             the mode's kernels (x hops) and one ``cudaGraphLaunch``;
             install, evict, evict, reinstall between replays show in the
             next replay with no resident ``data_ptr`` moved and no entry
             added; ``cache_size()`` == the warmed ladder's length and
             ragged replays add nothing; two threads replaying at once;
             ``--capture-failure`` as a child process must exit nonzero
             (beside it, ``ncu``'s attempt for phase 9).
11. fronts — ``AsyncZooServer`` and ``ContinuousZooServer`` bit-identical
             to the sync classify on the zoo's traffic (1-64-packet
             requests); the closed-loop rate of ``ContinuousZooServer``
             (n_slots 2, 64 clients); ``open_loop`` (Poisson) at 0.25-1.0
             of that rate, each load with the server's own split of a
             dispatch (``latency_stats()``: the wait for a slot, to the
             thread, on it, the executor's lock, back to the loop, the
             buckets' padding) and the garbage collector's pauses.
12. fleet  — the zoo of phase 5 deployed by ``FleetRuntime`` over
             ``fat_tree(4)`` between two pods on switches of 40 stage
             slots (5 hosting hops), on its hop pool: B 4096 in the fused
             and layerwise modes == ``mode="ref"`` with hops x 1 and
             hops x (L + 2) launches a replay, ms a batch; a retarget to
             the 3-hop deployment of 60-slot switches and back (one graph
             per hosting count, none added on the revisit, no resident
             ``data_ptr`` moved); the 8 seeded fault schedules of the
             conformance lane (``repro_torch.data.conformance``) served
             live through ``fleet.serving()`` in both modes, the kills
             landing mid-phase, every answer == ``mode="ref"``, each heal
             counted and the dead switches off the new path; the
             closed-loop rate through the fleet's front, then ``open_loop``
             at 0.5 of it with a hosting core switch killed 1 s in: no
             errors, every answer == ``mode="ref"``, the heal split into
             replan / drain / reinstall, the first post-heal dispatch,
             p50/p99 before and after; the src's edge switch killed:
             ``heal()`` raises and ``heal_failures == 1``.
13. lanes  — the pipelined and sharded executors, every lane on this
             card on a stream of its own: ``PipelinedExecutor`` over phase
             7's 5 hop programs (n_micro 8), ``ShardedExecutor`` over them
             with 2 ports (n_micro 4), and over the full zoo with 4 ports
             (n_micro 1), each in the fused and layerwise modes through
             ``DataplaneRuntime``: the ladder warmed to 4096, then B 4096,
             1, 7, 509 and 4095 == ``mode="ref"`` with n_micro x switches x
             ports x the mode's launches, ``cache_size()`` the ladder's
             length before and after; a swap to the zoo with vid 0 evicted
             and back shown in the next replay, no resident ``data_ptr``
             moved; a ``ContinuousZooServer`` over a lane pool of
             ``ShardedExecutor``s at 1, 2 and 4 ports under an impossible
             SLO widens to 4 with every answer == ``mode="ref"``; with
             more than one card, the same checks with lanes on distinct
             cards.  Beside phase 7's sequential path: ms a batch,
             requests/s, and under the profiler busy us, one
             ``cudaGraphLaunch`` a replay, and how the lanes' kernels
             overlap on the card.
14. examples — every ``examples/torch_port/*.py`` as a child process on
             the card, all at once: each exits 0; its seconds and the tail
             of its output.
15. families — qwen3-moe-235b-a22b (4 of its 94 layers: the card's 80
             GB), recurrentgemma-2b, rwkv6-7b and whisper-tiny, each at
             full width, one after another (each freed before the next)
             through ``launch.serve.serve``: B 16, 64 prompt + 32 greedy
             tokens, 2 tenants swapped in place; exact ``decode_attn``
             launches (attention layers x steps); the last tenant
             teacher-forced through the kernel, every launch held to the
             plain version at the full-width bound and the served tokens
             its argmax; whisper-tiny in bf16 and every family on an f32
             copy held against the twin and against ``forward`` (moe
             without drops there), a wrong attention refused by both
             bounds; RWKV by depth through ``decode_step`` (its state
             dropped as the control) and layer by layer; ms a step at
             kv_len 96 against its ``roofline_terms`` bound (the moe's
             experts as routed), the device's busy share;
             recurrentgemma-2b at 2 superblocks, B 4, its ring of 2048
             slots wrapped (2112 positions, the last 64 held to
             ``forward``'s window mask); ``decode_attn`` timed at the
             families' shapes beside its plain version and SDPA.
16. train  — the training stack through ``launch/train.py``'s functions:
             internlm2-1.8b at full width and depth (bf16 weights, f32
             AdamW state by the launcher's rule, remat on), seq 4096,
             global batch 8, n_micro 4; one warm-up and 5 timed steps, the
             loss of each, step 1's batch again after them (it must be
             below its loss at step 1: 6 warm-up steps do not move the
             stream's loss beyond its noise), ms a step,
             tokens/s, the ``model_flops`` bound and its share (mfu), peak
             memory, one step under the profiler (busy share, top ops) and
             ``adamw_update`` alone; no kernel launched on this path (every
             count 0: training's attention is the plain f32 one, as in the
             reference).  Then one f32 step of each family's smoke config
             on the card against the same step on the CPU (loss, gradients,
             grad_norm and the updated weights at the CPU tests' f32
             bounds; gradients and grad_norm x 1.01 refused).  Last, as a
             child with deterministic algorithms, internlm2-1.8b at full
             width and 2 layers: 4 steps straight against 2, a checkpoint
             saved and restored into other weights, and 2 more, bit-equal.

17. mxu    — internlm2-1.8b with ``attn_mxu_native`` through
             ``launch.serve.serve`` at full width (B 16, 64 + 32 tokens, 2
             tenants; 24 mxu_native ``decode_attn`` launches a step, counted
             apart as ``decode_attn_mxu_native``), each tenant
             teacher-forced: every launch held to the mxu_native plain
             version at ``mxu_bound``, the logits to the mxu_native twin's
             at phase 8's bound, the served tokens their argmax, the
             default kernel's decode unlike it, a wrong attention refused;
             the step at kv_len 4096 with and without the flag, 10 pairs
             of windows in alternating order.
             Then the dry run (``launch/dryrun.py``) over its 80 cells
             (every one ``ok`` and fitting the card or ``skip`` as
             ``applicable`` says), and device (0, 0) of the 16 x 16 mesh
             held on this card for grok-1-314b ``train_4k`` and
             qwen3-moe-235b-a22b ``decode_32k``: every shard allocated and
             zeroed, the allocator's growth the dry run's
             ``analytic_bytes_per_device`` within its rounding per tensor.

18. costs  — the dry run counted (``launch/dryrun.py``, each cell's real
             step on ``meta`` DTensors over a fake process group,
             ``analysis.cost.CostCounter``): the 40 one-pod cells and four
             at two pods, in six processes, every status as
             ``applicable`` says and every ``ok`` record's counted fields
             filled; phase 16's full-width train step (counted on the card
             in its warm-up step) and phase 9's decode step (B 16, kv_len
             4096, counted after its timing) against the dry run's count of
             the same step on a 1 x 1 mesh: the flops equal, the train
             step's peak within 10% of the card's ``max_memory_allocated``,
             24 ``decode_attn`` ops a decode step; each step's bound from
             its counted flops and bytes beside its measured ms.

Each main path (5, 6, 7, 8, 11, 12, 13, 15, 16, 17, and phase 18's
counted decode step) runs with every kernel's launch count set to 0 just
before it and read just after; a kernel of the path that never launched
fails the run, and so does any launch on phase 16's path.  A replayed graph adds the launches its capture
counted.  Output: a ``paths`` JSON line, a ``kernels`` JSON line (with
``launch_floor_ms``), the card's name and power limit, and last
``{"ok": true, "device": {...}}``.  ``--two-streams`` runs only phase 4's
two-stream check, against the sources beside the script;
``--capture-failure`` only phase 10's failing capture; ``--families``
only the build, phase 4's family shapes and phase 15; ``--train`` only the
build and phase 16 (``--train-resume``: its child); ``--mxu`` only the
build, phase 4's mxu_native part and phase 17.  Every bound comes
from ``repro_torch.analysis.roofline`` (``HW()``: the H100's peaks).
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src"
FULL = dict(max_versions=4)      # the paper's default profile, four slots
FEATURES = 60
SVM_KW = dict(multi_class="ovr", C=1e4, lr=0.01, epochs=400)
BATCH = 4096                     # requests per batch on the main paths
SWITCH_STAGES = 40               # stage slots per switch of the multi path
REPLACES = {                     # the TPU kernel each CUDA kernel replaces
    "classify_fused": "src/repro/kernels/classify_fused.py:166",
    "tree_walk": "src/repro/kernels/tree_walk.py:94",
    "tcam_match": "src/repro/kernels/tcam_match.py:81",
    "forest_vote": "src/repro/kernels/forest_vote.py:69",
    "svm_lookup": "src/repro/kernels/svm_lookup.py:71",
    "decode_attn": "src/repro/kernels/decode_attn.py:82",
    "expand_request": "none",    # the note atop csrc/request_record.cu
}
SOURCES = {"expand_request": "request_record"}   # where not the wrapper's name
MODES = (None, "unfused", "layerwise")   # the classify modes of the paths
RAGGED = (1, 7, 63, 64, 65, 4095)        # ragged sizes replayed in phase 10
KERNEL_FN = {                    # each wrapper's __global__ function
    "classify_fused": "classify_fused_kernel", "tree_walk": "tree_walk_kernel",
    "tcam_match": "tcam_match_kernel", "forest_vote": "forest_vote_kernel",
    "svm_lookup": "svm_lookup_kernel", "decode_attn": "attn_",
    "expand_request": "expand_request_kernel"}
LOADS = (0.25, 0.5, 0.75, 1.0)   # open-loop offered load / closed-loop rate
FLEET_SRC, FLEET_DST = "h0_0_0", "h2_0_0"   # phase 12: two pods apart
FLEET_STAGES = 40                # stage slots a switch: the zoo on 5 hops
FLEET_STAGES_ALT = 60            # the retarget's other deployment: 3 hops
FLEET_LOAD = 0.5                 # open-loop load of the kill run / closed rate
FLEET_SECONDS = 2.0              # arrivals scheduled in the kill run
LOAD_SECONDS = 2.0               # arrivals scheduled per offered load
CLIENTS = 64                     # closed-loop clients of phase 11
LM_ARCH = "internlm2-1.8b"
MXU = "decode_attn_mxu_native"   # decode_attn's variant with P in bf16
# phase 17: the production mesh's device (0, 0) held on the card in two
# 1-pod cells of the dry run; the caching allocator hands a tensor a block
# of its bytes rounded up to 512, or past 1 MiB a whole block of up to 2 MiB
MESH_CELLS = (("grok-1-314b", "train_4k"),
              ("qwen3-moe-235b-a22b", "decode_32k"))
ALLOC_ROUND = 2 ** 21
LM_SERVE = dict(batch=16, prompt_len=64, gen=32, swaps=2)
LM_CACHE = 4096                  # kv_len of the timed decode step
# (atol, rtol): decode_attn vs its plain version.  On the sweep, the JAX
# package's own (tests/test_kernels.py:178); the integer kernels are exact.
ATTN_TOL = {"bfloat16": (2e-2, 1e-2), "float32": (2e-5, 1e-2)}
# At full width a row of long kv_len gives outputs of ~0.03 (a softmax over
# up to 4096 rows), where atol 2e-2 would pass almost any answer.  Kernel and plain version both sum
# in f32 and round once to the output dtype: bf16 is held to one unit in the
# last place of the plain version's output (rtol 2**-7), f32 as on the sweep.
# Two wrong attentions must fail this bound in every run (attn_controls).
ATTN_TOL_FULL = {"bfloat16": (1e-5, 2 ** -7), "float32": (2e-5, 1e-2)}
# two more full-width shapes (B, Hq, Hkv, D, S): granite-20b's MQA heads
# (G 48), and internlm2-1.8b's at a 32768 cache with B * Hkv = 32 groups,
# the case splitting the cache exists for (537 MB of K/V in bf16)
ATTN_WIDE = {"granite-20b heads, B 16, kv_len 4096": (16, 48, 1, 128, 4096),
             "internlm2-1.8b heads, B 4, kv_len 32768": (4, 16, 8, 128, 32768)}
# the LM families' decode shapes (B, Hq, Hkv, D, S), phase 4 and phase 15:
# recurrentgemma-2b's local attention (D 256) over its window, over the 96
# positions phase 15 serves (one span of 128 rows, no merge) and over the
# ring phase 15 wraps (B 4); qwen3-moe's G 16 at kv_len 4096 and at the
# served 96, grok-1's G 6 at 4096, whisper-tiny's self attention (G 1) over
# the served 96 positions and its cross attention over the 1500-row encoder
# cache (a multiple of no tile)
ATTN_FAMILIES = {
    "recurrentgemma-2b heads (D 256), B 16 over its window of 2048":
        (16, 10, 1, 256, 2048),
    "recurrentgemma-2b heads (D 256), B 16, kv_len 96": (16, 10, 1, 256, 96),
    "recurrentgemma-2b heads (D 256), B 4 over the wrapped ring of 2048":
        (4, 10, 1, 256, 2048),
    "qwen3-moe heads (G 16), B 16, kv_len 4096": (16, 64, 4, 128, 4096),
    "qwen3-moe heads (G 16), B 16, kv_len 96": (16, 64, 4, 128, 96),
    "grok-1 heads (G 6), B 16, kv_len 4096": (16, 48, 8, 128, 4096),
    "whisper-tiny self attention (G 1), B 16, kv_len 96": (16, 6, 6, 64, 96),
    "whisper-tiny cross attention (G 1), B 16 over 1500 rows":
        (16, 6, 6, 64, 1500)}
# full-width logits, teacher-forced: the kernel's decode against the twin's,
# no looser than the JAX package's decode bound (tests/test_models_lm.py:72)
DECODE_TOL = (0.12, 0.05)
# ... and against the port's forward over the same tokens: bf16 at the same
# bound, f32 at the CPU tests' (measured on an H100: 0.1016, 2.0e-5, 0.0916;
# PERF.md).  The bf16 bounds are sanity bounds; the f32 one gates the
# kernel's precision.  Each must refuse a wrong attention (lm_check_phase).
FORWARD_TOL = {"bf16 decode vs bf16 forward": (0.12, 0.05),
               "f32 decode vs f32 forward": (1e-4, 1e-4),
               "bf16 decode vs f32 forward": (0.12, 0.05)}


T_START = time.perf_counter()


def bound_ms(nbytes: float, flops: float = 0.0) -> float:
    """The least ms one card could take to move ``nbytes`` through HBM and
    do ``flops`` at the bf16 tensor-core peak: ``roofline_terms`` with the
    H100's peaks (``repro_torch.analysis.roofline.HW``)."""
    from repro_torch.analysis import roofline_terms

    return roofline_terms(hlo_flops=flops, hlo_bytes=nbytes,
                          collective_wire_bytes=0.0,
                          chips=1)["step_s_lower_bound"] * 1e3


def hbm_tb_s() -> str:
    from repro_torch.analysis import HW

    return f"{HW().hbm_gbps / 1e12:g} TB/s"


def phase(name: str) -> None:
    print(f"== {name} (at {time.perf_counter() - T_START:.1f} s)",
          flush=True)


def stamp(what: str) -> None:
    print(f"   ({what} at {time.perf_counter() - T_START:.1f} s)", flush=True)


def kernels():
    """Every kernel wrapper of the port, by name (each counts its launches
    in ``.launches``)."""
    from repro_torch.kernels.classify_fused import classify_fused
    from repro_torch.kernels.decode_attn import decode_attn
    from repro_torch.kernels.forest_vote import forest_vote
    from repro_torch.kernels.request_record import expand_request
    from repro_torch.kernels.svm_lookup import svm_lookup
    from repro_torch.kernels.tcam_match import tcam_match
    from repro_torch.kernels.tree_walk import tree_walk

    return {"classify_fused": classify_fused, "tree_walk": tree_walk,
            "tcam_match": tcam_match, "forest_vote": forest_vote,
            "svm_lookup": svm_lookup, "decode_attn": decode_attn,
            "expand_request": expand_request}


def launches() -> dict:
    """Each wrapper's count, and ``MXU``: the launches of ``decode_attn``'s
    mxu_native variant (counted in ``decode_attn`` too)."""
    from repro_torch.kernels.decode_attn import decode_attn

    return {**{k: f.launches for k, f in kernels().items()},
            MXU: decode_attn.mxu_launches}


def zero_launches() -> None:
    from repro_torch.kernels.decode_attn import decode_attn

    for f in kernels().values():
        f.launches = 0
    decode_attn.mxu_launches = 0


# ----------------------------------------------------------------- phases
def build_phase():
    from repro_torch.kernels.build import build

    libs = build(*(SOURCES.get(k, k) for k in kernels()))
    for name, lib in libs.items():
        print(f"built {lib.path.name} in {lib.build_seconds:.2f} s")
        for line in lib.log.splitlines():
            if "ptxas" in line:
                print("  " + line.strip())
    return libs


def random_tables(rng, prof, torch, device, empty_slot):
    """Random full-width source tables (uint32 as int32 bits)."""
    import numpy as np

    V, L, T = prof.max_versions, prof.max_layers, prof.max_trees
    E, P, F = prof.max_entries_per_layer, prof.max_leaves, prof.max_features
    H, C, lv = prof.max_hyperplanes, prof.max_classes, prof.levels
    shape = (V, L, T, E)

    def t(a, dtype=None):
        return torch.from_numpy(a if dtype is None else a.astype(dtype)).to(device)

    flo = rng.integers(0, lv - 1, shape)
    valid = rng.random(shape) < 0.9
    pred_valid = rng.random((V, T, P)) < 0.9
    lut = rng.integers(-60_000, 60_000, (V, H, F, lv))
    valid[empty_slot] = False
    pred_valid[empty_slot] = False
    lut[empty_slot] = 0
    pc = np.sort(rng.choice(2**16, size=V * T * P, replace=False)
                 .reshape(V, T, P), axis=2)
    return dict(
        code_value=t(rng.integers(0, 2**6, shape), np.int32),
        code_mask=t(rng.integers(0, 2**6, shape), np.int32),
        fid=t(rng.integers(0, F, shape), np.int32),
        f_lo=t(flo, np.int32),
        f_hi=t(flo + rng.integers(0, lv // 2, shape), np.int32),
        set_bit=t(rng.integers(0, 2, shape), np.int32),
        valid=t(valid), layer_shift=t(rng.permutation(L), np.int32),
        pred_codes=t(pc, np.int32), pred_labels=t(rng.integers(0, C, (V, T, P)), np.int32),
        pred_valid=t(pred_valid), weights=t(rng.random((V, T)), np.float32),
        lut=t(lut, np.int32), bias=t(np.zeros((V, H)), np.int32))


def kernel_phase(prof, seed, device):
    import numpy as np
    import torch
    from repro_torch.kernels import ref, tiling
    from repro_torch.kernels.classify_fused import classify_fused

    rng = np.random.default_rng(seed)
    tabs = random_tables(rng, prof, torch, device, empty_slot=2)
    ops_ = tiling.prep_classify_fused(*(tabs[k] for k in (
        "code_value", "code_mask", "fid", "f_lo", "f_hi", "set_bit", "valid",
        "pred_codes", "pred_labels", "pred_valid", "weights", "lut", "bias")))
    C = prof.max_classes
    for B in (1, 300, BATCH):
        codes = torch.from_numpy(rng.integers(0, 2**12, (B, prof.max_trees))
                                 .astype(np.int32)).to(device)
        feats = torch.from_numpy(rng.integers(0, prof.levels, (B, prof.max_features))
                                 .astype(np.int32)).to(device)
        vid = torch.from_numpy(rng.integers(0, prof.max_versions, B)
                               .astype(np.int32)).to(device)
        got = classify_fused(codes, feats, vid, tabs["layer_shift"], ops_, C)
        want = ref.classify_fused_v(
            codes, feats, vid, tabs["code_value"], tabs["code_mask"],
            tabs["fid"], tabs["f_lo"], tabs["f_hi"], tabs["set_bit"],
            tabs["valid"], tabs["layer_shift"], tabs["pred_codes"],
            tabs["pred_labels"], tabs["pred_valid"], tabs["weights"],
            tabs["lut"], tabs["bias"], C)
        torch.cuda.synchronize()
        for name, g, w in zip(("codes", "label", "sums"), got, want):
            if not torch.equal(g, w):
                bad = int((g != w).sum())
                raise AssertionError(f"kernel != twin at B={B}: {name} "
                                     f"differs in {bad} places")
        hits = int((got[0] != codes).any(dim=1).sum())
        print(f"B={B}: kernel == twin bit for bit "
              f"({hits} packets changed codes, {int((vid == 2).sum())} "
              "on the empty slot)")


# the staged kernels' geometry edges beside the full-width batches: (B,
# profile fields): B 1; B just past a block's packets (tcam_match: 4 at 8
# trees, 10 at 3; svm_lookup: 8; tree_walk and forest_vote: 2 at 8 trees
# from B 528 on, 6 at 3 from B 1584, 16 at 1 from B 4224); T 3 and 33 (a
# lane group walks more than one tree); H 1 and H at svm_lookup.MAX_H (16);
# L 13 (two chunks of the walk's 8 layers, the last part-filled); P 9 and
# P 1 (the leaf search's rounds); C 33 (two chunks of the vote's classes)
STAGE_EDGES = [
    (5, dict(max_hyperplanes=16)),
    (11, dict(max_trees=3, max_hyperplanes=1, max_features=10,
              max_layers=4)),
    (9, dict(max_hyperplanes=16, max_entries_per_layer=9, max_layers=3)),
    (40, dict(max_trees=33, max_hyperplanes=5, max_features=13,
              max_entries_per_layer=17, max_layers=3)),
    (529, dict(max_layers=13)),
    (1585, dict(max_trees=3, max_features=10, max_layers=4, max_leaves=9,
                max_classes=33)),
    (4225, dict(max_trees=1, max_leaves=1, max_layers=13)),
]


def stage_phase(prof, seed, device):
    """Each staged kernel against its plain version on random tables (the
    operand image the plane would install): at full width at B in {1, 300,
    4096}, then at the geometry edges (``STAGE_EDGES``), then
    ``tcam_match`` on rows at its lane groups' edges (``tcam_edge_rows``)."""
    import numpy as np
    import torch
    from repro_torch.kernels import tiling
    from repro_torch.kernels.forest_vote import forest_vote, forest_vote_plain
    from repro_torch.kernels.svm_lookup import svm_lookup, svm_lookup_plain
    from repro_torch.kernels.tcam_match import tcam_match, tcam_match_plain
    from repro_torch.kernels.tree_walk import tree_walk, tree_walk_plain

    rng = np.random.default_rng(seed + 7)

    def same(what, got, want):
        torch.cuda.synchronize()
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            if not torch.equal(g, w):
                raise AssertionError(f"{what} != its plain version in "
                                     f"{int((g != w).sum())} places")

    def ints(lo, hi, shape):
        return torch.from_numpy(rng.integers(lo, hi, shape)
                                .astype(np.int32)).to(device)

    cases = [(B, {}) for B in (1, 300, BATCH)] + STAGE_EDGES
    for B, fields in cases:
        p = dataclasses.replace(prof, **fields)
        tabs = random_tables(rng, p, torch, device, empty_slot=2)
        V, T, L = p.max_versions, p.max_trees, p.max_layers
        lv, H = p.levels, p.max_hyperplanes
        bias = ints(-10_000, 10_000, (V, H))
        img = tiling.prep_classify_fused(*(tabs[k] for k in (
            "code_value", "code_mask", "fid", "f_lo", "f_hi", "set_bit",
            "valid", "pred_codes", "pred_labels", "pred_valid", "weights",
            "lut")), bias)
        shift, C = tabs["layer_shift"], p.max_classes
        codes = ints(0, 2**12, (B, T))
        feats = ints(0, lv, (B, p.max_features))
        vid = ints(0, V, B)
        same(f"tree_walk B={B}", tree_walk(codes, feats, vid, shift, img.walk),
             tree_walk_plain(codes, feats, vid, shift, img.walk))
        for layer in (0, L // 2, L - 1):
            same(f"tcam_match B={B} layer={layer}",
                 tcam_match(codes, feats, vid, shift, img.walk, layer),
                 tcam_match_plain(codes, feats, vid, shift, img.walk, layer))
        # codes that hit a leaf of their version (80%), else stay random
        v = vid.long()
        hits = img.pred_codes[v[:, None], torch.arange(T, device=device),
                              ints(0, p.max_leaves, (B, T)).long()]
        leaf_codes = torch.where(ints(0, 5, (B, T)) > 0, hits, codes)
        got = forest_vote(leaf_codes, vid, img.leaves, C)
        same(f"forest_vote B={B}", got,
             forest_vote_plain(leaf_codes, vid, img.leaves, C))
        # features outside [0, levels), above and below, add 0
        wide = torch.where(ints(0, 10, feats.shape) == 0,
                           ints(lv, lv + 100, feats.shape), feats)
        wide[::7, 0] = -1
        same(f"svm_lookup B={B}", svm_lookup(wide, vid, img.svm),
             svm_lookup_plain(wide, vid, img.svm))
        print(f"B={B} T={T} H={H} F={p.max_features} E="
              f"{p.max_entries_per_layer}: tree_walk, tcam_match (layers 0, "
              f"{L // 2}, {L - 1}), forest_vote ({int((got[1] != 0).sum())} "
              "leaf hits) and svm_lookup == plain bit for bit")
    for shift in (3, 31, 32):
        codes, feats, vid, ops_ = tcam_edge_rows(20, torch, device)
        sh = torch.tensor([shift], dtype=torch.int32, device=device)
        got = tcam_match(codes, feats, vid, sh, ops_, 0)
        same(f"tcam_match edge rows, shift {shift}", got,
             tcam_match_plain(codes, feats, vid, sh, ops_, 0))
        changed = int((got[0] != codes[0]).sum())
        print(f"tcam_match on rows of length 0, 1, 8, 9, 20 (hit at the "
              f"last valid entry or none), shift {shift}: == plain, "
              f"{changed} of {codes.shape[1]} rows set the bit")


def tcam_edge_rows(E, torch, device):
    """One version, one layer, a tree per row: lengths 0, 1, 8, 9 (one
    lane group's round and one past it) and E, each with a hit at its last
    valid entry and with none; two hits in one round, the first with
    set_bit 0; a hit in a later round; every record past a row's length
    would match.  Packets: code 0b101, features 5; vids 0, -1 and 1."""
    lengths, hits = [], []
    for n in (1, 8, 9, E):
        lengths += [n, n]
        hits += [[n - 1], []]
    lengths += [0, 8, E]
    hits += [[], [2, 5], [11, 17]]
    T = len(lengths)
    rec = torch.zeros((1, 1, T, E, 4), dtype=torch.int32)
    rec[..., 0], rec[..., 1] = 0b010, 0b111
    rec[..., 2], rec[..., 3] = 5 << 16, 5 | (1 << 16)
    for t, (n, hit) in enumerate(zip(lengths, hits)):
        rec[0, 0, t, n:, 0] = 0b101
        for e in hit:
            rec[0, 0, t, e, 0] = 0b101
        if hit == [2, 5]:
            rec[0, 0, t, 2, 3] = 5
    from repro_torch.kernels.tiling import WalkOperands

    ops_ = WalkOperands(rec.to(device), torch.tensor(
        lengths, dtype=torch.int32, device=device).reshape(1, 1, T))
    codes = torch.full((3, T), 0b101, dtype=torch.int32, device=device)
    feats = torch.full((3, 4), 5, dtype=torch.int32, device=device)
    vid = torch.tensor([0, -1, 1], dtype=torch.int32, device=device)
    return codes, feats, vid, ops_


def close(got, want, atol, rtol):
    """(max |got - want|, whether |got - want| <= atol + rtol |want|
    everywhere), in float32."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    return float(err.max()), bool((err <= atol + rtol * w.abs()).all())


def attn_inputs(gen, B, Hq, Hkv, D, S, dtype, device):
    """Random q, k, v and kv_len drawn from [1, S], with a row at 1 and a
    row at S where B > 1."""
    import torch

    q = torch.randn(B, Hq, D, generator=gen, device=device).to(dtype)
    k = torch.randn(B, S, Hkv, D, generator=gen, device=device).to(dtype)
    v = torch.randn(B, S, Hkv, D, generator=gen, device=device).to(dtype)
    kv_len = torch.randint(1, S + 1, (B,), generator=gen, device=device,
                           dtype=torch.int32)
    if B > 1:
        kv_len[0], kv_len[-1] = 1, S
    return q, k, v, kv_len


def attn_controls(ins, want, within):
    """Two wrong attentions that a full-width bf16 bound (``within(got)``:
    (max abs err, within the bound)) must refuse: the plain version's f32
    softmax with its P.V sum accumulated in bf16 (each row added in turn),
    and the plain version with each row's newest cached position dropped
    (``kv_len - 1`` where ``kv_len > 1``).  Prints their errors and whether
    the JAX package's bound would have passed them."""
    import torch
    from repro_torch.kernels.decode_attn import decode_attn_plain

    q, k, v, kv_len = ins
    B, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    qg = q.reshape(B, Hkv, Hq // Hkv, D).float()
    logits = torch.einsum("bhgd,bshd->bhgs", qg, k.float()) * D ** -0.5
    mask = torch.arange(S, device=q.device)[None, :] < kv_len[:, None]
    p = torch.softmax(logits.masked_fill(~mask[:, None, None], float("-inf")),
                      dim=-1)
    acc = torch.zeros_like(qg, dtype=torch.bfloat16)
    vt = v.transpose(1, 2)
    for s in range(int(kv_len.max())):
        acc = acc + (p[..., s, None] * vt[:, :, None, s].float()).bfloat16()
    wrong = {
        "P.V accumulated in bf16": acc.reshape(B, Hq, D),
        "newest row dropped": decode_attn_plain(
            q, k, v, torch.where(kv_len > 1, kv_len - 1, kv_len)),
    }
    for what, got in wrong.items():
        err, ok = within(got)
        jax_ok = close(got, want, *ATTN_TOL["bfloat16"])[1]
        print(f"  control, {what}: max abs err {err:.3g}: "
              f"{'PASSES' if ok else 'refused'}; the JAX package's bound "
              f"would {'pass' if jax_ok else 'refuse'} it")
        if ok:
            raise AssertionError(f"the full-width bound passes a wrong "
                                 f"attention ({what})")


def hold_attn(what, got, want, tol):
    """Fail unless ``got`` is within (atol, rtol) of ``want``."""
    import torch

    torch.cuda.synchronize()
    err, ok = close(got, want, *tol)
    print(f"{what}: max abs err {err:.3g} (atol {tol[0]:.3g}, rtol "
          f"{tol[1]:.3g})")
    if not ok or got.dtype != want.dtype:
        raise AssertionError(f"decode_attn != its plain version: {what}")
    return err


def mxu_within(got, want, ins):
    """(max abs err, within ``mxu_bound`` everywhere, the largest error
    over its bound): the mxu_native variant's bound against another bf16-P
    attention on ``ins``."""
    import torch
    from repro_torch.kernels.decode_attn import mxu_bound

    err = (got.float() - want.float()).abs()
    over = err / mxu_bound(*ins, want)
    torch.cuda.synchronize()
    return float(err.max()), bool((over <= 1).all()) and (
        got.dtype == want.dtype), float(over.max())


def mxu_attn_phase(gen, device):
    """The mxu_native variant (P in bf16 for P.V, as the reference's
    ``attn_mxu_native``) against its plain version within ``mxu_bound``:
    at internlm2-1.8b's full width (B 16, S 4096; the two wrong attentions
    refused), with a row per kv_len on internlm2's tile and span edges, at
    ``ATTN_WIDE`` and at the families' shapes (``ATTN_FAMILIES``); every
    output differs from the default kernel's on the same inputs (the flag
    reaches the kernel), and f32 with the flag equals the default kernel
    bit for bit.  Returns {shape: max abs err}."""
    import torch
    from repro_torch.kernels.decode_attn import (
        decode_attn,
        decode_attn_plain,
        plan,
    )

    bf16 = torch.bfloat16
    full = f"{LM_ARCH} heads, B 16, kv_len {LM_CACHE}"
    shapes = {full: (16, 16, 8, 128, LM_CACHE), **ATTN_WIDE, **ATTN_FAMILIES}

    def cases():
        for what, shape in shapes.items():
            yield what, attn_inputs(gen, *shape, bf16, device)
            if what == full:   # a row per kv_len on the plan's edges
                B, Hq, Hkv, D, S = shape
                lens = edge_lengths(plan(11, Hq, Hkv, D, S, bf16), S)
                p = plan(len(lens), Hq, Hkv, D, S, bf16)
                lens = edge_lengths(p, S)
                q, k, v, _ = attn_inputs(gen, len(lens), Hq, Hkv, D, S, bf16,
                                         device)
                yield (f"  edges: {p.n_split} spans of {p.split_len}, "
                       f"kv_len {lens}", (q, k, v, torch.tensor(
                           lens, dtype=torch.int32, device=device)))

    errs = {}
    for what, ins in cases():
        got = decode_attn(*ins, mxu_native=True)
        want = decode_attn_plain(*ins, mxu_native=True)
        err, ok, over = mxu_within(got, want, ins)
        share = float((got != decode_attn(*ins)).float().mean())
        print(f"mxu_native {what}: max abs err {err:.3g}, {over:.3f} of "
              "mxu_bound at most; "
              f"{100 * share:.1f}% of the outputs differ from the default "
              "kernel's")
        if not ok:
            raise AssertionError(f"decode_attn mxu_native != its plain "
                                 f"version at {what}")
        if share == 0:
            raise AssertionError(f"decode_attn mxu_native gives the default "
                                 f"kernel's output at {what}")
        errs[what] = err
        if what == full:
            attn_controls(ins, want,
                          lambda bad: mxu_within(bad, want, ins)[:2])
        del ins, got, want
    ins32 = attn_inputs(gen, 16, 16, 8, 128, LM_CACHE, torch.float32, device)
    if not torch.equal(decode_attn(*ins32, mxu_native=True),
                       decode_attn(*ins32)):
        raise AssertionError("decode_attn mxu_native in f32 is not the "
                             "default kernel")
    print("mxu_native in f32 == the default kernel, bit for bit")
    return errs


def edge_lengths(p, S):
    """kv_len at, beside and between a plan's tile and span edges, 0 and
    S."""
    edges = {0, 1, p.tile - 1, p.tile, p.tile + 1, p.split_len - 1,
             p.split_len, p.split_len + 1, 2 * p.split_len, S - 1, S}
    return sorted(x for x in edges if 0 <= x <= S)


def edge_phase(gen, device):
    """The split-KV kernel at internlm2-1.8b's and granite-20b's heads
    (S 4096), one row per kv_len at and beside the tile and span edges, 0
    and S, held to the full-width bound; rows of kv_len 0 give zeros."""
    import torch
    from repro_torch.kernels.decode_attn import (
        decode_attn,
        decode_attn_plain,
        plan,
    )

    for Hq, Hkv in ((16, 8), (48, 1)):
        for dtype in (torch.bfloat16, torch.float32):
            S, D = LM_CACHE, 128
            lens = edge_lengths(plan(11, Hq, Hkv, D, S, dtype), S)
            p = plan(len(lens), Hq, Hkv, D, S, dtype)
            lens = edge_lengths(p, S)
            q, k, v, _ = attn_inputs(gen, len(lens), Hq, Hkv, D, S, dtype,
                                     device)
            kv_len = torch.tensor(lens, dtype=torch.int32, device=device)
            got = decode_attn(q, k, v, kv_len)
            hold_attn(f"edges Hq {Hq} Hkv {Hkv} {dtype}, {p.n_split} spans "
                      f"of {p.split_len}, tiles of {p.tile}, kv_len {lens}",
                      got, decode_attn_plain(q, k, v, kv_len),
                      ATTN_TOL_FULL[str(dtype).removeprefix("torch.")])
            if not torch.equal(got[0], torch.zeros_like(got[0])):
                raise AssertionError("decode_attn: kv_len 0 is not zeros")


def family_attn_phase(gen, device):
    """``decode_attn`` at the LM families' shapes (``ATTN_FAMILIES``), in
    bf16 and f32, against its plain version at the full-width bound: once
    with random kv_len (rows at 1 and S among them), once with a row per
    kv_len at and beside the plan's tile and span edges, 0 and S (rows of
    kv_len 0 give zeros)."""
    import torch
    from repro_torch.kernels.decode_attn import (
        decode_attn,
        decode_attn_plain,
        plan,
    )

    for name, (B, Hq, Hkv, D, S) in ATTN_FAMILIES.items():
        for dtype in (torch.bfloat16, torch.float32):
            tol = ATTN_TOL_FULL[str(dtype).removeprefix("torch.")]
            ins = attn_inputs(gen, B, Hq, Hkv, D, S, dtype, device)
            hold_attn(f"{name} {dtype}", decode_attn(*ins),
                      decode_attn_plain(*ins), tol)
            lens = edge_lengths(plan(11, Hq, Hkv, D, S, dtype), S)
            p = plan(len(lens), Hq, Hkv, D, S, dtype)
            lens = edge_lengths(p, S)
            q, k, v, _ = attn_inputs(gen, len(lens), Hq, Hkv, D, S, dtype,
                                     device)
            kv_len = torch.tensor(lens, dtype=torch.int32, device=device)
            got = decode_attn(q, k, v, kv_len)
            hold_attn(f"  edges: {p.n_split} spans of {p.split_len}, tiles "
                      f"of {p.tile}, {p.qc} query rows a block, "
                      f"{p.smem:,} bytes of shared memory, kv_len {lens}",
                      got, decode_attn_plain(q, k, v, kv_len), tol)
            if not torch.equal(got[0], torch.zeros_like(got[0])):
                raise AssertionError("decode_attn: kv_len 0 is not zeros")
            del ins, q, k, v


def two_streams(seed, device, rounds=6, per_round=8):
    """``decode_attn`` launched on two streams at once, at the two phase 4
    shapes that split the cache (``ATTN_WIDE``): each round both streams
    sleep on the card while the host enqueues ``per_round`` launches on
    each, alternating, so the two streams' launches run together; every
    output is held to the plain version at the full-width bf16 bound.
    Returns {shape: (launches, wrong outputs)}; raises nothing itself."""
    import torch
    from repro_torch.kernels.decode_attn import (
        decode_attn,
        decode_attn_plain,
        plan,
    )

    gen = torch.Generator(device=device).manual_seed(seed + 19)
    cyc = sleep_cycles_per_ms(torch)
    streams = [torch.cuda.Stream(device) for _ in range(2)]
    tol = ATTN_TOL_FULL["bfloat16"]
    found = {}
    for name, shape in ATTN_WIDE.items():
        p = plan(*shape, torch.bfloat16)
        ins = [attn_inputs(gen, *shape, torch.bfloat16, device)
               for _ in streams]
        want = [decode_attn_plain(*x) for x in ins]
        torch.cuda.synchronize()
        bad = total = 0
        worst = 0.0
        for _ in range(rounds):
            outs = [[] for _ in streams]
            for s in streams:
                with torch.cuda.stream(s):
                    torch.cuda._sleep(int(5 * cyc))
            for _ in range(per_round):
                for i, s in enumerate(streams):
                    with torch.cuda.stream(s):
                        outs[i].append(decode_attn(*ins[i]))
            torch.cuda.synchronize()
            for i, got in enumerate(outs):
                for o in got:
                    err, ok = close(o, want[i], *tol)
                    worst = max(worst, err)
                    bad += not ok
                    total += 1
        found[name] = (total, bad)
        print(f"two streams at once, {name}: {p.n_split} spans a group, "
              f"{total} launches, {bad} outputs outside the full-width bound "
              f"(max abs err {worst:.3g})")
        del ins, want
        torch.cuda.empty_cache()
    return found


def attn_phase(seed, device):
    """decode_attn against its plain version: the tests/test_kernels.py:166
    sweep and the full width, each in bf16 and f32."""
    import torch
    from repro_torch.kernels.decode_attn import decode_attn, decode_attn_plain

    gen = torch.Generator(device=device).manual_seed(seed + 11)
    shapes = [(2, 4, 4, 16, 33), (3, 8, 2, 32, 128), (1, 16, 8, 64, 700),
              (16, 16, 8, 128, LM_CACHE)]
    for shape in shapes:
        for dtype in (torch.bfloat16, torch.float32):
            ins = attn_inputs(gen, *shape, dtype, device)
            got = decode_attn(*ins)
            want = decode_attn_plain(*ins)
            torch.cuda.synchronize()
            full = shape == shapes[-1]
            tol = (ATTN_TOL_FULL if full else ATTN_TOL)[
                str(dtype).removeprefix("torch.")]
            err, ok = close(got, want, *tol)
            print(f"(B, Hq, Hkv, D, S) = {shape} {dtype}: max abs err "
                  f"{err:.3g} (atol {tol[0]:.3g}, rtol {tol[1]:.3g}); "
                  f"output rms {float(want.float().square().mean().sqrt()):.3g}")
            if not ok or got.dtype != dtype:
                raise AssertionError(f"decode_attn != its plain version at "
                                     f"{shape} {dtype}")
            if full and dtype == torch.bfloat16:
                attn_controls(ins, want, lambda got: close(got, want, *tol))
    for name, shape in ATTN_WIDE.items():
        for dtype in (torch.bfloat16, torch.float32):
            ins = attn_inputs(gen, *shape, dtype, device)
            hold_attn(f"{name} {dtype}", decode_attn(*ins),
                      decode_attn_plain(*ins),
                      ATTN_TOL_FULL[str(dtype).removeprefix("torch.")])
            del ins
    edge_phase(gen, device)
    family_attn_phase(gen, device)
    mxu_attn_phase(gen, device)
    q, k, v, _ = attn_inputs(gen, 3, 4, 2, 16, 40, torch.float32, device)
    kv_len = torch.tensor([0, 17, 0], dtype=torch.int32, device=device)
    got = decode_attn(q, k, v, kv_len)
    if not (torch.equal(got[0::2], torch.zeros_like(got[0::2]))
            and close(got, decode_attn_plain(q, k, v, kv_len),
                      *ATTN_TOL["float32"])[1]):
        raise AssertionError("decode_attn: rows of kv_len 0 are not zeros")
    print("kv_len = 0 rows give zeros, as the TPU kernel does")
    if any(bad for _, bad in two_streams(seed, device).values()):
        raise AssertionError("decode_attn on two streams at once != its "
                             "plain version")


def make_zoo(seed):
    """Host side: datasets, the port's models and their programs."""
    from repro_torch.core.mlmodels import (
        DecisionTree,
        LinearSVM,
        Quantizer,
        RandomForest,
    )
    from repro_torch.core.translator import translate
    from repro_torch.data import load_dataset

    Xtr, ytr, Xte, _ = load_dataset("cicids-17", scale=0.05)
    q = Quantizer(8).fit(Xtr)
    Xtr, Xte = q.transform(Xtr)[:, :FEATURES], q.transform(Xte)[:, :FEATURES]
    Dtr, dytr, Dte, _ = load_dataset("digits")
    qd = Quantizer(8).fit(Dtr)
    Dtr, Dte = qd.transform(Dtr)[:, :FEATURES], qd.transform(Dte)[:, :FEATURES]
    models = {
        0: RandomForest(n_estimators=8, max_depth=12, max_leaf_nodes=64,
                        random_state=seed).fit(Xtr, ytr),
        1: DecisionTree(max_depth=32, max_leaf_nodes=250).fit(Xtr, ytr),
        2: LinearSVM(random_state=seed, **SVM_KW).fit(Dtr, dytr),
    }
    programs = {v: translate(m, vid=v) for v, m in models.items()}
    for v, p in programs.items():
        if p.kind == "svm":
            print(f"vid {v}: svm, {p.n_hyperplanes} hyperplanes x "
                  f"{p.n_features} features")
        else:
            print(f"vid {v}: {p.kind}, {p.n_trees} trees, layers "
                  f"{p.tree_depths}, max entries/layer "
                  f"{max(l.n_entries for ls in p.dt_layers for l in ls)}, "
                  f"leaves {max(d.n_entries for d in p.dt_predicts)}")
    print("vid 3: empty")
    return models, programs, {0: Xte, 1: Xte, 2: Dte}


def traffic(rng, zoo, test_sets, B):
    """B requests over all four slots, 10% FORWARD passthrough packets
    carrying nonzero intermediates and rslt."""
    import numpy as np
    import torch
    from repro_torch.core.packets import PacketType

    mids = {0: 1, 1: 0, 2: 2, 3: 0}
    vid = rng.integers(0, 4, B).astype(np.int32)
    X = np.zeros((B, FEATURES), np.int64)
    for v, Xs in test_sets.items():
        sel = vid == v
        X[sel] = Xs[rng.integers(0, Xs.shape[0], int(sel.sum()))]
    sel = vid == 3
    X[sel] = rng.integers(0, 256, (int(sel.sum()), FEATURES))
    mid = np.asarray([mids[v] for v in vid], np.int32)
    pb = zoo.make_request(X, mid=mid, vid=vid)
    fwd = torch.from_numpy(rng.random(B) < 0.1)
    pb = dataclasses.replace(
        pb,
        ptype=torch.where(fwd, PacketType.FORWARD, PacketType.REQUEST).to(torch.int32),
        codes=torch.where(fwd[:, None], torch.from_numpy(
            rng.integers(1, 2**20, pb.codes.shape).astype(np.int32)), pb.codes),
        svm_acc=torch.where(fwd[:, None], torch.from_numpy(
            rng.integers(-99, 99, pb.svm_acc.shape).astype(np.int32)), pb.svm_acc),
        rslt=torch.where(fwd, torch.from_numpy(
            rng.integers(0, 9, B).astype(np.int32)), pb.rslt))
    return pb, X, vid, fwd.numpy()


def per_classify(mode, prof) -> dict:
    """The launches one classify makes in ``mode``, by kernel."""
    L = prof.max_layers
    return {None: {"classify_fused": 1},
            "unfused": {"tree_walk": 1, "forest_vote": 1, "svm_lookup": 1},
            "layerwise": {"tcam_match": L, "forest_vote": 1,
                          "svm_lookup": 1}}[mode]


def by_record(want: dict) -> dict:
    """``want`` for a ``ZooServer.classify`` whose features fit a byte on
    the card: the request staged as a record, one ``expand_request`` ahead
    of the classify's launches."""
    return {**want, "expand_request": 1}


def checked(fn, want: dict, n_classify: int = 1):
    """Run ``fn`` and check that it launched exactly ``n_classify`` times
    the per-classify launches ``want`` of each kernel, and nothing else."""
    import torch

    before = launches()
    out = fn()
    torch.cuda.synchronize()
    got = {k: n - before[k] for k, n in launches().items()}
    expected = {k: n_classify * want.get(k, 0) for k in got}
    if got != expected:
        raise AssertionError(f"kernel launches {got}, expected {expected}")
    return out


def main_path_phase(prof, seed, device, models, programs, test_sets,
                    mode=None):
    """The main path through the port's entry points, in classify ``mode``;
    returns what timing needs.  Launch counts are checked per call here and
    read as a whole by the caller."""
    import numpy as np
    import torch
    from repro_torch.core.plane import SwitchEngine
    from repro_torch.serving import ZooServer

    fields = ("rslt", "codes", "svm_acc")
    want_n = per_classify(mode, prof)
    rng = np.random.default_rng(seed + 1)
    zoo = ZooServer(prof, mode=mode, device=device)
    for v, p in programs.items():
        zoo.install(p, vid=v)
    oracle = SwitchEngine(prof, mode="ref", device=device)

    B = BATCH
    pb, X, vid, fwd = traffic(rng, zoo, test_sets, B)
    out = checked(lambda: zoo.runtime.run(pb), want_n)
    want = oracle.classify(zoo.packed, pb)
    for f in fields:
        if not torch.equal(getattr(out, f), getattr(want, f)):
            raise AssertionError(f"ZooServer({mode}) != mode ref on {f}")
    rslt = out.rslt.cpu().numpy()
    req = ~fwd
    for v, model in models.items():
        sel = req & (vid == v)
        agree = (rslt[sel] == model.predict(X[sel])).mean()
        print(f"vid {v}: {int(sel.sum())} requests, agree with predict "
              f"{agree:.4f}")
        # the SVM's fixed-point LUTs may flip a sign near zero
        if not (agree > 0.97 if v == 2 else agree == 1.0):
            raise AssertionError(f"vid {v} disagrees with predict: {agree}")
    if not (rslt[req & (vid == 3)] == -1).all():
        raise AssertionError("the empty slot answered")
    for f in fields:
        if not torch.equal(getattr(out, f).cpu()[torch.from_numpy(fwd)],
                           getattr(pb, f)[torch.from_numpy(fwd)]):
            raise AssertionError(f"passthrough packets changed {f}")
    print(f"B={B}: ZooServer == mode ref on {', '.join(fields)}; "
          f"{int(fwd.sum())} passthrough packets untouched")

    for n in (1, 7, 300, BATCH + 1):
        pbn, Xn, vn, _ = traffic(rng, zoo, test_sets, n)
        mids = pbn.mid.numpy()
        got = checked(lambda: zoo.classify(Xn, mid=mids, vid=vn),
                      by_record(want_n))
        want = oracle.classify(zoo.packed, zoo.make_request(Xn, mid=mids,
                                                            vid=vn))
        if not np.array_equal(got, want.rslt.cpu().numpy()):
            raise AssertionError(f"classify != mode ref at B={n}")
    reqs = []
    for n in (1, 7, 300, BATCH + 1):
        pbn, Xn, vn, _ = traffic(rng, zoo, test_sets, n)
        reqs.append((Xn, pbn.mid.numpy(), vn))
    got = checked(lambda: zoo.classify_coalesced(reqs), want_n)
    for (Xn, mn, vn), g in zip(reqs, got):
        w = oracle.classify(zoo.packed, zoo.make_request(Xn, mid=mn, vid=vn))
        if not np.array_equal(g, w.rslt.cpu().numpy()):
            raise AssertionError("classify_coalesced != mode ref")
    print(f"ragged B in (1, 7, 300, {BATCH + 1}): classify and "
          f"classify_coalesced == mode ref; launches per classify "
          f"{by_record(want_n)} and per coalesced dispatch {want_n}")
    return zoo, pb


def multi_switch_phase(prof, device, programs, zoo, pb):
    """plan_zoo over fat_tree(4), host to host; the hop programs on the
    card; the sequential path in the fused and layerwise modes against the
    single switch in mode ref.  Returns the two runtimes."""
    import torch
    from repro_torch.core.distributed_plane import build_zoo_device_programs
    from repro_torch.core.plane import SwitchEngine
    from repro_torch.core.planner import DeviceModel, plan_zoo
    from repro_torch.core.topology import fat_tree
    from repro_torch.runtime import DataplaneRuntime, SequentialPathExecutor

    net = fat_tree(4)
    hosts = net.hosts()
    vids = sorted(programs)
    t0 = time.perf_counter()
    plans = plan_zoo([programs[v] for v in vids], net, hosts[0], hosts[-1],
                     default_device=DeviceModel(n_stages=SWITCH_STAGES))
    print(f"plan_zoo in {time.perf_counter() - t0:.3f} s, {SWITCH_STAGES} "
          f"stage slots per switch, path {' -> '.join(plans[0].path)}")
    for v, plan in zip(vids, plans):
        per = plan.device_stages()
        print(f"  vid {v} ({programs[v].kind}, {len(programs[v].stages())} "
              "stages): " + ", ".join(f"{d} {len(per[d])}" for d in plan.path
                                     if d in per)
              + f"; objective {plan.objective:.6g}")
    t0 = time.perf_counter()
    devs, dps = build_zoo_device_programs([programs[v] for v in vids], plans,
                                          prof, device)
    print(f"{len(devs)} hop programs built on the card in "
          f"{time.perf_counter() - t0:.3f} s: {', '.join(devs)}")
    if len(devs) < 3:
        raise AssertionError(f"the zoo spans {len(devs)} switches, not >= 3")
    want = SwitchEngine(prof, mode="ref", device=device).classify(zoo.packed,
                                                                  pb)
    runtimes = {}
    for mode in (None, "layerwise"):
        rt = DataplaneRuntime(SequentialPathExecutor(
            dps, n_classes=prof.max_classes, mode=mode))
        out = checked(lambda: rt.run(pb), per_classify(mode, prof),
                      n_classify=len(dps))
        for f in ("rslt", "codes", "svm_acc"):
            if not torch.equal(getattr(out, f), getattr(want, f)):
                raise AssertionError(f"multi-switch ({mode}) != the single "
                                     f"switch on {f}")
        print(f"B={pb.batch}, mode {mode or 'fused'}: {len(dps)} hops == the "
              "single switch in mode ref on rslt, codes, svm_acc; launches "
              f"{len(dps)} x {per_classify(mode, prof)}")
        runtimes[mode] = rt
    return runtimes


def lm_path_phase(seed, device):
    """The launcher's serve loop at full width; returns (cfg, model, runs)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve

    cfg = get_config(LM_ARCH)
    print(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} query / {cfg.n_kv} KV heads of {cfg.hd}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab}, {cfg.param_count():,} params "
          f"({cfg.dtype})")
    steps = LM_SERVE["prompt_len"] + LM_SERVE["gen"]
    n = LM_SERVE["swaps"] * steps
    model, _, runs = checked(
        lambda: serve(cfg, seed=seed, device=device, **LM_SERVE),
        {"decode_attn": cfg.n_layers}, n_classify=n)
    B = LM_SERVE["batch"]
    for t, run in enumerate(runs):
        print(f"tenant {t}: {B}x({LM_SERVE['prompt_len']} prompt + "
              f"{LM_SERVE['gen']} greedy) steps in {run.seconds * 1e3:.1f} ms "
              f"({B * LM_SERVE['gen'] / run.seconds:.1f} generated tok/s, "
              f"{B * steps / run.seconds:.1f} tok/s over all steps)")
    print(f"{n} decode steps x {cfg.n_layers} decode_attn launches; weights "
          "and caches written in place across the swaps")
    return cfg, model, runs


@contextlib.contextmanager
def wrong_attention(fn):
    """Within the block the decode step's attention is ``fn(q, k, v,
    kv_len)``, a deliberately wrong one, in place of ``ops.decode_attn``:
    the controls that show a bound refuses what it should."""
    from repro_torch.kernels import ops

    real = ops.decode_attn
    ops.decode_attn = lambda q, k, v, kv_len, **_: fn(q, k, v, kv_len)
    try:
        yield
    finally:
        ops.decode_attn = real


def lm_check_phase(cfg, model, runs, seed, device):
    """Every tenant's steps, teacher-forced, against the twin attention and
    the port's forward; the last tenant also in f32, and two wrong
    attentions held to the same bounds, each of which must refuse them.
    Reports every error, then fails on any outside its bound and on any
    control inside one.  Returns the errors."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.launch.serve import tenant_generator
    from repro_torch.models.transformer import DenseLM, forward

    hold = Holds()

    def bf16_rounded(q, k, v, kv_len):    # the twin, output rounded to bf16
        return ref.decode_attn(q, k, v, kv_len).bfloat16().to(q.dtype)

    def newest_dropped(q, k, v, kv_len):  # an off-by-one mask
        return ref.decode_attn(q, k, v, kv_len - 1)

    last = len(runs) - 1
    for tenant in reversed(range(len(runs))):
        run = runs[tenant]
        if tenant != last:
            model.init_(tenant_generator(seed, tenant, device))
        print(f"tenant {tenant}, {run.fed.shape[1]} steps teacher-forced:")
        dec = family_teacher_forced(model, cfg, run.fed, None, device)
        P = run.prompt_len
        greedy = dec[:, P - 1:].argmax(dim=-1).cpu()
        if not torch.equal(greedy, run.tokens[:, P:]):
            raise AssertionError(f"tenant {tenant}: the served tokens are not "
                                 "the argmax of the teacher-forced steps")
        twin = family_teacher_forced(model, cfg, run.fed, None, device,
                                     mode="ref")
        print(f"  logits: max |x| {float(dec.float().abs().max()):.3f}, "
              f"rms {float(dec.float().square().mean().sqrt()):.3f}")
        hold(f"tenant {tenant} decode vs the twin attention", dec, twin,
             DECODE_TOL)
        fed = run.fed.to(device)
        fwd = forward(model, fed, cfg)
        hold(f"tenant {tenant} bf16 decode vs bf16 forward", dec, fwd,
             FORWARD_TOL["bf16 decode vs bf16 forward"])
        if tenant == last:
            cfg32 = cfg.scaled(dtype="float32")
            m32 = DenseLM(cfg32, device=device)
            with torch.no_grad():
                for p32, p in zip(m32.parameters(), model.parameters()):
                    p32.copy_(p)
            fwd32 = forward(m32, fed, cfg32)
            hold(f"tenant {tenant} f32 decode vs f32 forward",
                 family_teacher_forced(m32, cfg32, run.fed, None, device),
                 fwd32,
                 FORWARD_TOL["f32 decode vs f32 forward"])
            hold(f"tenant {tenant} bf16 decode vs f32 forward", dec, fwd32,
                 FORWARD_TOL["bf16 decode vs f32 forward"])
            with wrong_attention(bf16_rounded):
                hold("f32 decode, attention rounded to bf16, vs f32 forward",
                     family_teacher_forced(m32, cfg32, run.fed, None, device,
                                           mode="ref"),
                     fwd32, FORWARD_TOL["f32 decode vs f32 forward"],
                     control=True)
            with wrong_attention(newest_dropped):
                bad_dec = family_teacher_forced(model, cfg, run.fed, None,
                                                device, mode="ref")
            hold("newest row dropped, vs the twin attention", bad_dec, twin,
                 DECODE_TOL, control=True)
            for what, want in (("bf16", fwd), ("f32", fwd32)):
                hold(f"newest row dropped, vs {what} forward", bad_dec,
                     want, FORWARD_TOL[f"bf16 decode vs {what} forward"],
                     control=True)
            del m32, fwd32, bad_dec
        print(f"  served tokens == argmax of the teacher-forced steps; "
              f"{run.fed.shape[1]} x {cfg.n_layers} decode_attn launches per "
              "kernel-path run, none on the twin's")
    torch.cuda.empty_cache()
    if hold.bad:
        raise AssertionError(f"failed: {hold.bad}")
    return hold.errors


def sdpa_library(q, k, v, kv_len, torch):
    """``scaled_dot_product_attention(..., enable_gqa=True)`` with a boolean
    ``kv_len`` mask on the cache tensors as they lie ([B, S, Hkv, D] seen as
    [B, Hkv, S, D]).  Returns (the call, the backend it picked, by the aten
    op it dispatched to)."""
    import torch.nn.functional as Fn
    from torch.profiler import ProfilerActivity, profile

    S = k.shape[1]
    mask = (torch.arange(S, device=q.device)[None, :]
            < kv_len[:, None])[:, None, None, :]

    def call():
        return Fn.scaled_dot_product_attention(
            q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, enable_gqa=True)[:, :, 0]

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        call()
        torch.cuda.synchronize()
    ops_ = " ".join(e.key for e in p.key_averages())
    backends = [b for b in ("flash", "efficient", "cudnn", "math")
                if f"_scaled_dot_product_{b}_attention" in ops_
                or f"_scaled_dot_product_attention_{b}" in ops_]
    return call, "/".join(backends) or "unknown"


@contextlib.contextmanager
def gc_pauses():
    """Within the block, Python's cyclic collections (``gc.callbacks``):
    yields a dict that counts them, those of generation 2 and their ms."""
    t0, seen = [0.0], dict(n=0, gen2=0, ms=0.0)

    def cb(what, info):
        if what == "start":
            t0[0] = time.perf_counter()
        else:
            seen["n"] += 1
            seen["gen2"] += info["generation"] == 2
            seen["ms"] += (time.perf_counter() - t0[0]) * 1e3

    gc.callbacks.append(cb)
    try:
        yield seen
    finally:
        gc.callbacks.remove(cb)


def host_step_s(step, torch, n, windows=5):
    """(median seconds a step, ms a step of each window, the windows' gc
    pauses): ``windows`` windows of ``n`` steps by the host clock, the card
    synchronised at each window's end.  The host's clock varies between
    windows by more than the gaps between two trees (PERF.md), so one
    window is no measurement."""
    rows = []
    with gc_pauses() as gcp:
        for _ in range(windows):
            t0 = time.perf_counter()
            for _ in range(n):
                step()
            torch.cuda.synchronize()
            rows.append((time.perf_counter() - t0) / n)
    return sorted(rows)[windows // 2], [r * 1e3 for r in rows], gcp


def gc_text(gcp) -> str:
    return (f"python gc in the timed steps: {gcp['n']} collections "
            f"({gcp['gen2']} of generation 2), {gcp['ms']:.3f} ms")


def lm_timing(cfg, model, seed, torch, n_iter=50):
    """The full-width decode step with the cache filled to ``LM_CACHE`` at
    B 16, and ``decode_attn`` and its mxu_native variant on one layer's
    cache."""
    from repro_torch.models.transformer import decode_step, init_decode_state

    device = model.embed.device
    B, T = LM_SERVE["batch"], LM_CACHE
    gen = torch.Generator(device=device).manual_seed(seed + 13)
    state = init_decode_state(cfg, B, T, device=device)
    for cache in state.values():
        cache.normal_(generator=gen)
    tok = torch.randint(0, cfg.vocab, (B, 1), generator=gen, device=device)

    def step():
        return decode_step(model, state, tok, T - 1, cfg)

    step()
    torch.cuda.synchronize()
    step_s, windows, gcp = host_step_s(step, torch, 20)
    zero_launches()
    counted = counted_step(step, [model, state, tok], torch)
    counted["launches"] = launches()
    del counted["result"]

    q = torch.randn(B, cfg.n_heads, cfg.hd, generator=gen,
                    device=device).to(cfg.tdtype)
    kv_len = torch.full((B,), T, dtype=torch.int32, device=device)
    ins = (q, state["k"][0], state["v"][0], kv_len)
    cyc = sleep_cycles_per_ms(torch)
    a = attn_timing(f"{LM_ARCH} B {B} kv_len {T}", ins, torch, cyc, n_iter)
    am = attn_timing(f"{LM_ARCH} B {B} kv_len {T}", ins, torch, cyc, n_iter,
                     mxu=True)
    print(f"  mxu_native / default kernel: {am['ms']:.5f} / {a['ms']:.5f} ms "
          f"= {am['ms'] / a['ms']:.3f}")
    from repro_torch.analysis import model_flops

    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    step_bytes = weights + cfg.n_layers * a["bytes"]
    step_flops = model_flops(cfg, 1, B, "decode") + cfg.n_layers * a["flops"]
    step_bound = bound_ms(step_bytes, step_flops)
    ws = ", ".join(f"{w:.3f}" for w in windows)
    print(f"decode step at kv_len {T}, B {B}: {step_s * 1e3:.3f} ms, the "
          f"median of 5 windows of 20 steps ({ws}; {B / step_s:.1f} tok/s); "
          f"bound {step_bound:.4f} ms "
          f"(roofline_terms: {weights:,} bytes of weights + {cfg.n_layers} x "
          f"{a['bytes']:,} of attention at {hbm_tb_s()}; {step_flops:,.0f} "
          f"flops); {gc_text(gcp)}")
    print(f"-- where the time goes, lm decode step at kv_len {T}")
    busy_us = where_the_time_goes(step, torch, n=5)["busy_us"]
    print(f"device busy {busy_us:.1f} us per step = "
          f"{100 * busy_us / (step_s * 1e6):.1f}% of the unprofiled step")
    del state
    torch.cuda.empty_cache()
    counted.update(step_ms=step_s * 1e3, analytic_bytes=step_bytes,
                   analytic_flops=step_flops, bound_ms=step_bound)
    return a, am, B / step_s, counted


def attn_timing(name, ins, torch, cyc, n_iter=50, mxu=False):
    """``decode_attn`` on ``ins`` (``mxu``: its mxu_native variant): the
    kernel (two timed runs), its plain version and
    ``scaled_dot_product_attention`` by CUDA events, its launch geometry
    and its bound (``bound_ms``: the K/V rows up to kv_len once, q and out,
    through HBM; the flops at the bf16 tensor-core peak)."""
    from repro_torch.kernels.decode_attn import (
        decode_attn,
        decode_attn_plain,
        plan,
    )

    q, k, v, kv_len = ins
    B, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    got = decode_attn(*ins, mxu_native=mxu)
    want = decode_attn_plain(*ins, mxu_native=mxu)
    err, ok = (mxu_within(got, want, ins)[:2] if mxu else close(
        got, want, *ATTN_TOL_FULL[str(q.dtype).removeprefix("torch.")]))
    if not ok:
        raise AssertionError(f"decode_attn != its plain version at {name}")
    k_ms = ms(lambda: decode_attn(*ins, mxu_native=mxu), n_iter, torch, cyc)
    p_ms = ms(lambda: decode_attn_plain(*ins, mxu_native=mxu),
              max(n_iter // 10, 3), torch, cyc, attempts=1)
    k_ms2 = ms(lambda: decode_attn(*ins, mxu_native=mxu), n_iter, torch, cyc)
    try:
        lib, backend = sdpa_library(*ins, torch)
        lib_err, lib_ok = close(lib(), decode_attn(*ins, mxu_native=mxu),
                                *ATTN_TOL[str(q.dtype).removeprefix("torch.")])
        if not lib_ok:
            raise AssertionError(f"scaled_dot_product_attention computes "
                                 f"another function (max abs err {lib_err})")
        lib_ms = ms(lib, n_iter, torch, cyc)
    except (RuntimeError, TypeError) as e:   # torch without this SDPA form
        lib_ms, backend = None, f"refused: {e}"
    esize = q.element_size()
    kv_rows = int(kv_len.clamp(0, S).sum())
    nbytes = 2 * kv_rows * Hkv * D * esize + 2 * q.numel() * esize + 4 * B
    flops = 4 * kv_rows * Hq * D
    bound = bound_ms(nbytes, flops)
    g = plan(B, Hq, Hkv, D, S, q.dtype)
    best = min(k_ms, k_ms2)
    print(f"decode_attn{' mxu_native' if mxu else ''} at {name} (B {B}, Hq "
          f"{Hq}, Hkv {Hkv}, D {D}, S {S}, {q.dtype}): kernel {k_ms:.5f} ms and {k_ms2:.5f} ms (device time "
          f"per launch, two runs of {n_iter}), plain {p_ms:.5f} ms, library "
          f"{'null' if lib_ms is None else f'{lib_ms:.5f} ms'} "
          f"[scaled_dot_product_attention, backend {backend}], bound "
          f"{bound:.6f} ms ({nbytes:,} bytes at {hbm_tb_s()}; {flops:,} flops), "
          f"gap {best / bound:.2f}x, {nbytes / best / 1e6:.0f} GB/s, max abs "
          f"err {err:.3g}")
    print(f"  geometry: {g.qc} query rows a block, {g.n_split} spans of "
          f"{g.split_len} rows, tiles of {g.tile}, {g.blocks} blocks of 128 "
          f"threads, {g.smem:,} bytes of dynamic shared memory a block, "
          f"{g.resident} resident an SM by shared memory")
    return dict(ms=best, plain_ms=p_ms, bound_ms=bound, max_abs_err=err,
                matched=ok, library_ms=lib_ms, bytes=nbytes, flops=flops)


def attn_shapes_timing(seed, torch, n_iter=50):
    """``decode_attn`` at the two further full-width shapes, every row at
    kv_len = S."""
    device = torch.device("cuda")
    gen = torch.Generator(device=device).manual_seed(seed + 17)
    cyc = sleep_cycles_per_ms(torch)
    out = {}
    for name, (B, Hq, Hkv, D, S) in ATTN_WIDE.items():
        q, k, v, _ = attn_inputs(gen, B, Hq, Hkv, D, S, torch.bfloat16, device)
        kv_len = torch.full((B,), S, dtype=torch.int32, device=device)
        out[name] = attn_timing(name, (q, k, v, kv_len), torch, cyc, n_iter)
        del q, k, v
        torch.cuda.empty_cache()
    return out


def bytes_touched(zoo, pb, prof, torch):
    """The least bytes each kernel must move on these inputs: each input
    byte it needs read once, each output written once.  Walk records count
    up to the furthest entry any packet of a version reads in each (layer,
    tree) row; leaves count the entries found; the LUT counts the (feature,
    level) cells the packets select.  ``tcam_match`` is one launch, the mean
    over the L layers of one walk."""
    from repro_torch.kernels import ref, tiling

    packed, dev = zoo.packed, zoo.engine.device
    pbd = pb.to(dev)
    V, L, T, E = packed.dt_cv.shape
    B, F = pbd.features.shape
    H, lv = packed.svm_lut.shape[1], packed.svm_lut.shape[3]
    vid = torch.where((pbd.vid >= 0) & (pbd.vid < V), pbd.vid, 0).long()
    ops_ = packed.image.fused
    cv, cm, fid, flo, fhi, bit, valid = tiling.unpack_walk(ops_.walk)
    codes = pbd.codes.clone()
    rows = torch.zeros((V, L, T), dtype=torch.int64, device=dev)
    for l in range(L):
        f = torch.gather(pbd.features, 1,
                         fid[vid, l].long().reshape(B, T * E)).reshape(B, T, E)
        ok = (((codes[:, :, None] & cm[vid, l]) == cv[vid, l])
              & (f >= flo[vid, l]) & (f <= fhi[vid, l]) & valid[vid, l])
        read = torch.where(ok.any(-1), ok.int().argmax(-1).long() + 1,
                           ops_.n_entries[vid, l].long())
        rows[:, l].scatter_reduce_(0, vid[:, None].expand(B, T), read,
                                   reduce="amax")
        codes = ref.tcam_match_v(codes, pbd.features, vid, cv[:, l], cm[:, l],
                                 fid[:, l], flo[:, l], fhi[:, l], bit[:, l],
                                 valid[:, l], packed.layer_shift[l])
    used = torch.unique(vid)
    walk = int(rows.sum()) * 16 + len(used) * L * T * 4
    pc = ops_.pred_codes[vid]
    found = (pc == codes[..., None]).any(-1)
    leaves = int(torch.unique(torch.stack(
        [vid[:, None].expand(B, T), torch.arange(T, device=dev).expand(B, T),
         codes], -1)[found], dim=0).shape[0]) * 8 + len(used) * T * 4
    x = pbd.features.long()
    inr = (x >= 0) & (x < lv)
    cells = torch.stack([vid[:, None].expand(B, F),
                         torch.arange(F, device=dev).expand(B, F), x], -1)[inr]
    lut = int(torch.unique(cells, dim=0).shape[0]) * H * 4 + len(used) * H * 4
    walk_io = B * (8 * T + 4 * F + 4)
    return {
        "classify_fused": walk + leaves + lut
        + B * (8 * T + 4 * F + 4 + 4 + 4 * H) + 4 * L,
        "tree_walk": walk + walk_io + 4 * L,
        "tcam_match": walk / L + walk_io + 4,
        "forest_vote": leaves + B * (8 * T + 4 + 4),
        "svm_lookup": lut + B * (4 * F + 4 + 4 * H),
    }


def where_the_time_goes(step, torch, n=10):
    """``torch.profiler`` over ``n`` end-to-end steps: the device's busy
    time per step (the kernels' and copies' own device time, each counted
    once: the torch ops that launched them are left out of the sum) and its
    share of the wall time under the profiler; the top host ops and the top
    device activities; the host time of each of the program's spans
    (``repro_torch.runtime.trace``: the request build, admission, the
    executor, the copy out) a step.  Returns the busy us per step."""
    from repro_torch.runtime.trace import PREFIX
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = p.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))
    on_device = [e for e in events if e.device_type != DeviceType.CPU]
    busy = sum(dev_us(e) for e in on_device)
    if busy == 0:
        print("profiler: no device time recorded; busy share not measured")
    else:
        print(f"profiler over {n} steps: wall {wall_us / n:.1f} us/step, "
              f"device busy {busy / n:.1f} us/step "
              f"({100 * busy / wall_us:.1f}% of the wall)")
    for what, rows, us in (
            ("host ops by self CPU time", events,
             lambda e: e.self_cpu_time_total),
            ("device activities by device time", on_device, dev_us)):
        print(f"top {what} (us per step, calls per step):")
        for e in sorted(rows, key=us, reverse=True)[:8]:
            print(f"  {us(e) / n:10.1f}  {e.count / n:6.1f}  {e.key[:70]}")
    calls = {api: sum(e.count for e in events if e.key.startswith(api)) / n
             for api in ("cudaLaunchKernel", "cudaMemcpyAsync",
                         "cudaGraphLaunch")}
    print("host API calls per step: " + ", ".join(
        f"{k} {v:g}" for k, v in calls.items()))
    spans = collections.Counter()
    for e in p.events():
        if e.name.startswith(PREFIX) and e.device_type == DeviceType.CPU:
            spans[e.name] += (e.time_range.end - e.time_range.start) / n
    if spans:
        print("the program's spans (host us per step, each with its "
              "children): " + ", ".join(f"{k} {v:.1f}"
                                        for k, v in spans.items()))
    return dict(busy_us=busy / n, wall_us=wall_us / n, spans_us=dict(spans),
                **calls)


NCU_METRICS = ("sm__warps_active.avg.pct_of_peak_sustained_active",
               "dram__throughput.avg.pct_of_peak_sustained_elapsed")


def kernel_resources(libs):
    """Registers, spills and static shared memory of each function of the
    redesigned kernels, from ``nvcc -Xptxas -v``."""
    for name in ("decode_attn", "classify_fused", "tcam_match",
                 "svm_lookup", "tree_walk", "forest_vote", "request_record"):
        fn = None
        for line in libs[name].log.splitlines():
            if "Compiling entry function" in line:
                fn = line.split("'")[1]
            elif ("Used" in line or "spill" in line) and fn:
                print(f"{name} {fn}: {line.split(':', 1)[-1].strip()}")


@contextlib.contextmanager
def child(args, timeout=300, env=None, cwd=None):
    """A child process running ``args`` (this script again, or an example),
    started now and left to run beside the caller's work; ``get()`` waits
    for it and returns (exit code, output).  The child is killed on the way
    out whatever happened."""
    import os
    import signal

    proc = subprocess.Popen(args, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True, env=env, cwd=cwd)
    t_end = time.perf_counter() + timeout

    def get():
        try:
            out, err = proc.communicate(
                timeout=max(t_end - time.perf_counter(), 1))
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            out, err = proc.communicate()
            return None, out + err
        return proc.returncode, (out, err)
    get.proc = proc
    try:
        yield get
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()


def ncu_args(seed):
    """``ncu``'s achieved occupancy and DRAM throughput for one launch of
    each redesigned kernel at its timed shape (this script's
    ``--ncu-probe``), or None where that tool is not on the machine."""
    import shutil

    ncu = shutil.which("ncu")
    if ncu is None:
        return None
    return [ncu, "--csv", "--metrics", ",".join(NCU_METRICS),
            "--kernel-name", "regex:attn_bf16|classify_fused_kernel",
            sys.executable, str(Path(__file__).resolve()), "--ncu-probe",
            "--seed", str(seed)]


def report_ncu(rc, out):
    if rc is None:
        print("ncu: timed out; not measured")
        return
    out = "\n".join(out)
    rows = [line for line in out.splitlines()
            if any(m in line for m in NCU_METRICS)]
    if not rows:
        tail = " | ".join(out.strip().splitlines()[-3:])
        print(f"ncu: no metrics (exit {rc}): {tail[:400]}")
        return
    for line in rows:
        cells = [c.strip('"') for c in line.split('","')]
        print("ncu: " + ", ".join(c for c in (cells[4:5] + cells[-3:]) if c))


def ncu_probe(seed):
    """One launch of each redesigned kernel at its timed shape, for ncu:
    ``decode_attn`` at internlm2-1.8b's width (B 16, kv_len 4096) and
    ``classify_fused`` on random full-width tables at B 4096."""
    import numpy as np
    import torch
    from repro_torch.core.plane import PlaneProfile
    from repro_torch.kernels import tiling
    from repro_torch.kernels.classify_fused import classify_fused
    from repro_torch.kernels.decode_attn import decode_attn

    device = torch.device("cuda")
    gen = torch.Generator(device=device).manual_seed(seed)
    B = LM_SERVE["batch"]
    q, k, v, _ = attn_inputs(gen, B, 16, 8, 128, LM_CACHE, torch.bfloat16,
                             device)
    decode_attn(q, k, v, torch.full((B,), LM_CACHE, dtype=torch.int32,
                                    device=device))
    prof = PlaneProfile(**FULL)
    rng = np.random.default_rng(seed)
    tabs = random_tables(rng, prof, torch, device, empty_slot=2)
    ops_ = tiling.prep_classify_fused(*(tabs[k] for k in (
        "code_value", "code_mask", "fid", "f_lo", "f_hi", "set_bit", "valid",
        "pred_codes", "pred_labels", "pred_valid", "weights", "lut", "bias")))

    def ints(hi, shape):
        return torch.from_numpy(rng.integers(0, hi, shape).astype(np.int32)
                                ).to(device)
    classify_fused(ints(2**12, (BATCH, prof.max_trees)),
                   ints(prof.levels, (BATCH, prof.max_features)),
                   ints(prof.max_versions, BATCH), tabs["layer_shift"], ops_,
                   prof.max_classes)
    torch.cuda.synchronize()
    return 0


LIBRARY_NONE = {
    "classify_fused": "no single PyTorch call computes walk, vote and SVM "
                      "sums",
    "tree_walk": "no PyTorch call computes a first-match ternary search "
                 "over variable-length rows",
    "tcam_match": "no PyTorch call computes a first-match ternary search "
                  "over variable-length rows",
    "forest_vote": "torch.searchsorted finds a leaf, but no single call "
                   "also takes the weighted vote",
    "expand_request": "no PyTorch call widens a byte record into the flat "
                      "batch's field-major layout",
}


def ms(fn, n, torch, cycles_per_ms, attempts=4):
    """Mean device ms per call of ``fn`` over ``n`` calls, by CUDA events.

    The device first sleeps for longer than the host takes to enqueue the
    ``n`` calls (1.5x a timed dry run of them), so the events time the
    device's work back to back, not the host's launch path; that path's
    cost shows end to end and in the profiler tables instead.  A run whose
    enqueue outlasted the sleep (the host slowed: the device waited for
    launches) is not kept: it is run again with twice the sleep, up to
    ``attempts`` times, and the last run is kept with a warning.  The plain
    versions, which overflow the launch queue whatever the sleep, get one
    attempt."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for attempt in range(attempts):
        sleep_ms = 1.5 * 2 ** attempt * host_ms + 0.5
        t0 = time.perf_counter()
        torch.cuda._sleep(int(sleep_ms * cycles_per_ms))
        start.record()
        for _ in range(n):
            fn()
        end.record()
        enqueued_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        if enqueued_ms < sleep_ms:
            break
    else:
        print(f"  timing: the host's enqueue ({enqueued_ms:.3f} ms) outlasted "
              f"the card's sleep ({sleep_ms:.3f} ms) {attempts} time(s); the "
              "time below includes the host's launch gaps")
    return start.elapsed_time(end) / n


def sleep_cycles_per_ms(torch) -> float:
    """The card's clock cycles per ms under ``torch.cuda._sleep``, timed by
    CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    torch.cuda._sleep(10**7)
    end.record()
    torch.cuda.synchronize()
    return 10**7 / start.elapsed_time(end)


def max_abs_err(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    return max(int((g.long() - w.long()).abs().max()) for g, w in
               zip(got, want))


def svm_library(img, features, vid, lv, torch):
    """The SVM sums as one ``embedding_bag(mode="sum")`` call: the LUT as
    a ``[V * F * levels, H]`` table, one bag of F cells per packet,
    out-of-range features weighted 0.  Returns the call; prints whether
    the card's ``embedding_bag`` takes the int32 table itself."""
    import torch.nn.functional as Fn

    V, H, F, _ = img.lut.shape
    x = features.long()
    inr = (x >= 0) & (x < lv)
    f = torch.arange(F, device=x.device)
    idx = (vid.long()[:, None] * F + f) * lv + x.clamp(0, lv - 1)
    table = img.lut.permute(0, 2, 3, 1).reshape(V * F * lv, H).contiguous()
    try:
        Fn.embedding_bag(idx, table, mode="sum")
        print("library: embedding_bag takes the int32 table")
    except RuntimeError as e:
        print(f"library: embedding_bag refuses the int32 table ({e}); timed "
              "on a float64 copy, exact for these sums")
        table = table.double()
    w = inr.to(table.dtype)
    return lambda: Fn.embedding_bag(idx, table, mode="sum",
                                    per_sample_weights=w)


def eager_twins(prof, device, programs, runtimes):
    """The zoo in the three modes and the planned path, as the graph path
    has them, through executors built with ``graphs=False``: the eager
    yardstick of phase 9."""
    from repro_torch.runtime import (
        DataplaneRuntime,
        SequentialPathExecutor,
        SingleSwitchExecutor,
    )
    from repro_torch.serving import ZooServer

    zoos = {}
    for m in MODES:
        zoos[m] = ZooServer(prof, executor=SingleSwitchExecutor(
            prof, mode=m, device=device, graphs=False))
        for v, p in programs.items():
            zoos[m].install(p, vid=v)
    rts = {m: DataplaneRuntime(SequentialPathExecutor(
        list(rt.executor.programs), n_classes=prof.max_classes, mode=m,
        graphs=False)) for m, rt in runtimes.items()}
    return zoos, rts


def timing_phase(zoos, runtimes, eager_zoos, eager_runtimes, pb, prof,
                 models, torch, n_iter=50):
    from repro_torch.kernels.classify_fused import (
        classify_fused,
        classify_fused_plain,
        packets_per_block,
    )
    from repro_torch.kernels import forest_vote as vote_module
    from repro_torch.kernels import svm_lookup as svm_module
    from repro_torch.kernels import tcam_match as tcam_module
    from repro_torch.kernels import tree_walk as walk_module
    from repro_torch.core.packets import flat_size
    from repro_torch.kernels.forest_vote import forest_vote, forest_vote_plain
    from repro_torch.kernels.request_record import (
        expand_request,
        expand_request_plain,
        record_layout,
        write_record,
    )
    from repro_torch.kernels.svm_lookup import svm_lookup, svm_lookup_plain
    from repro_torch.kernels.tcam_match import tcam_match, tcam_match_plain
    from repro_torch.kernels.tree_walk import tree_walk, tree_walk_plain

    zoo = zoos[None]
    packed, dev = zoo.packed, zoo.engine.device
    pbd = pb.to(dev)
    V, L = packed.n_versions, prof.max_layers
    vid = torch.where((pbd.vid >= 0) & (pbd.vid < V), pbd.vid, 0)
    C = prof.max_classes
    img = packed.image.fused
    codes, feats, shift = pbd.codes, pbd.features, packed.layer_shift
    walked = tree_walk(codes, feats, vid, shift, img.walk)

    def layers(step):
        def run():
            c = codes
            for l in range(L):
                c = step(c, feats, vid, shift, img.walk, l)
            return c
        return run

    # the main path's request as a record on the card (B 4096, F 60) and
    # the flat batch it widens into (T 8, H 12)
    from repro_torch.runtime.staging import Record

    B, F = pb.batch, prof.max_features
    T, H = prof.max_trees, prof.max_hyperplanes
    rec = Record(B, F, pin=True)
    if not write_record(rec, pb.features.numpy(), mid=pb.mid.numpy(),
                        vid=pb.vid.numpy()):
        raise AssertionError("the main path's features do not fit a byte")
    rec_d = rec.buf.to(dev)
    flat_d = torch.empty(flat_size(B, F, T, H), dtype=torch.int32,
                         device=dev)

    def expand():
        expand_request(rec_d, flat_d, B, F, T, H)
        return flat_d

    calls = {
        "classify_fused": (
            lambda: classify_fused(codes, feats, vid, shift, img, C),
            lambda: classify_fused_plain(codes, feats, vid, shift, img, C),
            1),
        "tree_walk": (lambda: tree_walk(codes, feats, vid, shift, img.walk),
                      lambda: tree_walk_plain(codes, feats, vid, shift,
                                              img.walk), 1),
        "tcam_match": (layers(tcam_match), layers(tcam_match_plain), L),
        "forest_vote": (lambda: forest_vote(walked, vid, img.leaves, C),
                        lambda: forest_vote_plain(walked, vid, img.leaves, C),
                        1),
        "svm_lookup": (lambda: svm_lookup(feats, vid, img.svm),
                       lambda: svm_lookup_plain(feats, vid, img.svm), 1),
        "expand_request": (expand, lambda: expand_request_plain(
            rec_d, B, F, T, H), 1),
    }
    library = {"svm_lookup": svm_library(img, feats, vid, prof.levels, torch)}
    lib_sums = library["svm_lookup"]().long() & 0xFFFFFFFF
    if not torch.equal(lib_sums, svm_lookup(feats, vid, img.svm).long()
                       & 0xFFFFFFFF):
        raise AssertionError("the embedding_bag yardstick computes other sums")
    nbytes = bytes_touched(zoo, pb, prof, torch)
    # the flat batch written, the record read
    nbytes["expand_request"] = 4 * flat_size(B, F, T, H) + record_layout(
        B, F).nbytes
    cyc = sleep_cycles_per_ms(torch)
    B, T, F = pb.batch, prof.max_trees, prof.max_features
    pb_n = packets_per_block(T, F, B, L=L)
    print(f"classify_fused geometry at B {B}: {pb_n} packets a block, "
          f"{-(-B // pb_n)} blocks of 160 threads, "
          f"{(pb_n * (F + T + 1 + L * T) + L) * 4} bytes of shared memory a "
          "block")
    g = tcam_module.geometry(B, T)
    print(f"tcam_match geometry at B {B}: {tcam_module.LANES} lanes a "
          f"(packet, tree), {g.packets} packets a block, {g.blocks} blocks "
          f"of {g.threads} threads ({g.blocks * g.threads / 32 / 132:.1f} "
          "warps an SM on 132), no shared memory")
    H = prof.max_hyperplanes
    gs = svm_module.geometry(B, H)
    print(f"svm_lookup geometry at B {B}, H {H}: {svm_module.LANES} lanes "
          f"a packet ({gs.cell_lanes} a cell, a quad of hyperplanes each, x "
          f"{gs.slices} slices of the features), {gs.packets} packets a "
          f"block, {gs.blocks} blocks of {gs.threads} threads "
          f"({gs.blocks * gs.threads / 32 / 132:.1f} warps an SM), no shared "
          "memory")

    gw = walk_module.geometry(B, T, F, L)
    print(f"tree_walk geometry at B {B}: {walk_module.LANES} lanes a (packet,"
          f" tree), {gw.packets} packets a block, {gw.blocks} blocks of "
          f"{gw.threads} threads ({gw.blocks * gw.threads / 32 / 132:.1f} "
          f"warps an SM on 132), {gw.smem} bytes of shared memory a block")
    gv = vote_module.geometry(B, T)
    print(f"forest_vote geometry at B {B}: {vote_module.LANES} lanes a "
          f"(packet, tree), a warp a packet's vote, {gv.packets} packets a "
          f"block, {gv.blocks} blocks of {gv.threads} threads "
          f"({gv.blocks * gv.threads / 32 / 132:.1f} warps an SM), {gv.smem} "
          "bytes of shared memory a block")

    def empty_layers(blocks, threads):
        def run():
            for _ in range(L):
                tcam_module.empty_launch(dev, blocks, threads)
        return run
    # the card's floor per launch: an empty kernel launched as tcam_match
    # is (L back to back, the same path), at its grid and at one block
    floor = {}
    for what, (blocks, threads) in (("tcam_match's grid",
                                     (g.blocks, g.threads)),
                                    ("forest_vote's grid",
                                     (gv.blocks, gv.threads)),
                                    ("one block of 32", (1, 32))):
        n = max(3, n_iter // L)
        runs = [ms(empty_layers(blocks, threads), n, torch, cyc) / L
                for _ in range(2)]
        floor[what] = min(runs)
        print(f"launch_floor_ms ({what}, {blocks} x {threads}): "
              f"{runs[0]:.5f} ms and {runs[1]:.5f} ms (device time per "
              f"launch, two runs of {n} calls of {L} launches)")
    out = {"launch_floor_ms": floor["tcam_match's grid"],
           "launch_floor_forest_vote_grid_ms": floor["forest_vote's grid"],
           "launch_floor_one_block_ms": floor["one block of 32"]}
    for name, (kernel, plain, per) in calls.items():
        err = max_abs_err(kernel(), plain())
        # at most ~n_iter launches a timed run: the device's launch queue
        # must hold them all while it sleeps
        n = max(3, n_iter // per)
        k_ms = ms(kernel, n, torch, cyc) / per
        p_ms = ms(plain, max(n_iter // 10, 3), torch, cyc, attempts=1) / per
        k_ms2 = ms(kernel, n, torch, cyc) / per
        lib_ms = (ms(library[name], n_iter, torch, cyc) if name in library
                  else None)
        bound = bound_ms(nbytes[name])
        print(f"{name}: kernel {k_ms:.5f} ms and {k_ms2:.5f} ms (device time "
              f"per launch, two runs of {n} calls"
              f"{f' of {per} launches' if per > 1 else ''}), plain "
              f"{p_ms:.5f} ms, library "
              f"{'null' if lib_ms is None else f'{lib_ms:.5f} ms'}, bound "
              f"{bound:.6f} ms ({nbytes[name]:.0f} bytes at {hbm_tb_s()}), gap "
              f"{min(k_ms, k_ms2) / bound:.1f}x, max abs err {err}")
        if lib_ms is None:
            print(f"  library_ms null: {LIBRARY_NONE[name]}")
        out[name] = dict(ms=min(k_ms, k_ms2), plain_ms=p_ms, bound_ms=bound,
                         max_abs_err=err, matched=err == 0,
                         library_ms=lib_ms, bytes=nbytes[name])

    print(f"tcam_match per launch / launch_floor_ms at its grid: "
          f"{out['tcam_match']['ms'] / out['launch_floor_ms']:.2f}x; "
          f"forest_vote / launch_floor_ms at its grid: "
          f"{out['forest_vote']['ms'] / out['launch_floor_forest_vote_grid_ms']:.2f}x"
          f"; tree_walk / classify_fused: "
          f"{out['tree_walk']['ms'] / out['classify_fused']['ms']:.2f}x")
    stamp("kernel timing done")
    B = pb.batch
    X = pb.features.numpy()
    mid, vids = pb.mid.numpy(), pb.vid.numpy()
    steps = {}
    for path, zs, rts in (("graph", zoos, runtimes),
                          ("eager", eager_zoos, eager_runtimes)):
        tag = "" if path == "graph" else "_eager"
        steps.update({f"zoo_{m or 'fused'}{tag}":
                      (lambda z=z: z.classify(X, mid=mid, vid=vids))
                      for m, z in zs.items()})
        steps.update({f"multi_switch_{m or 'fused'}{tag}":
                      (lambda rt=rt: rt.run(pb).rslt.cpu())
                      for m, rt in rts.items()})
    rps, prof_steps, walls = {}, {}, {}
    for name, step in steps.items():
        step()
        # each step on the host clock: the median stands for the step, so
        # one stall of the shared host (a collector pass, a neighbour)
        # does not; the mean is printed beside it
        dts = []
        for _ in range(20):
            t0 = time.perf_counter()
            step()
            dts.append(time.perf_counter() - t0)
        walls[name] = sorted(dts)[len(dts) // 2]
        rps[name] = B / walls[name]
        print(f"{name} end to end: {rps[name]:.0f} requests/s (median "
              f"{walls[name] * 1e3:.3f} ms per {B}-request batch of 20, "
              f"mean {sum(dts) / len(dts) * 1e3:.3f} ms)")
    stamp("end to end done")
    for name, step in steps.items():
        print(f"-- where the time goes, {name}")
        prof_steps[name] = dict(where_the_time_goes(step, torch, n=5),
                                wall_ms=walls[name] * 1e3)
    stamp("profiles done")
    writes = install_timing(zoos[None], models, torch)
    return out, rps, prof_steps, writes


def same_fields(what, got, want):
    """Raise unless ``got`` and ``want`` agree on rslt, codes and svm_acc."""
    import torch

    for f in ("rslt", "codes", "svm_acc"):
        g = getattr(got, f)
        w = getattr(want, f).to(g.device)
        if not torch.equal(g, w):
            raise AssertionError(f"{what}: {f} differs in "
                                 f"{int((g != w).sum())} places")


def passthrough(prof):
    """``make_batch(b)``: b zero FORWARD packets at ``prof``'s widths, the
    batch a warm-up drives (the plane forwards it untouched)."""
    import numpy as np
    import torch
    from repro_torch.core.packets import PacketBatch

    def make(b):
        pb = PacketBatch.make_request(
            np.zeros((b, prof.max_features), np.int32),
            max_features=prof.max_features, n_trees=prof.max_trees,
            n_hyperplanes=prof.max_hyperplanes)
        return dataclasses.replace(pb, ptype=torch.zeros(b, dtype=torch.int32))
    return make


def kernel_events(run, torch):
    """``run()`` once under the profiler: the device kernels it ran, by
    wrapper name (``KERNEL_FN``), and its ``cudaGraphLaunch`` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        run()
        torch.cuda.synchronize()
    got, graphs = {}, 0
    for e in p.key_averages():
        if e.device_type == DeviceType.CPU:
            graphs += e.count if e.key.startswith("cudaGraphLaunch") else 0
            continue
        for name, fn in KERNEL_FN.items():
            if fn in e.key:
                got[name] = got.get(name, 0) + e.count
    return got, graphs


def draws_phase(device):
    """The 204 conformance draws (the port's models, ``data/conformance``)
    through graph replay and eager classify in the three modes, each held
    to ``SwitchEngine(mode="ref")``; every draw a replay of a warmed
    bucket, with exactly the mode's launches."""
    import numpy as np
    from repro_torch.core.plane import SwitchEngine
    from repro_torch.data import conformance as draws
    from repro_torch.runtime import DataplaneRuntime, SingleSwitchExecutor

    n = 0
    for V in sorted(draws.N_CASES):
        cprof = draws.profile(V)
        maker = SwitchEngine(cprof, device=device)
        oracle = SwitchEngine(cprof, mode="ref", device=device)
        rts = {(m, g): DataplaneRuntime(SingleSwitchExecutor(
            cprof, mode=m, device=device, graphs=g))
            for m in MODES for g in (True, False)}
        top = max(draws.SIZES)
        ladders = {k: rt.warm(passthrough(cprof), top)
                   for k, rt in rts.items() if k[1]}
        for case in range(draws.N_CASES[V]):
            packed, pb = draws.draw_case(V, case, maker)
            want = oracle.classify(packed, pb)
            outs = {}
            for (m, g), rt in rts.items():
                rt.swap(packed)
                outs[m, g] = checked(lambda: rt.run(pb), per_classify(m, cprof))
                same_fields(f"V={V} case={case} mode={m} "
                            f"{'graph' if g else 'eager'}", outs[m, g], want)
            for m in MODES:
                same_fields(f"V={V} case={case} mode={m} graph vs eager",
                            outs[m, True], outs[m, False])
            n += 1
        for k, ladder in ladders.items():
            if rts[k].cache_size() != len(ladder):
                raise AssertionError(f"V={V} mode={k[0]}: cache_size "
                                     f"{rts[k].cache_size()} after the draws, "
                                     f"warmed {len(ladder)}")
        print(f"V={V}: {draws.N_CASES[V]} draws, graph replay == eager == "
              f"mode ref on rslt, codes, svm_acc in modes "
              f"{[m or 'fused' for m in MODES]}; launches per replay "
              f"{[per_classify(m, cprof) for m in MODES]}; cache_size "
              f"{len(ladder)} before and after")
    return n


def graph_phase(prof, seed, device, models, programs, zoos, runtimes, pb):
    """Phase 10: the graph path on the card (see the module docstring).
    Returns the zoo warmed to ``BATCH`` that phase 11 serves."""
    from repro_torch.core.plane import SwitchEngine

    me = [sys.executable, str(Path(__file__).resolve())]
    with contextlib.ExitStack() as stack:
        # two children beside this phase's checks: a capture that must fail,
        # and ncu (phase 9's counters) where the machine has it
        failing = stack.enter_context(child(me + ["--capture-failure"]))
        ncu = ncu_args(seed)
        ncu = stack.enter_context(child(ncu, 240)) if ncu else None
        zoo = graph_checks(prof, device, models, programs, zoos, runtimes,
                           pb, oracle=SwitchEngine(prof, mode="ref",
                                                   device=device))
        rc, (out, err) = failing()
        last = (err.strip().splitlines() or [""])[-1]
        print(f"--capture-failure: exit {rc}; {last[:300]}")
        if rc == 0 or '"ok": true' in out:
            raise AssertionError("a failing capture did not end the run")
        if "capture" not in err.lower():
            raise AssertionError("the child failed, but not in its "
                                 "capture: " + err[-2000:])
        if ncu is None:
            print("ncu: not on this machine; occupancy and DRAM throughput "
                  "not measured")
        else:
            report_ncu(*ncu())
    return zoo


def graph_checks(prof, device, models, programs, zoos, runtimes, pb,
                 oracle):
    """Phase 10's checks on this process's card (see ``graph_phase``)."""
    import threading

    import torch
    from repro_torch.core.plane import program_tensors
    from repro_torch.core.translator import translate
    from repro_torch.runtime import DataplaneRuntime, SequentialPathExecutor
    from repro_torch.serving import ZooServer

    t0 = time.perf_counter()
    n = draws_phase(device)
    print(f"{n} draws in {time.perf_counter() - t0:.1f} s")
    stamp("draws done")

    def rows(B):
        return pb.map(lambda x: x[:B])

    # the planned path, fused and layerwise: replay == eager == the single
    # switch in mode ref, at B 4096 and the ragged sizes
    for m, rt in runtimes.items():
        hops = len(rt.executor.programs)
        rt.warm(passthrough(prof), BATCH)
        eager = DataplaneRuntime(SequentialPathExecutor(
            list(rt.executor.programs), n_classes=prof.max_classes, mode=m,
            graphs=False))
        for B in (BATCH,) + RAGGED:
            pbx = rows(B)
            want = oracle.classify(zoos[None].packed, pbx)
            got = checked(lambda: rt.run(pbx), per_classify(m, prof),
                          n_classify=hops)
            same_fields(f"path {m or 'fused'} B={B} graph", got, want)
            same_fields(f"path {m or 'fused'} B={B} eager", eager.run(pbx),
                        want)
        print(f"path of {hops} hops, mode {m or 'fused'}: replay == eager == "
              f"the single switch in mode ref at B {(BATCH,) + RAGGED}; "
              f"launches per replay {hops} x {per_classify(m, prof)}")

    stamp("path done")
    # one replay under the profiler: exactly the mode's kernels
    for m, zoo in zoos.items():
        zoo.runtime.run(pb)
        got, graphs = kernel_events(lambda: zoo.runtime.run(pb), torch)
        want = per_classify(m, prof)
        print(f"profiler, one replay ({m or 'fused'}): kernels {got}, "
              f"cudaGraphLaunch {graphs}")
        if got != want or graphs != 1:
            raise AssertionError(f"one replay ran {got} and {graphs} graph "
                                 f"launches, expected {want} and 1")
    for m, rt in runtimes.items():
        hops = len(rt.executor.programs)
        got, graphs = kernel_events(lambda: rt.run(pb), torch)
        want = {k: hops * v for k, v in per_classify(m, prof).items()}
        print(f"profiler, one replay of the path ({m or 'fused'}): kernels "
              f"{got}, cudaGraphLaunch {graphs}")
        if got != want or graphs != 1:
            raise AssertionError(f"one path replay ran {got}, expected {want}")

    # install and evict between replays, in place
    dt3 = translate(models[1], vid=3)
    for m, zoo in zoos.items():
        ptrs = [t.data_ptr() for t in program_tensors(zoo.packed)]
        size = zoo.cache_size()
        base = zoo.runtime.run(pb)
        steps = [("install vid 3", lambda: zoo.install(dt3, vid=3)),
                 ("evict vid 3", lambda: zoo.evict(vid=3)),
                 ("evict vid 0", lambda: zoo.evict(vid=0)),
                 ("reinstall vid 0", lambda: zoo.install(programs[0],
                                                         vid=0))]
        changed = []
        for what, write in steps:
            write()
            out = zoo.runtime.run(pb)
            same_fields(f"{m or 'fused'} after {what}", out,
                        oracle.classify(zoo.packed, pb))
            changed.append(int((out.rslt != base.rslt).sum()))
        if not (changed[0] > 0 and changed[1] == 0 and changed[2] > 0
                and changed[3] == 0):
            raise AssertionError(f"the writes did not show: {changed}")
        if [t.data_ptr() for t in program_tensors(zoo.packed)] != ptrs:
            raise AssertionError("a slot write moved a resident tensor")
        if zoo.cache_size() != size:
            raise AssertionError("a slot write changed the graph cache")
        print(f"{m or 'fused'}: install vid 3, evict vid 3, evict vid 0, "
              f"reinstall vid 0 between replays: the next replay == mode ref "
              f"each time ({changed} packets changed from the first); "
              f"{len(ptrs)} resident data_ptrs unchanged; cache_size {size}")

    # cache_size is the warmed ladder; ragged replays add nothing
    zoo = ZooServer(prof, device=device)
    for v, p in programs.items():
        zoo.install(p, vid=v)
    ladder = zoo.runtime.warm(passthrough(prof), BATCH)
    if zoo.cache_size() != len(ladder):
        raise AssertionError(f"cache_size {zoo.cache_size()} after warming "
                             f"{len(ladder)} buckets")
    wants = {}
    for B in RAGGED + (BATCH,):
        out = zoo.runtime.run_host(rows(B))
        wants[B] = oracle.classify(zoo.packed, rows(B))
        same_fields(f"ragged B={B}", out, wants[B])
    if zoo.cache_size() != len(ladder):
        raise AssertionError(f"ragged replays grew the cache to "
                             f"{zoo.cache_size()}")
    print(f"warm({BATCH}): cache_size {zoo.cache_size()} == ladder "
          f"{ladder}; run_host at B {RAGGED} == mode ref, cache_size "
          "unchanged")

    # two threads replaying at once
    errors = []

    def worker(sizes, rounds=25):
        try:
            for _ in range(rounds):
                for B in sizes:
                    same_fields(f"thread B={B}", zoo.runtime.run_host(rows(B)),
                                wants[B])
        except Exception as e:   # reported by the main thread
            errors.append(e)
    sizes = ((BATCH, RAGGED[2], RAGGED[1]), (RAGGED[-1], RAGGED[3], BATCH))
    threads = [threading.Thread(target=worker, args=(sz,)) for sz in sizes]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    if errors or any(th.is_alive() for th in threads):
        raise AssertionError(f"concurrent replays: {errors or 'timed out'}")
    print(f"two threads x 25 rounds of run_host at B {sizes[0]} and "
          f"{sizes[1]}, replaying the same graphs: every answer == mode ref")

    stamp("threads done")
    return zoo


def capture_failure(seed) -> int:
    """A zoo whose classify synchronises with the host: the warm-up runs,
    the capture must raise, and that error must end this process."""
    import numpy as np
    import torch
    from repro_torch.data import conformance as draws
    from repro_torch.runtime import executors
    from repro_torch.serving import ZooServer

    real = executors._classify_impl

    def syncing(packed, pb, **kw):
        int(pb.vid.sum())          # a host read: illegal while capturing
        return real(packed, pb, **kw)

    executors._classify_impl = syncing
    zoo = ZooServer(draws.profile(1), device=torch.device("cuda"))
    print("capture-failure: classifying through a graph whose body reads "
          "the host", flush=True)
    zoo.classify(np.zeros((3, draws.N_FEATURES), np.int32), mid=0, vid=0)
    print(f"capture-failure: NO ERROR, cache_size {zoo.cache_size()}")
    return 0


def install_timing(zoo, models, torch, n=7):
    """ms of one in-place slot install and one evict (the DT into vid 3),
    each from the call to the card's finishing it."""
    from repro_torch.core.translator import translate

    prog = translate(models[1], vid=3)
    out = {"install": [], "evict": []}
    for _ in range(n):
        for what, write in (("install", lambda: zoo.install(prog, vid=3)),
                            ("evict", lambda: zoo.evict(vid=3))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            write()
            torch.cuda.synchronize()
            out[what].append((time.perf_counter() - t0) * 1e3)
    for what, xs in out.items():
        xs.sort()
        print(f"{what} of one slot (the {prog.n_trees}-tree DT, "
              f"{sum(len(l) for l in prog.dt_layers)} layer rows): median "
              f"{xs[n // 2]:.3f} ms, min {xs[0]:.3f} ms over {n}")
    return {k: xs[n // 2] for k, xs in out.items()}


def dispatch_probe(zoo, reqs, torch, n=30):
    """One dispatch's pieces, host clock: eight requests coalesced, then
    ``run_host`` of them on this thread and on a worker thread, as a slot
    runs it; then sequential submits to an idle ``ContinuousZooServer``,
    split by the server into queue wait and dispatch."""
    import asyncio
    import concurrent.futures

    import numpy as np
    from repro_torch.runtime import SizeOrDeadlinePolicy
    from repro_torch.serving import ContinuousZooServer

    rt = zoo.runtime
    pbs = [zoo.make_request(X, mid=m, vid=v) for X, m, v in reqs[:8]]
    t0 = time.perf_counter()
    for _ in range(n):
        flat, _ = rt.coalesce(pbs)
    t_co = (time.perf_counter() - t0) / n * 1e3

    def run_host():
        t0 = time.perf_counter()
        for _ in range(n):
            rt.run_host(flat)
        return (time.perf_counter() - t0) / n * 1e3
    t_main = run_host()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        t_thread = pool.submit(run_host).result()

    async def idle():
        async with ContinuousZooServer(zoo, policy=SizeOrDeadlinePolicy(
                max_batch=BATCH, max_wait_us=500.0), n_slots=2) as srv:
            for X, m, v in reqs[:n]:
                await srv.submit(X, mid=m, vid=v)
            return srv.latency_stats()
    st = asyncio.run(idle())
    print(f"one dispatch of 8 requests ({flat.batch} packets): coalesce "
          f"{t_co:.3f} ms, run_host {t_main:.3f} ms on this thread and "
          f"{t_thread:.3f} ms on a worker; {n} sequential submits to an idle "
          f"ContinuousZooServer: p50 {st['p50_ms']:.3f} ms, queue wait p50 "
          f"{st['p50_wait_ms']:.3f} ms, a dispatch "
          f"{st['mean_dispatch_ms']:.3f} ms")


def fronts_phase(prof, seed, zoo, test_sets, device):
    """Phase 11: ``AsyncZooServer`` and ``ContinuousZooServer`` against the
    sync classify on the zoo's traffic; the closed-loop rate of the engine;
    ``open_loop`` at ``LOADS`` of it."""
    import asyncio

    import numpy as np
    import torch
    from repro_torch.core.packets import u32_from_bits
    from repro_torch.runtime import SizeOrDeadlinePolicy
    from repro_torch.serving import (
        AsyncZooServer,
        ContinuousZooServer,
        open_loop,
    )

    rng = np.random.default_rng(seed + 11)
    pbs = [traffic(rng, zoo, test_sets, int(rng.integers(1, 65)))[0]
           for _ in range(96)]
    wants = [zoo.runtime.run_host(p) for p in pbs]

    def policy():
        return SizeOrDeadlinePolicy(max_batch=BATCH, max_wait_us=500.0)

    async def fronts(cls, **kw):
        async with cls(zoo, policy=policy(), **kw) as srv:
            outs = await asyncio.gather(*[srv.submit_batch(p) for p in pbs])
            return outs, srv.latency_stats()

    for cls, kw in ((AsyncZooServer, {}),
                    (ContinuousZooServer, {"n_slots": 2})):
        outs, stats = asyncio.run(fronts(cls, **kw))
        for i, (o, w) in enumerate(zip(outs, wants)):
            if not (np.array_equal(o.rslt, w.rslt.numpy())
                    and np.array_equal(o.codes, u32_from_bits(w.codes))
                    and np.array_equal(o.svm_acc, w.svm_acc.numpy())):
                raise AssertionError(f"{cls.__name__} request {i} != the "
                                     "sync classify")
        print(f"{cls.__name__}: {len(pbs)} requests of 1-64 packets == "
              f"ZooServer's sync classify on rslt, codes, svm_acc; "
              f"{stats['dispatches']} dispatches, "
              f"{stats['mean_batch_packets']:.1f} packets a dispatch"
              + (f", engine {stats['engine']}" if "engine" in stats else ""))

    # requests for the load runs: 1-64 packets of the zoo's traffic
    reqs = []
    for _ in range(512):
        pbn, Xn, vn, _ = traffic(rng, zoo, test_sets, int(rng.integers(1, 65)))
        reqs.append((Xn, pbn.mid.numpy(), vn))

    dispatch_probe(zoo, reqs, torch)

    async def closed(seconds=LOAD_SECONDS):
        async with ContinuousZooServer(zoo, policy=policy(),
                                       n_slots=2) as srv:
            loop = asyncio.get_running_loop()
            done = [0]
            t_end = loop.time() + seconds

            async def client(c):
                i = c
                while loop.time() < t_end:
                    X, mid, vid = reqs[i % len(reqs)]
                    await srv.submit(X, mid=mid, vid=vid)
                    done[0] += 1
                    i += CLIENTS
            t0 = loop.time()
            await asyncio.gather(*[client(c) for c in range(CLIENTS)])
            return done[0] / (loop.time() - t0), srv.latency_stats()

    rate, stats = asyncio.run(closed())
    print(f"closed loop, {CLIENTS} clients x {LOAD_SECONDS} s through "
          f"ContinuousZooServer (n_slots 2, size-or-deadline {BATCH} / 500 "
          f"us): {rate:.1f} requests/s, p50 {stats['p50_ms']:.3f} ms, p99 "
          f"{stats['p99_ms']:.3f} ms, {stats['mean_batch_packets']:.1f} "
          "packets a dispatch")

    async def opened(load):
        async with ContinuousZooServer(zoo, policy=policy(),
                                       n_slots=2) as srv:
            async def submit(i):
                X, mid, vid = reqs[i % len(reqs)]
                await srv.submit(X, mid=mid, vid=vid)
            n = max(int(load * rate * LOAD_SECONDS), 8)
            pauses = []
            t_gc = [0.0]

            def on_gc(what, info):
                if what == "start":
                    t_gc[0] = time.perf_counter()
                else:
                    pauses.append((info["generation"],
                                   (time.perf_counter() - t_gc[0]) * 1e3))
            gc.callbacks.append(on_gc)
            try:
                report = await open_loop(submit, rate_rps=load * rate,
                                         n_requests=n, n_clients=8,
                                         seed=seed)
            finally:
                gc.callbacks.remove(on_gc)
            return report, dict(srv.latency_stats(),
                                gc_n=len(pauses),
                                gc_ms=sum(ms_ for _, ms_ in pauses),
                                gc2_n=sum(g == 2 for g, _ in pauses),
                                gc_max_ms=max((ms_ for _, ms_ in pauses),
                                              default=0.0))

    def row(load, report, stats):
        print(f"open loop at {load} x {rate:.1f} = {report.offered_rps:.1f} "
              f"requests/s offered (Poisson, 1-64 packets): achieved "
              f"{report.achieved_rps:.1f}/s, p50 {report.p50_ms:.3f} ms, p99 "
              f"{report.p99_ms:.3f} ms, p99.9 {report.p999_ms:.3f} ms, errors "
              f"{report.errors} of {report.requests}; in the server: p50 "
              f"{stats['p50_ms']:.3f} ms, queue wait p50 "
              f"{stats['p50_wait_ms']:.3f} ms, a cut's wait for a slot "
              f"{stats['mean_slot_wait_ms']:.3f} ms, a dispatch "
              f"{stats['mean_dispatch_ms']:.3f} ms (to the thread "
              f"{stats['mean_to_thread_ms']:.3f}, on it "
              f"{stats['mean_on_thread_ms']:.3f} of which the lock "
              f"{stats['mean_lock_wait_ms']:.3f}, back to the loop "
              f"{stats['mean_to_loop_ms']:.3f}), "
              f"{stats['mean_batch_packets']:.1f} packets, padding "
              f"{100 * stats['pad_share']:.1f}% of the buckets; the garbage "
              f"collector ran {stats['gc_n']} times ({stats['gc2_n']} full), "
              f"{stats['gc_ms']:.1f} ms in all, longest "
              f"{stats['gc_max_ms']:.1f} ms")
        if report.errors:
            raise AssertionError(f"{report.errors} requests failed at load "
                                 f"{load}")
        return dict(load=load, **report.row(),
                    mean_batch_packets=stats["mean_batch_packets"],
                    server_p50_ms=stats["p50_ms"],
                    server_wait_p50_ms=stats["p50_wait_ms"],
                    dispatch_ms=stats["mean_dispatch_ms"],
                    **{k: stats[k] for k in (
                        "mean_slot_wait_ms", "mean_to_thread_ms",
                        "mean_on_thread_ms", "mean_lock_wait_ms",
                        "mean_to_loop_ms", "pad_share")},
                    gc_collections=stats["gc_n"], gc_full=stats["gc2_n"],
                    gc_ms=stats["gc_ms"], gc_max_ms=stats["gc_max_ms"])

    rows = [row(load, *asyncio.run(opened(load))) for load in LOADS]
    torch.cuda.synchronize()
    return {"closed_loop_requests_per_s": rate, "open_loop": rows}


def fleet_kill_schedule(fleet, draw, oracle_engine, mode):
    """One fault schedule of the topology lane (``draw``: a ``FleetCase``)
    served live through ``fleet.serving()``, the kills landing while the
    "during" phase is in flight; every phase held to ``mode="ref"``.
    Returns the control counters."""
    import asyncio

    import numpy as np
    from repro_torch.core.packets import u32_from_bits

    async def serve():
        outs = []
        async with fleet.serving(probe_interval_s=0.005):
            outs.append(await fleet.submit_batch(draw.phases[0]))
            during = asyncio.create_task(fleet.submit_batch(draw.phases[1]))
            await asyncio.sleep(0)
            for d in draw.kills:
                fleet.kill(d)
            outs.append(await during)
            outs.append(await fleet.submit_batch(draw.phases[2]))
            return outs, fleet.latency_stats()["control"]

    outs, ctl = asyncio.run(serve())
    for name, pb, out in zip(("before", "during", "after"), draw.phases,
                             outs):
        want = oracle_engine.classify(draw.packed, pb)
        got = (out.rslt, out.codes, out.svm_acc)
        exp = (want.rslt.cpu().numpy(), u32_from_bits(want.codes),
               want.svm_acc.cpu().numpy())
        for f, g, w in zip(("rslt", "codes", "svm_acc"), got, exp):
            if not np.array_equal(g, w):
                raise AssertionError(f"fault schedule seed {draw.seed} mode "
                                     f"{mode}: phase {name} {f} != mode ref")
    if not (ctl["failures_detected"] >= 1 and ctl["replans"] >= 1
            and ctl["drains"] >= 1 and ctl["reinstalls"] >= 1
            and ctl["heal_failures"] == 0):
        raise AssertionError(f"fault schedule seed {draw.seed}: counters "
                             f"{ctl}")
    if set(draw.kills) & set(fleet.path):
        raise AssertionError(f"killed {draw.kills} still on {fleet.path}")
    return ctl


def pool_ptrs(executor):
    """Every resident tensor's address in the fleet's hop pool."""
    from repro_torch.core.plane import program_tensors

    return [[t.data_ptr() for t in program_tensors(p)]
            for p in executor.pool]


def fleet_phase(prof, seed, device, programs, zoo, test_sets, pb):
    """Phase 12: the self-healing fleet on the card (see the module
    docstring).  Returns the numbers of the ``paths`` line."""
    import asyncio

    import numpy as np
    import torch
    from repro_torch.core.distributed_plane import build_zoo_device_programs
    from repro_torch.core.packets import u32_from_bits
    from repro_torch.core.plane import SwitchEngine
    from repro_torch.core.planner import DeviceModel, plan_zoo
    from repro_torch.core.topology import fat_tree
    from repro_torch.data import conformance as draws
    from repro_torch.serving import FleetRuntime, open_loop

    net = fat_tree(4)
    vids = sorted(programs)
    progs = [programs[v] for v in vids]
    oracle = SwitchEngine(prof, mode="ref", device=device)
    want = oracle.classify(zoo.packed, pb)
    out = {}

    # the zoo at full width, two pods apart, in the fused and layerwise modes
    fleets = {}
    for mode in (None, "layerwise"):
        t0 = time.perf_counter()
        fl = fleets[mode] = FleetRuntime(
            net, prof, progs, src=FLEET_SRC, dst=FLEET_DST, mode=mode,
            default_device=DeviceModel(n_stages=FLEET_STAGES))
        hops = fl.executor.devices
        if len(hops) < 2 or fl.executor.device.type != device.type:
            raise AssertionError(f"fleet on {fl.executor.device} hosted by "
                                 f"{hops}: not a card fleet of >= 2 hops")
        print(f"FleetRuntime(mode={mode!r}) built in "
              f"{time.perf_counter() - t0:.3f} s: path "
              f"{' -> '.join(fl.path)}, hosting {', '.join(hops)}")
        per = per_classify(mode, prof)
        for what in ("capture", "replay"):
            got = checked(lambda: fl.runtime.run(pb), per,
                          n_classify=len(hops))
            same_fields(f"fleet ({mode or 'fused'}, {what}) vs mode ref",
                        got, want)
        steps = []
        for _ in range(20):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fl.runtime.run(pb)
            torch.cuda.synchronize()
            steps.append((time.perf_counter() - t0) * 1e3)
        ms_ = float(np.median(steps))
        out[f"classify_ms_{mode or 'fused'}"] = ms_
        out[f"requests_per_s_{mode or 'fused'}"] = pb.batch / ms_ * 1e3
        print(f"B={pb.batch}, mode {mode or 'fused'}: {len(hops)} hops == "
              f"mode ref on rslt, codes, svm_acc; launches {len(hops)} x "
              f"{per} a replay; {ms_:.3f} ms a batch (median of 20), "
              f"{pb.batch / ms_ * 1e3:.1f} requests/s")
    fleet = fleets[None]
    del fleets["layerwise"]

    # retarget to another hosting count and back: one entry per count, no
    # resident tensor moved
    ex = fleet.executor
    home = (list(fleet.path), list(ex.devices), fleet.replan_sync()[2])
    alt = plan_zoo(progs, net, FLEET_SRC, FLEET_DST,
                   default_device=DeviceModel(n_stages=FLEET_STAGES_ALT))
    alt_devs, alt_progs = build_zoo_device_programs(progs, alt, prof, "cpu")
    if len(alt_devs) == len(home[1]):
        raise AssertionError(f"{FLEET_STAGES_ALT} stage slots host the zoo "
                             f"on {len(alt_devs)} switches too")
    ptrs, size, per = pool_ptrs(ex), ex.cache_size(), per_classify(None, prof)
    t0 = time.perf_counter()
    ex.retarget(alt[0].path, alt_devs, alt_progs)
    retarget_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    got = checked(lambda: fleet.runtime.run(pb), per, n_classify=len(alt_devs))
    capture_ms = (time.perf_counter() - t0) * 1e3
    same_fields(f"fleet retargeted to {len(alt_devs)} hops", got, want)
    grown = ex.cache_size()
    ex.retarget(*home)
    got = checked(lambda: fleet.runtime.run(pb), per, n_classify=len(home[1]))
    same_fields(f"fleet retargeted back to {len(home[1])} hops", got, want)
    bound = 1 * 2                  # one bucket (B 4096) x two hosting counts
    if not (grown == size + 1 and ex.cache_size() == grown <= bound):
        raise AssertionError(f"cache_size {size} -> {grown} -> "
                             f"{ex.cache_size()}: bound {bound}")
    if pool_ptrs(ex) != ptrs:
        raise AssertionError("a retarget moved a resident data_ptr")
    print(f"retarget {len(home[1])} -> {len(alt_devs)} hops "
          f"({retarget_ms:.3f} ms, programs copied in from the host), the "
          f"first classify there (a capture) {capture_ms:.3f} ms, and back: "
          f"cache_size {size} -> {grown} -> {ex.cache_size()} (bound 1 "
          "bucket x 2 hosting counts), no resident data_ptr moved")
    out.update(retarget_ms=retarget_ms, capture_at_new_count_ms=capture_ms)

    # the eight seeded fault schedules of the conformance lane
    cprof = draws.profile(draws.FLEET_V)
    maker = SwitchEngine(cprof, device=device)
    coracle = SwitchEngine(cprof, mode="ref", device=device)
    heals = []
    for case in range(draws.N_FAULT_CASES):
        draw = draws.draw_fleet_case(case, maker)
        row = []
        for mode in (None, "layerwise"):
            fl = FleetRuntime(draw.network, cprof, draw.programs,
                              src=draw.src, dst=draw.dst, mode=mode,
                              default_device=draw.device_model)
            if fl.path != draw.path:
                raise AssertionError(f"fault case {case}: path {fl.path}, "
                                     f"drawn on {draw.path}")
            n0 = len(fl.executor.devices)
            ctl = fleet_kill_schedule(fl, draw, coracle, mode)
            heals.append(ctl["last_heal_ms"])
            row.append(f"{mode or 'fused'} {n0} -> "
                       f"{len(fl.executor.devices)} hops, heal "
                       f"{ctl['last_heal_ms']:.3f} ms, retries "
                       f"{ctl['retries']}")
        print(f"fault case {case} (seed {draw.seed}, {draw.device_model.n_stages}"
              f" stages, kill {draw.kills} on {' -> '.join(draw.path)}): "
              "every phase == mode ref; " + "; ".join(row))
    out["fault_schedule_heal_ms"] = heals

    # a kill under open-loop load
    rng = np.random.default_rng(seed + 12)
    reqs, wants = [], []
    for _ in range(512):
        pbn, Xn, vn, _ = traffic(rng, zoo, test_sets, int(rng.integers(1, 65)))
        reqs.append((Xn, pbn.mid.numpy(), vn))
        w = oracle.classify(zoo.packed, zoo.make_request(Xn, mid=pbn.mid.numpy(),
                                                         vid=vn))
        wants.append((w.rslt.cpu().numpy(), u32_from_bits(w.codes),
                      w.svm_acc.cpu().numpy()))
    fleet.runtime.warm(passthrough(prof), 64)

    wrong = []

    def check(i, r):
        w = wants[i % len(reqs)]
        if not (np.array_equal(r.rslt, w[0]) and np.array_equal(r.codes, w[1])
                and np.array_equal(r.svm_acc, w[2])):
            wrong.append(i)

    async def closed(seconds):
        async with fleet.serving():
            loop = asyncio.get_running_loop()
            done = [0]
            t_end = loop.time() + seconds

            async def client(c):
                i = c
                while loop.time() < t_end:
                    X, mid, vid = reqs[i % len(reqs)]
                    check(i, await fleet.submit(X, mid=mid, vid=vid))
                    done[0] += 1
                    i += CLIENTS
            t0 = loop.time()
            await asyncio.gather(*[client(c) for c in range(CLIENTS)])
            return done[0] / (loop.time() - t0), fleet.latency_stats()

    rate, stats = asyncio.run(closed(FLEET_SECONDS / 2))
    if wrong:
        raise AssertionError(f"closed loop: requests {wrong[:8]} != mode ref")
    print(f"closed loop through fleet.serving() ({CLIENTS} clients, "
          f"{len(ex.devices)} hops, size-or-deadline 64 / 500 us): "
          f"{rate:.1f} requests/s, p50 {stats['p50_ms']:.3f} ms, p99 "
          f"{stats['p99_ms']:.3f} ms; every answer == mode ref")

    victim = fleet.path[3]
    if victim not in ex.devices:
        raise AssertionError(f"{victim} hosts no stage of {ex.devices}")
    spans, calls = {}, []

    def timed(name, fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                spans[name] = (t0, time.perf_counter())
        return run

    def atimed(name, fn):
        async def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return await fn(*a, **kw)
            finally:
                spans[name] = (t0, time.perf_counter())
        return run

    classify = ex.classify

    def logged(batch):
        t0 = time.perf_counter()
        try:
            return classify(batch)
        finally:
            calls.append((t0, (time.perf_counter() - t0) * 1e3,
                          ex.cache_size()))

    async def opened(load):
        async with fleet.serving():
            server = fleet.control.server
            server.drain = atimed("drain", server.drain)
            loop = asyncio.get_running_loop()
            lat = []

            async def submit(i):
                X, mid, vid = reqs[i % len(reqs)]
                t0 = time.perf_counter()
                r = await fleet.submit(X, mid=mid, vid=vid)
                lat.append((t0, (time.perf_counter() - t0) * 1e3))
                check(i, r)

            async def kill():
                await asyncio.sleep(FLEET_SECONDS / 2)
                spans["kill"] = (time.perf_counter(),) * 2
                fleet.kill(victim)
            killer = loop.create_task(kill())
            report = await open_loop(
                submit, rate_rps=load * rate,
                n_requests=max(int(load * rate * FLEET_SECONDS), 8),
                n_clients=8, seed=seed)
            await killer
            return report, lat, fleet.latency_stats()

    fleet.replan_sync = timed("replan", fleet.replan_sync)
    fleet.reinstall = timed("reinstall", fleet.reinstall)
    ex.classify = logged
    try:
        report, lat, stats = asyncio.run(opened(FLEET_LOAD))
    finally:
        del fleet.replan_sync, fleet.reinstall, ex.classify
    ctl = stats["control"]
    if (report.errors or wrong or ctl["heal_failures"]
            or not ctl["reinstalls"]):
        raise AssertionError(f"open loop with a kill: {report.errors} "
                             f"errors, requests {wrong[:8]} != mode ref, "
                             f"counters {ctl}")
    if victim in fleet.path:
        raise AssertionError(f"{victim} still on {fleet.path}")
    split = {k: (spans[k][1] - spans[k][0]) * 1e3
             for k in ("replan", "drain", "reinstall")}
    t_kill, t_healed = spans["kill"][0], spans["reinstall"][1]
    after = [c for c in calls if c[0] >= t_healed]
    first_ms = after[0][1]

    def pct(xs):
        return (float(np.percentile(xs, 50)), float(np.percentile(xs, 99))) \
            if xs else (float("nan"), float("nan"))
    before = pct([ms_ for t, ms_ in lat if t < t_kill])
    healed = pct([ms_ for t, ms_ in lat if t >= t_healed])
    print(f"open loop at {FLEET_LOAD} x {rate:.1f} = {report.offered_rps:.1f}"
          f" requests/s (Poisson, 1-64 packets), {victim} killed "
          f"{FLEET_SECONDS / 2} s in: errors {report.errors} of "
          f"{report.requests}, every answer == mode ref, achieved "
          f"{report.achieved_rps:.1f}/s, p50 {report.p50_ms:.3f} ms, p99 "
          f"{report.p99_ms:.3f} ms")
    print(f"heal: last_heal_ms {ctl['last_heal_ms']:.3f} (replan "
          f"{split['replan']:.3f} on a worker thread, drain "
          f"{split['drain']:.3f}, reinstall {split['reinstall']:.3f}); "
          f"failures {ctl['failures_detected']}, replans {ctl['replans']}, "
          f"retries {ctl['retries']}; new path {' -> '.join(fleet.path)}; "
          f"the first post-heal dispatch {first_ms:.3f} ms (cache_size "
          f"{after[0][2]}); per request from the submit call, before the "
          f"kill p50 {before[0]:.3f} / p99 {before[1]:.3f} ms, after the "
          f"heal p50 {healed[0]:.3f} / p99 {healed[1]:.3f} ms")
    out.update(closed_loop_requests_per_s=rate, open_loop=report.row(),
               last_heal_ms=ctl["last_heal_ms"],
               heal_split_ms=split, first_post_heal_dispatch_ms=first_ms,
               retries=ctl["retries"], p50_p99_before_ms=before,
               p50_p99_after_ms=healed)

    # the cut vertex: the src host's only edge switch
    edge = fleet.path[1]

    async def cut():
        async with fleet.serving(probe_interval_s=30.0):
            fleet.kill(edge)
            try:
                await fleet.control.heal()
            except RuntimeError as e:
                return str(e), fleet.counters.heal_failures
            raise AssertionError(f"heal() with {edge} dead did not raise")
    msg, failures = asyncio.run(cut())
    fleet.revive(edge)
    if "no surviving path" not in msg or failures != 1:
        raise AssertionError(f"cut vertex: {msg!r}, heal_failures {failures}")
    print(f"cut vertex {edge} killed: heal() raised RuntimeError "
          f"({msg.split(' with ')[0]}), heal_failures {failures}")
    torch.cuda.synchronize()
    return out


# ------------------------------------------------- phase 13: the lanes
LANE_SIZES = (BATCH, 1, 7, 509, 4095)    # phase 13: B 4096, then ragged


def lane_layouts(dps, full):
    """Phase 13's layouts: (name, programs, n_ports, n_micro)."""
    return (("pipelined_5x1", dps, 1, 8),
            ("sharded_5x2", dps, 2, 4),
            ("sharded_1x4", [full], 4, 1))


def lane_trace(step, torch, n=5):
    """``step()`` ``n`` times under the profiler: the device's busy us a
    step (each kernel and copy once), kernels by wrapper name and
    ``cudaGraphLaunch`` calls a step, and how the kernels' intervals on
    the card overlap: the us a step during which any kernel ran, the us
    during which two or more ran at once, the most at once, and the
    kernels that began while another was running."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    dev = [e for e in p.events() if e.device_type != DeviceType.CPU]
    busy = sum(e.time_range.end - e.time_range.start for e in dev)
    kern = sorted((e.time_range.start, e.time_range.end) for e in dev
                  if not e.name.startswith(("Memcpy", "Memset")))
    got = {}
    for e in dev:
        for name, fn in KERNEL_FN.items():
            if fn in e.name:
                got[name] = got.get(name, 0) + 1
    graphs = sum(1 for e in p.events() if e.device_type == DeviceType.CPU
                 and e.name.startswith("cudaGraphLaunch"))
    edges = sorted([(t0, 1) for t0, _ in kern] + [(t1, -1) for _, t1 in kern])
    live = most = 0
    overlap = active = 0.0
    last = None
    for t, d in edges:
        if live >= 1:
            active += t - last
        if live >= 2:
            overlap += t - last
        live += d
        most = max(most, live)
        last = t
    began, end = 0, float("-inf")
    for t0, t1 in kern:               # sorted by start
        began += end > t0
        end = max(end, t1)
    return dict(busy_us=busy / n, kernel_active_us=active / n,
                kernels_per_step=len(kern) / n, overlap_us=overlap / n,
                most_at_once=most, began_while_another_ran=began / n,
                by_kernel={k: v / n for k, v in got.items()},
                graph_launches=graphs / n)


def lane_runtimes(dps, full, devices_of, prof):
    """Every phase 13 layout in the fused and layerwise modes, lanes on
    ``devices_of(n)``: {(layout, mode): (runtime, hops a classify)}."""
    from repro_torch.runtime import DataplaneRuntime, ShardedExecutor

    rts = {}
    for name, progs, n_ports, n_micro in lane_layouts(dps, full):
        for mode in (None, "layerwise"):
            ex = ShardedExecutor(progs, n_classes=prof.max_classes,
                                 mode=mode, n_ports=n_ports, n_micro=n_micro,
                                 devices=devices_of(len(progs) * n_ports))
            rts[name, mode] = (DataplaneRuntime(ex),
                               n_micro * len(progs) * n_ports)
    return rts


def lane_checks(rts, prof, pb, want, second, swaps, tag):
    """Each runtime at every B of ``LANE_SIZES`` == ``want[B]`` with exact
    launches (after warming the ladder to ``BATCH`` where it keeps
    graphs: ``cache_size()`` the ladder's length, before and after); a swap
    to the second zoo (``swaps[layout][0]``, answering ``second``) and back
    between replays, shown in the next replay, no resident ``data_ptr``
    moved."""
    from repro_torch.core.plane import program_tensors

    def ptrs(ex):
        return [[t.data_ptr() for t in program_tensors(p)]
                for p in ex.programs]
    for (name, mode), (rt, hops) in rts.items():
        ex = rt.executor
        graphs = len({d for row in ex.lanes for d in row}) == 1
        ladder = rt.warm(passthrough(prof), BATCH) if graphs else ()
        if rt.cache_size() != len(ladder):
            raise AssertionError(f"{tag} {name} {mode}: cache_size "
                                 f"{rt.cache_size()} after warming "
                                 f"{len(ladder)} buckets")
        before = ptrs(ex)
        for B in LANE_SIZES:
            part = pb.map(lambda x: x[:B])
            out = checked(lambda: rt.run(part), per_classify(mode, prof),
                          n_classify=hops)
            same_fields(f"{tag} {name} {mode or 'fused'} B={B}", out,
                        want[B])
        for progs, answer in zip(swaps[name], (second, want[BATCH])):
            rt.swap(progs)
            same_fields(f"{tag} {name} {mode or 'fused'} after a swap",
                        rt.run(pb), answer)
        if rt.cache_size() != len(ladder) or ptrs(ex) != before:
            raise AssertionError(f"{tag} {name} {mode}: the ragged sizes or "
                                 "the swaps added an entry or moved a "
                                 "resident data_ptr")
        print(f"{tag} {name} {mode or 'fused'}: {ex.n_switch} switches x "
              f"{ex.n_ports} ports, n_micro {ex.n_micro}, granularity "
              f"{ex.granularity}: B {', '.join(map(str, LANE_SIZES))} == mode "
              f"ref; launches {hops} x {per_classify(mode, prof)}; "
              f"cache_size {rt.cache_size()}"
              f"{' (eager)' if not graphs else ' (the warmed ladder)'} "
              "before and after; a swap and back shown in the next replay, "
              "no data_ptr moved")


def lane_autoscale(full, prof, pb, want, device):
    """``ContinuousZooServer`` over a lane pool of ``ShardedExecutor``s at
    1, 2 and 4 ports under an impossible SLO: it widens to 4 lanes and
    every answer equals mode ref."""
    import asyncio

    import numpy as np
    from repro_torch.core.packets import batch_to_arrays
    from repro_torch.runtime import (
        ShardedExecutor,
        SizeOrDeadlinePolicy,
        SloAutoscaler,
    )
    from repro_torch.serving import ContinuousZooServer, ZooServer

    pool = {k: ShardedExecutor([full], n_classes=prof.max_classes,
                               n_ports=k, n_micro=1, devices=[device] * k)
            for k in (1, 2, 4)}
    zoo = ZooServer(prof, executor=pool[1])
    scaler = SloAutoscaler(slo_p99_ms=1e-6, lanes=(1, 2, 4), window=4,
                           patience=1, cooldown=0)
    starts = [(97 * i) % (pb.batch - 48) for i in range(40)]
    spans = [(lo, lo + 1 + i % 48) for i, lo in enumerate(starts)]

    async def serve():
        async with ContinuousZooServer(
                zoo, policy=SizeOrDeadlinePolicy(max_batch=64,
                                                 max_wait_us=200.0),
                n_slots=2, lane_pool=pool, autoscaler=scaler) as srv:
            outs = []
            for lo, hi in spans:
                outs.append(await srv.submit_batch(
                    pb.map(lambda x: x[lo:hi])))
            return outs, srv.lanes, srv.latency_stats()["engine"]
    outs, lanes, eng = asyncio.run(serve())
    if lanes != 4 or eng["scale_ups"] != 2:
        raise AssertionError(f"the lane pool did not widen to 4: lanes "
                             f"{lanes}, {eng}")
    w = batch_to_arrays(want[BATCH])
    for (lo, hi), out in zip(spans, outs):
        for f in ("rslt", "codes", "svm_acc"):
            if not np.array_equal(getattr(out, f), w[f][lo:hi]):
                raise AssertionError(f"autoscaled lanes: {f} of [{lo}, "
                                     f"{hi}) differs from mode ref")
    print(f"autoscaled lane pool {{1, 2, 4}} ports: widened 1 -> 2 -> 4 "
          f"({eng['scale_ups']} scale-ups), {len(spans)} requests == mode "
          f"ref across the scale events; {len(eng['warmed_buckets'])} "
          "buckets warmed on the last lane")


def lanes_phase(prof, device, programs, runtimes, pb):
    """Phase 13 (see the module docstring).  Returns the numbers of the
    ``paths`` line."""
    import torch
    from repro_torch.core.plane import SwitchEngine, evict_program

    dps = list(runtimes[None].executor.programs)
    oracle = SwitchEngine(prof, mode="ref", device=device)
    full = oracle.empty()
    for v, p in programs.items():
        full = oracle.install(full, p, vid=v)
    want = {B: oracle.classify(full, pb.map(lambda x: x[:B]))
            for B in LANE_SIZES}
    second = oracle.classify(evict_program(full, prof, vid=0), pb)
    swaps = {name: ([evict_program(p, prof, vid=0) for p in progs], progs)
             for name, progs, _, _ in lane_layouts(dps, full)}
    print(f"the planned path's {len(dps)} hop programs and the zoo's full "
          "program; the second zoo: each with vid 0 evicted")
    card = torch.device("cuda", torch.cuda.current_device())
    rts = lane_runtimes(dps, full, lambda n: [card] * n, prof)
    lane_checks(rts, prof, pb, want, second, swaps, "one card:")
    stamp("lane checks done")
    lane_autoscale(full, prof, pb, want, card)
    stamp("lane autoscale done")
    n_cards = torch.cuda.device_count()
    if n_cards > 1:
        cards = [torch.device("cuda", i) for i in range(n_cards)]
        multi = lane_runtimes(dps, full, lambda n: [cards[i % n_cards]
                                                    for i in range(n)], prof)
        lane_checks(multi, prof, pb, want, second, swaps,
                    f"{n_cards} cards:")
    else:
        print(f"lanes on distinct cards: not run (this host has {n_cards} "
              "card)")
    steps = {f"{name}_{mode or 'fused'}": rt for (name, mode), (rt, _) in
             rts.items()}
    steps.update({f"sequential_5x1_{m or 'fused'}": rt
                  for m, rt in runtimes.items()})
    out = {}
    B = pb.batch
    for name, rt in steps.items():
        def step(rt=rt):
            return rt.run(pb).rslt.cpu()
        step()
        dts = []
        for _ in range(20):
            t0 = time.perf_counter()
            step()
            dts.append(time.perf_counter() - t0)
        wall = sorted(dts)[len(dts) // 2]
        tr = lane_trace(step, torch)
        out[name] = dict(ms=wall * 1e3, requests_per_s=B / wall, **tr)
        print(f"{name}: median {wall * 1e3:.3f} ms a {B}-request batch of "
              f"20 ({B / wall:.0f} requests/s); busy {tr['busy_us']:.1f} us "
              f"a step; {tr['kernels_per_step']:g} kernels a step, "
              f"{tr['overlap_us']:.1f} us of them with two or more at once "
              f"(most {tr['most_at_once']}), "
              f"{tr['began_while_another_ran']:g} began while another ran; "
              f"cudaGraphLaunch {tr['graph_launches']:g} a step")
        if tr["graph_launches"] != 1:
            raise AssertionError(f"{name}: {tr['graph_launches']} "
                                 "cudaGraphLaunch a replay, not 1")
    out["distinct_cards"] = n_cards > 1
    return out


# ---------------------------------------------- phase 15: the LM families
# arch -> layers on the card (None: all of them); qwen3-moe's 94 layers are
# 4.98 GB each in bf16, so 4 of them (22.4 GB with the embedding and head)
FAMILIES = {"qwen3-moe-235b-a22b": 4, "recurrentgemma-2b": None,
            "rwkv6-7b": None, "whisper-tiny": None}
# The families whose bf16 decode is also held end to end, kernel against
# twin and decode against forward, at the JAX package's bf16 bound.  The
# others fail that bound on correct runs (PERF.md, PR 20): qwen3-moe's top-8
# of 128 experts flips across near ties (gaps of 1e-8) between any two bf16
# orders of summation, and bf16 rounding carried through recurrentgemma-2b's
# 26 and rwkv6-7b's 32 random layers outgrows it.  In bf16 they are held
# launch by launch (every decode_attn against its plain version) and by the
# served tokens; their f32 copies are held end to end.
BF16_END_TO_END = ("whisper-tiny",)
# rwkv6-7b in f32: decode_step against forward on the model's first d
# layers, the weights shared; held (with the dropped-state control) up to
# RWKV_HELD layers, measured beyond: a random RWKV stack amplifies the two
# orders of summation's difference with depth (PERF.md)
RWKV_DEPTHS, RWKV_HELD = (1, 2, 4, 8, 16, 32), 2
# the hybrid's ring wrapped once: 2 superblocks at full width, B 4, a ring
# of cache_len = window = 2048 slots, 2048 + 64 positions teacher-forced
RING_ARCH, RING_LAYERS, RING_BATCH, RING_PAST = "recurrentgemma-2b", 6, 4, 64


def attn_layers(cfg) -> int:
    """``decode_attn`` launches a decode step of ``cfg``."""
    return {"dense": cfg.n_layers, "moe": cfg.n_layers,
            "hybrid": cfg.n_layers // 3, "rwkv": 0,
            "encdec": 2 * cfg.n_layers}[cfg.family]


def mxu_layers(cfg) -> int:
    """Launches a decode step of ``cfg`` of the mxu_native variant: its
    self attention where ``attn_mxu_native`` is set in bf16 (the cross
    attention never, as in the reference)."""
    if not (cfg.attn_mxu_native and cfg.dtype == "bfloat16"):
        return 0
    return attn_layers(cfg) // (2 if cfg.family == "encdec" else 1)


def family_cfg(arch):
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    depth = FAMILIES[arch]
    if depth is not None and depth < cfg.n_layers:
        print(f"{arch}: depth cut to {depth} of {cfg.n_layers} layers (the "
              "card's 80 GB), widths as published")
        cfg = cfg.scaled(n_layers=depth)
    else:
        print(f"{arch}: all {cfg.n_layers} layers"
              + (f" + {cfg.n_enc_layers} encoder layers"
                 if cfg.family == "encdec" else "") + ", no cut")
    return cfg


def family_state(model, cfg, B, cache_len, enc, device):
    from repro_torch.models.transformer import encode_kv, init_decode_state

    state = init_decode_state(cfg, B, cache_len, device=device)
    if cfg.family == "encdec":
        ks, vs = encode_kv(model, enc, cfg)
        state["ek"].copy_(ks)
        state["ev"].copy_(vs)
    return state


@contextlib.contextmanager
def launches_held():
    """Within the block every ``decode_attn`` call of the kernel path is
    held to the plain version on the same inputs, at the full-width bound
    (``ATTN_TOL_FULL``; the mxu_native variant's at ``mxu_bound``), and its
    output handed on; the plain version
    launches no kernel.  Yields a dict that gets the calls and the largest
    error after the block, which fails if any output was out of bounds."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attn import decode_attn_plain, mxu_bound

    real = ops.decode_attn
    errs, bad, seen = [], [], {}

    def held(q, k, v, kv_len, *, mxu_native=False, mode=None):
        out = real(q, k, v, kv_len, mxu_native=mxu_native, mode=mode)
        if q.is_cuda and mode in (None, "cuda"):
            want = decode_attn_plain(q, k, v, kv_len, mxu_native=mxu_native)
            atol, rtol = ATTN_TOL_FULL[str(q.dtype).removeprefix("torch.")]
            err = (out.float() - want.float()).abs()
            bound = (mxu_bound(q, k, v, kv_len, want)
                     if mxu_native and q.dtype == torch.bfloat16
                     else atol + rtol * want.float().abs())
            errs.append(err.amax())
            bad.append((err > bound).any() | (out.dtype != want.dtype))
        return out

    ops.decode_attn = held
    try:
        yield seen
    finally:
        ops.decode_attn = real
    seen["calls"] = len(errs)
    seen["max_abs_err"] = float(torch.stack(errs).max()) if errs else 0.0
    if errs and bool(torch.stack(bad).any()):
        raise AssertionError(f"decode_attn != its plain version in "
                             f"{int(torch.stack(bad).sum())} of {len(errs)} "
                             "calls of a decode run")


def family_teacher_forced(model, cfg, fed, enc, device, mode=None,
                          cache_len=None, keep_from=0):
    """Decode steps over ``fed`` [B, n] from a zero state (the encdec
    cross K/V from ``enc``); the logits [B, n - keep_from, V] of positions
    ``keep_from`` on.  Checks ``attn_layers(cfg)`` decode_attn launches a
    step on the kernel path and none on the twin's; on the kernel path
    every launch is held to the plain version (``launches_held``)."""
    import torch
    from repro_torch.models.transformer import decode_step

    fed = fed.to(device)
    B, n = fed.shape

    def run():
        state = family_state(model, cfg, B, cache_len or n, enc, device)
        out = []
        for t in range(n):
            logits, state = decode_step(model, state, fed[:, t:t + 1], t, cfg,
                                        mode=mode)
            if t >= keep_from:
                out.append(logits[:, 0])
        return torch.stack(out, dim=1)

    if mode is not None:
        return checked(run, {"decode_attn": 0}, n_classify=n)
    want = {"decode_attn": attn_layers(cfg), MXU: mxu_layers(cfg)}
    with launches_held() as seen:
        out = checked(run, want, n_classify=n)
    if seen["calls"]:
        atol, rtol = ATTN_TOL_FULL[cfg.dtype]
        bound = (f"atol {atol:.3g}, rtol {rtol:.3g}" if not want[MXU] else
                 f"mxu_bound for the {want[MXU]} mxu_native launches a step")
        print(f"  {seen['calls']} decode_attn launches, each held to its "
              f"plain version: max abs err {seen['max_abs_err']:.3g} "
              f"({bound})")
    return out


def family_forward(model, cfg, fed, enc, device, seqs=16):
    """``forward`` over ``fed``, ``seqs`` sequences a call."""
    import torch
    from repro_torch.models.transformer import forward

    fed = fed.to(device)
    return torch.cat([forward(model, fed[i:i + seqs], cfg,
                              enc_inputs=None if enc is None
                              else enc[i:i + seqs])
                      for i in range(0, fed.shape[0], seqs)])


@contextlib.contextmanager
def state_dropped():
    """Within the block, RWKV's decode step forgets its [K, V] state every
    step: the control of a family with no attention."""
    import torch
    from repro_torch.models import rwkv

    real = rwkv.time_mix_step

    def forgetful(x, params, state, *, n_heads):
        return real(x, params, {"S": torch.zeros_like(state["S"]),
                                "last": state["last"]}, n_heads=n_heads)

    rwkv.time_mix_step = forgetful
    try:
        yield
    finally:
        rwkv.time_mix_step = real


@contextlib.contextmanager
def routes(log):
    """Within the block, every routing of the port's MoE appends its
    experts [T, k] to ``log``."""
    from repro_torch.models import moe

    real = moe._route

    def spy(logits, top_k):
        probs, gates, idx = real(logits, top_k)
        log.append(idx)
        return probs, gates, idx

    moe._route = spy
    try:
        yield
    finally:
        moe._route = real


def family_step_bound(model, cfg, state, B, kv_len, experts=None):
    """(bytes, flops, ms) of the least a decode step at ``kv_len`` must do:
    the weights once (of a MoE's experts only the ``experts[l]`` that layer
    l's routing touched in the step), the K/V rows up to ``kv_len`` (the
    hybrid's ring up to its slots, the encdec's encoder cache whole) and
    every recurrent state once; flops 2 x active params x B plus 4 x rows x
    Hq x hd an attention layer (``roofline_terms``)."""
    from repro_torch.analysis import model_flops
    from repro_torch.models.transformer import state_items

    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    if experts is not None:
        lp = model.layers[0]
        one = sum(lp[n][0].numel() * lp[n].element_size()
                  for n in ("wg", "wu", "wd"))
        weights += one * (sum(experts) - cfg.n_layers * cfg.n_experts)
    es = 2 if cfg.dtype == "bfloat16" else 4
    row = B * cfg.n_kv * cfg.hd
    if cfg.family == "hybrid":
        rows = [min(kv_len, state["super"]["k"].shape[2])] * (cfg.n_layers // 3)
    elif cfg.family == "rwkv":
        rows = []
    else:
        rows = [kv_len] * cfg.n_layers
        if cfg.family == "encdec":
            rows += [cfg.enc_seq] * cfg.n_layers
    recurrent = sum(t.numel() * t.element_size()
                    for path, t in state_items(state)
                    if path[-1] not in ("k", "v", "ek", "ev"))
    nbytes = weights + sum(2 * r * row * es for r in rows) + recurrent
    flops = (model_flops(cfg, 1, B, "decode")
             + sum(4 * r * B * cfg.n_heads * cfg.hd for r in rows))
    return nbytes, flops, bound_ms(nbytes, flops)


class Holds:
    """Errors against bounds: a check must pass, a control must be
    refused; ``bad`` names each that did not."""

    def __init__(self):
        self.errors, self.bad = {}, []

    def __call__(self, what, got, want, tol, control=False):
        err, ok = close(got, want, *tol)
        rms = float((got.float() - want.float()).square().mean().sqrt())
        self.errors[("control: " if control else "") + what] = err
        verdict = (("PASSES  <-- NOT REFUSED" if ok else "refused")
                   if control else ("" if ok else "  <-- OUT OF BOUNDS"))
        print(f"  {'control, ' if control else ''}{what}: max abs err "
              f"{err:.4g}, rms {rms:.3g} (atol {tol[0]}, rtol {tol[1]})"
              f"{': ' if control else ''}{verdict}")
        if ok == control:
            self.bad.append(what)


def rwkv_layerwise(model, cfg, fed, device):
    """RWKV-6's decode recurrence against its chunked forward layer by
    layer, each layer fed the forward's own input: (every layer's stepwise
    outputs [L, B, S, D], the chunked ones), time mix and channel mix
    stacked; where the two agree up to the order of summation, however
    deep the stack."""
    import torch
    from repro_torch.models import rwkv
    from repro_torch.models.common import rms_norm

    H = cfg.n_heads
    x = model.embed[fed.to(device).long()]
    B, S, D = x.shape
    K = D // H
    stepwise, chunked = [], []
    for lp in model.layers:
        for which in ("time", "channel"):
            h = rms_norm(x, lp["ln1" if which == "time" else "ln2"])
            if which == "time":
                y, _ = rwkv.time_mix(h, lp, None, n_heads=H)
                st = {"S": torch.zeros((B, H, K, K), device=device),
                      "last": torch.zeros((B, D), device=device)}
            else:
                y, _ = rwkv.channel_mix(h, lp, None)
                st = {"last_c": torch.zeros((B, D), device=device)}
            outs = []
            for t in range(S):
                if which == "time":
                    o, st = rwkv.time_mix_step(h[:, t:t + 1], lp, st,
                                               n_heads=H)
                else:
                    o, st = rwkv.channel_mix_step(h[:, t:t + 1], lp, st)
                outs.append(o)
            stepwise.append(torch.cat(outs, dim=1))
            chunked.append(y)
            x = x + y
    return torch.stack(stepwise), torch.stack(chunked)


def first_layers(model, cfg, d):
    """(cfg, model) of ``model``'s first ``d`` layers, its embedding, norm
    and head: the same tensors, nothing copied."""
    import torch
    from repro_torch.models.transformer import new_model

    c = cfg.scaled(n_layers=d)
    m = new_model(c, device="meta")
    for name in ("embed", "head", "ln_f"):
        setattr(m, name, model[name])
    m.layers = torch.nn.ModuleList(list(model.layers)[:d])
    return c, m


def rwkv_depths(model, cfg, fed, device, hold, tag, tol):
    """RWKV's ``decode_step`` against ``forward`` on the model's first d
    layers (``RWKV_DEPTHS``): held, and the dropped state refused, up to
    ``RWKV_HELD`` layers; deeper, the error is measured (the drift of a
    random stack).  Then every layer's recurrence against its chunked
    forward at full depth (``rwkv_layerwise``), held.  Returns the error a
    depth."""
    drift = {}
    for d in RWKV_DEPTHS:
        c, m = first_layers(model, cfg, d)
        dec = family_teacher_forced(m, c, fed, None, device)
        fwd = family_forward(m, c, fed, None, device)
        if d <= RWKV_HELD:
            hold(f"{tag} decode_step vs forward, the first {d} layers", dec,
                 fwd, tol)
            with state_dropped():
                wrong = family_teacher_forced(m, c, fed, None, device)
            hold(f"{tag}, the first {d} layers, the RWKV state dropped every "
                 f"step, vs {tag} forward", wrong, fwd, tol, control=True)
            del wrong
        drift[d] = close(dec, fwd, *tol)[0]
        print(f"  {tag} the first {d} layers: decode_step vs forward max abs "
              f"err {drift[d]:.4g}")
        del c, m, dec, fwd
    got, want = rwkv_layerwise(model, cfg, fed, device)
    hold(f"{tag} every layer's decode recurrence vs its chunked forward, on "
         f"the forward's inputs ({cfg.n_layers} x time and channel mix)", got,
         want, tol)
    return drift


def family_checks(model, cfg, run, device, hold, tag, tol):
    """The last tenant's tokens teacher-forced through the kernel (each
    launch held to the plain version) against the twin attention and
    ``forward`` (moe: without drops, a sequence a call), and a wrong
    attention that both bounds must refuse; RWKV, with no attention, by
    depth and layer by layer (``rwkv_depths``).  Returns the kernel path's
    logits and RWKV's error a depth."""
    from repro_torch.kernels import ref

    enc, fed = run.enc_inputs, run.fed
    dec = family_teacher_forced(model, cfg, fed, enc, device)
    if cfg.family == "rwkv":
        return dec, rwkv_depths(model, cfg, fed, device, hold, tag, tol)
    twin = family_teacher_forced(model, cfg, fed, enc, device, mode="ref")
    hold(f"{tag} decode vs the twin attention", dec, twin, DECODE_TOL)
    fcfg, seqs, fdec = cfg, fed.shape[0], dec
    if cfg.family == "moe":
        # capacity depends on how many tokens route at once: without drops
        # (capacity_factor = n_experts, as tests/test_models_lm.py) prefill
        # and decode route alike
        fcfg, seqs = cfg.scaled(capacity_factor=float(cfg.n_experts)), 1
        fdec = family_teacher_forced(model, fcfg, fed, enc, device)
    fwd = family_forward(model, fcfg, fed, enc, device, seqs)
    hold(f"{tag} decode vs {tag} forward"
         + (f" (capacity factor {fcfg.capacity_factor})"
            if fcfg is not cfg else ""), fdec, fwd, tol)

    def newest_dropped(q, k, v, kv_len):
        return ref.decode_attn(q, k, v, kv_len - 1)

    with wrong_attention(newest_dropped):
        wrong = family_teacher_forced(model, fcfg, fed, enc, device,
                                      mode="ref")
    what = "newest row dropped"
    hold(f"{tag}, {what}, vs {tag} forward", wrong, fwd, tol, control=True)
    if fcfg is cfg:
        hold(f"{tag}, {what}, vs the twin attention", wrong, twin,
             DECODE_TOL, control=True)
    return dec, None


def f32_copy(cfg, seed, tenant, device):
    """An f32 model of ``cfg`` drawn from tenant ``tenant``'s generator."""
    from repro_torch.launch.serve import tenant_generator
    from repro_torch.models.transformer import new_model

    cfg32 = cfg.scaled(dtype="float32")
    return cfg32, new_model(cfg32, device=device).init_(
        tenant_generator(seed, tenant, device))


def family_phase(arch, seed, device):
    """One family at full width through ``launch.serve.serve`` (B 16, 64
    prompt + 32 greedy tokens, 2 tenants swapped in place), its last tenant
    teacher-forced through the kernel (every launch held to the plain
    version; the served tokens its argmax), and the step's time against
    its bound.  In bf16 the kernel against the twin and decode against
    ``forward`` are held for ``BF16_END_TO_END``; then on an f32 copy of the
    same depth, the bf16 weights freed first, they are held for every
    family (``family_checks``: kernel vs twin at phase 8's bound, decode vs
    forward at f32 1e-4)."""
    import torch
    from repro_torch.launch.serve import serve
    from repro_torch.models.transformer import decode_step, state_items

    cfg = family_cfg(arch)
    B, P, G = LM_SERVE["batch"], LM_SERVE["prompt_len"], LM_SERVE["gen"]
    steps = P + G
    print(f"{cfg.name} ({cfg.family}): {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} query / {cfg.n_kv} KV heads of "
          f"{cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab}"
          + (f", {cfg.n_experts} experts top {cfg.top_k} of d_ff "
             f"{cfg.moe_d_ff}, capacity factor {cfg.capacity_factor}"
             if cfg.family == "moe" else "")
          + (f", window {cfg.window}, RG-LRU width {cfg.lru_dim}"
             if cfg.family == "hybrid" else "")
          + (f", encoder {cfg.n_enc_layers} layers over {cfg.enc_seq} frames"
             if cfg.family == "encdec" else "")
          + f"; {attn_layers(cfg)} decode_attn launches a step")
    torch.cuda.reset_peak_memory_stats()
    model, _, runs = checked(
        lambda: serve(cfg, seed=seed, device=device, **LM_SERVE),
        {"decode_attn": attn_layers(cfg)},
        n_classify=LM_SERVE["swaps"] * steps)
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    print(f"  {weights:,} bytes of weights ({torch.cuda.max_memory_allocated() / 1e9:.1f} "
          "GB the card's peak while serving)")
    for t, run in enumerate(runs):
        print(f"  tenant {t}: {B}x({P} prompt + {G} greedy) steps in "
              f"{run.seconds * 1e3:.1f} ms ({B * G / run.seconds:.1f} "
              f"generated tok/s, {B * steps / run.seconds:.1f} tok/s over "
              "all steps)")
    run, last = runs[-1], len(runs) - 1
    hold = Holds()
    tol = FORWARD_TOL["bf16 decode vs bf16 forward"]
    if arch in BF16_END_TO_END:
        dec = family_checks(model, cfg, run, device, hold, "bf16", tol)[0]
    else:
        dec = family_teacher_forced(model, cfg, run.fed, run.enc_inputs,
                                    device)
    greedy = dec[:, P - 1:].argmax(dim=-1).cpu()
    if not torch.equal(greedy, run.tokens[:, P:]):
        raise AssertionError(f"{arch}: the served tokens are not the argmax "
                             "of the teacher-forced steps")
    print(f"  served tokens == argmax of the teacher-forced steps; logits: "
          f"max |x| {float(dec.float().abs().max()):.3f}, rms "
          f"{float(dec.float().square().mean().sqrt()):.3f}")
    del dec

    # one step's time with the caches filled to the served length
    enc = run.enc_inputs
    gen = torch.Generator(device=device).manual_seed(seed + 23)
    state = family_state(model, cfg, B, steps, enc, device)
    for path, t in state_items(state):
        if path[-1] in ("k", "v"):
            t.normal_(generator=gen)
    tok = torch.randint(0, cfg.vocab, (B, 1), generator=gen, device=device)

    def step():
        return decode_step(model, state, tok, steps - 1, cfg)

    log = []
    with routes(log):
        step()
    experts = [int(idx.unique().numel()) for idx in log] or None
    torch.cuda.synchronize()
    step_s, windows, gcp = host_step_s(step, torch, 10)
    nbytes, flops, bound = family_step_bound(model, cfg, state, B, steps,
                                             experts)
    ws = ", ".join(f"{w:.3f}" for w in windows)
    print(f"  decode step at kv_len {steps}, B {B}: {step_s * 1e3:.3f} ms, "
          f"the median of 5 windows of 10 steps ({ws}; {B / step_s:.1f} "
          f"tok/s); bound {bound:.4f} ms (roofline_terms: {nbytes:,} bytes "
          f"at {hbm_tb_s()}, {flops:,.0f} flops), {step_s * 1e3 / bound:.1f}x "
          f"the bound; {gc_text(gcp)}"
          + (f"; experts read: the {sum(experts)} of {cfg.n_layers} x "
             f"{cfg.n_experts} that the step's routing touched "
             f"({experts} a layer)" if experts else ""))
    print(f"  -- where the time goes, {arch} decode step at kv_len {steps}")
    busy = where_the_time_goes(step, torch, n=5)
    print(f"  device busy {busy['busy_us']:.1f} us a step = "
          f"{100 * busy['busy_us'] / (step_s * 1e6):.1f}% of the unprofiled "
          "step")
    del state, step, model
    gc.collect()
    torch.cuda.empty_cache()
    cfg32, model = f32_copy(cfg, seed, last, device)
    print(f"  f32 copy ({cfg32.n_layers} layers, tenant {last}'s generator), "
          "the same tokens:")
    drift = family_checks(model, cfg32, run, device, hold, "f32",
                          FORWARD_TOL["f32 decode vs f32 forward"])[1]
    if hold.bad:
        raise AssertionError(f"{arch}: failed {hold.bad}")
    out = dict(layers=cfg.n_layers, weight_bytes=weights,
               generated_tokens_per_s=[B * G / r.seconds for r in runs],
               step_ms=step_s * 1e3, step_tokens_per_s=B / step_s,
               step_bound_ms=bound, step_bytes=nbytes, step_flops=flops,
               experts_read=experts, gc_ms=gcp["ms"],
               busy_us=busy["busy_us"], launches_per_step=attn_layers(cfg),
               errors=hold.errors, f32_drift_by_depth=drift)
    del model, runs
    gc.collect()
    torch.cuda.empty_cache()
    return out


def ring_phase(seed, device):
    """recurrentgemma-2b at full width, depth cut to 2 superblocks, B 4,
    its ring of 2048 slots (``cache_len = window``) wrapped once: 2048 + 64
    positions teacher-forced through the kernel (every launch held to the
    plain version); the last 64 held to ``forward``, whose local attention
    is the window mask, at the bf16 bound and, on an f32 copy, at f32
    1e-4, which must refuse forward with no window."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import forward, init_params

    cfg = get_config(RING_ARCH)
    W = cfg.window
    cfg = cfg.scaled(n_layers=RING_LAYERS)
    n = W + RING_PAST
    print(f"{RING_ARCH}: depth cut to {RING_LAYERS} layers ("
          f"{RING_LAYERS // 3} superblocks), widths as published; B "
          f"{RING_BATCH}, a ring of {W} slots, {n} positions")
    gen = torch.Generator(device=device).manual_seed(seed + 29)
    fed = torch.randint(0, cfg.vocab, (RING_BATCH, n), generator=gen,
                        device=device)
    hold, out = Holds(), {"steps": n}
    for dtype in ("bfloat16", "float32"):
        c = cfg.scaled(dtype=dtype)
        model = init_params(c, torch.Generator(device=device).manual_seed(
            seed + 37), device=device)
        t0 = time.perf_counter()
        dec = family_teacher_forced(model, c, fed, None, device,
                                    cache_len=W, keep_from=W)
        secs = time.perf_counter() - t0
        fwd = forward(model, fed, c)[:, W:]
        tag = "bf16" if dtype == "bfloat16" else "f32"
        print(f"  {tag}: {n} steps in {secs:.2f} s, the checks of its "
              f"{n * attn_layers(c)} decode_attn launches included")
        tol = FORWARD_TOL[f"{tag} decode vs {tag} forward"]
        hold(f"{tag} positions {W}-{n - 1}, after the wrap, vs {tag} "
             "forward with its window mask", dec, fwd, tol)
        if tag == "f32":
            full = forward(model, fed, c.scaled(window=0))[:, W:]
            hold(f"{tag} the same, vs forward with no window", dec, full,
                 tol, control=True)
            del full
        out[f"{tag}_seconds"] = secs
        del model, dec, fwd
        gc.collect()
        torch.cuda.empty_cache()
    if hold.bad:
        raise AssertionError(f"the hybrid's ring: failed {hold.bad}")
    out["errors"] = hold.errors
    return out


def family_attn_timing(seed, torch, n_iter=50):
    """``decode_attn`` at the families' shapes (``ATTN_FAMILIES``), bf16,
    every row at kv_len = S; D 256 also in f32."""
    device = torch.device("cuda")
    gen = torch.Generator(device=device).manual_seed(seed + 31)
    cyc = sleep_cycles_per_ms(torch)
    out = {}
    shapes = [(name, shape, torch.bfloat16)
              for name, shape in ATTN_FAMILIES.items()]
    name0, shape0 = next(iter(ATTN_FAMILIES.items()))
    shapes.append((name0 + ", f32", shape0, torch.float32))
    for name, (B, Hq, Hkv, D, S), dtype in shapes:
        q, k, v, _ = attn_inputs(gen, B, Hq, Hkv, D, S, dtype, device)
        kv_len = torch.full((B,), S, dtype=torch.int32, device=device)
        out[name] = attn_timing(name, (q, k, v, kv_len), torch, cyc, n_iter)
        del q, k, v
        torch.cuda.empty_cache()
    return out


def families_phase(seed, device):
    """Phase 15: every family but dense at full width, one after another,
    each freed before the next; the hybrid's ring wrapped; decode_attn
    timed at the families' shapes."""
    out = {}
    for arch in FAMILIES:
        out[arch] = family_phase(arch, seed, device)
        stamp(f"{arch} served")
    out["ring"] = ring_phase(seed, device)
    stamp("ring wrapped")
    return out


def examples_phase(timeout=300):
    """Phase 14: every ``examples/torch_port/*.py`` as a child process on
    the card, all started together; each must exit 0."""
    import os

    root = Path(__file__).resolve().parent
    paths = sorted((root / "examples" / "torch_port").glob("*.py"))
    if not paths:
        raise AssertionError("no examples under examples/torch_port")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    seconds = {}
    with contextlib.ExitStack() as stack:
        t0 = time.perf_counter()
        gets = {p.stem: stack.enter_context(child(
            [sys.executable, str(p)], timeout=timeout, env=env, cwd=root))
            for p in paths}
        # each child's own seconds: from the start to its exit (an
        # example prints a few lines, far below a pipe's buffer)
        while len(seconds) < len(gets) and \
                time.perf_counter() - t0 < timeout:
            for name, get in gets.items():
                if name not in seconds and get.proc.poll() is not None:
                    seconds[name] = time.perf_counter() - t0
            time.sleep(0.05)
        for name, get in gets.items():
            rc, out = get()
            text = out if rc is None else out[0] + out[1]
            tail = "\n    ".join(text.strip().splitlines()[-4:])
            print(f"{name}: exit {rc} in {seconds.get(name, timeout):.1f} "
                  f"s\n    {tail}")
            if rc != 0:
                raise AssertionError(f"examples/torch_port/{name}.py exited "
                                     f"{rc}:\n{text[-3000:]}")
    return seconds


# ------------------------------------------------ phase 16: the training stack
# internlm2-1.8b at full width and depth through launch/train.py's functions:
# the reference's train_4k seq (src/repro/configs/__init__.py:39), the global
# batch cut from 256 to 8 for one card; n_micro = microbatch_plan(...) = 4
TRAIN_ARCH = "internlm2-1.8b"
TRAIN_SEQ, TRAIN_BATCH = 4096, 8
TRAIN_TIMED = 5                  # timed steps after one warm-up step
# one f32 train step of each family's smoke config, card against CPU
TRAIN_FAMILIES = ("internlm2-1.8b", "qwen3-moe-235b-a22b", "recurrentgemma-2b",
                  "rwkv6-7b", "whisper-tiny")
# the f32 holds of the CPU tests (tests/torch_train_lane.py): loss and
# grad_norm at 1e-4, each gradient leaf scaled by its largest |g|, and the
# updated weights where |g| > 1e-3 x the leaf's largest or g == 0 (at most
# 5% of the elements left out)
TRAIN_TOL = (1e-4, 1e-4)
TRAIN_MASK, TRAIN_LEFT_OUT = 1e-3, 0.05
# the resume check: full width, 2 of the 24 layers (505 M parameters; the
# full depth's checkpoint would be 22.7 GB of npz), 4 steps straight against
# 2 + save + restore into other weights + 2, in a child process with
# deterministic algorithms
RESUME_LAYERS = 2
RESUME_ENV = {"CUBLAS_WORKSPACE_CONFIG": ":4096:8"}


def train_setup(cfg, device, seed, steps):
    """A run of ``launch/train.py``: the launcher's AdamW rule, its model,
    state, token pipeline and step at phase 16's shape."""
    from repro_torch.launch.train import opt_config, setup
    from repro_torch.train.step import microbatch_plan

    n_micro = microbatch_plan(cfg, TRAIN_SEQ, TRAIN_BATCH, 1)
    return setup(cfg, seq=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                 n_micro=n_micro, device=device, seed=seed,
                 ocfg=opt_config(cfg, smoke=False, steps=steps))


def train_profile(run, batch, torch):
    """One train step under ``torch.profiler``: wall and device busy ms,
    and the top torch ops by the device time of the kernels each launched
    itself (a split with no op counted twice)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        run.step(run.model, run.opt, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = p.key_averages()

    def dev_ms(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0)) / 1e3
    busy = sum(dev_ms(e) for e in events if e.device_type != DeviceType.CPU)
    if busy == 0:
        print("  profiler: no device time recorded; busy share not measured")
        return dict(wall_ms=wall_ms, busy_ms=None, ops={})
    print(f"  profiled step: wall {wall_ms:.1f} ms, device busy {busy:.1f} "
          f"ms ({100 * busy / wall_ms:.1f}% of the wall)")
    ops = sorted((e for e in events if e.device_type == DeviceType.CPU
                  and dev_ms(e) > 0), key=dev_ms, reverse=True)
    print("  top ops by the device time of their own kernels (ms, share "
          "of busy, calls):")
    for e in ops[:12]:
        print(f"    {dev_ms(e):9.1f}  {100 * dev_ms(e) / busy:5.1f}%  "
              f"{e.count:6d}  {e.key[:60]}")
    return dict(wall_ms=wall_ms, busy_ms=busy,
                ops={e.key: dev_ms(e) for e in ops[:12]})


def optimizer_ms(run, torch, n=3):
    """Device ms of one ``adamw_update`` over the model's weights and
    state, on random f32 gradients (CUDA events, the mean of ``n``)."""
    from repro_torch.optim.adamw import adamw_update

    gen = torch.Generator(device=run.device).manual_seed(5)
    grads = {k: torch.randn(p.shape, generator=gen, device=run.device) * 1e-5
             for k, p in run.model.named_parameters()}
    adamw_update(grads, run.opt, run.model, run.ocfg)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(n):
        adamw_update(grads, run.opt, run.model, run.ocfg)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def batch_loss(run, batch) -> float:
    """``loss_fn`` over ``batch`` under the run's current weights, the mean
    over its microbatches as the step takes it, with no gradient."""
    import torch
    from repro_torch.train.step import loss_fn

    with torch.no_grad():
        return sum(float(loss_fn(run.model, batch["tokens"][i],
                                 batch["labels"][i], run.cfg))
                   for i in range(run.n_micro)) / run.n_micro


def train_full_width(seed, device):
    """Phase 16 part 1: internlm2-1.8b at full width and depth, one warm-up
    and ``TRAIN_TIMED`` timed steps through the launcher's functions."""
    import statistics

    import torch
    from repro_torch.analysis import HW, model_flops
    from repro_torch.configs import get_config
    from repro_torch.launch.train import next_batch

    cfg = get_config(TRAIN_ARCH)
    torch.cuda.reset_peak_memory_stats()
    run = train_setup(cfg, device, seed, steps=1 + TRAIN_TIMED)
    n_param = sum(p.numel() for p in run.model.parameters())
    tokens = TRAIN_SEQ * TRAIN_BATCH
    print(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{n_param:,} parameters in {cfg.dtype}, AdamW state "
          f"{run.ocfg.state_dtype}, lr {run.ocfg.lr} (warm-up "
          f"{run.ocfg.warmup_steps}), remat on; seq {TRAIN_SEQ}, global "
          f"batch {TRAIN_BATCH}, n_micro {run.n_micro}")
    losses, times = [], []
    for s in range(1 + TRAIN_TIMED):
        batch = next_batch(run)
        torch.cuda.synchronize()
        if s == 0:
            first = batch
            counted = counted_step(lambda: run.step(run.model, run.opt,
                                                    batch),
                                   [run.model, run.opt, batch], torch)
            m = counted.pop("result")[2]
            times.append(counted["seconds"])
        else:
            t0 = time.perf_counter()
            _, _, m = run.step(run.model, run.opt, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        print(f"  step {s + 1}: loss {losses[-1]:.5f}, grad_norm "
              f"{float(m['grad_norm']):.4f}, lr {float(m['lr']):.3g}, "
              f"{times[-1] * 1e3:.1f} ms{' (warm-up, counted)' if s == 0 else ''}")
    peak = torch.cuda.max_memory_allocated()
    again = batch_loss(run, first)
    print(f"  the stream's loss from step 1 to {1 + TRAIN_TIMED}: "
          f"{losses[0]:.5f} -> {losses[-1]:.5f}; step 1's batch again after "
          f"the steps: {again:.5f} (at step 1: {losses[0]:.5f})")
    if not again < losses[0]:
        raise AssertionError(f"training did not lower step 1's batch's "
                             f"loss: {losses[0]} -> {again}")
    step_ms = statistics.median(times[1:]) * 1e3
    flops = model_flops(cfg, TRAIN_SEQ, TRAIN_BATCH, "train")
    bound_ms = flops / HW().peak_flops * 1e3
    print(f"  step {step_ms:.1f} ms (median of {TRAIN_TIMED}), "
          f"{tokens / step_ms * 1e3:.1f} tokens/s; bound {bound_ms:.1f} ms "
          f"(model_flops {flops:.4g} at {HW().peak_flops / 1e12:g} TFLOP/s "
          f"bf16), mfu {bound_ms / step_ms:.4f}; peak memory "
          f"{peak / 1e9:.2f} GB (max_memory_allocated)")
    prof = train_profile(run, next_batch(run), torch)
    opt_ms = optimizer_ms(run, torch)
    print(f"  adamw_update alone: {opt_ms:.2f} ms a step (plain torch, "
          f"{len(run.opt['m'])} tensors)")
    out = dict(arch=cfg.name, layers=cfg.n_layers, parameters=n_param,
               n_micro=run.n_micro, losses=losses,
               first_batch_loss_after=again, step_ms=step_ms,
               step_ms_all=[t * 1e3 for t in times],
               tokens_per_s=tokens / step_ms * 1e3, bound_ms=bound_ms,
               model_flops=flops, mfu=bound_ms / step_ms, peak_bytes=peak,
               profiled=prof, optimizer_ms=opt_ms,
               counted=dict(counted, n_micro=run.n_micro,
                            state_dtype=run.ocfg.state_dtype))
    del run
    gc.collect()
    torch.cuda.empty_cache()
    return out


def within(got, want, atol, rtol) -> float:
    """max |got - want| / (atol + rtol |want|): 1 or less holds."""
    g, w = got.double(), want.double()
    if g.numel() == 0:
        return 0.0
    return float(((g - w).abs() / (atol + rtol * w.abs())).max())


def train_family_step(arch, seed, device):
    """Phase 16 part 2: one f32 train step of ``arch``'s smoke config on
    the card and on the CPU from the same weights and batch: loss,
    gradients and grad_norm at ``TRAIN_TOL``, the updated weights where the
    gradient is above its noise; gradients and grad_norm scaled by 1.01
    must be refused.  Returns the worst ratios to the bounds."""
    import numpy as np
    import torch
    from repro_torch.configs import smoke_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.models.transformer import init_params, new_model
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.train.step import loss_fn, make_train_step

    cfg = smoke_config(arch).scaled(dtype="float32")
    cpu = torch.device("cpu")
    on_cpu = init_params(cfg, torch.Generator().manual_seed(seed),
                         device=cpu)
    on_card = new_model(cfg, device=device)
    with torch.no_grad():
        for p, w in zip(on_card.parameters(), on_cpu.parameters()):
            p.copy_(w)
    b = TokenPipeline(vocab_size=cfg.vocab, seq_len=16,
                      global_batch=4).next_batch()
    batch = {k: torch.from_numpy(b[k]).reshape(2, 2, 16)
             for k in ("tokens", "labels")}
    if cfg.family == "encdec":
        batch["enc_inputs"] = torch.from_numpy(np.random.default_rng(
            seed).normal(size=(2, 2, cfg.enc_seq, cfg.d_model)).astype(
            np.float32))
    out = {}
    for where, model in (("cpu", on_cpu), ("card", on_card)):
        model.trainable_()
        x = {k: v.to(model.embed.device) for k, v in batch.items()}
        enc = x.get("enc_inputs")
        loss = loss_fn(model, x["tokens"].reshape(4, 16),
                       x["labels"].reshape(4, 16), cfg,
                       enc_inputs=None if enc is None else enc.reshape(
                           4, *enc.shape[2:]))
        grads = [g.cpu() for g in torch.autograd.grad(
            loss, list(model.parameters()))]
        ocfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=40)
        opt = adamw_init(model, ocfg)
        _, _, m = make_train_step(cfg, ocfg, n_micro=2,
                                  has_enc=enc is not None)(model, opt, x)
        out[where] = dict(loss=loss.detach().cpu(), grads=grads,
                        step_loss=m["loss"].cpu(),
                        grad_norm=m["grad_norm"].cpu(),
                        weights=[p.detach().cpu() for p in model.parameters()])
    got, want = out["card"], out["cpu"]

    def grad_ratio(scale):
        return max(within(g * scale / w.abs().max().clamp_min(1e-30),
                          w / w.abs().max().clamp_min(1e-30), *TRAIN_TOL)
                   for g, w in zip(got["grads"], want["grads"]))

    ratios = {k: within(got[k], want[k], *TRAIN_TOL)
              for k in ("loss", "step_loss", "grad_norm")}
    ratios["grads"] = grad_ratio(1.0)
    left = total = 0
    worst = 0.0
    for g, w, gw in zip(got["weights"], want["weights"], want["grads"]):
        a = gw.abs()
        keep = (a == 0) | (a > TRAIN_MASK * a.max())
        worst = max(worst, within(g[keep], w[keep], *TRAIN_TOL))
        left, total = left + int((~keep).sum()), total + keep.numel()
    ratios["weights"] = worst
    controls = {"grads x 1.01": grad_ratio(1.01),
                "grad_norm x 1.01": within(got["grad_norm"] * 1.01,
                                           want["grad_norm"], *TRAIN_TOL)}
    print(f"  {arch} ({cfg.family}), f32 smoke config, card vs CPU (ratio "
          "to the bound, <= 1 holds): " + ", ".join(
              f"{k} {v:.3g}" for k, v in ratios.items())
          + f"; {left} of {total} weights left out (|g| at its noise); "
          "controls " + ", ".join(f"{k} {v:.3g}" for k, v in controls.items()))
    bad = [k for k, v in ratios.items() if not v <= 1]
    bad += [f"control {k} not refused" for k, v in controls.items()
            if not v > 1]
    if left > TRAIN_LEFT_OUT * total:
        bad.append(f"{left} of {total} weights left out")
    if bad:
        raise AssertionError(f"{arch}: train step card vs CPU: {bad}")
    return dict(ratios=ratios, controls=controls, left_out=left)


def train_resume(seed) -> int:
    """``--train-resume`` (a child of phase 16, with
    ``CUBLAS_WORKSPACE_CONFIG`` set): deterministic algorithms on;
    internlm2-1.8b at full width and ``RESUME_LAYERS`` layers, 4 steps
    straight against 2 steps, a save, a restore into a model initialised
    from another seed and 2 more steps.  Weights, m, v, step and the data
    cursor must be bit-equal.  Prints one JSON line; exits 1 if anything
    differs."""
    import os
    import shutil
    import tempfile

    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.train import next_batch
    from repro_torch.train.checkpoint import Checkpointer

    torch.use_deterministic_algorithms(True)
    device = torch.device("cuda")
    cfg = get_config(TRAIN_ARCH).scaled(n_layers=RESUME_LAYERS)

    def steps(run, n):
        for _ in range(n):
            run.step(run.model, run.opt, next_batch(run))

    def tensors(run):
        return ([p for _, p in run.model.named_parameters()]
                + list(run.opt["m"].values()) + list(run.opt["v"].values())
                + [run.opt["step"]])

    straight = train_setup(cfg, device, seed, steps=4)
    steps(straight, 4)
    first = train_setup(cfg, device, seed, steps=4)
    steps(first, 2)
    d = tempfile.mkdtemp(prefix="acorn_train_resume_")
    try:
        ck = Checkpointer(d, keep=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ck.save(2, first.model, first.opt,
                extra={"data": first.pipe.state_dict()})
        copy_s = time.perf_counter() - t0
        ck.wait()
        save_s = time.perf_counter() - t0
        del first
        gc.collect()
        torch.cuda.empty_cache()
        nbytes = sum(os.path.getsize(os.path.join(r, f))
                     for r, _, fs in os.walk(d) for f in fs)
        resumed = train_setup(cfg, device, seed + 1, steps=4)
        ptrs = [t.data_ptr() for t in tensors(resumed)]
        t0 = time.perf_counter()
        s0, _, _, extra = ck.restore(resumed.model, resumed.opt)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        resumed.pipe.load_state_dict(extra["data"])
    finally:
        shutil.rmtree(d)
    steps(resumed, 2)
    differ = sum(not torch.equal(a, b)
                 for a, b in zip(tensors(resumed), tensors(straight)))
    result = dict(
        layers=cfg.n_layers,
        parameters=sum(p.numel() for p in resumed.model.parameters()),
        restored_step=s0, tensors=len(ptrs), tensors_differing=differ,
        data_ptr_moved=[t.data_ptr() for t in tensors(resumed)] != ptrs,
        cursor=resumed.pipe.cursor, cursor_straight=straight.pipe.cursor,
        save_copy_s=copy_s, save_s=save_s, restore_s=restore_s,
        checkpoint_bytes=nbytes, temp_dir_removed=not os.path.exists(d))
    print(json.dumps({"train_resume": result}))
    return int(differ != 0 or result["data_ptr_moved"]
               or result["cursor"] != result["cursor_straight"]
               or not result["temp_dir_removed"])


def train_phase(seed, device):
    """Phase 16: the training stack on the card (see the module's
    docstring); returns its numbers for the ``paths`` line."""
    import os

    t0 = time.perf_counter()
    out = {"full_width": train_full_width(seed, device)}
    stamp("full-width steps")
    out["card_vs_cpu"] = {arch: train_family_step(arch, seed, device)
                          for arch in TRAIN_FAMILIES}
    stamp("each family's f32 step held to the CPU")
    env = dict(os.environ, **RESUME_ENV, PYTHONPATH=str(SRC))
    with child([sys.executable, str(Path(__file__).resolve()),
                "--train-resume", "--seed", str(seed)], timeout=400,
               env=env) as get:
        rc, res = get()
    text = res if rc is None else res[0] + res[1]
    lines = [json.loads(x) for x in text.splitlines()
             if x.startswith('{"train_resume"')]
    if rc != 0 or not lines:
        raise AssertionError(f"the resume child exited {rc}:\n{text[-3000:]}")
    r = out["resume"] = lines[-1]["train_resume"]
    print(f"  resume ({r['layers']} layers, {r['parameters']:,} parameters, "
          f"deterministic algorithms): {r['tensors']} tensors bit-equal to "
          f"the straight run, cursor {r['cursor']}; save {r['save_s']:.2f} s "
          f"(host copy {r['save_copy_s']:.2f} s), restore "
          f"{r['restore_s']:.2f} s, {r['checkpoint_bytes']:,} bytes; the "
          "temporary directory removed")
    out["seconds"] = time.perf_counter() - t0
    print(f"  phase 16 took {out['seconds']:.1f} s")
    return out


# ------------------------------------ phase 17: mxu_native, the mesh
def mxu_serving_phase(seed, device):
    """internlm2-1.8b with ``attn_mxu_native`` through the launcher's serve
    loop at full width (``LM_SERVE``): every decode_attn launch the
    mxu_native variant's.  Returns (cfg, model, runs)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve

    cfg = get_config(LM_ARCH).scaled(attn_mxu_native=True)
    steps = LM_SERVE["prompt_len"] + LM_SERVE["gen"]
    n = LM_SERVE["swaps"] * steps
    model, _, runs = checked(
        lambda: serve(cfg, seed=seed, device=device, **LM_SERVE),
        {"decode_attn": cfg.n_layers, MXU: cfg.n_layers}, n_classify=n)
    B = LM_SERVE["batch"]
    for t, run in enumerate(runs):
        print(f"tenant {t} (attn_mxu_native): {B}x({LM_SERVE['prompt_len']} "
              f"prompt + {LM_SERVE['gen']} greedy) steps in "
              f"{run.seconds * 1e3:.1f} ms ({B * LM_SERVE['gen'] / run.seconds:.1f}"
              f" generated tok/s)")
    print(f"{n} decode steps x {cfg.n_layers} mxu_native decode_attn launches")
    return cfg, model, runs


def mxu_check_phase(cfg, model, runs, seed, device):
    """Every tenant's steps teacher-forced through the kernel (each launch
    held to the mxu_native plain version at ``mxu_bound``) against the same
    steps with the mxu_native twin (``mode="ref"``), at phase 8's bound;
    the served tokens their argmax.  The last tenant's kernel decode also
    against the default kernel's (it must differ: the flag reaches the
    kernel) and a wrong attention refused.  Returns the errors."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.launch.serve import tenant_generator

    hold = Holds()
    last = len(runs) - 1
    for tenant in reversed(range(len(runs))):
        run = runs[tenant]
        if tenant != last:
            model.init_(tenant_generator(seed, tenant, device))
        print(f"tenant {tenant}, {run.fed.shape[1]} steps teacher-forced:")
        dec = family_teacher_forced(model, cfg, run.fed, None, device)
        P = run.prompt_len
        if not torch.equal(dec[:, P - 1:].argmax(dim=-1).cpu(),
                           run.tokens[:, P:]):
            raise AssertionError(f"tenant {tenant}: the served tokens are not "
                                 "the argmax of the teacher-forced steps")
        twin = family_teacher_forced(model, cfg, run.fed, None, device,
                                     mode="ref")
        hold(f"tenant {tenant} mxu_native decode vs the mxu_native twin",
             dec, twin, DECODE_TOL)
        if tenant == last:
            default = family_teacher_forced(
                model, cfg.scaled(attn_mxu_native=False), run.fed, None,
                device)
            share = float((default != dec).float().mean())
            print(f"  the default kernel's decode: {100 * share:.1f}% of the "
                  "logits differ from the mxu_native decode's")
            if share == 0:
                raise AssertionError("attn_mxu_native does not reach the "
                                     "kernel: the decode equals the default")
            hold("default kernel decode vs the mxu_native twin", default,
                 twin, DECODE_TOL)
            with wrong_attention(lambda q, k, v, kv_len: ref.decode_attn(
                    q, k, v, kv_len - 1, mxu_native=True)):
                bad = family_teacher_forced(model, cfg, run.fed, None,
                                            device, mode="ref")
            hold("newest row dropped, vs the mxu_native twin", bad, twin,
                 DECODE_TOL, control=True)
            del default, bad
        del dec, twin
    torch.cuda.empty_cache()
    if hold.bad:
        raise AssertionError(f"failed: {hold.bad}")
    return hold.errors


def mxu_step_timing(cfg, model, seed, pairs=10):
    """The full-width decode step at kv_len ``LM_CACHE``, B 16, with the
    default attention and with ``attn_mxu_native``: ``pairs`` pairs of
    windows of 20 steps by the host clock, the two in alternating order.
    Returns {"default": [ms a window], "mxu_native": [...], "mxu_wins": n}
    (pairs whose mxu_native window was the faster)."""
    import statistics

    import torch
    from repro_torch.models.transformer import decode_step, init_decode_state

    device = model.embed.device
    B, T = LM_SERVE["batch"], LM_CACHE
    gen = torch.Generator(device=device).manual_seed(seed + 13)
    state = init_decode_state(cfg, B, T, device=device)
    for cache in state.values():
        cache.normal_(generator=gen)
    tok = torch.randint(0, cfg.vocab, (B, 1), generator=gen, device=device)
    steps = {k: (lambda c=c: decode_step(model, state, tok, T - 1, c))
             for k, c in (("default", cfg.scaled(attn_mxu_native=False)),
                          ("mxu_native", cfg))}
    for step in steps.values():
        step()
    torch.cuda.synchronize()
    out = {k: [] for k in steps}
    for i in range(pairs):
        for k in (("default", "mxu_native") if i % 2 == 0
                  else ("mxu_native", "default")):
            out[k].append(host_step_s(steps[k], torch, 20, windows=1)[0]
                          * 1e3)
    out["mxu_wins"] = sum(m < d for d, m in zip(out["default"],
                                                 out["mxu_native"]))
    q = statistics.quantiles(out["default"], n=4)
    print(f"decode step at kv_len {T}, B {B}, {pairs} pairs of 20-step "
          f"windows in alternating order: default median "
          f"{statistics.median(out['default']):.3f} ms (quartiles "
          f"{q[0]:.3f} / {q[2]:.3f}), mxu_native median "
          f"{statistics.median(out['mxu_native']):.3f} ms; mxu_native "
          f"faster in {out['mxu_wins']} of {pairs} pairs")
    del state
    return out


def mesh_phase(device):
    """The dry run over its 80 cells (``launch/dryrun.py``: 10 archs x 4
    shapes x the 16 x 16 and 2 x 16 x 16 meshes, on ``meta``): every cell
    ``ok`` and fitting the card, or ``skip`` where ``applicable`` says so.
    Then, for each of ``MESH_CELLS`` (1 pod), device (0, 0)'s shard of every
    leaf a card holds allocated on this card and zeroed: the allocator's
    growth must be the record's ``analytic_bytes_per_device``, each tensor
    rounded up by less than ``ALLOC_ROUND``, and below the card's memory.
    Returns {cell: numbers}."""
    import torch
    from repro_torch.analysis import HW
    from repro_torch.configs import all_cells, applicable, get_config
    from repro_torch.launch import dryrun

    t0 = time.perf_counter()
    n = {"ok": 0, "skip": 0}
    for arch, shape in all_cells():
        for mp in (False, True):
            rec = dryrun.run_cell(arch, shape, multi_pod=mp, count=False)
            ok, why = applicable(get_config(arch), shape)
            want = "ok" if ok else "skip"
            if rec["status"] != want or (ok and not rec["fits"]) or (
                    not ok and rec["reason"] != why):
                raise AssertionError(f"dry run {arch} {shape} "
                                     f"{2 if mp else 1} pod: {rec}")
            n[want] += 1
    print(f"dry run: {n['ok']} cells ok and fitting {HW().hbm_bytes / 1e9:g} "
          f"GB, {n['skip']} skipped (full attention at long_500k), in "
          f"{time.perf_counter() - t0:.1f} s (records in dryrun_out/)")
    out = {}
    for arch, shape in MESH_CELLS:
        meta, leaves = dryrun.cell_leaves(arch, shape)
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(device)
        held, worst = [], 0
        for group, path, shard, dtype in leaves:
            before = torch.cuda.memory_allocated(device)
            x = torch.empty(shard, dtype=dtype, device=device).zero_()
            grew = torch.cuda.memory_allocated(device) - before
            if not x.nbytes <= grew < x.nbytes + ALLOC_ROUND:
                raise AssertionError(f"{group} {path} {shard}: {x.nbytes} "
                                     f"bytes took {grew}")
            worst = max(worst, grew - x.nbytes)
            held.append(x)
        torch.cuda.synchronize()
        growth = torch.cuda.memory_allocated(device) - base
        analytic = meta["analytic_bytes_per_device"]
        free, total = torch.cuda.mem_get_info(device)
        print(f"{arch} {shape}, device (0, 0) of the 16 x 16 mesh: "
              f"{len(leaves)} shards ({', '.join(sorted({g for g, *_ in leaves}))})"
              f" allocated and zeroed: {growth:,} bytes against the dry "
              f"run's {analytic:,.0f} ({growth - analytic:,.0f} of allocator "
              f"rounding, at most {worst:,} a tensor); {free / 1e9:.2f} of "
              f"{total / 1e9:.2f} GB free on the card beside them")
        if not (0 <= growth - analytic < len(leaves) * ALLOC_ROUND
                and growth < total and analytic <= HW().hbm_bytes):
            raise AssertionError(f"{arch} {shape}: the allocator grew "
                                 f"{growth} for {analytic} analytic bytes")
        out[f"{arch} {shape}"] = dict(shards=len(leaves), allocated=growth,
                                      analytic=analytic)
        del held, x
        torch.cuda.empty_cache()
    return out


def mxu_phase(seed, device, main_path):
    """Phase 17: the mxu_native serving path and the mesh's device."""
    cfg, model, runs = main_path("lm_decode_mxu_native",
                                 lambda: mxu_serving_phase(seed, device),
                                 ["decode_attn", MXU])
    errors = mxu_check_phase(cfg, model, runs, seed, device)
    B = LM_SERVE["batch"]
    out = {"generated_tokens_per_s": [B * LM_SERVE["gen"] / r.seconds
                                      for r in runs],
           "max_abs_err": {k: v for k, v in errors.items()
                           if not k.startswith("control")}}
    out["step_ms"] = mxu_step_timing(cfg, model, seed)
    del model
    import torch
    torch.cuda.empty_cache()
    stamp("mxu_native serving held and timed")
    out["mesh"] = mesh_phase(device)
    return out


def acorn_and_dense(seed, prof, device, libs, main_path, path_launches,
                    torch) -> tuple:
    """Phases 2-14: returns the ``paths`` JSON object (``main`` adds phase
    15's families), the other decode_attn shapes' timings, phase 9's kernel
    timings and the dense LM's dtype."""
    phase("2 kernel vs twin, random full-width tables, V=4 with an empty slot")
    kernel_phase(prof, seed, device)
    phase("3 staged kernels vs their plain versions, the same tables")
    stage_phase(prof, seed, device)
    phase("4 decode_attn vs its plain version, the sweep and the full width")
    attn_phase(seed, device)
    models, programs, test_sets = make_zoo(seed)

    def classify_kernels(modes):
        return {k for m in modes for k in per_classify(m, prof)}

    zoos = {}
    for n, mode in (("5", None), ("6", "unfused"), ("6", "layerwise")):
        phase(f"{n} main path: the zoo through ZooServer(mode={mode!r})")
        zoos[mode], pb = main_path(
            f"zoo_{mode or 'fused'}",
            lambda mode=mode: main_path_phase(prof, seed, device, models,
                                              programs, test_sets, mode),
            [*classify_kernels([mode]), "expand_request"])
    phase("7 main path: the zoo planned over fat_tree(4), hop by hop")
    runtimes = main_path("multi_switch", lambda: multi_switch_phase(
        prof, device, programs, zoos[None], pb),
        classify_kernels([None, "layerwise"]))
    phase(f"8 main path: LM decode serving, {LM_ARCH} at full width")
    cfg, lm, runs = main_path("lm_decode",
                              lambda: lm_path_phase(seed, device),
                              ["decode_attn"])
    lm_check_phase(cfg, lm, runs, seed, device)
    phase(f"9 timing at B = {BATCH}, graph and eager paths; the decode step "
          f"at kv_len {LM_CACHE}")
    eager_zoos, eager_runtimes = eager_twins(prof, device, programs,
                                             runtimes)
    t, rps, steps, writes = timing_phase(
        zoos, runtimes, eager_zoos, eager_runtimes, pb, prof, models, torch)
    del eager_zoos, eager_runtimes
    t["decode_attn"], t[MXU], step_tok_s, t["lm_step_counted"] = lm_timing(
        cfg, lm, seed, torch)
    stamp("decode step timed")
    wide = attn_shapes_timing(seed, torch)
    stamp("attention shapes timed")
    kernel_resources(libs)
    phase("10 the graph path: replay vs eager vs mode ref, in-place writes, "
          "the cache, two threads, a failing capture")
    warmed = graph_phase(prof, seed, device, models, programs, zoos,
                         runtimes, pb)
    phase("11 main path: the async fronts over the graph path, open loop")
    fronts = main_path("async_fronts", lambda: fronts_phase(
        prof, seed, warmed, test_sets, device), ["classify_fused"])
    phase("12 main path: the self-healing fleet, fault schedules and a kill "
          "under open-loop load")
    fleet = main_path("fleet", lambda: fleet_phase(
        prof, seed, device, programs, zoos[None], test_sets, pb),
        classify_kernels([None, "layerwise"]))
    phase("13 main path: the pipelined and sharded lanes, a graph per "
          "bucket, swaps, an autoscaled lane pool; beside the path of phase 7")
    lanes = main_path("lanes", lambda: lanes_phase(
        prof, device, programs, runtimes, pb),
        classify_kernels([None, "layerwise"]))
    phase("14 the examples of examples/torch_port, as children on the card")
    examples = examples_phase()
    B = LM_SERVE["batch"]
    served = {"generated_tokens_per_s": [
        B * LM_SERVE["gen"] / r.seconds for r in runs],
        f"decode_step_tokens_per_s_at_kv_len_{LM_CACHE}": step_tok_s}
    paths = {"launches": path_launches, "requests_per_s": rps,
             "steps": steps, "slot_write_ms": writes, "fronts": fronts,
             "fleet": fleet, "lanes": lanes, "examples_seconds": examples,
             "lm_decode": served}
    return paths, wide, t, cfg.dtype


# ------------------------------------------- phase 18: the dry run's costs
# the cells also counted at two pods: the ones tests/test_torch_dryrun_mesh.py
# holds to the reference
COST_CELLS_2POD = (("internlm2-1.8b", "decode_32k"),
                   ("internlm2-1.8b", "prefill_32k"),
                   ("qwen3-moe-235b-a22b", "decode_32k"),
                   ("rwkv6-7b", "long_500k"))
COST_WORKERS = 6                 # processes counting cells at once
PEAK_TOL = 0.10                  # the counted peak against the card's


def counted_step(run, args, torch) -> dict:
    """``run()`` once on the card under an ``analysis.cost.CostCounter``
    with ``args`` (the step's arguments) tracked: its counted flops,
    bytes, ops and peak, the card's ``max_memory_allocated`` over it less
    what was allocated beside the arguments, its seconds and its result."""
    from repro_torch.analysis.cost import CostCounter

    counter = CostCounter()
    torch.cuda.synchronize()
    held = counter.track(args)
    beside = torch.cuda.memory_allocated() - held
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with counter:
        result = run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return dict(result=result, seconds=seconds, flops=counter.matmul_flops,
                bytes=counter.traffic_bytes, ops=dict(counter.ops),
                counted_peak=counter.peak_bytes,
                card_peak=torch.cuda.max_memory_allocated() - beside,
                argument_bytes=held)


def _count_cell(cell):
    """One cell's counted record (a worker process of phase 18)."""
    from repro_torch.launch import dryrun

    arch, shape, mp, out = cell
    return dryrun.run_cell(arch, shape, multi_pod=mp, out_dir=out)


def cost_cells(card: str):
    """Phase 18 (a): the 40 one-pod cells and ``COST_CELLS_2POD`` at two
    pods, counted in ``COST_WORKERS`` processes: every status the one
    ``applicable`` gives, every ``ok`` record's counted fields filled and
    ``hlo_*_raw`` null with the reason."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from repro_torch.configs import all_cells, applicable, get_config
    from repro_torch.launch import dryrun

    out = str(Path(dryrun.RESULTS_DIR) / "phase18")
    cells = [(a, s, False, out) for a, s in all_cells()] + [
        (a, s, True, out) for a, s in COST_CELLS_2POD]
    t0 = time.perf_counter()
    with ProcessPoolExecutor(
            COST_WORKERS,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        recs = list(pool.map(_count_cell, cells))
    n = {"ok": 0, "skip": 0}
    for rec in recs:
        ok, why = applicable(get_config(rec["arch"]), rec["shape"])
        want = "ok" if ok else "skip"
        if rec["status"] != want:
            raise AssertionError(f"dry run {rec['arch']} {rec['shape']} "
                                 f"{rec['pods']} pod: {rec['status']} "
                                 f"({rec.get('error', rec.get('reason'))})")
        n[want] += 1
        if not ok:
            continue
        empty = [k for k in dryrun.COUNTED_FIELDS
                 if (rec[k] is None) != k.endswith("_raw")]
        if empty or rec["not_available"]["reason"] != dryrun.NOT_AVAILABLE:
            raise AssertionError(f"{rec['arch']} {rec['shape']}: fields "
                                 f"{empty} not as they should be")
        rl, mem = rec["roofline"], rec["memory"]
        print(f"  {rec['arch']:20s} {rec['shape']:12s} {rec['pods']} pod: "
              f"{rec['hlo_flops_per_device']:.4g} flops, "
              f"{rec['hlo_bytes_per_device']:.4g} bytes, "
              f"{rec['collective_wire_bytes']:.4g} wire bytes, peak "
              f"{mem['peak_bytes'] / 1e9:.2f} GB a device; bound "
              f"{rl['step_s_lower_bound'] * 1e3:.3f} ms ({rl['dominant']}); "
              f"useful {rec['useful_flops_ratio']:.3f} [{card}]")
    seconds = time.perf_counter() - t0
    print(f"dry run counted: {n['ok']} cells ok, {n['skip']} skipped, in "
          f"{seconds:.1f} s on {COST_WORKERS} processes (records in "
          f"{out})")
    return {"ok": n["ok"], "skip": n["skip"], "seconds": seconds}


def cost_phase(paths, t, card):
    """Phase 18: the dry run's counted cells (``cost_cells``); then phase
    16's full-width training step and phase 9's decode step as counted on
    the card held to the dry run's count of the same step on a 1 x 1 mesh
    on ``meta``: the flops equal, the train step's peak within
    ``PEAK_TOL`` of the card's, 24 ``decode_attn`` ops a decode step (and
    24 launches: phase 18's own in the ``kernels`` line); each step's
    bound from its counted flops and bytes beside its measured ms."""
    from repro_torch.analysis import HW
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh

    t0 = time.perf_counter()
    out = {"cells": cost_cells(card)}
    one = make_mesh((1, 1), ("data", "model"))
    hw = HW()
    tr = paths["train"]["full_width"]
    c = tr["counted"]
    cfg = get_config(TRAIN_ARCH)
    meta = dryrun.count_step(cfg, ShapeSpec("train", TRAIN_SEQ, TRAIN_BATCH,
                                            "train"), one,
                             n_micro=c["n_micro"],
                             overrides={"state_dtype": c["state_dtype"]})
    peak = meta["memory"]["peak_bytes"]
    bound = max(c["flops"] / hw.peak_flops, c["bytes"] / hw.hbm_gbps) * 1e3
    print(f"{TRAIN_ARCH} train step (phase 16, seq {TRAIN_SEQ}, global batch "
          f"{TRAIN_BATCH}, n_micro {c['n_micro']}), counted on the card: "
          f"{c['flops']:.6g} flops (dry run on meta {meta['flops']:.6g}), "
          f"{c['bytes']:.6g} bytes (dry run {meta['bytes']:.6g}); peak: dry "
          f"run {peak / 1e9:.3f} GB, the card's max_memory_allocated "
          f"{c['card_peak'] / 1e9:.3f} GB ({peak / c['card_peak']:.3f}); "
          f"bound {bound:.1f} ms (compute "
          f"{c['flops'] / hw.peak_flops * 1e3:.1f}, memory "
          f"{c['bytes'] / hw.hbm_gbps * 1e3:.1f}) against the measured "
          f"{tr['step_ms']:.1f} ms [{card}]")
    if c["flops"] != meta["flops"]:
        raise AssertionError(f"train step flops: card {c['flops']} != dry "
                             f"run {meta['flops']}")
    if abs(peak - c["card_peak"]) > PEAK_TOL * c["card_peak"]:
        raise AssertionError(f"train step peak: dry run {peak}, card "
                             f"{c['card_peak']}")
    out["train"] = dict(flops=c["flops"], bytes=c["bytes"],
                        meta_bytes=meta["bytes"], meta_peak=peak,
                        card_peak=c["card_peak"],
                        counted_peak=c["counted_peak"], bound_ms=bound,
                        step_ms=tr["step_ms"])
    d = t["lm_step_counted"]
    B, T = LM_SERVE["batch"], LM_CACHE
    meta = dryrun.count_step(get_config(LM_ARCH),
                             ShapeSpec("decode", T, B, "decode"), one)
    ops = d["ops"].get("decode_attn", 0)
    bound = max(d["flops"] / hw.peak_flops, d["bytes"] / hw.hbm_gbps) * 1e3
    print(f"{LM_ARCH} decode step (phase 9, B {B}, kv_len {T}), counted on "
          f"the card: {ops} decode_attn ops ({d['launches']['decode_attn']} "
          f"launches), {d['flops']:.6g} flops (dry run "
          f"on meta {meta['flops']:.6g}, {meta['decode_attn_ops']} "
          f"decode_attn ops), {d['bytes']:.6g} bytes against the phase's "
          f"analytic {d['analytic_bytes']:.6g} "
          f"({d['bytes'] / d['analytic_bytes']:.3f}); bound from the counts "
          f"{bound:.4f} ms, from the analytic bytes {d['bound_ms']:.4f} ms, "
          f"measured {d['step_ms']:.3f} ms [{card}]")
    if ops != 24 or meta["decode_attn_ops"] != 24 or d["launches"][
            "decode_attn"] != 24:
        raise AssertionError(f"decode step: {ops} / "
                             f"{meta['decode_attn_ops']} decode_attn ops")
    if d["flops"] != meta["flops"]:
        raise AssertionError(f"decode step flops: card {d['flops']} != dry "
                             f"run {meta['flops']}")
    out["decode"] = dict(flops=d["flops"], bytes=d["bytes"],
                         analytic_bytes=d["analytic_bytes"],
                         ratio=d["bytes"] / d["analytic_bytes"],
                         bound_ms=bound, analytic_bound_ms=d["bound_ms"],
                         step_ms=d["step_ms"], decode_attn_ops=ops)
    out["seconds"] = time.perf_counter() - t0
    print(f"  phase 18 took {out['seconds']:.1f} s")
    return out


def kernels_line(t, path_launches, lm_dtype) -> dict:
    """The contract's ``kernels`` JSON object: each kernel's launches on
    the main paths and its measurements from phase 9 (``decode_attn``'s
    mxu_native variant a row of its own, its launches those of phase
    17)."""
    tolerance = {k: ({"atol": ATTN_TOL_FULL[lm_dtype][0],
                      "rtol": ATTN_TOL_FULL[lm_dtype][1]}
                     if k == "decode_attn" else {"atol": 0, "rtol": 0})
                 for k in kernels()}
    tolerance[MXU] = {"bound": "mxu_bound: one bf16 ulp + 2^-7 sum P|V|"}
    source = {**{k: SOURCES.get(k, k) for k in kernels()},
              MXU: "decode_attn"}
    replaces = {**REPLACES, MXU: REPLACES["decode_attn"]}
    return {"kernels": [{
        "name": name, "route": "cuda",
        "source": f"src/repro_torch/csrc/{source[name]}.cu",
        "replaces": replaces[name],
        "launches": sum(p.get(name, 0) for p in path_launches.values()),
        "max_abs_err": t[name]["max_abs_err"],
        "tolerance": tolerance[name], "ms": t[name]["ms"],
        "plain_ms": t[name]["plain_ms"], "bound_ms": t[name]["bound_ms"],
        "bound_by": "bytes", "library_ms": t[name]["library_ms"],
        "matched_twin": t[name]["matched"]}
        for name in [*kernels(), MXU]],
        "launch_floor_ms": t["launch_floor_ms"],
        "launch_floor_forest_vote_grid_ms":
            t["launch_floor_forest_vote_grid_ms"],
        "launch_floor_one_block_ms": t["launch_floor_one_block_ms"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ncu-probe", action="store_true",
                    help="only launch the redesigned kernels once each, "
                         "for ncu (phase 9 runs this under ncu)")
    ap.add_argument("--two-streams", action="store_true",
                    help="only phase 4's two-stream check of decode_attn "
                         "against the sources beside this script; exits 1 "
                         "if an output was wrong")
    ap.add_argument("--capture-failure", action="store_true",
                    help="only a classify whose graph capture must fail; "
                         "the error ends the process (phase 10 runs this "
                         "and requires a nonzero exit)")
    ap.add_argument("--families", action="store_true",
                    help="only the build, decode_attn at the families' "
                         "shapes (phase 4's part) and phase 15")
    ap.add_argument("--train", action="store_true",
                    help="only the build and phase 16 (the training stack)")
    ap.add_argument("--mxu", action="store_true",
                    help="only the build, phase 4's mxu_native part and "
                         "phase 17 (mxu_native serving, the mesh's device)")
    ap.add_argument("--train-resume", action="store_true",
                    help="only phase 16's resume check (phase 16 runs this "
                         "as a child with deterministic algorithms)")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are not under {SRC}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    if args.ncu_probe:
        return ncu_probe(args.seed)
    if args.two_streams:
        found = two_streams(args.seed, torch.device("cuda"))
        return int(any(bad for _, bad in found.values()))
    if args.capture_failure:
        return capture_failure(args.seed)
    if args.train_resume:
        return train_resume(args.seed)
    from repro_torch.core.plane import PlaneProfile

    t_start = time.perf_counter()
    device = torch.device("cuda")
    prof = PlaneProfile(**FULL)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    phase("1 build")
    libs = build_phase()
    path_launches = {}

    def main_path(name, run, needed):
        zero_launches()
        result = run()
        path_launches[name] = got = launches()
        print(f"main path {name}: launches {got}")
        for k in needed:
            if got[k] < 1:
                raise AssertionError(f"the {name} path never launched {k}")
        return result

    fam_attn = {}
    if args.mxu:
        phase("4 (part) decode_attn's mxu_native variant vs its plain "
              "version")
        mxu_attn_phase(torch.Generator(device=device).manual_seed(11),
                       device)
    if args.families:
        phase("4 (part) decode_attn at the families' shapes")
        family_attn_phase(torch.Generator(device=device).manual_seed(11),
                          device)
    only = args.families or args.train or args.mxu
    if only:
        paths, shapes, t, lm_dtype = ({"launches": path_launches}, {},
                                      None, None)
    else:
        paths, shapes, t, lm_dtype = acorn_and_dense(
            args.seed, prof, device, libs, main_path, path_launches, torch)
    if not (args.train or args.mxu):
        phase("15 main path: the moe, hybrid, rwkv and encdec families at "
              "full width through launch/serve.py; the hybrid's ring "
              "wrapped")
        paths["families"] = main_path(
            "families", lambda: families_phase(args.seed, device),
            ["decode_attn"])
        fam_attn = family_attn_timing(args.seed, torch)
        stamp("family attention shapes timed")
    if not (args.families or args.mxu):
        phase(f"16 main path: training {TRAIN_ARCH} at full width through "
              "launch/train.py; each family's f32 step against the CPU; a "
              "deterministic resume")
        paths["train"] = main_path(
            "train", lambda: train_phase(args.seed, device), [])
        if any(path_launches["train"].values()):
            raise AssertionError("the training path launched a kernel: "
                                 f"{path_launches['train']}")
    if not (args.families or args.train):
        phase(f"17 main path: {LM_ARCH} decode serving with attn_mxu_native "
              "at full width; the dry run's 80 cells and device (0, 0) of "
              "the production mesh held on this card")
        paths["mxu_native"] = mxu_phase(args.seed, device, main_path)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    if not only:
        phase("18 the dry run's costs: its cells counted; phase 16's train "
              "step and phase 9's decode step counted on the card against "
              "the dry run's count on meta")
        paths["costs"] = cost_phase(paths, t, smi[0] if smi else "card ?")
        # the counted decode step's launches (phase 9, counts zeroed just
        # before it and read just after)
        path_launches["costs"] = t["lm_step_counted"]["launches"]
        print(f"main path costs: launches {path_launches['costs']}")
    if only:
        kernel_resources(libs)
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"paths": paths, "decode_attn_shapes": {
        k: {x: a[x] for x in ("ms", "plain_ms", "bound_ms", "library_ms",
                              "max_abs_err")}
        for k, a in {**shapes, **fam_attn}.items()}}))
    if t is not None:
        print(json.dumps(kernels_line(t, path_launches, lm_dtype)))
    print(smi[0] if smi else "nvidia-smi: no answer")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
