#!/usr/bin/env python3
"""Per-block phase times of the ``classify_fused`` kernel on one CUDA card.

    python3 tools/classify_fused_phases.py [--seed N]

Compiles a copy of ``src/repro_torch/csrc/classify_fused.cu`` with
``%globaltimer`` stamps at each block's phase boundaries (start; features,
row lengths and layer bits staged; walk, leaf lookup and SVM sums done;
vote done) into ``src/repro_torch/_build/``, runs it warm on
``chip_smoke.py``'s zoo and traffic at B 4096, checks that its outputs equal
the kernel's, and prints each phase's mean time by the packets' version and
the blocks resident on an SM on average.  Device event timing gives a
launch's total only; this shows where a block's time goes.  Needs one card
and ``nvcc``; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
STAMPS = 5   # per block: start, staged, walked, voted, SM id

HEAD = """
__device__ long long g_stamp[1 << 20];
__device__ __forceinline__ long long now() {
  long long t; asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t)); return t;
}
__device__ __forceinline__ int sm_id() {
  int s; asm volatile("mov.u32 %0, %smid;" : "=r"(s)); return s;
}
"""


def _stamp(i: int) -> str:
    return f"  if (threadIdx.x == 0) g_stamp[blockIdx.x * 5 + {i}] = now();\n"


# (anchor in the kernel's source, what replaces it)
EDITS = [
    ("  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;\n",
     "  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;\n"
     + _stamp(0) + "  if (threadIdx.x == 0) g_stamp[blockIdx.x * 5 + 4]"
     " = sm_id();\n"),
    ("  __syncthreads();\n\n  // ---- svm sums, beside",
     "  __syncthreads();\n" + _stamp(1) + "\n  // ---- svm sums, beside"),
    ("  __syncthreads();\n\n  // ---- vote",
     "  __syncthreads();\n" + _stamp(2) + "\n  // ---- vote"),
    ("hop.rslt[b];\n      }\n    }\n  }\n",
     "hop.rslt[b];\n      }\n    }\n  }\n  __syncthreads();\n" + _stamp(3)),
]


def stamped_source(src: str) -> str:
    """The kernel's source with the stamps; raises if an anchor moved."""
    out = src.replace("namespace {", HEAD + "namespace {", 1)
    for anchor, repl in EDITS:
        if anchor not in out:
            raise RuntimeError(f"not in classify_fused.cu: {anchor!r}")
        out = out.replace(anchor, repl, 1)
    return out + """
extern "C" int acorn_stamps(long long* host, int n) {
  return (int)cudaMemcpyFromSymbol(host, g_stamp, n * sizeof(long long));
}
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.core.plane import PlaneProfile
    from repro_torch.kernels.build import BUILD_DIR, CSRC, NVCC_FLAGS, nvcc_path
    from repro_torch.kernels.classify_fused import (
        classify_fused,
        packets_per_block,
    )
    from repro_torch.serving import ZooServer

    if not torch.cuda.is_available():
        print("classify_fused_phases: no CUDA device", file=sys.stderr)
        return 2
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = BUILD_DIR / "classify_fused_phases.cu"
    lib_path = BUILD_DIR / "libclassify_fused_phases.so"
    cu.write_text(stamped_source((CSRC / "classify_fused.cu").read_text()))
    subprocess.run([nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o",
                    str(lib_path), str(cu)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))

    prof = PlaneProfile(**cs.FULL)
    models, programs, tests = cs.make_zoo(args.seed)
    zoo = ZooServer(prof, device="cuda")
    for v, p in programs.items():
        zoo.install(p, vid=v)
    pb, *_ = cs.traffic(np.random.default_rng(args.seed + 1), zoo, tests,
                        cs.BATCH)
    packed, pbd = zoo.packed, pb.to("cuda")
    V = packed.n_versions
    vid = torch.where((pbd.vid >= 0) & (pbd.vid < V), pbd.vid, 0)
    img, C = packed.image.fused, prof.max_classes
    codes, feats, shift = pbd.codes, pbd.features, packed.layer_shift
    want = classify_fused(codes, feats, vid, shift, img, C)
    B, T = codes.shape
    _, L, _, E, _ = img.entries.shape
    P, (H, F, levels) = img.pred_codes.shape[2], img.lut.shape[1:]
    PB = packets_per_block(T, F, B, L=L)
    outs = [torch.empty_like(x) for x in want]
    fn = lib.acorn_classify_fused
    fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 11 \
        + [ctypes.c_void_p]
    tensors = (codes, feats, vid, shift, img.entries, img.n_entries,
               img.pred_codes, img.pred_labels, img.weights, img.lut_fh,
               img.bias, *outs)

    def run():
        err = fn(*(x.data_ptr() for x in tensors), B, F, V, L, T, E, P, H,
                 levels, C, PB, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")

    for _ in range(3):   # warm: tables in L2 and L1 as on the main path
        run()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(outs, want)):
        raise AssertionError("the stamped kernel computes other outputs")
    n_blocks = -(-B // PB)
    buf = (ctypes.c_longlong * (n_blocks * STAMPS))()
    if lib.acorn_stamps(ctypes.addressof(buf), n_blocks * STAMPS):
        raise RuntimeError("reading the stamps failed")
    st = np.array(buf, dtype=np.int64).reshape(n_blocks, STAMPS)
    t0 = st[:, 0].min()
    span = st[:, 3].max() - t0
    block_vid = vid.cpu().numpy()[::PB][:n_blocks]
    print(f"{torch.cuda.get_device_name(0)}: B {B}, {PB} packets a block, "
          f"{n_blocks} blocks; first block start to last block end "
          f"{span} ns (stamped run)")
    for name, (i, j) in {"stage": (0, 1), "walk + leaf + svm": (1, 2),
                         "vote": (2, 3), "block": (0, 3)}.items():
        d = st[:, j] - st[:, i]
        by_vid = ", ".join(f"vid {v} {d[block_vid == v].mean():.0f}"
                           for v in range(V) if (block_vid == v).any())
        print(f"  {name}: mean {d.mean():.0f} ns, p90 "
              f"{np.percentile(d, 90):.0f} ns; by the block's first "
              f"packet's version: {by_vid}")
    busy = (st[:, 3] - st[:, 0]).sum()
    n_sm = len(set(st[:, 4].tolist()))
    print(f"  blocks resident on an SM, on average over the span: "
          f"{busy / span / n_sm:.2f} ({n_sm} SMs)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
