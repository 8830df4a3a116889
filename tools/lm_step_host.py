#!/usr/bin/env python3
"""Host time of one eager LM decode step on one CUDA card, with Python's
cyclic collector's pauses in each timed window.

    python3 tools/lm_step_host.py [--src DIR] [--arch internlm2-1.8b]

Imports the port from ``--src`` (default: ``src/`` beside this script), so
one script times two trees of the port in one call, each in a fresh
process: ``--src`` of an unpacked older commit, then this tree's.  Builds
the config at full width with random weights (``init_params``, ``--seed``),
fills the K/V caches to ``--kv-len`` at B ``--batch``, warms up, then times
``--repeats`` windows of ``--steps`` steps by the host clock (the card
synchronised at each window's end), first with the collector on, then
with it off (``gc.disable``).  Prints one JSON line: ms a step a window,
and the collections (generation 2 among them) and their ms a window.
Needs one card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parent.parent
                                         / "src"))
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--kv-len", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("lm_step_host: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, args.src)
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import (
        decode_step,
        init_decode_state,
        init_params,
    )

    device = torch.device("cuda")
    cfg = get_config(args.arch)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    model = init_params(cfg, gen, device=device)
    B, T = args.batch, args.kv_len
    state = init_decode_state(cfg, B, T, device=device)
    for cache in state.values():
        cache.normal_(generator=gen)
    tok = torch.randint(0, cfg.vocab, (B, 1), generator=gen, device=device)

    def step():
        return decode_step(model, state, tok, T - 1, cfg)

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    seen = {"n": 0, "gen2": 0, "ms": 0.0}
    t0 = [0.0]

    def cb(what, info):
        if what == "start":
            t0[0] = time.perf_counter()
        else:
            seen["n"] += 1
            seen["gen2"] += info["generation"] == 2
            seen["ms"] += (time.perf_counter() - t0[0]) * 1e3

    gc.callbacks.append(cb)
    out = {"src": args.src, "arch": args.arch, "batch": B, "kv_len": T,
           "steps": args.steps}
    for label in ("gc_on", "gc_off"):
        if label == "gc_off":
            gc.disable()
        rows = []
        for _ in range(args.repeats):
            seen.update(n=0, gen2=0, ms=0.0)
            t = time.perf_counter()
            for _ in range(args.steps):
                step()
            torch.cuda.synchronize()
            rows.append({"ms_a_step": (time.perf_counter() - t) * 1e3
                         / args.steps, "gc": dict(seen)})
        out[label] = rows
    gc.enable()
    gc.callbacks.remove(cb)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
