#!/usr/bin/env python3
"""How far RWKV-6's decode drifts from its own forward with depth, in f32,
at rwkv6-7b's widths, on the CPU: the JAX package's or the port's.

    PYTHONPATH=src python3 tools/rwkv_depth_drift.py --package jax
    PYTHONPATH=src python3 tools/rwkv_depth_drift.py --package torch

For each depth of ``--depths``, rwkv6-7b's config cut to that many layers
(d_model 4096, 64 heads of 64, d_ff 14336, vocab 65536 as published), in
float32, with random weights from the package's own ``init_params`` (seed
``--seed``): ``--batch`` x ``--seq`` tokens (numpy, from the seed) through
``forward``, and the same tokens teacher-forced through ``decode_step``
from a zero state.  Prints a JSON line a depth: the largest |decode -
forward| over the logits, its rms, and the largest |logit|.  Each package
runs in its own process and imports only itself (``jax`` and ``repro``, or
``torch`` and ``repro_torch``).  A depth of L layers holds 2.1 + 0.88 L GB
of f32 weights.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def jax_logits(d, toks, seed):
    import jax
    import jax.numpy as jnp

    from repro import configs
    from repro.models import (
        decode_step,
        forward,
        init_decode_state,
        init_params,
    )

    cfg = configs.get_config("rwkv6-7b").scaled(n_layers=d, dtype="float32")
    params = init_params(cfg, jax.random.key(seed))
    t = jnp.asarray(toks)
    fwd = jax.jit(lambda p, x: forward(p, x, cfg, remat=False))(params, t)
    step = jax.jit(lambda p, s, x, pos: decode_step(p, s, x, pos, cfg))
    state = init_decode_state(cfg, *toks.shape)
    dec = []
    for i in range(toks.shape[1]):
        lg, state = step(params, state, t[:, i:i + 1], jnp.int32(i))
        dec.append(np.asarray(lg[:, 0], np.float32))
    return np.stack(dec, axis=1), np.asarray(fwd, np.float32)


def torch_logits(d, toks, seed):
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.transformer import (
        decode_step,
        forward,
        init_decode_state,
        init_params,
    )

    cpu = torch.device("cpu")
    cfg = get_config("rwkv6-7b").scaled(n_layers=d, dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(seed), device=cpu)
    t = torch.from_numpy(toks)
    fwd = forward(params, t, cfg)
    state = init_decode_state(cfg, *toks.shape, device=cpu)
    dec = []
    for i in range(toks.shape[1]):
        lg, state = decode_step(params, state, t[:, i:i + 1], i, cfg)
        dec.append(lg[:, 0])
    return torch.stack(dec, dim=1).numpy(), fwd.numpy()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--package", choices=("jax", "torch"), required=True)
    ap.add_argument("--depths", type=int, nargs="+", default=[1, 2, 4, 6])
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    run = jax_logits if args.package == "jax" else torch_logits
    toks = np.random.default_rng(args.seed).integers(
        0, 65536, (args.batch, args.seq)).astype(np.int32)
    for d in args.depths:
        t0 = time.perf_counter()
        dec, fwd = run(d, toks, args.seed)
        err = np.abs(dec - fwd)
        print(json.dumps({"package": args.package, "layers": d,
                          "max_abs_err": float(err.max()),
                          "rms_err": float(np.sqrt((err ** 2).mean())),
                          "max_abs_logit": float(np.abs(fwd).max()),
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
