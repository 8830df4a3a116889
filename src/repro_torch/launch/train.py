"""Train launcher: the train step with async checkpoints, cursor-exact data
resume and straggler timing.

Port of ``src/repro/launch/train.py``, with the same flags plus
``--device`` (default ``cuda``).  The optimizer state is bfloat16 above
150e9 parameters, float32 below; the data shard is the process's rank and
world size under ``torch.distributed`` (0 and 1 without it).
``--compress-pod-grads`` is parsed and unused, as in the reference (which
parses it and never reads it).  The reference's ``PRODUCTION_XLA_FLAGS``
are TPU flags and stay behind.

  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
      [--steps 50] [--ckpt-dir DIR] [--resume]
  PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \\
      --seq 4096 --global-batch 8 --n-micro 4
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time
from collections.abc import Callable

import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.data.tokens import TokenPipeline
from repro_torch.models.common import ArchConfig
from repro_torch.models.transformer import LM, init_params
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.train.checkpoint import Checkpointer
from repro_torch.train.step import make_train_step

__all__ = ["Run", "opt_config", "setup", "next_batch", "main"]


def opt_config(cfg: ArchConfig, *, smoke: bool, steps: int) -> AdamWConfig:
    """The launcher's AdamW: lr 3e-3 on a smoke config (3e-4 else), 10
    warm-up steps, and bfloat16 moments above 150e9 parameters."""
    return AdamWConfig(lr=3e-3 if smoke else 3e-4, warmup_steps=10,
                       total_steps=max(steps, 100),
                       state_dtype="bfloat16" if cfg.param_count() > 150e9
                       else "float32")


def _shard() -> tuple[int, int]:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


@dataclasses.dataclass
class Run:
    """What one training run holds: the model, its AdamW state and config,
    the token pipeline and the train step."""
    cfg: ArchConfig
    model: LM
    opt: dict
    ocfg: AdamWConfig
    pipe: TokenPipeline
    step: Callable
    n_micro: int
    device: torch.device


def setup(cfg: ArchConfig, *, seq: int, global_batch: int, n_micro: int,
          ocfg: AdamWConfig, device=None, seed: int = 0) -> Run:
    """The model (random weights from ``seed`` on ``device``, ``cuda`` by
    default), its AdamW state, this process's shard of the token stream and
    the train step."""
    device = torch.device("cuda" if device is None else device)
    model = init_params(cfg, torch.Generator(device).manual_seed(seed),
                        device=device)
    shard, num_shards = _shard()
    pipe = TokenPipeline(vocab_size=cfg.vocab, seq_len=seq,
                         global_batch=global_batch, shard=shard,
                         num_shards=num_shards)
    step = make_train_step(cfg, ocfg, n_micro=n_micro,
                           has_enc=cfg.family == "encdec")
    return Run(cfg, model, adamw_init(model, ocfg), ocfg, pipe, step,
               n_micro, device)


def next_batch(run: Run) -> dict:
    """The pipeline's next batch on the run's device, [n_micro, B_mb, S]
    (the encdec family's stub frames zeros, as in the reference)."""
    b = run.pipe.next_batch()
    out = {k: torch.from_numpy(b[k]).to(run.device).reshape(
        run.n_micro, -1, run.pipe.seq_len) for k in ("tokens", "labels")}
    if run.cfg.family == "encdec":
        B_mb = out["tokens"].shape[1]
        out["enc_inputs"] = torch.zeros(
            (run.n_micro, B_mb, run.cfg.enc_seq, run.cfg.d_model),
            dtype=run.cfg.tdtype, device=run.device)
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> list[float]:
    """Parse the flags and train; returns each step's loss."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's reduced config")
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--global-batch", type=int, default=16)
    ap.add_argument("--n-micro", type=int, default=2)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--compress-pod-grads", action="store_true",
                    help="parsed and unused, as in the reference")
    ap.add_argument("--straggler-warn-ms", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    run = setup(cfg, seq=args.seq, global_batch=args.global_batch,
                n_micro=args.n_micro, device=args.device,
                ocfg=opt_config(cfg, smoke=args.smoke, steps=args.steps))
    ck = Checkpointer(args.ckpt_dir or os.path.join(
        tempfile.gettempdir(), f"acorn_{args.arch}_ck"), keep=3)
    start = 0
    if args.resume:
        try:
            start, _, _, extra = ck.restore(run.model, run.opt)
            run.pipe.load_state_dict(extra["data"])
            print(f"resumed from step {start}")
        except FileNotFoundError:
            print("no checkpoint found; cold start")

    times, losses = [], []
    for s in range(start + 1, args.steps + 1):
        t0 = time.perf_counter()
        _, _, m = run.step(run.model, run.opt, next_batch(run))
        losses.append(float(m["loss"]))
        _sync(run.device)
        dt = time.perf_counter() - t0
        times.append(dt)
        # straggler hook: flag steps slower than the trailing median
        if args.straggler_warn_ms and len(times) > 5:
            med = sorted(times[-20:])[len(times[-20:]) // 2]
            if dt > med + args.straggler_warn_ms / 1e3:
                print(f"[straggler] step {s}: {dt*1e3:.0f} ms vs median "
                      f"{med*1e3:.0f} ms")
        if s % 10 == 0 or s == args.steps:
            print(f"step {s:5d} loss {losses[-1]:.4f} "
                  f"gnorm {float(m['grad_norm']):.3f} {dt*1e3:.0f} ms")
        if s % args.ckpt_every == 0 or s == args.steps:
            ck.save(s, run.model, run.opt,
                    extra={"data": run.pipe.state_dict()})
    ck.wait()
    print(f"done at step {args.steps}; checkpoints in {ck.dir}")
    return losses


if __name__ == "__main__":
    main()
