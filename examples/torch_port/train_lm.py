"""End-to-end LM training on the PyTorch port: a small config for a
few hundred steps with a checkpoint and a restart mid-run.  The port of
``examples/train_lm.py``: the same config, steps and batches.

    PYTHONPATH=src python examples/torch_port/train_lm.py [--device cpu] \\
        [--steps 300] [--arch internlm2-1.8b]

The arch's smoke config, cut to d_model 128, d_ff 256 and 4 layers (6 for
the hybrid family), is used; the full config trains through
``python -m repro_torch.launch.train`` (and ``chip_smoke.py --train``).
"""
import argparse
import tempfile
import time

import torch

from repro_torch.configs import smoke_config
from repro_torch.data import TokenPipeline
from repro_torch.models import init_params
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.train import Checkpointer, make_train_step


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--n-micro", type=int, default=2)
    ap.add_argument("--device", default="cuda",
                    help="where the model trains (default cuda)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)

    base = smoke_config(args.arch)
    cfg = base.scaled(d_model=128, d_ff=256,
                      n_layers=4 if base.family != "hybrid" else 6)
    ocfg = AdamWConfig(lr=3e-3, warmup_steps=20, total_steps=args.steps)

    def fresh():
        params = init_params(cfg, torch.Generator(device).manual_seed(0),
                             device=device)
        return params, adamw_init(params, ocfg)

    params, opt = fresh()
    pipe = TokenPipeline(vocab_size=cfg.vocab, seq_len=args.seq,
                         global_batch=args.batch)
    step_fn = make_train_step(cfg, ocfg, n_micro=args.n_micro)
    with tempfile.TemporaryDirectory(prefix="acorn_lm_ck_") as ckdir:
        ck = Checkpointer(ckdir, keep=2)

        def batch():
            b = pipe.next_batch()
            return {k: torch.from_numpy(b[k]).to(device).reshape(
                args.n_micro, -1, args.seq) for k in ("tokens", "labels")}

        t0 = time.time()
        first = last = None
        for s in range(1, args.steps // 2 + 1):
            params, opt, m = step_fn(params, opt, batch())
            if s == 1:
                first = float(m["loss"])
            if s % 50 == 0:
                print(f"step {s:4d} loss {float(m['loss']):.4f} "
                      f"({(time.time() - t0) / s * 1e3:.0f} ms/step)")
        ck.save(args.steps // 2, params, opt,
                extra={"data": pipe.state_dict()})
        ck.wait()
        print(f"--- simulated preemption at step {args.steps // 2}; "
              f"restarting from {ckdir} ---")

        # restart path: fresh weights and state, everything restored
        params, opt = fresh()
        s0, params, opt, extra = ck.restore(params, opt)
        pipe = TokenPipeline(vocab_size=cfg.vocab, seq_len=args.seq,
                             global_batch=args.batch)
        pipe.load_state_dict(extra["data"])
        for s in range(s0 + 1, args.steps + 1):
            params, opt, m = step_fn(params, opt, batch())
            if s % 50 == 0:
                print(f"step {s:4d} loss {float(m['loss']):.4f}")
            last = float(m["loss"])
    print(f"loss {first:.4f} -> {last:.4f} across a restart "
          f"({'OK' if last < first else 'NOT DECREASING'}) on {device}")


if __name__ == "__main__":
    main()
