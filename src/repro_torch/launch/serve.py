"""Serving launcher: batched fixed-shape decode with weight hot-swap.

Port of ``src/repro/launch/serve.py``, for an ``--arch`` of any family.
Each tenant gets new random weights (seeded on a ``torch.Generator``), a
random prompt fed through decode steps and ``gen`` greedy tokens; for the
encdec family the cross-attention K/V come first from ``encode_kv`` over
the stub frontend's frames (zeros, as in the reference).  Where JAX
asserts one compiled step across the swaps, the port asserts what a later
CUDA graph per shape needs: every swap writes the new weights into the same
parameter tensors and zeroes the one decode state (caches and recurrent
state) in place, so no ``data_ptr`` ever changes.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b \\
      --batch 16 --prompt-len 64 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b --smoke \\
      --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.models.common import ArchConfig
from repro_torch.models.transformer import (
    DEFAULT_DEVICE,
    LM,
    decode_step,
    encode_kv,
    init_decode_state,
    new_model,
    state_items,
)
from repro_torch.serving.serve import greedy_decode

__all__ = ["TenantRun", "serve", "tenant_generator", "main"]


@dataclasses.dataclass
class TenantRun:
    tokens: torch.Tensor   # [B, prompt_len + 1 + gen]: prompt, then output
    prompt_len: int
    seconds: float         # prompt steps + greedy steps, to the last token
    enc_inputs: torch.Tensor | None = None   # encdec: the encoder's frames

    @property
    def fed(self) -> torch.Tensor:
        """The tokens the decode steps consumed, one per step."""
        return self.tokens[:, :-1]


def tenant_generator(seed: int, tenant: int, device) -> torch.Generator:
    """The generator of tenant ``tenant``'s weights on ``device``; its
    prompt comes from seed ``seed + 100 + tenant``."""
    return torch.Generator(device=device).manual_seed(seed + tenant)


def _buffers(model: LM, state: dict) -> list[int]:
    return ([p.data_ptr() for p in model.parameters()]
            + [t.data_ptr() for _, t in state_items(state)])


def serve(cfg: ArchConfig, *, batch: int = 4, prompt_len: int = 16,
          gen: int = 32, swaps: int = 2, seed: int = 0, device=None):
    """Serve ``swaps`` tenants one after the other on one model and one
    decode state.  Returns (model, state, [TenantRun per tenant]); the
    model holds the last tenant's weights."""
    device = DEFAULT_DEVICE if device is None else torch.device(device)
    B, P = batch, prompt_len
    model = new_model(cfg, device=device)
    state = init_decode_state(cfg, B, P + gen, device=device)
    buffers = _buffers(model, state)
    runs = []
    for tenant in range(swaps):
        model.init_(tenant_generator(seed, tenant, device))
        for _, t in state_items(state):
            t.zero_()
        enc = None
        if cfg.family == "encdec":
            enc = torch.zeros((B, cfg.enc_seq, cfg.d_model), dtype=cfg.tdtype,
                              device=device)
            ks, vs = encode_kv(model, enc, cfg)
            state["ek"].copy_(ks)
            state["ev"].copy_(vs)
        g = torch.Generator(device=device).manual_seed(seed + 100 + tenant)
        prompts = torch.randint(0, cfg.vocab, (B, P), generator=g,
                                device=device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for t in range(P):
            logits, state = decode_step(model, state, prompts[:, t:t + 1], t,
                                        cfg)
        first = torch.argmax(logits[:, -1], dim=-1)[:, None]
        toks = greedy_decode(model, state, first, P, cfg, gen)
        tokens = torch.cat([prompts, first, toks], dim=1).cpu()
        runs.append(TenantRun(tokens, P, time.perf_counter() - t0, enc))
        if _buffers(model, state) != buffers:
            raise RuntimeError("a tenant swap reallocated the weights or the "
                               "decode state")
    return model, state, runs


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--swaps", type=int, default=2,
                    help="simulated tenant/model-version swaps")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    B, P, n = args.batch, args.prompt_len, args.gen
    _, _, runs = serve(cfg, batch=B, prompt_len=P, gen=n, swaps=args.swaps,
                       seed=args.seed, device=args.device)
    for tenant, run in enumerate(runs):
        print(f"tenant {tenant}: {B}x({P} prefill + {n} decode) in "
              f"{run.seconds * 1e3:.0f} ms ({B * n / run.seconds:.0f} tok/s)")
    print(f"served {args.swaps} tenants through ONE set of weight and cache "
          f"tensors, written in place ({cfg.name}, {cfg.family})")


if __name__ == "__main__":
    main()
