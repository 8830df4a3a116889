"""LM serving driver on the PyTorch port: feed a batch of prompts through
decode steps, then batched greedy decode with the KV cache — fixed shapes,
and a tenant/model swap writes new weights into the same tensors (the same
discipline as the ACORN plane).  The port of ``examples/serve_lm.py``; the
port serves the dense family (``--arch`` of the dense configs).

    PYTHONPATH=src python examples/torch_port/serve_lm.py [--device cpu] \\
        [--arch internlm2-1.8b]
"""
import argparse
import time

import torch

from repro_torch.configs import smoke_config
from repro_torch.models import decode_step, init_decode_state, init_params
from repro_torch.serving.serve import greedy_decode


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default="cuda",
                    help="where the model runs (default cuda)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    cfg = smoke_config(args.arch)
    params = init_params(cfg, torch.Generator(device).manual_seed(0),
                         device=device)
    B, P = args.batch, args.prompt_len
    prompts = torch.randint(0, cfg.vocab, (B, P), device=device,
                            generator=torch.Generator(device).manual_seed(1))

    # prefill: run the prompt through decode steps to warm the cache
    state = init_decode_state(cfg, B, P + args.gen, device=device)
    buffers = [t.data_ptr() for t in (*params.parameters(),
                                      *state.values())]
    t0 = time.perf_counter()
    logits = None
    for t in range(P):
        logits, state = decode_step(params, state, prompts[:, t:t + 1], t,
                                    cfg)
    sync()
    print(f"prefill {B}x{P} in {(time.perf_counter() - t0) * 1e3:.0f} ms")

    first = torch.argmax(logits[:, -1], dim=-1)[:, None]
    t0 = time.perf_counter()
    toks = greedy_decode(params, state, first, P, cfg, args.gen)
    sync()
    dt = time.perf_counter() - t0
    assert toks.shape == (B, args.gen)
    assert ((toks >= 0) & (toks < cfg.vocab)).all()
    print(f"decoded {B}x{args.gen} tokens in {dt * 1e3:.0f} ms "
          f"({B * args.gen / dt:.0f} tok/s on {device}; serving batch stays "
          "fixed-shape)")
    print("sample continuation ids:", toks[0, :12].cpu().numpy())

    # weight hot-swap: new model version written into the same tensors
    params.init_(torch.Generator(device).manual_seed(7))
    logits2, _ = decode_step(params, state, prompts[:, :1], P, cfg)
    assert torch.isfinite(logits2.float()).all()
    assert [t.data_ptr() for t in (*params.parameters(),
                                   *state.values())] == buffers
    print("weight swap OK — the same weight and cache tensors, written in "
          "place")


if __name__ == "__main__":
    main()
