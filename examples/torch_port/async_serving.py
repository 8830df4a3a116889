"""Scenario: a live request stream against the async serving front, on the
PyTorch port.

The batch examples hand the plane a ready-made batch; real ACORN ingress is
a *stream* — many clients, small ragged requests, Poisson arrivals.  This
example drives an ``AsyncZooServer`` with an open-loop Poisson client (the
arrival process never waits for responses — offered load is fixed, like
traffic hitting a switch port) and compares the pluggable batching
policies:

* ``ImmediatePolicy``       — every request dispatches alone;
* ``SizeOrDeadlinePolicy``  — coalesce up to 64 packets or 3 ms;
* ``AdaptiveBucketPolicy``  — the flush target widens to the next
  power-of-two admission bucket under sustained load and snaps back down
  when a deadline flush shows the load dropped.

Whatever the policy did to the stream, every response is bit-identical to a
synchronous classify of the same packets — asserted on every response.  The
port of ``examples/async_serving.py``.

    PYTHONPATH=src python examples/torch_port/async_serving.py [--device cpu]
"""
import argparse
import asyncio
import time

import numpy as np

from repro_torch.core.mlmodels import DecisionTree, Quantizer
from repro_torch.core.plane import PlaneProfile
from repro_torch.data import load_dataset
from repro_torch.runtime import (
    AdaptiveBucketPolicy,
    ImmediatePolicy,
    SizeOrDeadlinePolicy,
)
from repro_torch.serving import AsyncZooServer, ZooServer

N_REQUESTS = 300
MEAN_REQ_PKTS = 2


async def poisson_client(srv, Xteq, sync_all, rate_rps: float,
                         rng: np.random.Generator):
    """Open-loop Poisson arrivals: fire-and-gather, never wait in between."""
    loop = asyncio.get_running_loop()
    t0 = loop.time()
    arrivals = np.cumsum(rng.exponential(1.0 / rate_rps, N_REQUESTS))
    tasks, spans = [], []
    for t_arr in arrivals:
        delay = t0 + t_arr - loop.time()
        if delay > 0:
            await asyncio.sleep(delay)
        lo = int(rng.integers(0, Xteq.shape[0] - MEAN_REQ_PKTS))
        n = int(rng.integers(1, 2 * MEAN_REQ_PKTS))
        spans.append((lo, lo + n))
        tasks.append(asyncio.create_task(
            srv.submit(Xteq[lo:lo + n], mid=0, vid=0)))
    outs = await asyncio.gather(*tasks)
    # every response bit-identical to the synchronous classify of its span
    for (lo, hi), out in zip(spans, outs):
        assert (out.rslt == sync_all[lo:hi]).all(), \
            "async response diverged from synchronous classify"
    return outs


async def serve(zoo, Xteq, sync_all):
    # calibrate offered load to this host: a single-request dispatch time
    for _ in range(3):
        t0 = time.perf_counter()
        zoo.classify(Xteq[:1], mid=0, vid=0)
        t1 = time.perf_counter() - t0
    rate = 2.0 / t1          # 2x what per-request dispatch can serve
    print(f"single-request dispatch ~{t1 * 1e3:.2f} ms "
          f"-> offered load {rate:.0f} req/s ({N_REQUESTS} requests)\n")
    print(f"{'policy':<18} {'p50 ms':>8} {'p99 ms':>8} {'mean batch':>11} "
          f"{'dispatches':>11}")
    policies = {
        "immediate": ImmediatePolicy(),
        "size-or-deadline": SizeOrDeadlinePolicy(max_batch=64,
                                                 max_wait_us=3_000),
        "adaptive-bucket": AdaptiveBucketPolicy(max_batch=128,
                                                max_wait_us=3_000),
    }
    for name, policy in policies.items():
        async with AsyncZooServer(zoo, policy=policy) as srv:
            await poisson_client(srv, Xteq, sync_all, rate,
                                 np.random.default_rng(42))
            stats = srv.latency_stats()
        print(f"{name:<18} {stats['p50_ms']:>8.2f} {stats['p99_ms']:>8.2f} "
              f"{stats['mean_batch_packets']:>11.1f} "
              f"{stats['dispatches']:>11d}")
    print("\nevery response checked bit-identical to synchronous classify; "
          f"captured graphs: {zoo.cache_size()} (one per admission bucket)")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="where the zoo runs (default cuda)")
    args = ap.parse_args(argv)

    Xtr, ytr, Xte, yte = load_dataset("cicids-17", scale=0.04,
                                      max_train=4000)
    q = Quantizer(8).fit(Xtr)
    Xtrq, Xteq = q.transform(Xtr)[:, :36], q.transform(Xte)[:, :36]

    prof = PlaneProfile(max_features=36, max_trees=4, max_layers=12,
                        max_entries_per_layer=256, max_leaves=256,
                        max_classes=8, max_hyperplanes=8, max_versions=2)
    zoo = ZooServer(prof, device=args.device)
    zoo.install(DecisionTree(max_depth=6, max_leaf_nodes=48).fit(Xtrq, ytr),
                vid=0, tag="ids-v1")
    sync_all = zoo.classify(Xteq, mid=0, vid=0)     # the bit-identity oracle
    # warm every admission bucket a policy can dispatch into, so the latency
    # table below measures serving, not first-touch capture
    B = 1
    while B <= 128:
        zoo.classify(Xteq[:B], mid=0, vid=0)
        B *= 2
    asyncio.run(serve(zoo, Xteq, sync_all))


if __name__ == "__main__":
    main()
