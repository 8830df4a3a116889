"""The port's serving fronts on the 204 conformance draws (shared by the
``test_torch_fronts_conformance_v*.py`` files, one zoo width V each, so the
lane spreads over the test workers).

Each draw of ``tests/test_conformance.py`` (a random DT/RF/SVM zoo and a
ragged batch with passthrough and invalid-VID packets, drawn by the JAX
package) is carried into the port and classified through

* the graph-cache runtime (``DataplaneRuntime`` over a
  ``SingleSwitchExecutor``, reprogrammed by ``swap``; on the CPU the cache
  runs its classify eagerly on the static buffers) in the fused and
  layerwise modes, and
* the port's ``AsyncZooServer`` and ``ContinuousZooServer``, the batch
  submitted as 1-3 ragged client chunks under a size-or-deadline policy and
  demuxed back,

each of which must equal the JAX ``SwitchEngine(mode="ref")`` on ``rslt``,
``codes`` and ``svm_acc`` exactly.  The port's own draws
(``repro_torch.data.conformance``, used on the card) are held to the
reference's.
"""
import asyncio
import dataclasses

import numpy as np
import torch

import test_conformance as conf
from repro.core.plane import SwitchEngine as JaxEngine
from repro_torch.core import plane as tp
from repro_torch.data import conformance as draws
from repro_torch.runtime import (
    DataplaneRuntime,
    SingleSwitchExecutor,
    SizeOrDeadlinePolicy,
    bucket_ladder,
    bucket_size,
)
from repro_torch.serving import AsyncZooServer, ContinuousZooServer, ZooServer
from test_torch_plane import (
    assert_batches_equal,
    port_batch,
    port_packed,
    port_profile,
)

# the fronts' own mode (the kernels' plain versions on the exec image) and
# the layerwise twins; every mode on every draw is tests/test_torch_staged.py
MODES = ("cuda", "layerwise")


async def serve_chunks(zoo, pb, rng, server_cls):
    """``tests/test_conformance.py:_serve_async`` for the port: the batch as
    1-3 ragged client chunks through an async front; the demuxed results
    re-concatenated in order."""
    policy = SizeOrDeadlinePolicy(max_batch=32, max_wait_us=500.0)
    B = pb.batch
    n_chunks = int(rng.integers(1, min(3, B) + 1))
    cuts = sorted(rng.choice(np.arange(1, B), size=n_chunks - 1,
                             replace=False).tolist()) if n_chunks > 1 else []
    bounds = [0] + cuts + [B]
    chunks = [pb.map(lambda x, lo=lo, hi=hi: x[lo:hi])
              for lo, hi in zip(bounds, bounds[1:])]
    kw = {"n_slots": 2, "warm": False} \
        if server_cls is ContinuousZooServer else {}
    async with server_cls(zoo, policy=policy, **kw) as srv:
        outs = await asyncio.gather(*[srv.submit_batch(c) for c in chunks])
    return (np.concatenate([o.rslt for o in outs]),
            np.concatenate([o.codes for o in outs]),
            np.concatenate([o.svm_acc for o in outs]))


def run_lane(V: int) -> None:
    jprof = conf._profile(V)
    prof = port_profile(jprof)
    oracle = JaxEngine(jprof, mode="ref")
    rts = {m: DataplaneRuntime(SingleSwitchExecutor(prof, mode=m,
                                                    device="cpu"))
           for m in MODES}
    zoo = ZooServer(prof, executor=rts["cuda"].executor)
    maker = tp.SwitchEngine(prof, device="cpu")
    buckets = set()
    for case in range(conf.N_CASES[V]):
        seed, _progs, jpacked, jpb = conf._draw_case(V, case, jprof)
        want = oracle.classify(jpacked, jpb)
        packed, pb = port_packed(jpacked, jprof), port_batch(jpb)
        what = f"V={V} case={case}"
        if case % 6 == 0:       # the port's own draw is the reference's
            mine, mine_pb = draws.draw_case(V, case, maker)
            for x, y in zip(tp.program_tensors(mine),
                            tp.program_tensors(packed)):
                assert torch.equal(x, y), what
            for f in dataclasses.fields(pb):
                assert torch.equal(getattr(mine_pb, f.name),
                                   getattr(pb, f.name)), (what, f.name)
        for mode, rt in rts.items():
            rt.swap(packed)
            assert_batches_equal(rt.run(pb), want, what=f"{what} {mode}")
        for cls in (AsyncZooServer, ContinuousZooServer):
            rng = np.random.default_rng(seed + 1)   # same chunks both fronts
            rslt, codes, acc = asyncio.run(
                serve_chunks(zoo, pb, rng, cls), debug=True)
            np.testing.assert_array_equal(rslt, np.asarray(want.rslt),
                                          err_msg=f"{what} {cls.__name__}")
            np.testing.assert_array_equal(codes, np.asarray(want.codes),
                                          err_msg=f"{what} {cls.__name__}")
            np.testing.assert_array_equal(acc, np.asarray(want.svm_acc),
                                          err_msg=f"{what} {cls.__name__}")
        buckets.add(bucket_size(pb.batch))
    # one cache entry per admission bucket the draws reached, whatever the
    # swaps did in between; the fronts' dispatches (cut at 32 packets) stay
    # on the ladder
    assert rts["layerwise"].cache_size() == len(buckets)
    assert rts["cuda"].cache_size() <= len(bucket_ladder(max(conf.SIZES)))
