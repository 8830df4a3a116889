"""The paper's Figure 2 on device lanes, driven through the runtime layer
of the PyTorch port: a forest distributed across "switches", packets
hopping from lane to lane, GPipe-style pipelining — and then the same
traffic data-parallel across "port" lanes of a (switch x port) layout, the
"aggregate traffic from many ingress ports" model.

The port of ``examples/distributed_inference.py``.  The lanes spread over
the cards there are (``torch.cuda.device_count()``); on fewer cards than
lanes a card holds several (the reference emulates four devices for the
same), so every switch's program stays on the path.

    PYTHONPATH=src python examples/torch_port/distributed_inference.py \\
        [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core.distributed_plane import build_device_programs
from repro_torch.core.mlmodels import Quantizer, RandomForest, accuracy
from repro_torch.core.packets import PacketBatch
from repro_torch.core.plane import PlaneProfile, SwitchEngine
from repro_torch.core.planner import DeviceModel, plan_program
from repro_torch.core.topology import fat_tree
from repro_torch.core.translator import translate
from repro_torch.data import load_dataset
from repro_torch.runtime import (
    DataplaneRuntime,
    PipelinedExecutor,
    ShardedExecutor,
)

N_PORTS = 4     # the reference's port lanes: its four emulated devices


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (lanes over every card) or cpu")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    cards = (torch.cuda.device_count() if device.type == "cuda" else 0)

    def lanes(n):
        """n lane devices, round robin over the cards (or the CPU)."""
        if not cards:
            return [device] * n
        return [torch.device("cuda", i % cards) for i in range(n)]
    print(f"devices: {cards} card(s)" if cards else "devices: the CPU")

    Xtr, ytr, Xte, yte = load_dataset("satdap", scale=0.3)
    q = Quantizer(8).fit(Xtr)
    Xtrq, Xteq = q.transform(Xtr), q.transform(Xte)
    rf = RandomForest(n_estimators=4, max_depth=5,
                      max_leaf_nodes=30).fit(Xtrq, ytr)
    prog = translate(rf)

    net = fat_tree(4)
    h = net.hosts()
    plan = plan_program(prog, net, h[0], h[-1],
                        default_device=DeviceModel(n_stages=4), solver="dp")
    print(f"plan: {len(plan.device_stages())} switches on path {plan.path}")

    prof = PlaneProfile(max_features=36, max_trees=4, max_layers=8,
                        max_entries_per_layer=64, max_leaves=64,
                        max_classes=8, max_hyperplanes=8)
    _, dps = build_device_programs(prog, plan, prof, device=device)
    n_switch = len(dps)

    # ---- pipeline-parallel along the path: one executor behind the runtime
    runtime = DataplaneRuntime(PipelinedExecutor(
        dps, n_micro=8, n_classes=prof.max_classes,
        devices=lanes(n_switch)))
    B = 509  # deliberately ragged: admission pads to the power-of-two bucket
    Xm = np.tile(Xteq, (4, 1))[:B]
    pb = PacketBatch.make_request(Xm, mid=prog.mid, max_features=36,
                                  n_trees=4, n_hyperplanes=8)
    out = runtime.run(pb)  # capture + run
    t0 = time.perf_counter()
    got = runtime.run(pb).rslt.cpu().numpy()
    dt = time.perf_counter() - t0
    assert got.shape == (B,)
    assert (got == rf.predict(Xm)).all()
    assert (out.rslt.cpu().numpy() == got).all()
    print(f"pipelined {B} ragged packets (bucket {runtime.bucket(B)}) across "
          f"{n_switch} 'switches' in {dt * 1e3:.1f} ms — answers match the "
          "forest exactly")

    # ---- runtime reprogram the whole distributed plane, same graphs ----
    rf2 = RandomForest(n_estimators=4, max_depth=5, max_leaf_nodes=30,
                       random_state=9).fit(Xtrq, ytr)
    _, dps2 = build_device_programs(translate(rf2), plan, prof, device=device)
    runtime.swap(dps2)
    out2 = runtime.run(pb)
    assert (out2.rslt.cpu().numpy() == rf2.predict(Xm)).all()
    print(f"hot-swapped the model on every switch — still "
          f"{runtime.cache_size()} captured pipeline(s).")

    # ---- data-parallel across port lanes: (switch x port) layout --------
    # One switch worth of tables on every port lane; the packet batch itself
    # is sharded — each lane serves its slice of the aggregate traffic.
    eng = SwitchEngine(prof, device=device)
    full = eng.install(eng.empty(), translate(rf2))
    sharded = DataplaneRuntime(ShardedExecutor(
        [full], n_classes=prof.max_classes, n_ports=N_PORTS, n_micro=1,
        devices=lanes(N_PORTS)))
    out3 = sharded.run(pb)
    assert (out3.rslt.cpu().numpy() == rf2.predict(Xm)).all()
    ym = np.tile(yte, 4)[:B]
    print(f"same {B} packets sharded over {N_PORTS} port lanes "
          f"(bucket {sharded.bucket(B)}) — bit-identical answers, "
          f"acc={accuracy(ym, out3.rslt.cpu().numpy()):.3f}")


if __name__ == "__main__":
    main()
