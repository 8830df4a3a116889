"""Quickstart on the PyTorch port: the paper's headline workflow.

Train a Python model -> submit it to ACORN -> it is translated, planned, and
deployed across a fat-tree network -> send inference request packets ->
answers match the server-side model exactly (Cohen's kappa = 1).  The port
of ``examples/quickstart.py``: the switches' partial programs run in path
order through ``DataplaneRuntime(SequentialPathExecutor(...))``.

    PYTHONPATH=src python examples/torch_port/quickstart.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.core.distributed_plane import build_device_programs
from repro_torch.core.mlmodels import (
    DecisionTree,
    Quantizer,
    accuracy,
    cohen_kappa,
)
from repro_torch.core.netsim import acorn_serving_time
from repro_torch.core.packets import PacketBatch
from repro_torch.core.plane import PlaneProfile
from repro_torch.core.planner import DeviceModel, plan_program
from repro_torch.core.topology import fat_tree
from repro_torch.core.translator import translate
from repro_torch.data import load_dataset
from repro_torch.runtime import DataplaneRuntime, SequentialPathExecutor


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="where the switches' programs run (default cuda)")
    args = ap.parse_args(argv)

    # 1. An ML developer trains an ordinary Python model (46 features).
    Xtr, ytr, Xte, yte = load_dataset("nsl-kdd", scale=0.03, max_train=5000)
    q = Quantizer(8).fit(Xtr)
    model = DecisionTree(max_depth=12, max_leaf_nodes=200).fit(
        q.transform(Xtr)[:, :46], ytr)
    print(f"trained DT: {model.tree_.n_nodes} nodes, depth "
          f"{model.tree_.max_depth}, server-side acc "
          f"{accuracy(yte, model.predict(q.transform(Xte)[:, :46])):.3f}")

    # 2. ACORN translates it into match-action tables...
    prog = translate(model)
    print(f"translated: {prog.n_stages} stages, {prog.total_tcam_entries()} "
          f"TCAM + {prog.total_sram_entries()} SRAM entries")

    # 3. ...plans an optimal deployment over the network (ILP / exact DP)...
    net = fat_tree(4)
    hosts = net.hosts()
    plan = plan_program(prog, net, hosts[0], hosts[-1],
                        default_device=DeviceModel(n_stages=8), solver="dp")
    print(f"plan: path={plan.path}")
    print(f"      devices={plan.breakdown['devices_used']}, "
          f"J_L={acorn_serving_time(plan) * 1e6:.1f}us, solved in "
          f"{plan.solve_time * 1e3:.1f}ms")

    # 4. ...and installs entries on each switch (runtime-programmable plane).
    profile = PlaneProfile(max_features=46, max_trees=1, max_layers=16,
                           max_entries_per_layer=512, max_leaves=256)
    devices, device_programs = build_device_programs(prog, plan, profile,
                                                     device=args.device)

    # 5. Clients send ACORN request packets; the network classifies in-path.
    Xteq = q.transform(Xte)[:, :46]
    packets = PacketBatch.make_request(
        Xteq, mid=prog.mid, max_features=46, n_trees=profile.max_trees,
        n_hyperplanes=profile.max_hyperplanes)
    path = DataplaneRuntime(SequentialPathExecutor(
        device_programs, n_classes=profile.max_classes))
    in_network = path.run(packets).rslt.cpu().numpy()
    server_side = model.predict(Xteq)
    print(f"{len(devices)} switches on {path.executor.device}: in-network acc "
          f"{accuracy(yte, in_network):.3f}, kappa(in-network, server) = "
          f"{cohen_kappa(in_network, server_side):.3f}")
    assert cohen_kappa(in_network, server_side) == 1.0
    assert (in_network == server_side).all()
    print("OK: the network computes exactly the trained model.")


if __name__ == "__main__":
    main()
