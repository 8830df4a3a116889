"""Scenario: an IDS operator runs a random forest + an SVM side by side,
hot-swaps model versions at runtime, and survives a switch failure — on
the PyTorch port.

Demonstrates the paper's three pillars on one network:
  * runtime programmability — version swap = entry rewrite, nothing
    captured again (one graph per admission bucket);
  * multi-model data plane — tree + SVM pipelines coexist (Fig. 5);
  * beyond-paper fault tolerance — replan around a dead switch.

The port of ``examples/deploy_ids_model.py``: the plane is a
``DataplaneRuntime`` over a ``SingleSwitchExecutor``, and the replanned
path runs through ``DataplaneRuntime(SequentialPathExecutor(...))``.

    PYTHONPATH=src python examples/torch_port/deploy_ids_model.py \\
        [--device cpu]
"""
import argparse

from repro_torch.core.distributed_plane import build_device_programs
from repro_torch.core.mlmodels import (
    LinearSVM,
    Quantizer,
    RandomForest,
    accuracy,
)
from repro_torch.core.packets import PacketBatch
from repro_torch.core.plane import PlaneProfile
from repro_torch.core.planner import DeviceModel, plan_program, replan
from repro_torch.core.topology import fat_tree
from repro_torch.core.translator import translate
from repro_torch.data import load_dataset
from repro_torch.runtime import DataplaneRuntime, SequentialPathExecutor


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="where the plane runs (default cuda)")
    args = ap.parse_args(argv)

    Xtr, ytr, Xte, yte = load_dataset("cicids-17", scale=0.04,
                                      max_train=4000)
    q = Quantizer(8).fit(Xtr)
    Xtrq, Xteq = q.transform(Xtr)[:, :36], q.transform(Xte)[:, :36]

    prof = PlaneProfile(max_features=36, max_trees=8, max_layers=12,
                        max_entries_per_layer=256, max_leaves=256,
                        max_classes=8, max_hyperplanes=8, max_versions=4)
    plane = DataplaneRuntime.for_profile(prof, device=args.device)

    # v1 forest + an SVM tenant on the same plane
    rf_v1 = RandomForest(n_estimators=4, max_depth=6, max_leaf_nodes=40,
                         random_state=1).fit(Xtrq, ytr)
    svm = LinearSVM(epochs=150).fit(Xtrq, ytr)
    plane.install(translate(rf_v1, vid=1), vid=1)
    plane.install(translate(svm, vid=1), vid=1)

    def mk(mid, vid):
        return PacketBatch.make_request(
            Xteq, mid=mid, vid=vid, max_features=36, n_trees=8,
            n_hyperplanes=8, max_versions=prof.max_versions)

    def answers(runtime, mid, vid):
        return runtime.run(mk(mid, vid)).rslt.cpu().numpy()
    acc_rf = accuracy(yte, answers(plane, 1, 1))
    acc_svm = accuracy(yte, answers(plane, 2, 1))
    print(f"v1 forest acc={acc_rf:.3f} | svm tenant acc={acc_svm:.3f} "
          f"(one plane, two pipelines)")

    # deploy a stronger v2 forest into its own zoo slot — written in place,
    # and v1 stays resident: requests pick their version by VID
    rf_v2 = RandomForest(n_estimators=8, max_depth=8, max_leaf_nodes=100,
                         random_state=2).fit(Xtrq, ytr)
    plane.install(translate(rf_v2, vid=2), vid=2)
    acc_v2 = accuracy(yte, answers(plane, 1, 2))
    acc_v1_still = accuracy(yte, answers(plane, 1, 1))
    print(f"v2 forest acc={acc_v2:.3f} after runtime install "
          f"(v1 still serving: acc={acc_v1_still:.3f}); "
          f"captured graphs = {plane.cache_size()} (nothing captured again)")
    assert plane.cache_size() == 1
    assert (answers(plane, 1, 2) == rf_v2.predict(Xteq)).all()

    # distributed deployment + failure recovery
    net = fat_tree(4)
    h = net.hosts()
    dev = DeviceModel(n_stages=10)
    prog = translate(rf_v2, vid=2)
    plan = plan_program(prog, net, h[0], h[-1], default_device=dev,
                        solver="dp")
    print(f"deployed across {plan.breakdown['devices_used']}")
    dead = plan.breakdown["devices_used"][-1]
    plan2 = replan(prog, net, h[0], h[-1], {dead}, default_device=dev,
                   solver="dp")
    assert dead not in plan2.path
    print(f"switch {dead} died -> replanned onto "
          f"{plan2.breakdown['devices_used']} in "
          f"{plan2.solve_time * 1e3:.1f}ms")
    _, dps = build_device_programs(prog, plan2, prof, device=args.device)
    path = DataplaneRuntime(SequentialPathExecutor(
        dps, n_classes=prof.max_classes))
    assert (answers(path, 1, 2) == rf_v2.predict(Xteq)).all()
    print("post-failure answers identical — service uninterrupted.")


if __name__ == "__main__":
    main()
