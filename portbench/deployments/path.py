"""Deployment ``path``: the zoo planned over a topology, first host to
last, each hosting switch's partial program built by the program's
installer, served hop by hop (``SequentialPathExecutor``)."""


def build(deployment: dict, profile, programs: dict, device):
    from repro_torch.core.distributed_plane import build_zoo_device_programs
    from repro_torch.core.planner import DeviceModel, plan_zoo
    from repro_torch.core.topology import fat_tree
    from repro_torch.runtime import SequentialPathExecutor
    from repro_torch.serving import ZooServer

    if deployment["topology"] != "fat_tree":
        raise ValueError(f"unknown topology {deployment['topology']!r}")
    mode = None if deployment["mode"] == "fused" else deployment["mode"]
    net = fat_tree(deployment["k"])
    hosts = net.hosts()
    vids = sorted(programs)
    plans = plan_zoo([programs[v] for v in vids], net, hosts[0], hosts[-1],
                     default_device=DeviceModel(
                         n_stages=deployment["stages_per_switch"]))
    _, dps = build_zoo_device_programs([programs[v] for v in vids], plans,
                                       profile, device)
    if len(dps) != deployment["hops"]:
        raise RuntimeError(f"the plan has {len(dps)} hosting switches, the "
                           f"configuration states {deployment['hops']}")
    ex = SequentialPathExecutor(dps, n_classes=profile.max_classes, mode=mode)
    return ZooServer(profile, executor=ex)
