"""Deployment ``single_switch``: the zoo installed slot by slot on one
switch (``ZooServer`` over its default ``SingleSwitchExecutor``)."""


def build(deployment: dict, profile, programs: dict, device):
    from repro_torch.serving import ZooServer

    mode = None if deployment["mode"] == "fused" else deployment["mode"]
    zoo = ZooServer(profile, mode=mode, device=device)
    for v, prog in programs.items():
        zoo.install(prog, vid=v)
    return zoo
