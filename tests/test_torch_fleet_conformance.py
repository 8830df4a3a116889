"""The fault-schedule lane of ``tests/test_conformance.py`` on the port.

The 8 seeded schedules of ``test_conformance_fleet_fault_schedules`` (a
random zoo over ``fat_tree(4)`` between two pods, small switches that
spread it over several hops, 1-2 interior kills landing while the "during"
phase is in flight), drawn by the reference's helpers, carried into the
port with ``port_packed`` / ``port_batch`` and served live through the
port's ``FleetRuntime`` in the fused and ``layerwise`` modes (the kernel
wrappers' plain versions on the CPU; the graph cache runs eagerly on its
static buffers here).  Every phase's rslt, codes and svm_acc must equal
the JAX ``SwitchEngine(mode="ref")`` exactly; the control counters must
satisfy the reference lane's assertions; the wire path and the hosting
devices must equal the JAX ``FleetRuntime``'s before and after the heal.
The port's own draws (``repro_torch.data.conformance``, what
``chip_smoke.py`` serves on the card) are held to the reference's.
"""
import asyncio

import numpy as np
import pytest

import test_conformance as conf
from repro.core.plane import SwitchEngine as JaxEngine
from repro.core.planner import DeviceModel as JaxDeviceModel
from repro.core.topology import fat_tree as jax_fat_tree
from repro.serving import FleetRuntime as JaxFleet
from repro_torch.core.plane import SwitchEngine
from repro_torch.data import conformance as draws
from repro_torch.serving import FleetRuntime
from test_torch_plane import (
    assert_batches_equal,
    assert_images_equal,
    port_batch,
    port_packed,
    port_profile,
)

CASES = range(conf.N_FAULT_CASES)
MODES = ("cuda", "layerwise-cuda")


def _jax_case(case, engine):
    """The reference lane's draw of ``case``, in its rng order, and the
    JAX fleet's deployment before and after the kills."""
    jprof = conf._profile(conf.FLEET_V)
    seed = conf._fleet_seed(case)
    rng = np.random.default_rng(seed)
    progs, packed = conf._draw_zoo(rng, conf.FLEET_V, seed, jprof)
    net = jax_fat_tree(4)
    pods = rng.choice(4, size=2, replace=False)
    src, dst = f"h{pods[0]}_0_0", f"h{pods[1]}_0_0"
    dev = JaxDeviceModel(n_stages=int(rng.choice([4, 6, 20])))
    try:
        fleet = JaxFleet(net, jprof, progs, src=src, dst=dst,
                         default_device=dev, engine=engine)
    except RuntimeError:
        dev = JaxDeviceModel()
        fleet = JaxFleet(net, jprof, progs, src=src, dst=dst,
                         default_device=dev, engine=engine)
    kills = conf._draw_fault_schedule(rng, progs, net, src, dst, dev, fleet)
    phases = [conf._draw_traffic(rng, progs, conf.FLEET_V, jprof)
              for _ in range(3)]
    before = (list(fleet.path), list(fleet.executor.devices))
    for d in kills:
        fleet.kill(d)
    plans, devices, _ = fleet.replan_sync()
    after = (list(plans[0].path), list(devices))
    return dict(packed=packed, src=src, dst=dst, n_stages=dev.n_stages,
                kills=kills, phases=phases, before=before, after=after)


@pytest.fixture(scope="module")
def lane():
    """Every schedule, drawn once by each package, with the JAX oracle's
    answers."""
    jprof = conf._profile(conf.FLEET_V)
    oracle = JaxEngine(jprof, mode="ref")
    template = JaxEngine(jprof)
    port_oracle = SwitchEngine(port_profile(jprof), mode="ref", device="cpu")
    out = []
    for case in CASES:
        j = _jax_case(case, template)
        j["want"] = [oracle.classify(j["packed"], pb) for pb in j["phases"]]
        out.append((j, draws.draw_fleet_case(case, port_oracle)))
    return jprof, out


@pytest.mark.parametrize("case", CASES)
def test_port_draws_equal_the_reference_lane(lane, case):
    """The port's copy of the lane's draws: the same zoo tables, endpoints,
    switch size, path, kills and traffic."""
    jprof, cases = lane
    j, t = cases[case]
    want = port_packed(j["packed"], jprof)
    assert_images_equal(t.packed.image, want.image)
    assert (t.src, t.dst) == (j["src"], j["dst"])
    assert t.device_model.n_stages == j["n_stages"]
    assert t.path == j["before"][0]
    assert t.kills == j["kills"]
    for got, pb in zip(t.phases, j["phases"]):
        assert_batches_equal(got, pb, fields=conf.FIELDS + ("mid", "vid",
                                                            "ptype",
                                                            "features"))


async def _serve(fleet, phases, kills):
    """The reference lane's ``_run_fleet_phases``: the kills land while
    phase "during" is in flight."""
    outs = []
    async with fleet.serving(probe_interval_s=0.005):
        outs.append(await fleet.submit_batch(phases[0]))
        during = asyncio.create_task(fleet.submit_batch(phases[1]))
        await asyncio.sleep(0)
        for d in kills:
            fleet.kill(d)
        outs.append(await during)
        outs.append(await fleet.submit_batch(phases[2]))
        stats = fleet.latency_stats()
    return outs, stats


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", CASES)
def test_fleet_fault_schedule_equals_jax_ref(lane, case, mode):
    jprof, cases = lane
    j, t = cases[case]
    fleet = FleetRuntime(t.network, port_profile(jprof), t.programs,
                         src=t.src, dst=t.dst, default_device=t.device_model,
                         mode=mode, device="cpu")
    assert (fleet.path, fleet.executor.devices) == j["before"]
    phases = [port_batch(pb) for pb in j["phases"]]
    outs, stats = asyncio.run(_serve(fleet, phases, j["kills"]), debug=True)
    for name, out, want in zip(("before", "during", "after"), outs,
                               j["want"]):
        for f in conf.FIELDS:
            np.testing.assert_array_equal(
                np.asarray(getattr(out, f)), np.asarray(getattr(want, f)),
                err_msg=f"fault={case} mode={mode} phase={name} field={f}")
    ctl = stats["control"]
    assert ctl["failures_detected"] >= 1, ctl
    assert ctl["replans"] >= 1 and ctl["reinstalls"] >= 1, ctl
    assert ctl["drains"] >= 1 and ctl["heal_failures"] == 0, ctl
    assert not (set(j["kills"]) & set(fleet.path)), (j["kills"], fleet.path)
    assert (fleet.path, fleet.executor.devices) == j["after"]
