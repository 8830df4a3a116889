"""Network latency / overhead simulator (paper §7.4, §7.6; Figs. 6, 7, 10).

Port of ``src/repro/core/netsim.py``: numpy only, the same constants, the
same numpy draws (``simulate_serving`` gives the reference's array for the
same seed and windows).  The port keeps its own copy because the
reference's reaches JAX through ``repro.core.packets``.

The paper measures request serving time on a 2x Tofino2 testbed.  We model the
same decomposition (J_L = execution + propagation + transmission, §5.2) with
documented constants, and measure the *server-side inference time* for real —
wall-clocking our own numpy models per single request, which is what the
paper's server baseline does with sklearn.

Constants (documented; testbed-calibrated to the paper's reported ranges):
  l_e   = 1 µs    per-switch pipeline execution (Tofino-class)
  l_p   = 2 µs    per-hop propagation+serialization overhead in-DC
  rate  = 10 Gb/s link rate (paper's tcpreplay setup)
  host_stack = 25 µs per host network-stack traversal [1, 15, 61]
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.core import packets
from repro_torch.core.planner import DeploymentPlan, LatencyModel

__all__ = [
    "ServerModel",
    "acorn_serving_time",
    "server_serving_time",
    "measure_inference_time",
    "simulate_serving",
    "serving_availability",
    "forwarding_overhead",
]


@dataclasses.dataclass(frozen=True)
class ServerModel:
    """Server-based baseline: client -> ToR -> ... -> server NIC -> stack -> model."""

    hops: int = 6                 # paper §7.4: two racks through two ToRs
    host_stack_s: float = 25e-6   # per host-stack traversal
    latency: LatencyModel = LatencyModel()


def acorn_serving_time(plan: DeploymentPlan) -> float:
    """J_L of the chosen plan (s) — in-network serving time per request."""
    return float(plan.breakdown["J_L"])


def server_serving_time(
    model_predict_s: float,
    request_bytes: int,
    *,
    server: ServerModel = ServerModel(),
) -> float:
    """Round-trip through the network to a server plus inference time."""
    lat = server.latency
    per_hop = lat.l_p + lat.t_bytes(request_bytes)
    travel = server.hops * per_hop + server.hops * (lat.l_p + lat.t_bytes(packets.response_bytes()))
    return travel + 2 * server.host_stack_s + model_predict_s


def measure_inference_time(model, Xq: np.ndarray, *, n_requests: int = 200) -> float:
    """Wall-clock per-request (batch of 1) prediction latency of a CPU model —
    the real quantity behind the paper's Fig. 7 'prediction latency'."""
    n = min(n_requests, Xq.shape[0])
    model.predict(Xq[:1])  # warm
    t0 = time.perf_counter()
    for i in range(n):
        model.predict(Xq[i : i + 1])
    return (time.perf_counter() - t0) / n


def simulate_serving(
    base_s: float,
    *,
    n: int = 1000,
    jitter_frac: float = 0.04,
    seed: int = 0,
    arrival_rate_rps: float | None = None,
    downtime_windows: tuple[tuple[float, float], ...] = (),
    return_arrivals: bool = False,
) -> np.ndarray:
    """Per-request samples around a mean (switch pipelines are near-
    deterministic: the paper reports 'consistent intervals, very few
    outliers' — we model small gaussian jitter + rare 10x outliers).

    A deployment is not static (planner ``replan`` under device failure):
    ``downtime_windows`` are ``(t0, t1)`` control-plane outages — detect ->
    replan -> drain -> reinstall — on the arrival clock.  A request arriving
    inside a window is held until the window closes (the drain/reinstall
    barrier) and pays the remainder on top of its serving time.  Arrivals
    are Poisson at ``arrival_rate_rps`` (defaults to uniform spacing over
    ``n * base_s * 100`` when windows are given but no rate is).  With
    ``return_arrivals`` the arrival times come back alongside the samples.
    """
    rng = np.random.default_rng(seed)
    s = base_s * (1.0 + jitter_frac * rng.standard_normal(n))
    outliers = rng.random(n) < 0.002
    s[outliers] *= 10.0
    s = np.maximum(s, base_s * 0.5)
    if not downtime_windows and arrival_rate_rps is None:
        return s                     # static plan: exact pre-fault behavior
    if arrival_rate_rps is not None:
        t_arr = np.cumsum(rng.exponential(1.0 / arrival_rate_rps, n))
    else:
        t_arr = np.linspace(0.0, n * base_s * 100.0, n)
    for t0, t1 in downtime_windows:
        held = (t_arr >= t0) & (t_arr < t1)
        s = np.where(held, s + (t1 - t_arr), s)
    if return_arrivals:
        return s, t_arr
    return s


def serving_availability(latency_s: np.ndarray, slo_s: float) -> float:
    """Fraction of requests served within the SLO — the availability metric
    ``benchmarks/fleet_serve.py`` records per fault schedule."""
    lat = np.asarray(latency_s, float)
    if lat.size == 0:
        return 1.0
    return float((lat <= slo_s).mean())


def forwarding_overhead(
    payload_bytes: int = 8000,          # jumbo frames (paper Fig. 10 setup)
    acorn_header_bytes: int = 70,
    *,
    rate_bps: float = 10e9,
    base_latency_s: float = 1.0e-6,
    stages_used: int = 20,
    total_stages: int = 20,
) -> dict:
    """Static goodput/latency overhead of running ACORN on the forwarding
    path (paper Fig. 10): goodput shrinks by the header share, latency grows
    with the fraction of pipeline stages doing ML work."""
    goodput_frac = payload_bytes / (payload_bytes + acorn_header_bytes)
    latency_overhead = 0.03 * (stages_used / total_stages)  # <=3% (paper: 2.7-3.3%)
    return {
        "goodput_gbps": rate_bps * goodput_frac / 1e9,
        "goodput_frac": goodput_frac,
        "latency_s": base_latency_s * (1 + latency_overhead),
        "latency_overhead_frac": latency_overhead,
    }
