"""The port's roofline against the JAX package's.

``roofline_terms`` and ``model_flops`` of ``repro_torch.analysis`` must give
the JAX package's numbers on the same inputs with the same ``HW`` passed
explicitly (the fields keep the reference's names), and ``HW()`` must be
the H100 SXM5's data-sheet peaks.
"""
import dataclasses

import pytest

from repro import configs as jconfigs
from repro.analysis import roofline as jroof
from repro_torch import configs as tconfigs
from repro_torch.analysis import HW, model_flops, roofline_terms

TERMS = [
    dict(hlo_flops=197e12, hlo_bytes=819e9,
         collective_wire_bytes=256 * 50e9 * 2, chips=256),
    dict(hlo_flops=1e15, hlo_bytes=1e9, collective_wire_bytes=0.0, chips=1),
    dict(hlo_flops=3e9, hlo_bytes=8.2e10, collective_wire_bytes=4e9,
         chips=4),
]


@pytest.mark.parametrize("hw", ["tpu", "h100"])
@pytest.mark.parametrize("case", range(len(TERMS)))
def test_roofline_terms_equal_jax(case, hw):
    fields = (dataclasses.asdict(jroof.HW()) if hw == "tpu"
              else dataclasses.asdict(HW()))
    got = roofline_terms(**TERMS[case], hw=HW(**fields))
    want = jroof.roofline_terms(**TERMS[case], hw=jroof.HW(**fields))
    assert got == want


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_model_flops_equal_jax(arch, kind):
    for name, sp in jconfigs.SHAPES.items():
        want = jroof.model_flops(jconfigs.get_config(arch), sp.seq_len,
                                 sp.global_batch, kind)
        got = model_flops(tconfigs.get_config(arch), sp.seq_len,
                          sp.global_batch, kind)
        assert got == want, name


def test_hw_defaults_are_the_h100s():
    hw = HW()
    assert hw.peak_flops == 989.5e12      # bf16 dense tensor cores
    assert hw.hbm_gbps == 3.35e12         # HBM3
    assert hw.ici_gbps == 450e9           # NVLink 4, one way
    assert hw.hbm_bytes == 80e9
    assert [f.name for f in dataclasses.fields(HW)] == \
        [f.name for f in dataclasses.fields(jroof.HW)]


def test_default_hw_is_used_and_memory_dominates_decode():
    """A decode step's bytes dominate: internlm2-1.8b's bf16 weights once
    at B 16 take ~1.13 ms of HBM time against ~0.06 ms of compute."""
    cfg = tconfigs.get_config("internlm2-1.8b")
    r = roofline_terms(hlo_flops=model_flops(cfg, 1, 16, "decode"),
                       hlo_bytes=2 * cfg.param_count(),
                       collective_wire_bytes=0.0, chips=1)
    assert r["dominant"] == "memory"
    assert r["step_s_lower_bound"] == pytest.approx(
        2 * cfg.param_count() / 3.35e12)
    assert r["compute_s"] == pytest.approx(
        2 * cfg.param_count() * 16 / 989.5e12)
