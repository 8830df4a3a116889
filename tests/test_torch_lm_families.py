"""The moe (grok-1, qwen3-moe) and encdec (whisper-tiny) families held to
the JAX package on the CPU at the smoke configs
(``torch_lm_families_lane.py`` says what is held to what and at
which tolerance)."""
import pytest

import torch_lm_families_lane as lane

ARCHS = ["grok-1-314b", "qwen3-moe-235b-a22b", "whisper-tiny"]


@pytest.mark.parametrize("dtype", lane.DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch, dtype):
    lane.check_forward_matches_jax(arch, dtype)


@pytest.mark.parametrize("dtype", lane.DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_jax(arch, dtype):
    lane.check_decode_steps_match_jax(arch, dtype)


@pytest.mark.parametrize("dtype", lane.DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_port_decode_matches_port_forward(arch, dtype):
    lane.check_port_decode_matches_port_forward(arch, dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_cover_the_jax_tree(arch):
    lane.check_params_cover_the_jax_tree(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_follows_the_references_distributions(arch):
    lane.check_init_follows_the_references_distributions(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_serves_and_swaps_in_place(arch):
    lane.check_launcher_serves_and_swaps_in_place(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_name_the_family(arch):
    lane.check_config_fields_name_the_family(arch)


def test_new_model_refuses_a_config_of_another_family():
    lane.check_new_model_refuses_a_config_of_another_family()
