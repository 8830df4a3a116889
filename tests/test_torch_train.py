"""The port's training stack on the dense archs (internlm2-1.8b,
internlm2-20b, starcoder2-15b, granite-20b, chameleon-34b), held to the JAX
package on the CPU at the smoke configs (``torch_train_lane.py`` says what
is held to what, and at which tolerance)."""
import pytest

import torch_train_lane as lane
from torch_train_lane import one_torch_thread  # noqa: F401 (autouse)

ARCHS = ["internlm2-1.8b", "internlm2-20b", "starcoder2-15b", "granite-20b",
         "chameleon-34b"]
# one arch a family for the whole step against JAX's and for bf16
FAMILY = ["internlm2-1.8b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    lane.check_loss_and_grads_match_jax(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_on_equals_off(arch):
    lane.check_remat_on_equals_off(arch)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_adamw_on_identical_grads(arch, state_dtype):
    lane.check_adamw_on_identical_grads(arch, state_dtype)


@pytest.mark.parametrize("arch", FAMILY)
def test_train_step_matches_jax(arch):
    lane.check_train_step_matches_jax(arch)


@pytest.mark.parametrize("arch", FAMILY)
def test_bf16_step_matches_jax(arch):
    lane.check_bf16_step_matches_jax(arch)


@pytest.mark.parametrize("arch", FAMILY)
def test_grad_accum_equals_single_batch(arch):
    lane.check_grad_accum_equals_single_batch(arch)


@pytest.mark.parametrize("arch", FAMILY)
def test_loss_decreases(arch):
    lane.check_loss_decreases(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_tree_equals_init_params(arch):
    lane.check_tree_equals_init_params(arch)
