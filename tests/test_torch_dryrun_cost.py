"""The dry run's counted matmul flops of the train step on one device held
to the JAX package's ``parse_hlo_cost`` on the CPU: internlm2-1.8b,
qwen3-moe, rwkv6-7b and whisper-tiny at ``smoke_config``, n_micro 2,
remat (the shared body and the differences pinned:
``tests/torch_dryrun_one_device.py``).
"""
import pytest

from torch_dryrun_one_device import ARCHS, _explained, _port, _reference
from torch_train_lane import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("arch", ARCHS)
def test_one_device_flops_equal_parse_hlo_cost(arch):
    want = _reference(arch, "train")
    got = _port(arch, "train")
    assert want > 0
    assert got - want == _explained(arch, "train")
