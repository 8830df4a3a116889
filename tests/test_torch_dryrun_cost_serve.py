"""The dry run's counted matmul flops of the prefill and decode steps on
one device held to the JAX package's ``parse_hlo_cost`` on the CPU:
internlm2-1.8b, qwen3-moe, rwkv6-7b and whisper-tiny at ``smoke_config``
(the shared body and the differences pinned:
``tests/torch_dryrun_one_device.py``).
"""
import pytest

from torch_dryrun_one_device import ARCHS, _explained, _port, _reference
from torch_train_lane import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_one_device_flops_equal_parse_hlo_cost(arch, kind):
    want = _reference(arch, kind)
    got = _port(arch, kind)
    assert want > 0
    assert got - want == _explained(arch, kind)


def test_the_rwkv_and_encdec_decode_differences_are_a_layer_each():
    """The pinned decode differences are not zero: one layer of each
    family's decode is counted by the port and not by the reference."""
    for arch in ("rwkv6-7b", "whisper-tiny"):
        assert _explained(arch, "decode") > 0
