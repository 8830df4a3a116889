"""Production mesh descriptions.  Functions, not module constants: neither
importing this module nor calling its functions touches a device.

Port of ``src/repro/launch/mesh.py``.  The reference builds a
``jax.sharding.Mesh`` of 16 x 16 TPU chips a pod; the port has no mesh
object of its own to build, so a ``Mesh`` here is what the sharding rules
and the dry run read from one: ``axis_names`` and ``devices``, an array of
the mesh's shape holding each card's global rank (the duck type
``tests/test_sharding.py`` already gives the JAX rules).  The axes and
their sizes stay the reference's, so the port's specs can be held to the
JAX package's leaf for leaf.

On H100s the same mesh is 256 cards: 32 hosts of 8 cards, each host's 8
joined all to all by NVLink.  Ranks are laid out with ``model``
innermost, so a 16-way ``model`` axis spans two 8-card NVLink domains and
its collectives cross the hosts' network between them; ``data`` runs
across 16 such pairs of hosts.  The multi-pod mesh puts a ``pod`` axis of 2
in front (512 cards).  No time, rate or size of this mesh is measured:
the port runs on one card (``repro_torch.distributed.sharding``).

``fake_device_mesh`` stands a mesh up as a torch ``DeviceMesh`` over a
fake process group of its size in this one process, rank 0 being device
(0, 0): DTensors laid out on it run each op as device (0, 0) would, and
their collectives return at once, with no data (the dry run,
``launch/dryrun.py``).  It is the counterpart of the reference's 512
placeholder devices (``--xla_force_host_platform_device_count``).
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np

__all__ = ["Mesh", "make_mesh", "make_production_mesh", "mesh_chip_count",
           "fake_device_mesh", "is_fake_mesh"]


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A mesh of cards: ``devices[i, j, ...]`` is the global rank of the
    card at that position, ``axis_names`` names the axes in order."""

    axis_names: tuple[str, ...]
    devices: np.ndarray

    @property
    def shape(self) -> dict[str, int]:
        """axis name -> size."""
        return dict(zip(self.axis_names, self.devices.shape))


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...]) -> Mesh:
    """A mesh of ``prod(shape)`` cards, ranks in row-major order (the last
    axis innermost)."""
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         "length")
    return Mesh(tuple(axes), np.arange(int(np.prod(shape))).reshape(shape))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16 x 16 cards on ("data", "model"); the multi-pod mesh adds a
    leading pure-DP "pod" axis of 2."""
    if multi_pod:
        return make_mesh((2, 16, 16), ("pod", "data", "model"))
    return make_mesh((16, 16), ("data", "model"))


def mesh_chip_count(mesh) -> int:
    n = 1
    for s in mesh.devices.shape:
        n *= s
    return n


@contextlib.contextmanager
def fake_device_mesh(mesh: Mesh):
    """A ``torch.distributed.device_mesh.DeviceMesh`` of ``mesh``'s shape
    and axis names on the CPU, over a fake process group of
    ``mesh_chip_count(mesh)`` ranks started for the ``with`` block, this
    process being rank 0 (device (0, 0)); the group is destroyed on exit.
    Raises ``RuntimeError`` if a default process group already exists: a
    fake group never stands in for a real one."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a default process group already exists; the "
                           "fake mesh needs this process to itself")
    n = mesh_chip_count(mesh)
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield DeviceMesh("cpu", torch.as_tensor(mesh.devices),
                         mesh_dim_names=tuple(mesh.axis_names))
    finally:
        dist.destroy_process_group()


def is_fake_mesh(device_mesh) -> bool:
    """Whether a torch ``DeviceMesh`` runs over a fake process group
    (``fake_device_mesh``)."""
    import torch.distributed as dist

    return dist.is_initialized() and dist.get_backend(
        device_mesh.get_group(0)) == "fake"
