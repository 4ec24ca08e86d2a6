"""Production mesh factory (counterpart of ``repro.launch.mesh``): the
SAKURAONE 2-pod layout over ``torch.distributed``.

Functions, not module-level constants: importing this module touches no
process group.  Each builds its mesh with
``torch.distributed.device_mesh.init_device_mesh`` over the default
process group (which the caller, ``runtime.launcher.bootstrap``, has
opened) and wraps it in :class:`Mesh`, which reads like the reference's
``jax.sharding.Mesh``: ``axis_names``, ``shape`` (axis name -> size),
``size``; and adds what the port's collectives need, each axis's
process group and this rank's coordinate along it.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


class Mesh:
    """A named mesh of ranks, one device each."""

    def __init__(self, device_mesh: DeviceMesh):
        self.device_mesh = device_mesh
        self.axis_names: Tuple[str, ...] = tuple(device_mesh.mesh_dim_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              device_mesh.mesh.shape))
        self.size = int(device_mesh.mesh.numel())
        self.device_type = device_mesh.device_type

    def group(self, axis: str) -> dist.ProcessGroup:
        """The process group of this rank's line along ``axis``, its
        ranks ordered by their coordinate on it."""
        return self.device_mesh.get_group(axis)

    def coordinate(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        return self.device_mesh.get_local_rank(axis)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, device_type={self.device_type!r})"


def _device_type() -> str:
    """The device type of the default process group's backend."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device_type: Optional[str] = None) -> Mesh:
    """A mesh of ``shape`` named ``axes`` over the default process group,
    whose world size must equal the product of ``shape``."""
    return Mesh(init_device_mesh(device_type or _device_type(), tuple(shape),
                                 mesh_dim_names=tuple(axes)))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16×16 single-pod (256 ranks) or 2×16×16 multi-pod (512 ranks).

    The axis order follows the paper's bandwidth hierarchy: "pod" is the
    thin cross-pod layer, "data"/"model" the fat in-pod layer, "model"
    innermost on the fastest links."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_host_mesh() -> Mesh:
    """The world as a ``(world, 1)`` data × model mesh: one GPU, or one
    CPU process, per rank (the reference counts this host's devices)."""
    return make_mesh((dist.get_world_size(), 1), ("data", "model"))
