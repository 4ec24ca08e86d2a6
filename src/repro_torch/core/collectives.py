"""Topology-aware hierarchical collectives (counterpart of
``repro.core.collectives``), over a mesh's process groups.

``hierarchical_psum`` is the 3-phase all-reduce of gradient
synchronization across the 2-pod production mesh:

  1. reduce-scatter over the fat in-pod axis ("data"),
  2. all-reduce of the 1/N shard over the thin cross-pod axis ("pod"),
  3. all-gather back over "data".

Cross-pod traffic shrinks by the in-pod data-parallel size against a
flat all-reduce spanning both pods: the traffic stays on the rails.

``compressed_cross_pod_psum_local`` adds int8 compression with error
feedback on the cross-pod hop only: the scarce link carries a quarter
of the bytes while the in-pod reduction stays full precision.

The ``*_local`` functions run on every rank with its own ``x`` (the
reference runs them inside ``shard_map``); ``mesh`` is a
``launch.mesh.Mesh``.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist


def _flatten_pad(x: torch.Tensor, n: int):
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat, pad


def _reduce_scatter(flat: torch.Tensor, group) -> torch.Tensor:
    """This rank's row of ``flat.reshape(n, -1)`` summed over ``group``."""
    n = dist.get_world_size(group)
    out = flat.new_empty(flat.shape[0] // n)
    dist.reduce_scatter_tensor(out, flat.contiguous(), group=group)
    return out


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """``(n, *x.shape)``: every rank's ``x`` over ``group``, by rank."""
    n = dist.get_world_size(group)
    out = x.new_empty(n * x.numel())
    dist.all_gather_into_tensor(out, x.reshape(-1).contiguous(), group=group)
    return out.view(n, *x.shape)


def hierarchical_psum_local(x: torch.Tensor, mesh, *, in_axis: str = "data",
                            cross_axis: str = "pod") -> torch.Tensor:
    """The sum of ``x`` over ``(in_axis, cross_axis)`` by the
    rail-optimized schedule: the cross-axis hop moves only
    1/|in_axis| of the bytes."""
    n = mesh.shape[in_axis]
    flat, pad = _flatten_pad(x, n)
    mine = _reduce_scatter(flat, mesh.group(in_axis))        # 1: in-pod
    dist.all_reduce(mine, group=mesh.group(cross_axis))      # 2: cross-pod
    flat = all_gather(mine, mesh.group(in_axis)).reshape(-1)  # 3
    if pad:
        flat = flat[:-pad]
    return flat.reshape(x.shape)


def int8_compress(x: torch.Tensor, *, groups=()
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization. Returns ``(q, scale)``,
    ``scale`` a 0-d tensor; ``torch.round`` rounds half to even, as
    ``jnp.round`` does.  Where ``x`` is this rank's slice of a tensor
    split over the process ``groups`` (a leaf split over "data" and
    "model"), the scale is the whole tensor's (the largest magnitude
    taken over every group)."""
    amax = torch.max(torch.abs(x))
    for group in groups:
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    amax = amax + 1e-12
    scale = amax / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def compressed_cross_pod_psum_local(x: torch.Tensor,
                                    error_shard: torch.Tensor, mesh, *,
                                    in_axis: str = "data",
                                    cross_axis: str = "pod"):
    """Hierarchical all-reduce with int8 error-feedback compression on
    the cross-pod hop only (the in-pod phases stay full precision), one
    scale per shard.

    ``error_shard``: (ceil(x.numel() / n),) f32, this rank's quantization
    residual from the previous step.  Returns ``(result,
    new_error_shard)``.  The cross-pod link carries int8 payloads and one
    f32 scale per pod."""
    n = mesh.shape[in_axis]
    flat, pad = _flatten_pad(x, n)
    mine = _reduce_scatter(flat, mesh.group(in_axis)).float() + error_shard
    q, scale = int8_compress(mine)
    new_error = mine - q.float() * scale
    qs = all_gather(q, mesh.group(cross_axis))                # (P, M) int8
    scales = all_gather(scale, mesh.group(cross_axis))        # (P,)
    mine_red = torch.sum(qs.float() * scales[:, None], dim=0)
    flat_out = all_gather(mine_red.to(x.dtype),
                           mesh.group(in_axis)).reshape(-1)
    if pad:
        flat_out = flat_out[:-pad]
    return flat_out.reshape(x.shape), new_error


def hierarchical_psum(x: torch.Tensor, mesh, *, in_axis: str = "data",
                      cross_axis: str = "pod") -> torch.Tensor:
    """The sum of every rank's ``x`` over the data-parallel axes: the
    hierarchical schedule, or on a single-pod mesh (no ``cross_axis``) a
    plain all-reduce over ``in_axis``."""
    if cross_axis not in mesh.axis_names:
        out = x.clone()
        dist.all_reduce(out, group=mesh.group(in_axis))
        return out
    return hierarchical_psum_local(x, mesh, in_axis=in_axis,
                                   cross_axis=cross_axis)
