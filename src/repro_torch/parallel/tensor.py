"""Tensor parallelism over a mesh's "model" axis: the autograd functions
of the split layers (Megatron's f and g) and the vocab-parallel
embedding and cross-entropy pieces.  The reference gets the same
partition from GSPMD (``repro.launch.steps.build_cell`` lays the params
out by ``DEFAULT_RULES``) and, for the MoE block, from ``shard_map``
with a ``psum`` over "model".

A split region takes an input that every model rank holds whole (the
residual stream) through ``copy`` (identity forward, a sum over "model"
backward, so the input's gradient is whole again), computes on this
rank's slices of the weights (heads, ff columns, vocab rows), and
leaves through ``reduce`` (a sum over "model" forward, identity
backward).  A leaf that is whole on every model rank but read inside a
region (the q- and k-norms, the router, the shared expert's gate, the
K/V weights where "model" does not divide the KV heads) goes through
``copy`` where it is read, so that its gradient is summed over the
ranks' partial ones while a read of it outside the region (the MoE aux
loss's router) counts once.  ``gather`` is the other way round: a leaf
split over "model" but computed whole on every rank (the SSM block) is
gathered where it is used, and its backward is this rank's slice of the
gradient, which every rank computes whole and alike (a sum would
multiply it by the axis size).

On a model axis of one every collective is a copy: the path is the same
at every size.
"""
from __future__ import annotations

from collections import Counter
from typing import Optional

import torch
import torch.distributed as dist

#: Forward calls of each function, by name (``copy``, ``reduce``,
#: ``gather``, ``lse``): host counts that show a step went through the
#: split layers.  ``reset_calls`` sets them to 0.
calls: Counter = Counter()


def reset_calls() -> None:
    calls.clear()


def _all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM):
    out = t.clone()
    dist.all_reduce(out, op=op, group=group)
    return out


class _Copy(torch.autograd.Function):
    """Identity forward, a sum over the group backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        calls["copy"] += 1
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _Reduce(torch.autograd.Function):
    """A sum over the group forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        calls["reduce"] += 1
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    """All-gather along ``dim`` forward; backward this rank's slice of
    the gradient (every rank computes the same whole gradient)."""

    @staticmethod
    def forward(ctx, x, dim, group, n, rank):
        ctx.dim, ctx.n, ctx.rank = dim, n, rank
        calls["gather"] += 1
        xt = x.movedim(dim, 0).contiguous()
        out = xt.new_empty((n * xt.shape[0], *xt.shape[1:]))
        dist.all_gather_into_tensor(out, xt, group=group)
        return out.movedim(0, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return (g.chunk(ctx.n, ctx.dim)[ctx.rank].contiguous(), None, None,
                None, None)


class _LogSumExp(torch.autograd.Function):
    """``logsumexp`` over the last dimension of logits split over the
    group by columns: the max over the ranks (no gradient flows through
    it), the sum of ``exp(l - max)`` over the ranks, ``log(sum) + max``;
    the ops of ``torch.logsumexp``, whose backward, ``g·exp(l - lse)``,
    this one's is."""

    @staticmethod
    def forward(ctx, logits, group):
        calls["lse"] += 1
        m = _all_reduce(torch.amax(logits, dim=-1, keepdim=True), group,
                        dist.ReduceOp.MAX)
        s = _all_reduce(torch.sum(torch.exp(logits - m), dim=-1), group)
        lse = s.log_().add_(m.squeeze(-1))
        ctx.save_for_backward(logits, lse)
        return lse

    @staticmethod
    def backward(ctx, g):
        logits, lse = ctx.saved_tensors
        return g[..., None] * (logits - lse[..., None]).exp(), None


class TensorParallel:
    """The "model" group of this rank: ``n`` ranks, this one ``rank``."""

    def __init__(self, group, n: int, rank: int):
        self.group, self.n, self.rank = group, n, rank

    @classmethod
    def over(cls, mesh, axis: str = "model") -> "TensorParallel":
        """The group of ``mesh``'s ``axis`` (a ``launch.mesh.Mesh``)."""
        return cls(mesh.group(axis), mesh.shape[axis], mesh.coordinate(axis))

    def split(self, local: int, whole: int) -> Optional["TensorParallel"]:
        """This group where a dimension of ``whole`` is held as slices of
        ``local`` (split over the ranks), None where it is held whole."""
        return self if local * self.n == whole else None

    def offset(self, local: int) -> int:
        """The first index of this rank's slice of ``local`` entries."""
        return self.rank * local

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        return _Copy.apply(x, self.group)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return _Reduce.apply(x, self.group)

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return _Gather.apply(x, dim, self.group, self.n, self.rank)

    def logsumexp(self, logits: torch.Tensor) -> torch.Tensor:
        return _LogSumExp.apply(logits, self.group)


def embed_lookup(table: torch.Tensor, ids: torch.Tensor,
                 tp: TensorParallel) -> torch.Tensor:
    """Rows ``ids`` of an embedding ``table`` split over ``tp`` by rows
    (this rank's ``table``, its vocabulary slice): a row outside the
    slice is zero on this rank, and the ranks' rows are summed."""
    n = table.shape[0]
    local = ids - tp.offset(n)
    mine = (local >= 0) & (local < n)
    rows = table[local.clamp(0, n - 1)]
    return tp.reduce(torch.where(mine[..., None], rows, 0))


def target_logit(logits: torch.Tensor, target: torch.Tensor,
                 tp: TensorParallel) -> torch.Tensor:
    """``logits[..., target]`` of logits split over ``tp`` by columns:
    the rank that holds the target's column gives it, the others 0,
    summed over the ranks."""
    n = logits.shape[-1]
    local = target - tp.offset(n)
    mine = (local >= 0) & (local < n)
    got = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None])[..., 0]
    return tp.reduce(torch.where(mine, got, 0))
