"""The placement of the params over the mesh's "data" and "model" axes
and the gathers where they are used: the part of the reference's train
cell that GSPMD does for it (``repro.launch.steps.build_cell`` lays the
params out by ``spec_for_shape`` and XLA inserts the gathers).

Each parameter leaf is stored as this rank's slice along the dimension
that the rules give "data" (the "embed" dimension under
``DEFAULT_RULES``: FSDP) and along the one they give "model" (heads,
ff, vocab, expert_ff, the SSM's inner and head dimensions); a dimension
that an axis does not divide stays whole.  Where a leaf is used it is
gathered over "data" by :class:`_Gather`, an autograd function whose
forward is an all-gather and whose backward is a reduce-scatter (a sum)
over "data", so the gradients come out sharded like the params.  The
"model" slice of a leaf that a tensor-parallel layer reads
(``parallel.tensor``: attention heads, MLP and expert ff, the
vocabulary of the embedding and the head) stays local; any other leaf
split over "model" (the SSM block's, an encoder's) is gathered over
"model" too and computed whole on every model rank, its backward this
rank's slice of the gradient.  The decoder's layers are gathered one at
a time where the layer runs (``layer``, the hook of
``models.model.backbone``); under ``checkpoint`` backward gathers the
layer again, FSDP's re-gather.  Everything else (the embedding, the
final norm, the head, an encoder) is gathered at the loss's entry.

Every rank draws the whole initialization from the same generator and
keeps its slice (``shard``), so the sharded state is bit for bit a slice
of the single-device state, as ``jax.device_put`` of ``init_params`` is
in the reference.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.parallel.sharding import (LogicalRules, axes_and_shapes,
                                           shardings_for_tree)
from repro_torch.parallel.tensor import TensorParallel
from repro_torch.tree import (tree_flatten_with_paths, tree_leaves,
                              tree_unflatten)

#: The logical axes whose "model" slices the model's tensor-parallel
#: layers compute on (``models.attention``, ``models.modules.swiglu``,
#: ``models.moe``, the vocab-parallel embedding and cross-entropy).
TP_AXES = ("heads", "kv_heads", "ff", "expert_ff", "vocab")
#: The top-level params read by those layers: the decoder's blocks, the
#: embedding and the head (an encoder runs gathered).
TP_ROOTS = ("blocks", "embed", "lm_head")


def _gather(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order, in
    the layout of a whole leaf (contiguous)."""
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((n * xt.shape[0], *xt.shape[1:]))
    dist.all_gather_into_tensor(out, xt, group=group)
    return out.movedim(0, dim).contiguous()


def _scatter(g: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """The sum over ``group`` of every rank's ``g``, this rank's slice
    along ``dim``."""
    gt = g.movedim(dim, 0).contiguous()
    out = gt.new_empty((gt.shape[0] // n, *gt.shape[1:]))
    dist.reduce_scatter_tensor(out, gt, group=group)
    return out.movedim(0, dim).contiguous()


class _Gather(torch.autograd.Function):
    """All-gather over "data" forward, reduce-scatter backward."""

    @staticmethod
    def forward(ctx, x, dim, group, n):
        ctx.dim, ctx.group, ctx.n = dim, group, n
        return _gather(x, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        return _scatter(g, ctx.dim, ctx.group, ctx.n), None, None, None


class _AllReduce(torch.autograd.Function):
    """A sum over ``groups`` whose backward is the same sum: the output,
    equal on every rank, feeds every rank's loss."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        out = x.clone()
        for g in groups:
            dist.all_reduce(out, group=g)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        for grp in ctx.groups:
            dist.all_reduce(g, group=grp)
        return g, None


@dataclasses.dataclass(frozen=True)
class Split:
    """A leaf split over one or more mesh axes, each along a dimension of
    its own: ``parts``, one ``(dim, n, rank, group)`` per axis, the leaf
    split along ``dim`` over the ``n`` ranks of ``group``, this rank
    holding slice ``rank`` (the placement a checkpoint reads)."""
    parts: Tuple[Tuple[int, int, int, Any], ...]

    def slice(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the whole leaf ``t`` (a copy)."""
        for dim, n, rank, _ in self.parts:
            t = t.chunk(n, dim)[rank]
        return t.clone()

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """The whole leaf of this rank's slice ``t`` (every rank calls)."""
        for dim, n, _, group in reversed(self.parts):
            t = _gather(t, dim, group, n)
        return t


class Fsdp:
    """The placement and the gathers of a params tree over ``mesh``'s
    "data" and "model" axes.

    ``dims`` and ``mdims`` are trees like the params: per leaf the
    dimension "data", and the dimension "model", splits, or None where
    the leaf is whole over that axis; ``local``, per leaf, whether its
    "model" slice stays local where it is used (a tensor-parallel
    layer's) rather than gathered.  ``tp`` is the "model" group
    (``parallel.tensor.TensorParallel``; None on a mesh without "model").
    ``mean_axes`` are the axes over which ``mean`` averages a statistic
    of the loss (the MoE aux loss's routing fractions and importances):
    the data-parallel axes the loss is taken over."""

    def __init__(self, mesh, dims, mdims, local, *,
                 mean_axes: Sequence[str] = ("data",)):
        self.mesh = mesh
        self.dims, self.mdims, self.local = dims, mdims, local
        self.group = mesh.group("data")
        self.n = mesh.shape["data"]
        self.rank = mesh.coordinate("data")
        self.tp = (TensorParallel.over(mesh) if "model" in mesh.axis_names
                   else None)
        self.mean_groups = [mesh.group(a) for a in mean_axes
                            if a in mesh.axis_names]
        self.mean_size = math.prod(mesh.shape[a] for a in mean_axes
                                   if a in mesh.axis_names)

    @classmethod
    def for_specs(cls, specs, mesh, rules: LogicalRules, **kw) -> "Fsdp":
        """The placement that ``spec_for_shape`` gives a ParamSpec tree:
        each leaf split along the dimension "data" holds and the one
        "model" holds, if any; a leaf's "model" slice local where its
        axis is in ``TP_AXES`` under ``TP_ROOTS``.

        Raises:
          ValueError: rules that split a leaf over another axis, or one
              dimension over two."""
        axes, shapes = axes_and_shapes(specs)
        placements = shardings_for_tree(axes, mesh, rules, shapes)
        out = {"data": [], "model": [], "local": []}
        for (name, ax), pl in zip(tree_flatten_with_paths(axes),
                                  tree_leaves(placements)):
            split = dict(pl.splits)
            if set(split) - {"data", "model"} or \
                    len(set(split.values())) < len(split):
                raise ValueError(f"{name}: placement {pl.splits}; a param "
                                 "leaf splits over 'data' and 'model' "
                                 "only, one axis a dimension")
            m = split.get("model")
            out["data"].append(split.get("data"))
            out["model"].append(m)
            out["local"].append(m is not None and ax[m] in TP_AXES
                                and name.split("/")[0] in TP_ROOTS)
        return cls(mesh, *(tree_unflatten(specs, out[k]) for k in
                           ("data", "model", "local")), **kw)

    def sharded(self):
        """Per leaf, in ``tree_leaves`` order, whether it is split over
        "data"."""
        return [d is not None for d in _dim_leaves(self.dims)]

    def groups(self):
        """Per leaf, in ``tree_leaves`` order, the process groups of the
        axes it is split over ("data" first): its sums of squares and
        its largest magnitude are taken over them."""
        model = None if self.tp is None else self.tp.group
        return [tuple(g for g, dim in ((self.group, d), (model, m))
                      if dim is not None)
                for d, m in zip(_dim_leaves(self.dims),
                                _dim_leaves(self.mdims))]

    # -- placement ---------------------------------------------------------

    def _split(self, d: Optional[int], m: Optional[int]) -> Optional[Split]:
        parts = []
        if d is not None:
            parts.append((d, self.n, self.rank, self.group))
        if m is not None:
            parts.append((m, self.tp.n, self.tp.rank, self.tp.group))
        return Split(tuple(parts)) if parts else None

    def splits(self):
        """The tree of :class:`Split`s (None for a whole leaf) of a tree
        like the params."""
        return tree_unflatten(self.dims, [
            self._split(d, m) for d, m in zip(_dim_leaves(self.dims),
                                              _dim_leaves(self.mdims))])

    def shard(self, tree):
        """This rank's slice of every leaf of a whole tree like the
        params (a copy), a whole leaf copied as it is."""
        return _map2(lambda t, s: t.clone() if s is None else s.slice(t),
                     tree, self.splits())

    def reduce_scatter(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The sum over "data" of every rank's whole ``t``, this rank's
        slice along ``dim`` (no autograd)."""
        return _scatter(t, dim, self.group, self.n)

    # -- gathers of the loss -----------------------------------------------

    def gather(self, t: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
        """``t`` gathered over "data" along ``dim`` (autograd)."""
        return t if dim is None else _Gather.apply(t, dim, self.group, self.n)

    def _use(self, t, dim, mdim, local, lower: int = 0):
        """A leaf as a layer reads it: gathered over "data", and over
        "model" unless its slice stays ``local``; ``lower`` is subtracted
        from the dimensions (a stacked leaf's layer view)."""
        t = self.gather(t, None if dim is None else dim - lower)
        if mdim is None or local:
            return t
        return self.tp.gather(t, mdim - lower)

    def outside_blocks(self, params):
        """``params`` with every leaf outside the decoder's ``blocks``
        gathered (the embedding, the norms, the head, an encoder; the
        embedding's and the head's vocabulary slices stay local)."""
        return {k: (v if k == "blocks" else
                    _map4(self._use, v, self.dims[k], self.mdims[k],
                          self.local[k]))
                for k, v in params.items()}

    def layer(self, i: int, p):
        """The leaves of one decoder layer at period position ``i``
        (views of the stacked ``(G, ...)`` shards, any subset of
        ``blocks/pos{i}``'s keys) gathered: a stacked leaf's dimensions
        are one lower in a layer's view."""
        key = f"pos{i}"
        return _map4(lambda t, d, m, loc: self._use(t, d, m, loc, lower=1),
                     p, self.dims["blocks"][key], self.mdims["blocks"][key],
                     self.local["blocks"][key])

    def mean(self, t: torch.Tensor) -> torch.Tensor:
        """The mean over ``mean_axes`` of ``t`` (differentiable)."""
        return _AllReduce.apply(t, self.mean_groups) / self.mean_size


def _map2(fn, tree, dims):
    """``fn(leaf, dim)`` over ``tree``'s leaves, ``dims`` a tree holding
    at least ``tree``'s keys."""
    if isinstance(tree, dict):
        return {k: _map2(fn, v, dims[k]) for k, v in tree.items()}
    return fn(tree, dims)


def _map4(fn, tree, a, b, c):
    """``fn(leaf, a, b, c)`` over ``tree``'s leaves, ``a``, ``b``, ``c``
    trees holding at least ``tree``'s keys."""
    if isinstance(tree, dict):
        return {k: _map4(fn, v, a[k], b[k], c[k]) for k, v in tree.items()}
    return fn(tree, a, b, c)


def _dim_leaves(dims):
    """The leaves of a dims tree (ints or None) in ``tree_leaves``
    order."""
    if isinstance(dims, dict):
        return [d for k in sorted(dims) for d in _dim_leaves(dims[k])]
    return [dims]


def local_rows(mesh, batch_axes, global_batch: int):
    """``(lo, hi)``: this rank's rows of a global batch split over
    ``batch_axes`` (outermost first), as the reference's batch spec lays
    them out: every rank along another axis ("model") takes the same
    rows."""
    dp, idx = 1, 0
    for a in batch_axes:
        idx = idx * mesh.shape[a] + mesh.coordinate(a)
        dp *= mesh.shape[a]
    rows = global_batch // dp
    return idx * rows, (idx + 1) * rows

