"""A decode cache whose sequence is split over ranks: the placement
arithmetic and the merge of the ranks' partial attention states.

The reference's decode cell lays the cache ``(G, B, T, KVH, hd)`` out by
the rules (``("layers", "batch", "seq_shard", "kv_heads", None)``):
``decode_kv_seq_axis`` gives the sequence every mesh axis the batch
leaves free, and a batch below the data-parallel size puts it on
"data" (``parallel.sharding.activation_rules``).  GSPMD then partitions
the softmax over the keys for it.  The port does what that amounts to
by hand (``models.attention.decode_attention``'s ``seq``):

- a rank holds rows ``[lo, hi)`` of every seat's sequence
  (:meth:`SeqSplit.rows`), the axes that split it outermost first;
- the new K/V row at ``pos`` is written by the rank that owns it
  (:func:`owner_rows`, a masked index: no host branch on ``pos``);
- each rank attends its keys (K4 with ``lse=``, or its plain version)
  at local lengths ``clamp(pos + 1 - lo, 0, hi - lo)`` and, on a
  sliding-window layer, local starts ``clamp(pos + 1 - W - lo, 0, hi -
  lo)`` (:func:`local_bounds`), which gives its normalized output
  ``o_r`` and the log-sum-exp ``lse_r`` of its scaled scores;
- the ranks' states are merged (:func:`merge_over`, :func:`merge`):
  ``o = Σ_r exp(lse_r - m)·o_r / Σ_r exp(lse_r - m)`` with ``m`` the
  largest ``lse_r``, in f32: the merge K4 makes of its own splits inside
  one launch.  A rank with no key in range has ``lse_r = -inf`` and
  ``o_r = 0`` and weighs 0; a seat with no key on any rank gets 0.  At
  one rank the weight is exactly 1 and the merge returns ``o_r``
  unchanged.

The plain merge is the one the card path calls too: it is a handful of
elementwise ops over ``R × B × H × d`` values.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class SeqSplit:
    """The sequence of a cache leaf split over the mesh axes ``axes``
    (outermost first), of ``sizes``, this rank at ``coords`` on them;
    ``groups`` their process groups."""
    axes: Tuple[str, ...]
    sizes: Tuple[int, ...]
    coords: Tuple[int, ...]
    groups: Tuple[Any, ...]

    @classmethod
    def over(cls, mesh, axes) -> "SeqSplit":
        axes = tuple(axes)
        return cls(axes, tuple(mesh.shape[a] for a in axes),
                   tuple(mesh.coordinate(a) for a in axes),
                   tuple(mesh.group(a) for a in axes))

    @property
    def n(self) -> int:
        """Ranks the sequence is split over."""
        out = 1
        for s in self.sizes:
            out *= s
        return out

    @property
    def index(self) -> int:
        """This rank's slice of the sequence, ``0 .. n - 1``."""
        idx = 0
        for s, c in zip(self.sizes, self.coords):
            idx = idx * s + c
        return idx

    def rows(self, local: int) -> Tuple[int, int]:
        """``(lo, hi)``: the rows of the whole sequence that a slice of
        ``local`` rows holds on this rank."""
        return self.index * local, (self.index + 1) * local


@dataclasses.dataclass(frozen=True)
class LeafSplit:
    """How one layer's cache leaf lies over the mesh, in the layer's view
    (the stacked ``G`` axis dropped): ``seq`` the split of its sequence
    dimension (None where the leaf has none or it is whole), ``model_dim``
    the dimension "model" splits otherwise (the KV heads, an SSM state's
    inner or head dimension), None where "model" splits none."""
    seq: Optional[SeqSplit] = None
    model_dim: Optional[int] = None


def local_bounds(pos: torch.Tensor, lo: int, rows: int,
                 window: Optional[int] = None):
    """``(lengths, starts)`` in local rows of a rank holding rows ``[lo,
    lo + rows)``: the query at ``pos`` keeps global keys ``<= pos``, and
    with a ``window`` only those ``> pos - window``; ``starts`` is None
    without a window.  int32 (B,) each, every value in ``[0, rows]``."""
    lengths = torch.clamp(pos + 1 - lo, 0, rows).to(torch.int32)
    if window is None:
        return lengths, None
    starts = torch.clamp(pos + 1 - window - lo, 0, rows).to(torch.int32)
    return lengths, starts


def owner_rows(rows: torch.Tensor, lo: int, n: int):
    """``(local, mine)`` for global rows ``rows`` (B,) of a rank holding
    ``[lo, lo + n)``: the local row (clamped into range, so the index is
    always valid) and whether this rank holds it."""
    local = rows - lo
    mine = (local >= 0) & (local < n)
    return torch.clamp(local, 0, n - 1).long(), mine


def write_owned(cache: torch.Tensor, local: torch.Tensor,
                mine: torch.Tensor, new: torch.Tensor) -> None:
    """Write ``new`` (B, ...) at row ``local[b]`` of seat ``b`` of
    ``cache`` (B, T, ...) in place where ``mine[b]``; elsewhere the row
    is written back unchanged.  One gather, one select and one scatter,
    with no host read of ``local`` or ``mine``."""
    seat = torch.arange(cache.shape[0], device=cache.device)
    old = cache[seat, local]
    keep = mine.view(-1, *([1] * (new.dim() - 1)))
    cache[seat, local] = torch.where(keep, new.to(cache.dtype), old)


def merge(o: torch.Tensor, lse: torch.Tensor):
    """The merge of ``R`` partial attention states: ``o`` (R, B, H, d)
    each normalized over its own keys, ``lse`` (R, B, H) the natural-log
    log-sum-exp of each one's scaled scores (``-inf`` for no key).
    Returns ``(o, lse)`` of all the keys together, in f32: ``o = Σ_r
    w_r·o_r / Σ_r w_r`` with ``w_r = exp(lse_r - m)``, ``m`` the largest
    ``lse_r`` (0 where every one is ``-inf``, so that the weights are 0
    and the output 0, never NaN)."""
    o, lse = o.float(), lse.float()
    m = torch.amax(lse, dim=0)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    w = torch.exp(lse - m)
    den = w.sum(dim=0)
    out = (w[..., None] * o).sum(dim=0) / torch.clamp(den, min=1e-30)[..., None]
    return out, torch.log(den) + m


def _gather(t: torch.Tensor, group, n: int) -> torch.Tensor:
    """Every rank's ``t`` of ``group`` stacked along a new first
    dimension, in rank order."""
    if n == 1:
        return t[None]
    t = t.contiguous()
    out = t.new_empty((n * t.shape[0], *t.shape[1:]))
    dist.all_gather_into_tensor(out, t, group=group)
    return out.view(n, *t.shape)


def merge_over(o: torch.Tensor, lse: torch.Tensor, split: SeqSplit):
    """The merge (:func:`merge`) of this rank's state ``o`` (B, H, d) f32
    and ``lse`` (B, H) with those of every rank that holds another slice
    of the same sequence (``split``'s groups): each rank gathers all the
    states in slice order and merges them, so every rank returns the
    same ``(o, lse)``."""
    os_, ls = o.float()[None], lse.float()[None]
    for group, n in zip(reversed(split.groups), reversed(split.sizes)):
        os_ = _gather(os_, group, n).flatten(0, 1)
        ls = _gather(ls, group, n).flatten(0, 1)
    return merge(os_, ls)
