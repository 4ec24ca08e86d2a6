"""AdamW with global-norm clipping (counterpart of
``repro.optim.adamw``).

The optimizer state keeps the reference's tree, ``{"mu", "nu", "count"}``
with the moments parallel to the params and ``count`` a 0-d int32, so a
checkpoint of it reads the same in both packages.  The update is the
reference's formula, leaf by leaf; where the reference returns new
arrays (and its train step donates the old ones), the port updates the
params and the state in place and returns them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0


def init_opt_state(params) -> Dict[str, Any]:
    zeros = lambda: tree_map(torch.zeros_like, params)        # noqa: E731
    device = tree_leaves(params)[0].device
    return {"mu": zeros(), "nu": zeros(),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree, *, groups=None) -> torch.Tensor:
    """The 2-norm of every leaf of ``tree`` together.  Over a sharded
    tree (``groups``: per leaf, in ``tree_leaves`` order, the process
    groups of the mesh axes it is split over, empty for a whole leaf)
    each split leaf's sum of squares is summed over its groups and a
    leaf whole over an axis counts once along it, so every rank gets the
    norm of the whole tree; the leaves' sums are added in leaf order
    either way."""
    sums = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    # each set of groups in the order of its first leaf: the same
    # collectives in the same order on every rank
    for key in dict.fromkeys(gs for gs in groups or () if gs):
        at = [i for i, gs in enumerate(groups) if gs == key]
        part = torch.stack([sums[i] for i in at])
        for g in key:
            dist.all_reduce(part, group=g)
        for i, s in zip(at, part.unbind()):
            sums[i] = s
    return torch.sqrt(sum(sums))


@torch.no_grad()
def adamw_update(grads, opt_state, params, lr,
                 cfg: AdamWConfig = AdamWConfig(), *, groups=None):
    """One AdamW step: clip ``grads`` to ``cfg.clip_norm`` by their global
    norm, advance the moments, and move every leaf of ``params`` (the
    norms included, as in the reference) by
    ``lr·(m̂/(√v̂ + eps) + wd·p)``, the bias corrections taken at
    ``count + 1``.  ``lr`` is a number
    or a 0-d tensor on the params' device.

    ``params`` and ``opt_state`` are updated in place and returned:
    ``(params, opt_state, {"grad_norm"})``, the norm before clipping.
    Over a sharded tree (``groups``: see ``global_norm``)
    the norm, and so the clipping, is the whole tree's, and each leaf's
    update is the whole leaf's update restricted to its slice.
    Each product and sum is rounded as in the reference's expression;
    the moments and f32 params are updated in place, so a leaf's
    update holds at most two temporaries of its size (a full-width
    phi-3-vision-4.2b's largest leaf is 3 GiB in f32)."""
    count = opt_state["count"].add_(1)
    gnorm = global_norm(grads, groups=groups)
    scale = None
    if cfg.clip_norm is not None:
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12),
                            max=1.0)
    b1c = 1.0 - cfg.b1 ** count.float()
    b2c = 1.0 - cfg.b2 ** count.float()
    for g, mu, nu, p in zip(tree_leaves(grads), tree_leaves(opt_state["mu"]),
                            tree_leaves(opt_state["nu"]),
                            tree_leaves(params)):
        g = g.float() if scale is None else g.float() * scale
        _update(mu, lambda m: m.mul_(cfg.b1).add_(g * (1 - cfg.b1)))
        _update(nu, lambda v: v.mul_(cfg.b2).add_(
            torch.square(g).mul_(1 - cfg.b2)))
        del g
        step = (mu.float() / b1c).div_(
            (nu.float() / b2c).sqrt_().add_(cfg.eps))
        _update(p, lambda q: q.sub_(step.add_(q * cfg.weight_decay)
                                    .mul_(lr)))
    return params, opt_state, {"grad_norm": gnorm}


def _update(t: torch.Tensor, fn) -> None:
    """``t.copy_(fn(t.float()))``, ``fn`` working in place: on ``t``
    itself where ``t`` is f32."""
    t32 = t.float()
    fn(t32)
    if t32 is not t:
        t.copy_(t32)
