"""Parameter specs and the common modules of the port (counterparts of
``repro.models.modules``).

A model is a nested dict of :class:`ParamSpec`; :func:`init_params`
materializes it with draws from an explicit ``torch.Generator``.  The
draws differ from ``jax.random``'s for the same seed, so equivalence
tests carry JAX-initialized weights across with
``models.convert.params_from_jax`` instead.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.ref import rmsnorm_ref
from repro_torch.parallel.tensor import target_logit


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"       # normal | zeros | ones
    scale: float = 1.0

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def init_params(specs, generator: torch.Generator,
                dtype: torch.dtype = torch.float32, device=None,
                leaf_dtypes: Optional[dict] = None):
    """Materialize a params tree from a spec tree: normal leaves draw
    ``N(0, (scale / sqrt(fan_in))²)`` from ``generator`` (which must live
    on ``device``), in the JAX flattening order.  A leaf whose key is in
    ``leaf_dtypes`` is cast to that dtype as soon as it is made, before
    the next is drawn."""
    def build(tree):
        out = {}
        for key in sorted(tree):
            spec = tree[key]
            if not isinstance(spec, ParamSpec):
                out[key] = build(spec)
            elif spec.init == "zeros":
                out[key] = torch.zeros(spec.shape, dtype=dtype, device=device)
            elif spec.init == "ones":
                out[key] = torch.ones(spec.shape, dtype=dtype, device=device)
            else:
                fan_in = spec.shape[0] if spec.shape else 1
                std = spec.scale / math.sqrt(max(fan_in, 1))
                # no name holds the f32 draw: with ``leaf_dtypes`` it is
                # freed as soon as its cast replaces it, not when the
                # next leaf is drawn
                out[key] = torch.randn(
                    spec.shape, generator=generator, dtype=torch.float32,
                    device=device).mul_(std).to(dtype)
            if leaf_dtypes and key in leaf_dtypes and \
                    isinstance(spec, ParamSpec):
                out[key] = out[key].to(leaf_dtypes[key])
        return out
    return build(specs)


def abstract_params(specs, dtype: torch.dtype = torch.float32):
    """The params tree as tensors on the ``meta`` device: shapes and
    dtypes, no storage."""
    if isinstance(specs, ParamSpec):
        return torch.empty(specs.shape, dtype=dtype, device="meta")
    return {k: abstract_params(v, dtype) for k, v in specs.items()}


def count_params(specs) -> int:
    if isinstance(specs, ParamSpec):
        return math.prod(specs.shape)
    return sum(count_params(v) for v in specs.values())


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6):
    """Plain RMSNorm (``x·rsqrt(mean(x²)+eps)·(1+w)`` in f32).  The model
    norms through ``kernels.ops.rmsnorm``, which runs the Triton kernel
    on the card and this function on the CPU."""
    return rmsnorm_ref(x, w, eps=eps)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10_000.0) -> torch.Tensor:
    """Rotary embedding, half-split (not interleaved).
    x: (..., seq, heads..., head_dim); positions (..., seq)."""
    hd = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                          device=x.device) / hd))
    angles = positions.float()[..., None] * freqs   # (..., seq, hd/2)
    for _ in range(x.dim() - angles.dim()):
        angles = angles[..., None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(x, wg, wu, wd, compute_dtype: torch.dtype, tp=None):
    """``(silu(x·wg) ⊙ x·wu)·wd``.  ``tp`` (a
    ``parallel.tensor.TensorParallel``), where given, runs it
    tensor-parallel on this rank's ff slice (``wg``/``wu`` columns,
    ``wd`` rows): ``x`` through ``tp.copy``, the output summed over the
    ranks."""
    if tp is not None:
        x = tp.copy(x)
    g = x @ wg.to(compute_dtype)
    u = x @ wu.to(compute_dtype)
    out = (F.silu(g) * u) @ wd.to(compute_dtype)
    return out if tp is None else tp.reduce(out)


def mlp_specs(d_model: int, d_ff: int, prefix_axes=("embed", "ff")) -> dict:
    e, f = prefix_axes
    return {
        "wg": ParamSpec((d_model, d_ff), (e, f)),
        "wu": ParamSpec((d_model, d_ff), (e, f)),
        "wd": ParamSpec((d_ff, d_model), (f, e)),
    }


def _xent_chunk(xc, w_out, lc, compute_dtype: torch.dtype, tp=None):
    """Summed cross-entropy and token count of one chunk: xc (B, cs, D),
    w_out (D, V) (under ``tp``, this rank's vocabulary columns), lc (B,
    cs) with labels < 0 masked out."""
    w = w_out.to(compute_dtype).to(torch.promote_types(xc.dtype,
                                                        compute_dtype))
    logits = (xc @ w).float()
    target = lc.clamp(min=0).long()
    if tp is None:
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, target[..., None])[..., 0]
    else:
        lse = tp.logsumexp(logits)
        gold = target_logit(logits, target, tp)
    mask = (lc >= 0).float()
    return torch.sum((lse - gold) * mask), torch.sum(mask)


def softmax_xent_chunked(x, w_out, labels, *, chunk: int = 512,
                         compute_dtype: torch.dtype = torch.bfloat16,
                         tp=None):
    """Cross-entropy without materializing full (B, S, V) logits.

    x: (B, S, D) final hidden; w_out: (D, V); labels: (B, S) int32.
    Each chunk rounds ``w_out`` to ``compute_dtype`` and takes the
    product in the promoted dtype of the two, as the reference's scan
    body does: with f32 ``x`` the logits use bf16-rounded weights, and
    each chunk's gradient reaching ``w_out`` is rounded to bf16 before
    the chunks' gradients are summed.  Each chunk runs under
    ``torch.utils.checkpoint``: backward recomputes it, so only one
    chunk's (B, chunk, V) logits are alive at a time in either pass.
    ``tp`` (a ``parallel.tensor.TensorParallel``), where given, makes it
    vocab-parallel: ``w_out`` is this rank's vocabulary slice, ``x``
    enters through ``tp.copy``, the logsumexp and the target's logit are
    taken over the ranks' logits (``tp.logsumexp``, ``target_logit``).
    Returns (sum_loss, sum_tokens), 0-d f32.
    """
    if tp is not None:
        x = tp.copy(x)
    B, S, D = x.shape
    n = max(S // chunk, 1)
    cs = S // n
    xs = x.reshape(B, n, cs, D).unbind(1)
    ls = labels.reshape(B, n, cs).unbind(1)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    count = torch.zeros((), dtype=torch.float32, device=x.device)
    for xc, lc in zip(xs, ls):
        loss, cnt = checkpoint(_xent_chunk, xc, w_out, lc, compute_dtype,
                               tp, use_reentrant=False)
        total = total + loss
        count = count + cnt
    return total, count
