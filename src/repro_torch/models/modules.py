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

from repro_torch.kernels.ref import rmsnorm_ref


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"       # normal | zeros | ones
    scale: float = 1.0

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def init_params(specs, generator: torch.Generator,
                dtype: torch.dtype = torch.float32, device=None):
    """Materialize a params tree from a spec tree: normal leaves draw
    ``N(0, (scale / sqrt(fan_in))²)`` from ``generator`` (which must live
    on ``device``), in the JAX flattening order."""
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
                t = torch.randn(spec.shape, generator=generator,
                                dtype=torch.float32, device=device)
                out[key] = t.mul_(std).to(dtype)
        return out
    return build(specs)


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


def swiglu(x, wg, wu, wd, compute_dtype: torch.dtype):
    g = x @ wg.to(compute_dtype)
    u = x @ wu.to(compute_dtype)
    return (F.silu(g) * u) @ wd.to(compute_dtype)


def mlp_specs(d_model: int, d_ff: int, prefix_axes=("embed", "ff")) -> dict:
    e, f = prefix_axes
    return {
        "wg": ParamSpec((d_model, d_ff), (e, f)),
        "wu": ParamSpec((d_model, d_ff), (e, f)),
        "wd": ParamSpec((d_ff, d_model), (f, e)),
    }
