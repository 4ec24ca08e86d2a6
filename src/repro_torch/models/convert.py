"""Carry weights across from the JAX package, cast them once for
compute, or draw them already cast.

``params_from_jax`` takes the JAX params pytree with its leaves already
turned into numpy arrays (``jax.tree.map(np.asarray, params)`` on the JAX
side) and returns the same nested dict of torch tensors: ``embed``,
``blocks/pos{i}/...`` with the leading stacked ``(G,)`` axis (a
decoder layer's ``cross`` and ``ln_cross`` among them), ``final_norm``,
``lm_head`` when untied, and an encoder-decoder model's ``encoder/...``
and ``frontend_proj``.  It converts any such tree
(a paged KV pool too).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.modules import init_params

#: Matmul and embedding weights (the MoE router and shared-expert gate
#: among them, the SSM block's in/out projections), and the SSM block's
#: conv weight and bias and skip ``D``, and the audio frontend's
#: ``frontend_proj``, which the reference casts to the compute dtype at
#: each use; everything else stays f32 (the norms, and the SSM's
#: ``A_log`` and ``dt_bias``, which it reads in f32).
COMPUTE_CAST = frozenset(("wq", "wk", "wv", "wo", "wg", "wu", "wd",
                          "router", "gate", "embed", "lm_head",
                          "in_proj", "out_proj", "conv_w", "conv_b", "D",
                          "frontend_proj"))


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes bf16 from jax
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def params_from_jax(tree, device="cpu"):
    """Nested dict of numpy arrays -> the same nested dict of tensors."""
    return {k: (params_from_jax(v, device) if isinstance(v, dict)
                else _tensor(v, device)) for k, v in tree.items()}


def cast_for_compute(params, dtype: torch.dtype):
    """Cast the matmul and embedding weights once to the compute dtype.

    The JAX model casts each weight at every use (``w.astype(dt)``); the
    values are the same, and eager PyTorch would otherwise re-cast every
    weight on every tick.  Norm weights stay f32: ``rms_norm`` reads them
    in f32, and a bf16 round trip would change them."""
    def cast(tree):
        return {k: (cast(v) if isinstance(v, dict)
                    else v.to(dtype) if k in COMPUTE_CAST else v)
                for k, v in tree.items()}
    return cast(params)


def init_params_for_compute(specs, generator: torch.Generator,
                            dtype: torch.dtype, device=None):
    """``cast_for_compute(init_params(specs, generator, device=device),
    dtype)`` bit for bit, with each matmul and embedding leaf cast as
    soon as it is drawn: the f32 tree never exists whole, only the leaf
    being drawn (a full-width MoE's f32 tree would not fit beside its
    cast on one card)."""
    return init_params(specs, generator, device=device,
                       leaf_dtypes=dict.fromkeys(COMPUTE_CAST, dtype))
