"""Carry weights across from the JAX package, and cast them once for
compute.

``params_from_jax`` takes the JAX params pytree with its leaves already
turned into numpy arrays (``jax.tree.map(np.asarray, params)`` on the JAX
side) and returns the same nested dict of torch tensors: ``embed``,
``blocks/pos{i}/...`` with the leading stacked ``(G,)`` axis,
``final_norm``, and ``lm_head`` when untied.  It converts any such tree
(a paged KV pool too).
"""
from __future__ import annotations

import numpy as np
import torch

#: Matmul and embedding weights; everything else (the norms) stays f32.
COMPUTE_CAST = frozenset(("wq", "wk", "wv", "wo", "wg", "wu", "wd",
                          "embed", "lm_head"))


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
