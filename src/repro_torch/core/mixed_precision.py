"""KV-page precision layer: the KV half of ``repro.core.mixed_precision``.

fp8 or int8 values with one f32 scale per (token, head) vector, used by the
quantized paged KV pool.  Values and scales are bit-identical to the JAX
package's for the same inputs: the amax, the division and the rounding
(round half to even, both for the e4m3 cast and for ``torch.round``) are
the same IEEE float32 steps.
"""
from __future__ import annotations

from typing import Tuple

import torch

F8 = torch.float8_e4m3fn
F8_MAX = 448.0
I8_MAX = 127.0

# KV-cache storage dtypes the serving stack accepts (--kv-dtype).
KV_DTYPES = ("f32", "bf16", "fp8", "int8")
# The subset stored quantized: pages carry values + per-(token, head)
# f32 scales and are dequantized inside the decode path.
KV_QUANTIZED = ("fp8", "int8")


def kv_storage_dtype(kv_dtype: str) -> torch.dtype:
    """torch dtype that backs a KV pool stored as ``kv_dtype``.

    fp8 pools hold **uint8 bit patterns** of the e4m3 values, as in the
    JAX package, so pool bytes compare directly across the two and every
    structural op (scatter, gather, page copy) runs on a plain integer
    type; :func:`dequantize_kv_page` and the decode kernel reinterpret
    the bits as e4m3 at the single point the values are needed.

    Raises:
      ValueError: ``kv_dtype`` is not one of :data:`KV_DTYPES`."""
    if kv_dtype not in KV_DTYPES:
        raise ValueError(
            f"unknown kv_dtype {kv_dtype!r}; expected one of {KV_DTYPES}")
    return {"f32": torch.float32, "bf16": torch.bfloat16,
            "fp8": torch.uint8, "int8": torch.int8}[kv_dtype]


def kv_is_quantized(kv_dtype: str) -> bool:
    """Whether ``kv_dtype`` pages carry per-(token, head) scales."""
    kv_storage_dtype(kv_dtype)      # validate
    return kv_dtype in KV_QUANTIZED


def kv_token_bytes(kv_dtype: str, head_dim: int) -> int:
    """Bytes one token of one KV head costs in a ``kv_dtype`` pool
    (values plus the f32 scale for quantized dtypes)."""
    per_value = kv_storage_dtype(kv_dtype).itemsize
    scale = 4 if kv_is_quantized(kv_dtype) else 0
    return head_dim * per_value + scale


def kv_precision_bits(kv_dtype: str) -> int:
    """Fidelity rank of a KV storage dtype (value bits).  A pool satisfies
    a class requiring dtype R iff its bits are >= R's."""
    kv_storage_dtype(kv_dtype)      # validate
    return {"f32": 32, "bf16": 16, "fp8": 8, "int8": 8}[kv_dtype]


def quantize_kv_page(x: torch.Tensor,
                     kv_dtype: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize K or V vectors for a paged pool stored as ``kv_dtype``.

    ``x`` is ``(..., head_dim)``; each (token, head) vector gets its own
    f32 scale from the amax over its last axis, so a token's stored bytes
    depend only on its own values (copy-on-write and preemption replay
    stay bit-exact).

    Returns:
      ``(q, scale)`` with ``q`` shaped like ``x`` in the storage dtype
      (uint8 e4m3 bits or int8) and ``scale`` shaped ``x.shape[:-1]`` in
      f32, such that ``x ≈ dequantize_kv_page(q, scale)``.

    Raises:
      ValueError: ``kv_dtype`` is not a quantized KV dtype."""
    if not kv_is_quantized(kv_dtype):
        raise ValueError(
            f"quantize_kv_page needs a quantized kv_dtype "
            f"{KV_QUANTIZED}, got {kv_dtype!r}")
    x = x.float()
    amax = x.abs().amax(dim=-1)
    if kv_dtype == "fp8":
        # x / scale peaks at 448.00003, which e4m3 rounds to 448 exactly
        # as the JAX cast does (the two differ only past 464)
        scale = amax.clamp_min(1e-12) / F8_MAX
        q = (x / scale[..., None]).to(F8).view(torch.uint8)
    else:
        scale = amax.clamp_min(1e-12) / I8_MAX
        q = torch.round(x / scale[..., None]).clamp(
            -I8_MAX, I8_MAX).to(torch.int8)
    return q, scale


def dequantize_kv_page(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_kv_page`: f32 values from quantized K/V
    bytes and their per-(token, head) scales (``scale`` is
    ``q.shape[:-1]``).  uint8 inputs are e4m3 bit patterns."""
    if q.dtype == torch.uint8:
        q = q.view(F8)
    return q.float() * scale[..., None].float()
