"""Precision layer of the port: the counterpart of
``repro.core.mixed_precision``.

- The KV half: fp8 or int8 values with one f32 scale per (token, head)
  vector, used by the quantized paged KV pool.
- The fp8 half (HPL-MxP, paper Table 9): ``quantize_fp8``, the per-tensor
  ``fp8_matmul`` (e4m3 operands, f32 accumulation) that the HPL-MxP
  trailing update runs through the fp8 GEMM kernel, ``fp8_einsum_2d`` and
  ``iterative_refinement``.

Values and scales are bit-identical to the JAX package's for the same
inputs: the amax, the division and the rounding (round half to even, both
for the e4m3 cast and for ``torch.round``) are the same IEEE float32 steps.
"""
from __future__ import annotations

from typing import Callable, Tuple

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


# --- the fp8 half: e4m3 GEMMs with iterative refinement (HPL-MxP) ----------

def quantize_fp8(x: torch.Tensor, *,
                 axis=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scale ``x`` into e4m3 range.  Returns ``(x_fp8, scale)`` with
    ``x ≈ x_fp8.float() * scale``, ``x_fp8`` a ``torch.float8_e4m3fn``
    tensor and ``scale`` f32.

    Scale-shape contract (as in the JAX package): with ``axis=None`` the
    reduction is global and ``scale`` is 0-d; with an ``axis`` (an int or
    a tuple) the reduced dimensions are kept, so ``scale`` broadcasts
    against ``x``.  The amax, the division and the cast are the same
    IEEE steps as JAX's, so values and scales are bit-identical:
    ``x / scale`` peaks at 448.00003, which e4m3 rounds to 448 in both
    (the two casts differ only past 464)."""
    if axis is None:
        amax = x.abs().amax()
    else:
        amax = x.abs().amax(dim=axis, keepdim=True)
    scale = amax.clamp_min(1e-12) / F8_MAX
    return (x / scale).to(F8), scale.float()


def fp8_matmul(a: torch.Tensor, b: torch.Tensor, *,
               impl: str = "auto") -> torch.Tensor:
    """``a @ b`` with e4m3 operands and f32 accumulation, one scale per
    tensor: ``dot(qa, qb) · (sa · sb)`` as in the JAX package.  ``a`` is
    (..., K), ``b`` (K, N); the result is (..., N) f32.

    On CUDA this is the fp8 GEMM kernel (``kernels.ops.scaled_fp8_matmul``)
    with one scale block covering each operand (``bm = M``, ``bn = N``),
    so both scale vectors hold the one per-tensor scale and the kernel's
    epilogue ``acc · (a_scale[i] · b_scale[j])`` is exactly the
    reference's ``out · (sa · sb)``.  ``impl`` as in ``kernels.ops``."""
    from repro_torch.kernels import ops
    qa, sa = quantize_fp8(a)
    qb, sb = quantize_fp8(b)
    # the kernel's wrapper lays both operands out K-major
    # (``fp8_matmul.kernel_operands``): the HPL column panel, column-major
    # out of a triangular solve, is copied; the row panel, column-major
    # too, is read as it lies
    qa2 = qa.reshape(-1, a.shape[-1])
    m, k = qa2.shape
    n = b.shape[-1]
    out = ops.scaled_fp8_matmul(qa2, qb, sa.reshape(1), sb.reshape(1),
                                bm=max(m, 1), bn=max(n, 1), bk=max(k, 1),
                                impl=impl)
    return out.reshape(*a.shape[:-1], n)


def fp8_einsum_2d(x: torch.Tensor, w: torch.Tensor, *,
                  impl: str = "auto") -> torch.Tensor:
    """(..., K) @ (K, N) through the fp8 path (``fp8_matmul`` flattens
    the leading dimensions, as the reference's reshape to 2-D does)."""
    return fp8_matmul(x, w, impl=impl)


def iterative_refinement(apply_a: Callable, solve_lowprec: Callable,
                         b: torch.Tensor, *, iters: int = 5):
    """Solve A x = b given a low-precision solver (Richardson iteration):
    ``x_{k+1} = x_k + solve_lowprec(b - A x_k)``.  With an fp8/bf16 LU as
    the inner solver this recovers f32-accurate solutions (the HPL-MxP
    method).  Returns ``(x, history)``: ``history`` is a tensor of the
    ``iters`` relative residual norms ``|b - A x_k| / |b|``, each taken
    before its correction."""
    bf = b.float()
    bnorm = torch.linalg.vector_norm(bf).clamp_min(1e-30)
    x = solve_lowprec(b).float()
    hist = []
    for _ in range(iters):
        r = bf - apply_a(x)
        x = x + solve_lowprec(r).float()
        hist.append(torch.linalg.vector_norm(r) / bnorm)
    return x, (torch.stack(hist) if hist
               else torch.empty(0, device=b.device))
