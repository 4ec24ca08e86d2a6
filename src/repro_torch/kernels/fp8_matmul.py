"""fp8 GEMM: the Hopper CUDA kernel (K6), its plain version and its
error bound.

``fp8_matmul_cuda`` launches ``csrc/fp8_matmul.cu``, which replaces
``repro/kernels/fp8_matmul.py :: fp8_matmul_pallas``: a_q (M, K) and b_q
(K, N) e4m3 (``torch.float8_e4m3fn``), one f32 scale per bm-row block of
a and per bn-column block of b, the (M, N) f32 result
``acc · (a_scale[i / bm] · b_scale[j / bn])``.  The kernel runs fp8
``wgmma`` on the tensor cores and promotes its sums into f32 every
``PROMOTE_K`` products; ``error_bound`` states how far that may stray
from f32 sums.  It runs on the HPL-MxP trailing update
(``core.hpl.blocked_lu(matmul="fp8")`` through the per-tensor
``core.mixed_precision.fp8_matmul``) and behind the per-block
``kernels.ops.fp8_matmul``.

``kernel_operands`` lays the operands out as the kernel reads them: both
K-major (a as it is, b transposed, which costs nothing for a column-major
b) with K zero-padded to a multiple of 16.

``fp8_matmul_plain`` is the same function in plain PyTorch: the TPU
kernel's shape contract (``check_shapes``) followed by
``ref.fp8_matmul_ref``, which dequantizes to f32, runs one f32 matmul and
multiplies by ``sa[i] · sb[j]`` in the reference's order.  It serves CPU
tensors and the checks on the card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

E4M3 = torch.float8_e4m3fn

#: The kernel's promotion interval: its tensor cores sum at most this many
#: products (one 128-deep chunk of K, 4 wgmma k-steps of 32) before the
#: sum is added into an f32 register accumulator.
PROMOTE_K = 128
#: The tensor-core term of ``error_bound``, as a fraction of
#: ``(|a_q|·|b_q|)·(sa·sb)``: the limit the checks hold the kernel to.
TC_LIMIT = 2.0 ** -9
#: The worst case of that term under the model in ``error_bound``'s
#: docstring, c·2^-p with c = 272 truncations' worth per chunk and
#: p = 13 bits: documentation only, as large as a typical result.
TC_WORST = 2 * (PROMOTE_K + 2 * PROMOTE_K // 32) * 2.0 ** -13
#: K, and the kernel's row stride in bytes, is padded to this (TMA's
#: 16-byte stride rule).
K_ALIGN = 16


def check_shapes(a_q: torch.Tensor, b_q: torch.Tensor, bm: int, bn: int,
                 bk: int) -> None:
    """The TPU kernel's contract: a_q (M, K) @ b_q (K, N) with every
    dimension an exact multiple of its block.

    Raises:
      ValueError: the two K differ (``contraction mismatch``), or a
          dimension is ragged (naming it and its block, e.g. ``M=100 is
          not a multiple of bm=128``)."""
    m, k = a_q.shape
    k2, n = b_q.shape
    if k != k2:
        raise ValueError(
            f"fp8_matmul: contraction mismatch — a_q is (M={m}, K={k}) but "
            f"b_q is (K={k2}, N={n})")
    for dim_name, dim, blk_name, blk in (
            ("M", m, "bm", bm), ("N", n, "bn", bn), ("K", k, "bk", bk)):
        if blk < 1 or dim % blk != 0:
            raise ValueError(
                f"fp8_matmul: {dim_name}={dim} is not a multiple of "
                f"{blk_name}={blk} (shapes a_q={tuple(a_q.shape)}, "
                f"b_q={tuple(b_q.shape)}); the per-block scales cannot "
                "cover a ragged edge — pad to block multiples or use "
                "repro_torch.kernels.ops.fp8_matmul, which pads for you")


def fp8_matmul_plain(a_q, b_q, a_scale, b_scale, *, bm: int = 128,
                     bn: int = 128, bk: int = 128) -> torch.Tensor:
    """Plain version: returns (M, N) f32."""
    check_shapes(a_q, b_q, bm, bn, bk)
    return ref.fp8_matmul_ref(a_q, b_q, a_scale, b_scale, bm=bm, bn=bn)


def magnitude(a_q, b_q, sa_rows: torch.Tensor,
              sb_cols: torch.Tensor) -> torch.Tensor:
    """``(|a_q|·|b_q|)·(sa·sb)``, (M, N) f32: the sum of the magnitudes of
    each output's scaled products, which every summation error below is
    measured against.  ``sa_rows`` (M,) and ``sb_cols`` (N,) are each
    row's and column's scale."""
    mag = a_q.float().abs() @ b_q.float().abs()
    return mag.mul_(sa_rows[:, None] * sb_cols[None, :])


def error_bound(mag: torch.Tensor, plain: torch.Tensor, k: int, *,
                tensor_core: bool = True) -> torch.Tensor:
    """Per-element limit of |kernel − plain| for K = ``k``, with ``mag``
    from :func:`magnitude` and ``plain`` the plain version's result.

    f32 part: every e4m3 product is exact in f32 (4 + 4 significant
    bits), so two f32 summations of the same products differ by at most
    ``2·γ_K·mag`` with γ_K = K·u/(1 − K·u), u = 2^-24, plus one rounding
    of the scaling on each side, ``2^-23·|plain|``.  This is the whole
    bound of a kernel that sums in f32 (``tensor_core=False``).

    Tensor-core part, ``TC_LIMIT·mag`` = 2^-9·mag.  The fp8 ``wgmma``
    accumulator keeps about 14 significant bits (DeepSeek-V3 §3.3.2) and
    drops the rest toward zero; promotion restarts it every PROMOTE_K
    products, so its error in one chunk is measured against S_c, the
    chunk's sum of |products|, and the S_c add up to the unscaled
    ``mag``.  A worst case follows if every one of a k-step's 33
    addends (32 products and the running sum) and its result is cut to
    p = 13 bits at the largest magnitude, at most S_c: 34 cuts of less
    than 2^(1−p)·S_c per k-step, 4 k-steps per chunk, c·2^-p·S_c with
    c = 272 (``TC_WORST`` ≈ 0.033).  That is as large as a typical
    result at K = 1024 and would pass a kernel that reads the wrong
    scale block or drops a k-step, so the limit is set from what the
    H100 does instead (``chip_smoke.py`` logs every ratio): with every
    product of one sign, where no cut can cancel another, the kernel
    errs by up to 8.2e-4·mag at K = 1024, and by at most 2.2e-4·mag on
    the signed checks; 2^-9 = 1.95e-3 lies 2.4× above the one-sign
    reading.  The same run fails each planted fault: a scale of the
    wrong block (≥ 1.9e-2), a dropped k-step (≥ 4.3e-2), and sums kept
    on the tensor cores across all of K, never promoted, on one-sign
    operands (1.8e-2).  On signed operands at K ≤ 1024 promotion changes
    too little to see (≤ 6.3e-4 without it)."""
    u = 2.0 ** -24
    coef = 2 * k * u / (1 - k * u)
    if tensor_core:
        coef += TC_LIMIT
    return (mag * coef).add_(plain.abs(), alpha=2.0 ** -23)


def kernel_operands(a_q: torch.Tensor, b_q: torch.Tensor):
    """a_q (M, K) and b_q (K, N) as the kernel reads them: ``(a_k, bt_k)``,
    (M, Kp) and (N, Kp) row-major (K-major) and 16-byte aligned, with
    Kp = K rounded up to a multiple of ``K_ALIGN`` (at least one) and the
    added columns zero, which adds only zero products.  ``bt_k`` is
    ``b_q.t()`` itself, without a copy, when b_q is column-major and K
    needs no padding."""
    k = a_q.shape[1]
    kp = max(K_ALIGN, -(-k // K_ALIGN) * K_ALIGN)

    def lay_out(x):
        if kp != k:
            x = torch.nn.functional.pad(x.view(torch.uint8),
                                        (0, kp - k)).view(E4M3)
        if not x.is_contiguous():
            x = x.contiguous()
        if x.data_ptr() % 16:                 # a view at an odd offset
            x = x.clone()
        return x
    return lay_out(a_q), lay_out(b_q.t())


def fp8_matmul_cuda(a_q, b_q, a_scale, b_scale, out: torch.Tensor, *,
                    bm: int, bn: int) -> None:
    """Launch the kernel on the current stream, writing ``out`` (M, N).
    The caller (``kernels.ops``) has checked devices, dtypes and shapes;
    the operands go through ``kernel_operands`` (the transpose of b and
    the padding of K are part of the call).

    Raises:
      RuntimeError: the launch was refused (the CUDA error code)."""
    m = a_q.shape[0]
    n = b_q.shape[1]
    a_k, bt_k = kernel_operands(a_q, b_q)
    lib = _build.library("fp8_matmul")
    err = lib.fp8_matmul(
        a_k.data_ptr(), bt_k.data_ptr(), a_scale.data_ptr(),
        b_scale.data_ptr(), out.data_ptr(), m, n, a_k.shape[1], bm, bn,
        torch.cuda.current_stream(a_q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fp8_matmul kernel launch failed: CUDA error "
                           f"{err}")
