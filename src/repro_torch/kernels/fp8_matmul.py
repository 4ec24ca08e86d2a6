"""fp8 GEMM: the Hopper CUDA kernel (K6) and its plain version.

``fp8_matmul_cuda`` launches ``csrc/fp8_matmul.cu``, which replaces
``repro/kernels/fp8_matmul.py :: fp8_matmul_pallas``: a_q (M, K) and b_q
(K, N) e4m3 (``torch.float8_e4m3fn``), one f32 scale per bm-row block of
a and per bn-column block of b, f32 accumulation, the (M, N) f32 result
``acc · (a_scale[i / bm] · b_scale[j / bn])``.  It runs on the HPL-MxP
trailing update (``core.hpl.blocked_lu(matmul="fp8")`` through the
per-tensor ``core.mixed_precision.fp8_matmul``) and behind the per-block
``kernels.ops.fp8_matmul``.

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


def fp8_matmul_cuda(a_q, b_q, a_scale, b_scale, out: torch.Tensor, *,
                    bm: int, bn: int) -> None:
    """Launch the kernel on the current stream, writing ``out`` (M, N).
    The caller (``kernels.ops``) has checked devices, dtypes, shapes and
    contiguity.

    Raises:
      RuntimeError: the launch was refused (the CUDA error code)."""
    m, k = a_q.shape
    n = b_q.shape[1]
    lib = _build.library("fp8_matmul")
    err = lib.fp8_matmul(
        a_q.data_ptr(), b_q.data_ptr(), a_scale.data_ptr(),
        b_scale.data_ptr(), out.data_ptr(), m, n, k, bm, bn,
        torch.cuda.current_stream(a_q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fp8_matmul kernel launch failed: CUDA error "
                           f"{err}")
