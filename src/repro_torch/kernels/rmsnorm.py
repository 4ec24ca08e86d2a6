"""Fused RMSNorm: the Triton kernel and its plain version.

``rmsnorm_triton`` replaces ``repro/kernels/rmsnorm.py :: rmsnorm_pallas``:
``x·rsqrt(mean(x²)+eps)·(1+w)`` in f32, cast back to ``x.dtype``, one
program per row with the whole row in one block (``BLOCK =
next_pow2(D)``).  It is bound by memory: one read of the row, one write
of the result, where eager PyTorch would chain about five launches that
each move the row again.  Triton is imported, and the kernel compiled,
at the first launch, never at import.

``rmsnorm_plain`` (the oracle of ``kernels/ref.py``) is the same function
in plain PyTorch, for CPU tensors and for the checks on the card.
"""
import functools

import torch

from repro_torch.kernels.ref import rmsnorm_ref as rmsnorm_plain  # noqa: F401

tl = None     # triton.language, bound by _kernel() at the first launch


@functools.cache
def _kernel():
    global tl
    import triton
    import triton.language as tl

    @triton.jit
    def rmsnorm_rows(x_ptr, w_ptr, y_ptr, n_cols, eps, BLOCK: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        cols = tl.arange(0, BLOCK)
        mask = cols < n_cols
        x = tl.load(x_ptr + row * n_cols + cols, mask=mask,
                    other=0.0).to(tl.float32)
        var = tl.sum(x * x, axis=0) / n_cols
        y = x * tl.rsqrt(var + eps)
        w = tl.load(w_ptr + cols, mask=mask, other=0.0).to(tl.float32)
        tl.store(y_ptr + row * n_cols + cols,
                 (y * (1.0 + w)).to(y_ptr.dtype.element_ty), mask=mask)

    return rmsnorm_rows


def rmsnorm_triton(x: torch.Tensor, w: torch.Tensor, out: torch.Tensor,
                   eps: float) -> None:
    """Launch on the current stream: x, out ``(M, D)`` contiguous on the
    card, w ``(D,)``.  The caller (``kernels.ops``) has checked them."""
    m, d = x.shape
    block = 1 << (d - 1).bit_length()
    _kernel()[(m,)](x, w, out, d, eps, BLOCK=block,
                    num_warps=min(max(block // 256, 1), 8))
