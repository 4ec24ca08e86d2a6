"""Fused RMSNorm: the Triton kernels and their plain versions.

``rmsnorm_triton`` replaces ``repro/kernels/rmsnorm.py :: rmsnorm_pallas``:
``x·rsqrt(mean(x²)+eps)·(1+w)`` in f32, cast back to ``x.dtype``, one
program per row with the whole row in one block (``BLOCK =
next_pow2(D)``).  It is bound by memory: one read of the row, one write
of the result, where eager PyTorch would chain about five launches that
each move the row again.

At the model's widths a norm moves a few kilobytes and takes the card's
floor for any launch, about a hundred times its byte bound, so the two
fused kernels save launches rather than bytes; each computes the same
norm on the same rows as the first:

- ``add_rmsnorm_triton``: the residual add and the norm that reads its
  result (``s = x + y`` rounded to ``x.dtype``, as the JAX model's ``x =
  x + mix`` rounds it, then the norm of ``s``), writing both ``s`` and
  the norm; one launch where eager PyTorch makes two;
- ``rmsnorm_qk_triton``: attention's q-norm and k-norm, the q rows and
  the k rows with their own weights, in one launch instead of two.

Triton is imported, and a kernel compiled, at its first launch, never at
import.  The plain versions (the oracles of ``kernels/ref.py``) are the
same functions in plain PyTorch, for CPU tensors and for the checks on
the card.
"""
import functools

import torch

from repro_torch.kernels.ref import (  # noqa: F401
    add_rmsnorm_ref as add_rmsnorm_plain, rmsnorm_qk_ref as rmsnorm_qk_plain,
    rmsnorm_ref as rmsnorm_plain)

tl = None     # triton.language, bound by _kernels() at the first launch


@functools.cache
def _kernels():
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

    @triton.jit
    def add_rmsnorm_rows(x_ptr, r_ptr, w_ptr, s_ptr, y_ptr, n_cols, eps,
                         BLOCK: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        cols = tl.arange(0, BLOCK)
        mask = cols < n_cols
        at = row * n_cols + cols
        x = tl.load(x_ptr + at, mask=mask, other=0.0).to(tl.float32)
        r = tl.load(r_ptr + at, mask=mask, other=0.0).to(tl.float32)
        # the sum rounded to the stored type, as torch's and XLA's add
        # round it; the norm reads the rounded value
        s = (x + r).to(s_ptr.dtype.element_ty)
        tl.store(s_ptr + at, s, mask=mask)
        s = s.to(tl.float32)
        var = tl.sum(s * s, axis=0) / n_cols
        y = s * tl.rsqrt(var + eps)
        w = tl.load(w_ptr + cols, mask=mask, other=0.0).to(tl.float32)
        tl.store(y_ptr + at, (y * (1.0 + w)).to(y_ptr.dtype.element_ty),
                 mask=mask)

    @triton.jit
    def rmsnorm_qk_rows(q_ptr, k_ptr, wq_ptr, wk_ptr, qo_ptr, ko_ptr, m_q,
                        n_cols, eps, BLOCK: tl.constexpr):
        # programs [0, m_q) take the q rows, the rest the k rows; the
        # other tensor's loads and stores are masked off
        pid = tl.program_id(0)
        is_q = pid < m_q
        rq = tl.minimum(pid, m_q - 1).to(tl.int64) * n_cols
        rk = tl.maximum(pid - m_q, 0).to(tl.int64) * n_cols
        cols = tl.arange(0, BLOCK)
        mask = cols < n_cols
        mq = mask & is_q
        mk = mask & (pid >= m_q)
        x = tl.where(is_q,
                     tl.load(q_ptr + rq + cols, mask=mq, other=0.0),
                     tl.load(k_ptr + rk + cols, mask=mk,
                             other=0.0)).to(tl.float32)
        w = tl.where(is_q, tl.load(wq_ptr + cols, mask=mq, other=0.0),
                     tl.load(wk_ptr + cols, mask=mk,
                             other=0.0)).to(tl.float32)
        var = tl.sum(x * x, axis=0) / n_cols
        y = (x * tl.rsqrt(var + eps) * (1.0 + w)).to(
            qo_ptr.dtype.element_ty)
        tl.store(qo_ptr + rq + cols, y, mask=mq)
        tl.store(ko_ptr + rk + cols, y, mask=mk)

    return rmsnorm_rows, add_rmsnorm_rows, rmsnorm_qk_rows


def _launch_shape(d: int):
    """``BLOCK`` (the row in one block) and ``num_warps`` for width d."""
    block = 1 << (d - 1).bit_length()
    return block, min(max(block // 256, 1), 8)


def rmsnorm_triton(x: torch.Tensor, w: torch.Tensor, out: torch.Tensor,
                   eps: float) -> None:
    """Launch on the current stream: x, out ``(M, D)`` contiguous on the
    card, w ``(D,)``.  The caller (``kernels.ops``) has checked them."""
    m, d = x.shape
    block, warps = _launch_shape(d)
    _kernels()[0][(m,)](x, w, out, d, eps, BLOCK=block, num_warps=warps)


def add_rmsnorm_triton(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                       s: torch.Tensor, out: torch.Tensor,
                       eps: float) -> None:
    """Launch on the current stream: x, y, s, out ``(M, D)`` contiguous
    on the card, one dtype; w ``(D,)``.  Writes ``s = x + y`` and its
    norm ``out``.  The caller (``kernels.ops``) has checked them."""
    m, d = x.shape
    block, warps = _launch_shape(d)
    _kernels()[1][(m,)](x, y, w, s, out, d, eps, BLOCK=block,
                        num_warps=warps)


def rmsnorm_qk_triton(q: torch.Tensor, k: torch.Tensor, wq: torch.Tensor,
                      wk: torch.Tensor, q_out: torch.Tensor,
                      k_out: torch.Tensor, eps: float) -> None:
    """Launch on the current stream: q, q_out ``(Mq, D)`` and k, k_out
    ``(Mk, D)`` contiguous on the card, one dtype; wq, wk ``(D,)``, one
    dtype.  The caller (``kernels.ops``) has checked them."""
    mq, d = q.shape
    block, warps = _launch_shape(d)
    _kernels()[2][(mq + k.shape[0],)](q, k, wq, wk, q_out, k_out, mq, d,
                                      eps, BLOCK=block, num_warps=warps)
