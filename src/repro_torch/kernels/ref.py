"""Plain PyTorch oracles for the port's kernels (counterparts of
``repro.kernels.ref``), in the JAX package's layouts.

The kernel wrappers in ``kernels/ops.py`` take these for CPU tensors; the
tests hold them against the JAX oracles and the Pallas kernels, and
``chip_smoke.py`` holds the Hopper kernels against them on the card.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def fp8_matmul_ref(a_q: torch.Tensor, b_q: torch.Tensor,
                   a_scale: torch.Tensor, b_scale: torch.Tensor, *,
                   bm: int = 128, bn: int = 128) -> torch.Tensor:
    """Dequantize-then-matmul oracle of the fp8 GEMM: ``a_scale[i]``
    applies to rows ``[i*bm, (i+1)*bm)`` and ``b_scale[j]`` to columns
    ``[j*bn, (j+1)*bn)``, so M and N must be exact multiples of the block
    sizes.  a_q (M, K) and b_q (K, N) e4m3; returns (M, N) f32, the f32
    product times ``(sa · sb)``.

    Raises:
      ValueError: M or N is not a multiple of its block."""
    m, n = a_q.shape[0], b_q.shape[1]
    for dim_name, dim, blk_name, blk in (("M", m, "bm", bm),
                                         ("N", n, "bn", bn)):
        if dim % blk != 0:
            raise ValueError(
                f"fp8_matmul_ref: {dim_name}={dim} is not a multiple of "
                f"{blk_name}={blk} (shapes a_q={tuple(a_q.shape)}, "
                f"b_q={tuple(b_q.shape)}); the per-block scale layout cannot "
                "cover a ragged edge — pad to block multiples first")
    sa = a_scale.float().repeat_interleave(bm)[:, None]
    sb = b_scale.float().repeat_interleave(bn)[None, :]
    out = a_q.float() @ b_q.float()
    return out * (sa * sb)


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor, *,
                eps: float = 1e-6) -> torch.Tensor:
    """``x·rsqrt(mean(x²)+eps)·(1+w)`` in f32, cast back to ``x.dtype``."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + w.float())).to(x.dtype)


def add_rmsnorm_ref(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor, *,
                    eps: float = 1e-6):
    """A residual add and the RMSNorm that reads its result, as the JAX
    model writes them (``x = x + mix; h = rms_norm(x)``): returns
    ``(s, rmsnorm_ref(s, w))`` with ``s = x + y``."""
    s = x + y
    return s, rmsnorm_ref(s, w, eps=eps)


def rmsnorm_qk_ref(q: torch.Tensor, k: torch.Tensor, wq: torch.Tensor,
                   wk: torch.Tensor, *, eps: float = 1e-6):
    """The q-norm and the k-norm of attention: ``(rmsnorm_ref(q, wq),
    rmsnorm_ref(k, wk))``."""
    return rmsnorm_ref(q, wq, eps=eps), rmsnorm_ref(k, wk, eps=eps)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window=None) -> torch.Tensor:
    """Dense-softmax oracle. q: (BH, Sq, d); k/v: (BH, Skv, d); query i
    keeps keys j <= i (causal) and j > i - window (window), positions
    counted from 0 on both sides.  Returns (BH, Sq, d) in q.dtype."""
    d = q.shape[-1]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * (d ** -0.5)
    qp = torch.arange(q.shape[1], device=q.device)[:, None]
    kp = torch.arange(k.shape[1], device=q.device)[None, :]
    keep = torch.ones_like(s[0], dtype=torch.bool)
    if causal:
        keep &= kp <= qp
    if window is not None:
        keep &= kp > qp - window
    s = torch.where(keep[None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def _decode_keep(k, lengths, window=None, starts=None):
    """(BH, T) bool: keys ``t < lengths``, and ``t >= lengths - window``
    with a window or ``t >= starts`` with starts."""
    t = torch.arange(k.shape[1], device=k.device)[None, :]
    keep = t < lengths[:, None]
    if window is not None:
        keep &= t >= lengths[:, None] - window
    if starts is not None:
        keep &= t >= starts[:, None]
    return keep


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         lengths: torch.Tensor, window=None,
                         starts=None) -> torch.Tensor:
    """Oracle for single-query decode. q: (BH, d); k/v: (BH, T, d);
    lengths: (BH,) valid-key counts; ``window`` keeps only the last
    ``window`` of them (keys ``t >= lengths - window``, the sliding-window
    mask of the query at ``lengths - 1``), ``starts`` (BH,) only keys
    ``t >= starts``.  Returns (BH, d) in q.dtype."""
    d = q.shape[-1]
    s = torch.einsum("bd,btd->bt", q.float(), k.float()) * (d ** -0.5)
    s = torch.where(_decode_keep(k, lengths, window, starts), s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bt,btd->bd", p, v.float()).to(q.dtype)


def decode_attention_lse_ref(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, lengths: torch.Tensor,
                             starts=None):
    """``decode_attention_ref``'s keys (``starts`` as there), with the
    state a merge over slices of the keys needs: ``(out (BH, d) f32,
    lse (BH,) f32)``, ``lse`` the natural-log log-sum-exp of the scaled
    scores of the kept keys and ``out`` the softmax over them times v;
    a row with no key has ``lse = -inf`` and ``out = 0``."""
    d = q.shape[-1]
    s = torch.einsum("bd,btd->bt", q.float(), k.float()) * (d ** -0.5)
    keep = _decode_keep(k, lengths, starts=starts)
    s = torch.where(keep, s, -torch.inf)
    lse = torch.logsumexp(s, dim=-1)
    safe = torch.where(torch.isfinite(lse), lse, 0.0)
    p = torch.where(keep, torch.exp(s - safe[:, None]), 0.0)
    return torch.einsum("bt,btd->bd", p, v.float()), lse


def paged_decode_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                               v_pages: torch.Tensor, page_table: torch.Tensor,
                               lengths: torch.Tensor,
                               window=None) -> torch.Tensor:
    """Oracle for paged decode: gather each row's pages into a contiguous
    cache, then dense decode.  q: (BH, d); k_pages/v_pages: (P, page, d);
    page_table: (BH, n) int32; lengths: (BH,); ``window`` as in
    ``decode_attention_ref``."""
    bh = q.shape[0]
    d = k_pages.shape[-1]
    pt = page_table.long()
    k = k_pages[pt].reshape(bh, -1, d)     # (BH, n*page, d)
    v = v_pages[pt].reshape(bh, -1, d)
    return decode_attention_ref(q, k, v, lengths, window)


def quantized_paged_decode_attention_ref(q, k_pages, v_pages, k_scale,
                                         v_scale, page_table, lengths,
                                         window=None):
    """Oracle for paged decode over quantized pools: dequantize every
    page with its per-slot scales, then run the f32 paged oracle.
    k_pages/v_pages: (P, page, d) uint8 (e4m3 bit patterns) or int8;
    k_scale/v_scale: (P, page) f32 — one scale per stored d-vector."""
    if k_pages.dtype == torch.uint8:
        k_pages = k_pages.view(torch.float8_e4m3fn)
        v_pages = v_pages.view(torch.float8_e4m3fn)
    k = k_pages.float() * k_scale[..., None]
    v = v_pages.float() * v_scale[..., None]
    return paged_decode_attention_ref(q, k, v, page_table, lengths, window)
