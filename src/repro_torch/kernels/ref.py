"""Plain PyTorch oracles for the port's kernels (counterparts of
``repro.kernels.ref``), in the JAX package's layouts.

The kernel wrappers in ``kernels/ops.py`` take these for CPU tensors; the
tests hold them against the JAX oracles and the Pallas kernels, and
``chip_smoke.py`` holds the Hopper kernels against them on the card.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor, *,
                eps: float = 1e-6) -> torch.Tensor:
    """``x·rsqrt(mean(x²)+eps)·(1+w)`` in f32, cast back to ``x.dtype``."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + w.float())).to(x.dtype)


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         lengths: torch.Tensor) -> torch.Tensor:
    """Oracle for single-query decode. q: (BH, d); k/v: (BH, T, d);
    lengths: (BH,) valid-key counts.  Returns (BH, d) in q.dtype."""
    d = q.shape[-1]
    s = torch.einsum("bd,btd->bt", q.float(), k.float()) * (d ** -0.5)
    t = torch.arange(k.shape[1], device=k.device)[None, :]
    s = torch.where(t < lengths[:, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bt,btd->bd", p, v.float()).to(q.dtype)


def paged_decode_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                               v_pages: torch.Tensor, page_table: torch.Tensor,
                               lengths: torch.Tensor) -> torch.Tensor:
    """Oracle for paged decode: gather each row's pages into a contiguous
    cache, then dense decode.  q: (BH, d); k_pages/v_pages: (P, page, d);
    page_table: (BH, n) int32; lengths: (BH,)."""
    bh = q.shape[0]
    d = k_pages.shape[-1]
    pt = page_table.long()
    k = k_pages[pt].reshape(bh, -1, d)     # (BH, n*page, d)
    v = v_pages[pt].reshape(bh, -1, d)
    return decode_attention_ref(q, k, v, lengths)


def quantized_paged_decode_attention_ref(q, k_pages, v_pages, k_scale,
                                         v_scale, page_table, lengths):
    """Oracle for paged decode over quantized pools: dequantize every
    page with its per-slot scales, then run the f32 paged oracle.
    k_pages/v_pages: (P, page, d) uint8 (e4m3 bit patterns) or int8;
    k_scale/v_scale: (P, page) f32 — one scale per stored d-vector."""
    if k_pages.dtype == torch.uint8:
        k_pages = k_pages.view(torch.float8_e4m3fn)
        v_pages = v_pages.view(torch.float8_e4m3fn)
    k = k_pages.float() * k_scale[..., None]
    v = v_pages.float() * v_scale[..., None]
    return paged_decode_attention_ref(q, k, v, page_table, lengths)
