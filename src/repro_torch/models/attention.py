"""Paged attention of the port (counterpart of the paged subset of
``repro.models.attention``): GQA with RoPE, optional qk-norm and sliding
window, against a shared pool of KV pages.

Single-token decode on global layers (``C == 1 and kind == "attn"``, the
JAX model's Pallas condition) goes through ``kernels.ops.
paged_decode_attention``: the CUDA kernel on the card.  Chunked prefill
(C > 1) and sliding-window layers gather the pages and attend densely,
as the JAX model does on every backend.
"""
from __future__ import annotations

import torch

from repro_torch.core import mixed_precision as mp
from repro_torch.kernels import ops
from repro_torch.models.modules import ParamSpec, rope

NEG_INF = -1e30


def attn_specs(cfg) -> dict:
    d, h, kvh, hd = (cfg.d_model, cfg.padded_heads, cfg.padded_kv_heads,
                     cfg.resolved_head_dim)
    specs = {
        "wq": ParamSpec((d, h, hd), ("embed", "heads", "head_dim")),
        "wk": ParamSpec((d, kvh, hd), ("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((d, kvh, hd), ("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((h, hd, d), ("heads", "head_dim", "embed")),
    }
    if cfg.qk_norm:
        specs["q_norm"] = ParamSpec((hd,), ("head_dim",), "zeros")
        specs["k_norm"] = ParamSpec((hd,), ("head_dim",), "zeros")
    return specs


def _head_mask(cfg, out):
    """Zero the padded heads (cfg.pad_heads_to), keeping the padded model
    exactly equal to the assigned config."""
    if cfg.pad_heads_to is None:
        return out
    mask = (torch.arange(cfg.padded_heads, device=out.device)
            < cfg.num_heads).to(out.dtype)
    return out * mask[None, None, :, None]


def _proj(x, w):
    """``einsum("bsd,dhk->bshk")`` as one matmul: x (B, S, D) against
    w (D, heads, hd) in x's dtype."""
    D, h, k = w.shape
    return (x @ w.to(x.dtype).reshape(D, h * k)).reshape(*x.shape[:-1], h, k)


def _project_qkv(p, cfg, xq, xkv, positions_q, positions_kv, *,
                 use_rope=True, impl="auto"):
    q = _proj(xq, p["wq"])
    k = _proj(xkv, p["wk"])
    v = _proj(xkv, p["wv"])
    if "q_norm" in p:
        q = ops.rmsnorm(q, p["q_norm"], eps=cfg.norm_eps, impl=impl)
        k = ops.rmsnorm(k, p["k_norm"], eps=cfg.norm_eps, impl=impl)
    if use_rope:
        q = rope(q, positions_q, cfg.rope_theta)
        k = rope(k, positions_kv, cfg.rope_theta)
    return q, k, v


def _gqa_attend(q, k, v, keep, scale):
    """q: (B,Sq,H,hd); k,v: (B,T,KVH,hd); keep: (B,Sq,T) bool.  Mixed
    dtypes promote as in jnp.einsum (a pool stored above the compute
    dtype attends at pool precision)."""
    B, Sq, H, hd = q.shape
    KVH = k.shape[2]
    G = H // KVH
    qg = q.reshape(B, Sq, KVH, G, hd)
    ct = torch.promote_types(q.dtype, k.dtype)
    scores = torch.einsum("bsngd,btnd->bngst", qg.to(ct), k.to(ct)) * scale
    scores = torch.where(keep[:, None, None], scores.float(), NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    ct = torch.promote_types(q.dtype, v.dtype)
    out = torch.einsum("bngst,btnd->bsngd", probs.to(ct), v.to(ct))
    return out.reshape(B, Sq, H, hd)


def paged_attention(p, cfg, x, kv_entry, page_table, qpos, n_valid, *,
                    kind: str = "attn", impl: str = "auto"):
    """Attention against a paged KV pool (serving decode + chunked prefill).

    x: (A, C, D) — A seats, each advancing by up to C tokens;
    kv_entry: one layer's ``{"k", "v"}`` pools (P, page, KVH, hd), plus
       ``{"ks", "vs"}`` (P, page, KVH) f32 scales for fp8/int8 pools;
       page 0 is the scratch page that idle seats and chunk padding
       write to;
    page_table: (A, n) int32; qpos: (A, C) int32 absolute positions;
    n_valid: (A,) int32 — how many of the C tokens are real.

    The new K/V are written into the pool **in place** before attending
    (the JAX function returns a new pool instead), quantizing each
    (token, head) vector for quantized pools.  Returns out (A, C, D).
    """
    A, C, _ = x.shape
    k_pool, v_pool = kv_entry["k"], kv_entry["v"]
    quantized = "ks" in kv_entry
    page = k_pool.shape[1]
    n = page_table.shape[1]
    q, k_new, v_new = _project_qkv(p, cfg, x, x, qpos, qpos, impl=impl)

    valid_tok = (torch.arange(C, dtype=torch.int32, device=x.device)[None, :]
                 < n_valid[:, None])
    blk = torch.clamp(qpos // page, 0, n - 1).long()
    phys = torch.gather(page_table, 1, blk)                     # (A, C)
    phys = torch.where(valid_tok, phys, 0).long()               # -> scratch
    off = torch.where(valid_tok, qpos % page, 0).long()
    if quantized:
        kv_dtype = "fp8" if k_pool.dtype == torch.uint8 else "int8"
        kq, ks = mp.quantize_kv_page(k_new, kv_dtype)
        vq, vs = mp.quantize_kv_page(v_new, kv_dtype)
        k_pool[phys, off] = kq
        v_pool[phys, off] = vq
        kv_entry["ks"][phys, off] = ks
        kv_entry["vs"][phys, off] = vs
    else:
        k_pool[phys, off] = k_new.to(k_pool.dtype)
        v_pool[phys, off] = v_new.to(v_pool.dtype)

    hd = cfg.resolved_head_dim
    if C == 1 and kind == "attn":
        out = ops.paged_decode_attention(
            q, k_pool, v_pool, page_table, qpos[:, 0] + 1,
            k_scale=kv_entry["ks"] if quantized else None,
            v_scale=kv_entry["vs"] if quantized else None, impl=impl)
    else:
        pt = page_table.long()
        if quantized:
            kd = mp.dequantize_kv_page(k_pool[pt], kv_entry["ks"][pt])
            vd = mp.dequantize_kv_page(v_pool[pt], kv_entry["vs"][pt])
            kd, vd = kd.to(q.dtype), vd.to(q.dtype)
        else:
            kd, vd = k_pool[pt], v_pool[pt]
        k = kd.reshape(A, n * page, *kd.shape[3:])
        v = vd.reshape(A, n * page, *vd.shape[3:])
        kv_pos = torch.arange(n * page, dtype=torch.int32, device=x.device)
        keep = kv_pos[None, None, :] <= qpos[:, :, None]           # (A, C, T)
        if kind == "attn_local" and cfg.sliding_window is not None:
            keep &= kv_pos[None, None, :] > (qpos[:, :, None]
                                             - cfg.sliding_window)
        out = _gqa_attend(q, k, v, keep, hd ** -0.5)
    # a pool stored above the compute dtype (e.g. f32 under bf16 compute)
    # attends at pool precision; the residual stream stays in compute dtype
    out = _head_mask(cfg, out.to(x.dtype))
    wo = p["wo"].to(x.dtype)
    return out.reshape(A, C, -1) @ wo.reshape(-1, wo.shape[-1])
