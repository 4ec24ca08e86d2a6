"""Attention of the port (counterpart of ``repro.models.attention``): GQA
with RoPE, optional qk-norm and sliding window, over a paged KV pool
(the paged engine) or a dense per-slot cache (the fixed-slot engine).

- ``paged_attention``: single-token decode (``C == 1``) goes through
  ``kernels.ops.paged_decode_attention`` (K1/K2), on sliding-window
  (``attn_local``) layers with the window, whose mask the JAX model
  computes with jnp on every backend; chunked prefill (C > 1) gathers the
  pages and attends densely, as the JAX model does.
- ``attention`` (full-sequence prefill): on the card the causal,
  windowed and non-causal self-attention (an encoder's) and the
  cross-attention (queries against ``x_kv``, the encoder's output) run
  ``kernels.ops.flash_attention`` (K5); on the CPU, or with
  ``impl="plain"``, the JAX model's query-chunked dense path runs
  unchanged, ``q_chunk`` included.
- ``decode_attention`` (fixed-slot decode): ``kernels.ops.decode_attention``
  (K4) with ``lengths = pos + 1``, the JAX mask ``kv_pos <= pos``, and on
  ``attn_local`` layers the window ``kv_pos > pos - W``; with ``cross``
  against the cached encoder K/V, every row of it.
- ``ring_decode_attention``: sliding-window decode against a ring buffer
  of W rows (``RunOptions.ring_local_cache``), slot = position mod W; K4
  over the filled slots on the card, the JAX function's mask elsewhere.

Where the JAX functions return new caches, the port writes K/V in place.

The two decode functions also run one rank's part of a serving cell over
a mesh (``launch.steps.build_cell``): ``tp`` splits the q heads over
"model" as in training, and ``seq`` (a ``parallel.sequence.SeqSplit``)
says that the cache holds this rank's slice of each seat's sequence.
Where the cache holds every KV head while q holds this rank's heads (the
sequence took "model", or "model" does not divide the KV heads), q and
the new K/V rows are gathered over "model" first and every head attends;
over a split sequence the row at ``pos`` is written by its owner, each
rank attends its rows (K4 with ``lse=``) and the ranks' states are
merged from their log-sum-exps (``parallel.sequence.merge_over``).
"""
from __future__ import annotations

import torch

from repro_torch.core import mixed_precision as mp
from repro_torch.kernels import ops
from repro_torch.models.modules import ParamSpec, rope
from repro_torch.parallel import sequence as seqmod

NEG_INF = -1e30


def attn_specs(cfg, *, cross: bool = False) -> dict:
    """Specs of one attention block; a cross-attention block (``cross``)
    never has the q- and k-norms."""
    d, h, kvh, hd = (cfg.d_model, cfg.padded_heads, cfg.padded_kv_heads,
                     cfg.resolved_head_dim)
    specs = {
        "wq": ParamSpec((d, h, hd), ("embed", "heads", "head_dim")),
        "wk": ParamSpec((d, kvh, hd), ("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((d, kvh, hd), ("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((h, hd, d), ("heads", "head_dim", "embed")),
    }
    if cfg.qk_norm and not cross:
        specs["q_norm"] = ParamSpec((hd,), ("head_dim",), "zeros")
        specs["k_norm"] = ParamSpec((hd,), ("head_dim",), "zeros")
    return specs


def _head_mask(cfg, out, first: int = 0):
    """Zero the padded heads (cfg.pad_heads_to), keeping the padded model
    exactly equal to the assigned config; ``out``'s heads are heads
    ``first, first + 1, ...`` of the padded model (a tensor-parallel
    rank's slice)."""
    if cfg.pad_heads_to is None:
        return out
    mask = (torch.arange(first, first + out.shape[2], device=out.device)
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
        q, k = ops.rmsnorm_qk(q, k, p["q_norm"], p["k_norm"],
                              eps=cfg.norm_eps, impl=impl)
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


def _window(cfg, kind: str):
    """The sliding window of a layer of ``kind``: ``cfg.sliding_window``
    on ``attn_local`` layers, else None."""
    return cfg.sliding_window if kind == "attn_local" else None


def _out_proj(p, cfg, x, out, first: int = 0):
    """The attention output (rows, C, H, hd) in x's dtype, padded heads
    zeroed (``first``: see ``_head_mask``), through ``wo``: (rows, C,
    D)."""
    out = _head_mask(cfg, out.to(x.dtype), first)
    wo = p["wo"].to(x.dtype)
    return out.reshape(*x.shape[:2], -1) @ wo.reshape(-1, wo.shape[-1])


def _split_heads(p, cfg, tp):
    """A tensor-parallel block's leaves as this rank's heads read them,
    and the index of its first q head: the q/k-norms, whole on every
    rank, through ``tp.copy`` (their gradients are summed over the
    ranks); where "model" does not divide the KV heads (``wk``/``wv``
    whole, the GQA fallback) the KV heads that q heads ``first ..`` read
    (head h reads KV head h // group), through ``tp.copy`` too: a
    contiguous slice where each is read by as many of them, else one KV
    head per q head."""
    hl = p["wq"].shape[1]
    first = tp.offset(hl)
    p = dict(p)
    for key in ("q_norm", "k_norm"):
        if key in p:
            p[key] = tp.copy(p[key])
    if tp.split(p["wk"].shape[1], cfg.padded_kv_heads) is None:
        group = cfg.padded_heads // cfg.padded_kv_heads
        kv = [(first + j) // group for j in range(hl)]
        lo, n = kv[0], kv[-1] + 1 - kv[0]
        even = hl % n == 0 and kv == [lo + j // (hl // n) for j in range(hl)]
        for key in ("wk", "wv"):
            w = tp.copy(p[key])
            p[key] = w[:, lo:lo + n] if even else w[:, kv]
    return p, first


def attention(p, cfg, x, *, kind: str = "attn", causal: bool = True,
              x_kv=None, q_chunk: int = 1024, impl: str = "auto", tp=None,
              whole_kv: bool = False):
    """Full-sequence (prefill) attention of queries at positions
    ``0..S-1``.

    x: (B, S, D).  kind: ``"attn"`` (global) or ``"attn_local"``
    (sliding window ``cfg.sliding_window``); ``causal=False`` keeps every
    key (an encoder's self-attention, RoPE at 0..S-1 on q and k).
    ``x_kv`` (B, L, D) makes it cross-attention: K/V are projected from
    ``x_kv``, neither q nor k is rotated and every query keeps every key.
    ``impl`` picks the flash kernel (``kernels.ops``; ``auto`` = the
    kernel on CUDA) or the query-chunked dense path of the JAX model.

    ``tp`` (a ``parallel.tensor.TensorParallel``), where given and the
    block's ``wq`` holds this rank's slice of the heads, runs the block
    tensor-parallel: ``x`` enters through ``tp.copy`` (``x_kv`` is the
    caller's to pass through it, once for every block that reads it),
    this rank's q heads attend (``_split_heads``), and the output
    projection of its heads is summed over the ranks (``tp.reduce``).

    Returns ``(out (B, S, D), (k, v))``, k/v ``(B, S or L, KVH, hd)`` to
    seed the cache (this rank's KV heads under ``tp``; where "model" does
    not divide the KV heads, the ones this rank's q heads read, or with
    ``whole_kv`` every KV head, as a serving cell's cache holds them)."""
    B, S, _ = x.shape
    cross = x_kv is not None
    if tp is not None:
        tp = tp.split(p["wq"].shape[1], cfg.padded_heads)
    first, kv_whole = 0, None
    if tp is not None:
        if whole_kv and tp.split(p["wk"].shape[1],
                                 cfg.padded_kv_heads) is None:
            kv_whole = {key: tp.copy(p[key]) for key in ("wk", "wv")}
        p, first = _split_heads(p, cfg, tp)
        x = tp.copy(x)
    xkv = x_kv if cross else x
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device).expand(B, S)
    kv_positions = torch.arange(xkv.shape[1], dtype=torch.int32,
                                device=x.device).expand(B, -1)
    q, k, v = _project_qkv(p, cfg, x, xkv, positions, kv_positions,
                           use_rope=not cross, impl=impl)
    causal = causal and not cross
    hd = cfg.resolved_head_dim
    window = _window(cfg, kind)
    if ops.use_kernel(impl, q):
        out = ops.flash_attention(q, k, v, causal=causal, window=window,
                                  impl=impl)
    else:
        def keep(qp):
            kp = kv_positions[:, None, :]
            mask = torch.ones((B, qp.shape[1], kp.shape[2]), dtype=torch.bool,
                              device=x.device)
            if causal:
                mask &= kp <= qp[:, :, None]
            if window is not None:
                mask &= kp > qp[:, :, None] - window
            return mask

        n_chunks = S // q_chunk if (S % q_chunk == 0 and S > q_chunk) else 1
        out = torch.cat([
            _gqa_attend(qc, k, v, keep(pc), hd ** -0.5)
            for qc, pc in zip(q.chunk(n_chunks, dim=1),
                              positions.chunk(n_chunks, dim=1))], dim=1)
    out = _out_proj(p, cfg, x, out, first)
    if kv_whole is not None:
        _, k, v = _project_qkv({**p, **kv_whole}, cfg, x, xkv, positions,
                               kv_positions, use_rope=not cross, impl=impl)
    return (out if tp is None else tp.reduce(out)), (k, v)


def _serving_heads(p, cfg, tp, cache_kv: int):
    """``(tp, first, gather)`` of a decode block on this rank: ``tp`` the
    "model" group where it splits the block's q heads (else None),
    ``first`` the index of this rank's first q head, ``gather`` whether
    q must be gathered over "model" because the cache holds every KV
    head (``cache_kv`` of them) while q holds this rank's heads."""
    if tp is None:
        return None, 0, False
    hl = p["wq"].shape[1]
    tp = tp.split(hl, cfg.padded_heads)
    if tp is None:
        return None, 0, False
    return tp, tp.offset(hl), tp.n > 1 and cache_kv == cfg.padded_kv_heads


def _decode_qkv(p, cfg, x, pos, cache_kv: int, tp, gather: bool, impl):
    """q, k_new, v_new of one decode step with the heads the cache and the
    attention read: q gathered over "model" where ``gather``, and the new
    K/V rows wherever this rank projected fewer KV heads than the cache
    holds."""
    q, k_new, v_new = _project_qkv(p, cfg, x, x, pos[:, None], pos[:, None],
                                   impl=impl)
    if gather:
        q = tp.gather(q, 2)
    if k_new.shape[2] != cache_kv:
        k_new, v_new = tp.gather(k_new, 2), tp.gather(v_new, 2)
    return q, k_new, v_new


def _serving_out(p, cfg, x, out, tp, first: int, gather: bool):
    """The block's output for the attention output ``out``: this rank's
    heads of it (all of them were computed where ``gather``), through its
    ``wo`` slice and summed over "model" where ``tp`` splits the heads."""
    if gather:
        out = out[:, :, first:first + p["wq"].shape[1]]
    out = _out_proj(p, cfg, x, out, first)
    return out if tp is None else tp.reduce(out)


def _write_owned(cache_k, cache_v, rows, seq, k_new, v_new):
    """The new K/V row of each seat written at global row ``rows`` (B,)
    of a sequence split over ``seq``'s ranks, where this rank holds it
    (``parallel.sequence.write_owned``).  Returns ``(lo, n)``: this
    rank's first row and its count of rows."""
    n = cache_k.shape[1]
    lo, _ = seq.rows(n)
    local, mine = seqmod.owner_rows(rows, lo, n)
    seqmod.write_owned(cache_k, local, mine, k_new[:, 0])
    seqmod.write_owned(cache_v, local, mine, v_new[:, 0])
    return lo, n


def _split_attend(q, k, v, lengths, starts, seq, impl: str):
    """Attention of q (B, 1, H, d) to this rank's rows of a sequence split
    over ``seq``'s ranks (local ``lengths`` and ``starts``): K4, or its
    plain version, with ``lse=``, and the ranks' states merged in f32;
    (B, 1, H, d) in q's dtype."""
    B, _, H, _ = q.shape
    lse = torch.empty((B, H), dtype=torch.float32, device=q.device)
    out = ops.decode_attention(q, k, v, lengths, starts=starts, lse=lse,
                               impl=impl)
    out, _ = seqmod.merge_over(out[:, 0], lse, seq)
    return out[:, None].to(q.dtype)


def decode_attention(p, cfg, x, cache_k, cache_v, pos, *, kind: str = "attn",
                     cross: bool = False, lengths=None, impl: str = "auto",
                     tp=None, seq=None):
    """Single-token decode against a dense cache.

    x: (B, 1, D); cache_k/cache_v: (B, T, KVH, hd) one layer's cache;
    pos: (B,) int32 write position of each seat.  The new K/V are written
    at ``pos`` **in place** (the JAX function returns new caches), then
    every query attends to the keys at positions ``<= pos`` (and inside
    the window on ``attn_local`` layers).  With ``cross`` the cache holds
    the encoder's K/V (``ck``/``cv``), read and never written: q is
    ``x @ wq``, neither normed nor rotated, and attends to all T rows
    (``pos`` unread); ``lengths`` (B,) int32 of T each, built here when
    None, lets a caller build it once for all its layers.

    ``tp`` and ``seq``: one rank's part of a serving cell over a mesh
    (the module's docstring): with ``seq`` the cache holds rows ``[lo,
    hi)`` of each seat's sequence (``seq.rows``); the row at ``pos`` is
    written where this rank holds it, the query keeps local keys below
    ``pos + 1 - lo`` (on an ``attn_local`` layer from ``pos + 1 - W -
    lo`` on, K4's ``starts``) and the ranks' states are merged.  Returns
    ``(out (B, 1, D), cache_k, cache_v)``."""
    B = x.shape[0]
    tp, first, gather = _serving_heads(p, cfg, tp, cache_k.shape[2])
    if cross:
        q = _proj(x, p["wq"])
        if gather:
            q = tp.gather(q, 2)
        if lengths is None:
            lengths = torch.full((B,), cache_k.shape[1], dtype=torch.int32,
                                 device=x.device)
        out = ops.decode_attention(q, cache_k, cache_v, lengths, impl=impl)
        return (_serving_out(p, cfg, x, out, tp, first, gather), cache_k,
                cache_v)
    q, k_new, v_new = _decode_qkv(p, cfg, x, pos, cache_k.shape[2], tp,
                                  gather, impl)
    window = _window(cfg, kind)
    if seq is None:
        seat = torch.arange(B, device=x.device)
        cache_k[seat, pos.long()] = k_new[:, 0].to(cache_k.dtype)
        cache_v[seat, pos.long()] = v_new[:, 0].to(cache_v.dtype)
        out = ops.decode_attention(q, cache_k, cache_v, pos + 1,
                                   window=window, impl=impl)
    else:
        lo, n = _write_owned(cache_k, cache_v, pos, seq, k_new, v_new)
        lengths, starts = seqmod.local_bounds(pos, lo, n, window)
        out = _split_attend(q, cache_k, cache_v, lengths, starts, seq, impl)
    return _serving_out(p, cfg, x, out, tp, first, gather), cache_k, cache_v


def ring_decode_attention(p, cfg, x, cache_k, cache_v, pos, *,
                          impl: str = "auto", tp=None, seq=None):
    """Sliding-window decode against a ring buffer of W rows.

    x: (B, 1, D); cache_k/cache_v: (B, W, KVH, hd) one local layer's ring,
    slot = position mod W; pos: (B,) int32 write position.  The new K/V
    are written at slot ``pos % W`` **in place**, then the query attends
    to every filled slot: on the card the dense kernel (K4) over the
    first ``min(pos + 1, W)`` slots (a softmax over a set does not depend
    on its keys' order, and RoPE was applied before storage); elsewhere,
    or with ``impl="plain"``, the JAX function's mask over the position
    each slot holds, ``pos - ((pos - j) mod W) >= 0``.  ``tp`` and
    ``seq`` as in ``decode_attention``: with ``seq`` this rank holds
    slots ``[lo, hi)`` of the ring of ``W = (hi - lo) · seq.n``; slot
    ``pos mod W`` is written by its owner, and the valid slots are those
    below ``min(pos + 1, W)``.  Returns ``(out (B, 1, D), cache_k,
    cache_v)``."""
    B = x.shape[0]
    tp, first, gather = _serving_heads(p, cfg, tp, cache_k.shape[2])
    q, k_new, v_new = _decode_qkv(p, cfg, x, pos, cache_k.shape[2], tp,
                                  gather, impl)
    if seq is not None:
        W = cache_k.shape[1] * seq.n
        lo, n = _write_owned(cache_k, cache_v, torch.remainder(pos, W), seq,
                             k_new, v_new)
        lengths, _ = seqmod.local_bounds(torch.clamp(pos, max=W - 1), lo, n)
        out = _split_attend(q, cache_k, cache_v, lengths, None, seq, impl)
        return (_serving_out(p, cfg, x, out, tp, first, gather), cache_k,
                cache_v)
    W = cache_k.shape[1]
    seat = torch.arange(B, device=x.device)
    slot = torch.remainder(pos, W).long()
    cache_k[seat, slot] = k_new[:, 0].to(cache_k.dtype)
    cache_v[seat, slot] = v_new[:, 0].to(cache_v.dtype)
    if ops.use_kernel(impl, q):
        out = ops.decode_attention(q, cache_k, cache_v,
                                   torch.clamp(pos + 1, max=W), impl=impl)
    else:
        j = torch.arange(W, dtype=torch.int32, device=x.device)[None, :]
        kv_pos = pos[:, None] - torch.remainder(pos[:, None] - j, W)
        out = _gqa_attend(q, cache_k, cache_v, (kv_pos >= 0)[:, None, :],
                          cfg.resolved_head_dim ** -0.5)
    return _serving_out(p, cfg, x, out, tp, first, gather), cache_k, cache_v


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
    if C == 1:
        out = ops.paged_decode_attention(
            q, k_pool, v_pool, page_table, qpos[:, 0] + 1,
            k_scale=kv_entry["ks"] if quantized else None,
            v_scale=kv_entry["vs"] if quantized else None,
            window=_window(cfg, kind), impl=impl)
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
        window = _window(cfg, kind)
        if window is not None:
            keep &= kv_pos[None, None, :] > qpos[:, :, None] - window
        out = _gqa_attend(q, k, v, keep, hd ** -0.5)
    # a pool stored above the compute dtype (e.g. f32 under bf16 compute)
    # attends at pool precision; the residual stream stays in compute dtype
    return _out_proj(p, cfg, x, out)
