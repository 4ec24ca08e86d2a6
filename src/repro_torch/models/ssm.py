"""Mamba-2 (SSD, state-space duality) block of the port (counterpart of
``repro.models.ssm``), in plain PyTorch: the reference has no Pallas
kernel here.

Prefill runs the chunked SSD algorithm (arXiv:2405.21060): within a
chunk the quadratic "attention-like" term, across chunks the recurrent
state.  The reference carries that state with ``jax.lax.associative_scan``;
the port runs the same recurrence as a loop over the chunks, which is
the same function summed in another order.  Decode is the O(1)-per-token
recurrence on the (B, H, N, P) state.  The gated norm goes through
``kernels.ops.rmsnorm`` (K3).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.modules import ParamSpec


def ssm_dims(cfg):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    nheads = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.n_groups * s.d_state
    return d_inner, nheads, conv_dim


def ssm_specs(cfg) -> dict:
    s = cfg.ssm
    d = cfg.d_model
    d_inner, nheads, conv_dim = ssm_dims(cfg)
    d_in_proj = 2 * d_inner + 2 * s.n_groups * s.d_state + nheads
    return {
        "in_proj": ParamSpec((d, d_in_proj), ("embed", "ssm_inner")),
        "conv_w": ParamSpec((s.conv_width, conv_dim),
                            ("conv_width", "ssm_inner")),
        "conv_b": ParamSpec((conv_dim,), ("ssm_inner",), "zeros"),
        "A_log": ParamSpec((nheads,), ("ssm_heads",), "ones"),
        "D": ParamSpec((nheads,), ("ssm_heads",), "ones"),
        "dt_bias": ParamSpec((nheads,), ("ssm_heads",), "zeros"),
        "norm": ParamSpec((d_inner,), ("ssm_inner",), "zeros"),
        "out_proj": ParamSpec((d_inner, d), ("ssm_inner", "embed")),
    }


def _split_zxbcdt(cfg, zxbcdt):
    """``(z, x, B, C, dt)`` of the in-projection's last axis (the
    reference's ``jnp.split`` at indices; ``torch.split`` takes sizes)."""
    s = cfg.ssm
    d_inner, nheads, _ = ssm_dims(cfg)
    gs = s.n_groups * s.d_state
    return torch.split(zxbcdt, [d_inner, d_inner, gs, gs, nheads], dim=-1)


def _causal_conv(x, w, b, *, init_state=None):
    """Depthwise causal conv of width W. x: (B, S, C); w: (W, C).
    Returns ``(y, tail)``, ``tail`` the last W - 1 input rows (the
    ``init_state`` rows included), all in ``x.dtype``; the W products
    are summed in index order, as the reference's Python ``sum``."""
    W = w.shape[0]
    if init_state is None:
        pad = x.new_zeros((x.shape[0], W - 1, x.shape[2]))
    else:
        pad = init_state
    xp = torch.cat([pad, x], dim=1)
    S = x.shape[1]
    y = sum(xp[:, i:i + S] * w[i].to(x.dtype) for i in range(W))
    tail = xp[:, xp.shape[1] - (W - 1):]
    return y + b.to(x.dtype), tail


def _ssd_chunked(xh, dt, A, Bm, Cm, chunk: int):
    """Chunked SSD. xh: (B, S, H, P); dt: (B, S, H); A: (H,); Bm, Cm:
    (B, S, G, N); S a multiple of ``chunk``.

    Returns ``(y (B, S, H, P), final_state (B, H, N, P))``."""
    B, S, H, P = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    assert S % chunk == 0, (S, chunk)
    nc = S // chunk
    rep = H // G

    def cshape(t):  # (B, S, ...) -> (B, nc, chunk, ...)
        return t.reshape(B, nc, chunk, *t.shape[2:])

    xh_, dt_, B_, C_ = map(cshape, (xh, dt, Bm, Cm))
    dA = dt_ * A                                         # (B,nc,L,H) negative
    dA_cs = torch.cumsum(dA, dim=2)                      # within-chunk cumsum

    # intra-chunk (quadratic in the chunk's length): mask s >= t, decay
    # exp(dAcs_s - dAcs_t); group -> head repeats each group (jnp.repeat)
    Bh = B_.repeat_interleave(rep, dim=3)                # (B,nc,L,H,N)
    Ch = C_.repeat_interleave(rep, dim=3)
    scores = torch.einsum("bclhn,bcthn->bchlt", Ch, Bh)  # (B,nc,H,L,T)
    dh = dA_cs.permute(0, 1, 3, 2)                       # (B,nc,H,L)
    diff = dh[..., :, None] - dh[..., None, :]           # (B,nc,H,L,T)
    li = torch.arange(chunk, device=xh.device)
    causal = li[:, None] >= li[None, :]
    # mask BEFORE exp: above-diagonal diffs are positive and would overflow
    decay = torch.exp(torch.where(causal, diff, -torch.inf))
    M = scores * decay.to(scores.dtype)
    Mdt = M * dt_.permute(0, 1, 3, 2)[..., None, :].to(scores.dtype)
    y_intra = torch.einsum("bchlt,bcthp->bclhp", Mdt, xh_)

    # chunk summary states: h_c = sum_t exp(dAcs_L - dAcs_t) dt_t B_t x_t
    seg = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)         # (B,nc,L,H)
    h_chunk = torch.einsum("bclh,bclhn,bclhp->bchnp",
                           dt_ * seg, Bh, xh_)           # (B,nc,H,N,P)

    # inter-chunk recurrence H_c = exp(sum dA_c) H_{c-1} + h_c, chunk by
    # chunk; the state entering chunk c is H_{c-1} (zero for c = 0)
    total_decay = torch.exp(dA.sum(dim=2))               # (B,nc,H)
    state = torch.zeros_like(h_chunk[:, 0])
    entering = []
    for c in range(nc):
        entering.append(state)
        state = state * total_decay[:, c, :, None, None] + h_chunk[:, c]
    h_prev = torch.stack(entering, dim=1)                # (B,nc,H,N,P)

    # inter-chunk output: y_t += C_t · exp(dAcs_t) H_prev
    in_decay = torch.exp(dA_cs)                          # (B,nc,L,H)
    y_inter = torch.einsum("bclhn,bchnp->bclhp",
                           Ch * in_decay[..., None].to(Ch.dtype),
                           h_prev.to(Ch.dtype))
    y = (y_intra + y_inter).reshape(B, S, H, P)
    return y, state


def ssm_block(p, cfg, x, *, conv_state=None, ssm_state=None,
              decode: bool = False, impl: str = "auto"):
    """Mamba-2 block. x: (B, S, D) in the compute dtype.

    Prefill (``decode=False``) returns ``(y, (conv_tail, final_state))``;
    decode (``decode=True``, S == 1, both states given) returns ``(y,
    (new_conv_state, new_ssm_state))``.  ``conv_tail`` is (B, W - 1, C)
    in the compute dtype; the SSM state (B, H, N, P) is f32.  The SSD
    runs in f32 and ``y`` is cast to the compute dtype before the skip
    ``x·D``; the gated norm ``rmsnorm(y·silu(z))`` (``ops.rmsnorm`` by
    ``impl``) and ``out_proj`` run in the compute dtype."""
    s = cfg.ssm
    d_inner, nheads, _ = ssm_dims(cfg)
    dt_c = x.dtype
    zxbcdt = x @ p["in_proj"].to(dt_c)
    z, xBC_pre, Bm_pre, Cm_pre, dt_raw = _split_zxbcdt(cfg, zxbcdt)
    conv_in = torch.cat([xBC_pre, Bm_pre, Cm_pre], dim=-1)   # (B,S,conv_dim)
    conv_out, conv_tail = _causal_conv(conv_in, p["conv_w"], p["conv_b"],
                                       init_state=conv_state)
    conv_out = F.silu(conv_out)
    gs = s.n_groups * s.d_state
    xc, Bm, Cm = torch.split(conv_out, [d_inner, gs, gs], dim=-1)

    Bq = Bm.reshape(*Bm.shape[:-1], s.n_groups, s.d_state)
    Cq = Cm.reshape(*Cm.shape[:-1], s.n_groups, s.d_state)
    xh = xc.reshape(*xc.shape[:-1], nheads, s.head_dim)
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    # D per head, repeated per element of the head (jnp.repeat)
    skip = p["D"].to(dt_c).repeat_interleave(s.head_dim)

    if decode:
        # the recurrent single step on the given states
        dA = torch.exp(dt[:, 0] * A)                     # (B,H)
        rep = nheads // s.n_groups
        Bh = Bq[:, 0].repeat_interleave(rep, dim=1)      # (B,H,N)
        Ch = Cq[:, 0].repeat_interleave(rep, dim=1)
        dBx = (dt[:, 0][..., None, None] * Bh[..., :, None]
               * xh[:, 0][..., None, :].float())         # (B,H,N,P)
        new_state = ssm_state * dA[..., None, None] + dBx
        y = torch.einsum("bhn,bhnp->bhp", Ch.float(), new_state)
        y = y[:, None].to(dt_c).reshape(x.shape[0], 1, d_inner)
        states = (conv_tail, new_state)
    else:
        S = x.shape[1]
        chunk = min(s.chunk_size, S) if S % s.chunk_size else s.chunk_size
        pad = (-S) % chunk
        xh_p, dt_p, Bq_p, Cq_p = xh.float(), dt, Bq.float(), Cq.float()
        if pad:
            # zero-pad the tail after softplus: padded steps have dt = 0
            # and leave the state as it is
            xh_p, dt_p, Bq_p, Cq_p = (
                F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
                for t in (xh_p, dt_p, Bq_p, Cq_p))
        yh, final_state = _ssd_chunked(xh_p, dt_p, A, Bq_p, Cq_p, chunk)
        y = yh[:, :S].to(dt_c).reshape(*x.shape[:2], d_inner)
        states = (conv_tail, final_state)
    y = y + xc * skip

    y = ops.rmsnorm(y * F.silu(z), p["norm"], eps=cfg.norm_eps, impl=impl)
    out = y @ p["out_proj"].to(dt_c)
    return out, states
