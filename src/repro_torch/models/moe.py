"""Mixture-of-experts block of the port (counterpart of
``repro.models.moe``), on one device or tensor-parallel over a mesh's
"model" axis.

Tokens are routed top-k, replicated k times, sorted by expert id (a
stable sort, so within an expert lower flat slots come first), and pushed
through the expert FFNs: by default the capacity (GShard) formulation,
one batched product per weight over ``(E, C, ·)`` expert windows, where
the reference's einsums become ``torch.bmm``; or dropless per-expert
dense products (``impl="ragged"``), the fallback XLA lowers ``ragged_dot``
to off the TPU.

Every step is a tensor operation with shapes fixed by the input's shape,
so a CUDA graph captures the block: the group sizes are counted with
``scatter_add_`` (``torch.bincount`` reads its maximum back to the host),
the capacity is host arithmetic on static shapes, and nothing indexes
with a boolean mask or calls ``.item()``.  The combine takes each token's
k contributions in ascending expert id (the reference's sorted-slot
order) and sums them one after another from zeros in the compute dtype,
instead of ``index_add_``, whose atomics add in no fixed order on CUDA.

Over a mesh (``moe_block(mesh=)``, the reference's ``shard_map`` body)
every model rank routes its data shard's tokens whole, so the capacity
and the drops are per data shard; the expert FFNs run on this rank's
``expert_ff`` slice and the shared expert on its ``ff`` slice, and the
summed output is reduced over "model" once.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.modules import ParamSpec, swiglu
from repro_torch.parallel.tensor import TensorParallel


def moe_specs(cfg) -> dict:
    m = cfg.moe
    d = cfg.d_model
    specs = {
        "router": ParamSpec((d, m.num_experts), ("embed", "expert")),
        "wg": ParamSpec((m.num_experts, d, m.d_ff_expert),
                        ("expert", "embed", "expert_ff")),
        "wu": ParamSpec((m.num_experts, d, m.d_ff_expert),
                        ("expert", "embed", "expert_ff")),
        "wd": ParamSpec((m.num_experts, m.d_ff_expert, d),
                        ("expert", "expert_ff", "embed")),
    }
    if m.num_shared_experts:
        f_sh = _shared_ff(m)
        specs["shared"] = {
            "wg": ParamSpec((d, f_sh), ("embed", "ff")),
            "wu": ParamSpec((d, f_sh), ("embed", "ff")),
            "wd": ParamSpec((f_sh, d), ("ff", "embed")),
            "gate": ParamSpec((d, 1), ("embed", None)),
        }
    return specs


def capacity(m, tk: int) -> int:
    """Slots per expert of the capacity path for ``tk`` routed (token,
    expert) pairs: ``int(cf·TK/E) + 1``, padded to a multiple of 8 and
    bounded by TK (host arithmetic on the static shape)."""
    c = int(m.capacity_factor * tk / m.num_experts) + 1
    return min(max((c + 7) // 8 * 8, 8), tk)


def group_sizes(flat_expert: torch.Tensor, num_experts: int) -> torch.Tensor:
    """(E,) int32 count of each expert id in ``flat_expert``, on the
    device without a host read."""
    counts = torch.zeros(num_experts, dtype=torch.int32,
                         device=flat_expert.device)
    return counts.scatter_add_(0, flat_expert, torch.ones_like(
        flat_expert, dtype=torch.int32))


def route(p, m, xt: torch.Tensor):
    """Router of ``xt`` (T, D): logits in the compute dtype, softmax in
    f32, the top-k experts with JAX's tie order (the larger probability
    first, the lower index among equals: a stable descending sort) and
    their renormalised weights.  Returns ``(probs (T, E) f32, weights
    (T, k) f32, idx (T, k) int64)``."""
    logits = (xt @ p["router"].to(xt.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, idx = vals[:, :m.top_k], idx[:, :m.top_k]
    return probs, weights / weights.sum(dim=-1, keepdim=True), idx


def _expert_gemms_ragged(p, m, xs, sizes, dt):
    """Dropless expert FFNs: one dense ``(T·k, D)×(D, F)`` product per
    expert, each row kept where its sorted slot lies in that expert's
    group (E/k× the routed FLOPs, as XLA's fallback for ``ragged_dot``
    off the TPU).  Returns y (T·k, D), the slots in sorted order."""
    TK = xs.shape[0]
    ends = torch.cumsum(sizes, 0)
    slot = torch.arange(TK, device=xs.device)
    seg = torch.searchsorted(ends, slot, right=True)        # expert per slot

    def grouped(a, w):
        out = torch.zeros(TK, w.shape[-1], dtype=dt, device=xs.device)
        for e in range(m.num_experts):
            out = torch.where((seg == e)[:, None], a @ w[e].to(dt), out)
        return out
    g = grouped(xs, p["wg"])
    u = grouped(xs, p["wu"])
    return grouped(F.silu(g) * u, p["wd"])


def _expert_gemms_capacity(p, m, xs, sizes, dt):
    """Capacity-based expert FFNs (GShard): expert e reads the C-slot
    window of the sorted token array at its group offset, all experts
    run as one batched product per weight over ``(E, C, ·)``, and each
    sorted slot takes its cell's result.  A slot past its expert's C is
    dropped: its row is exactly 0.  Returns y (T·k, D), the slots in
    sorted order."""
    TK, D = xs.shape
    E = m.num_experts
    C = capacity(m, TK)
    ends = torch.cumsum(sizes, 0)
    offsets = ends - sizes                                     # (E,)
    cols = torch.arange(C, device=xs.device)
    slot = offsets[:, None] + cols[None, :]                    # (E, C)
    valid = cols[None, :] < sizes[:, None]                     # (E, C)
    idx = torch.clamp(slot, 0, TK - 1)
    xe = xs[idx.reshape(-1)].reshape(E, C, D)
    xe = xe * valid[..., None].to(dt)
    g = torch.bmm(xe, p["wg"].to(dt))
    u = torch.bmm(xe, p["wu"].to(dt))
    ye = torch.bmm(F.silu(g) * u, p["wd"].to(dt))
    ye = ye * valid[..., None].to(dt)
    # each sorted slot's cell: its expert and its place in the window
    slots = torch.arange(TK, device=xs.device)
    seg = torch.searchsorted(ends, slots, right=True)
    col = slots - offsets[seg]
    kept = col < C
    y = ye.reshape(E * C, D)[seg * C + torch.clamp(col, max=C - 1)]
    return y * kept[:, None].to(dt)


def combine(y, weights, idx, sort_idx):
    """The weighted sum over each token's experts: y (T·k, D), the expert
    outputs in sorted-slot order; weights and idx (T, k) of the router;
    sort_idx (T·k,) the stable sort of the flat expert ids.  Each token's
    k weighted rows are taken in ascending expert id, which is their
    sorted-slot order, and added one after another from zeros in y's
    dtype: the order in which the reference's ``.at[tok_ids].add``
    adds them.  Returns (T, D)."""
    T, k = idx.shape
    dt = y.dtype
    contrib = y * weights.reshape(-1)[sort_idx].to(dt)[:, None]
    where = torch.empty_like(sort_idx).scatter_(
        0, sort_idx, torch.arange(T * k, device=y.device))
    order = torch.argsort(idx, dim=-1)                 # ids distinct per row
    rows = torch.gather(where.reshape(T, k), 1, order)
    per_tok = contrib[rows.reshape(-1)].reshape(T, k, -1)
    out = torch.zeros((T, y.shape[1]), dtype=dt, device=y.device)
    for j in range(k):
        out = out + per_tok[:, j]
    return out


def _moe_local(p, cfg, x, *, impl: str = "capacity", tp=None):
    """MoE on one device, or with ``tp`` (a
    ``parallel.tensor.TensorParallel``) tensor-parallel: x: (B, S, D) ->
    (B, S, D).

    impl: 'capacity' (the reference's default: capacity drops) or
    'ragged' (dropless per-expert dense products).

    Under ``tp``, a part whose weights hold this rank's slice (the
    experts' ``expert_ff``, the shared expert's ``ff``) reads ``x``
    through ``tp.copy`` and its whole leaves (the router, the gate)
    through ``tp.copy``, so their gradients are summed over the ranks;
    the split parts' sum is reduced over the ranks, a part whose leaves
    are whole is added after."""
    m = cfg.moe
    B, S, D = x.shape
    dt = x.dtype
    xt = x.reshape(B * S, D)
    etp = tp and tp.split(p["wg"].shape[2], m.d_ff_expert)

    def into(part_tp, t):
        return t if part_tp is None else part_tp.copy(t)

    xe = into(etp, xt)
    _, weights, idx = route({"router": into(etp, p["router"])}, m, xe)
    flat_expert = idx.reshape(-1)                              # (T*k,)
    sort_idx = torch.argsort(flat_expert, stable=True)
    tok_ids = sort_idx // m.top_k                              # source token
    xs = xe[tok_ids]                                           # (T*k, D)
    sizes = group_sizes(flat_expert, m.num_experts)

    if impl == "ragged":
        y = _expert_gemms_ragged(p, m, xs, sizes, dt)
    elif impl == "capacity":
        y = _expert_gemms_capacity(p, m, xs, sizes, dt)
    else:
        raise ValueError(f"moe impl {impl!r}: 'capacity' or 'ragged'")

    out = combine(y, weights, idx, sort_idx)
    if "shared" in p:
        sh = p["shared"]
        stp = tp and tp.split(sh["wg"].shape[1], _shared_ff(m))
        # one copy of x where both parts are split: its gradient sums
        # every read in the order of the meshless block's
        xs_ = xe if (stp is not None and etp is not None) else into(stp, xt)
        ys = swiglu(xs_, sh["wg"], sh["wu"], sh["wd"], dt)
        gate = torch.sigmoid((xs_ @ into(stp, sh["gate"]).to(dt)).float())
        shared = ys * gate.to(dt)
        if (etp is None) != (stp is None):    # one part split: reduce it
            return (_reduced(etp, out) + _reduced(stp, shared)).reshape(
                B, S, D)
        out = out + shared
    return _reduced(etp, out).reshape(B, S, D)


def _shared_ff(m) -> int:
    """The shared experts' ff width (``moe_specs``)."""
    return m.d_ff_shared or m.num_shared_experts * m.d_ff_expert


def _reduced(tp, t):
    return t if tp is None else tp.reduce(t)


def moe_block(p, cfg, x, mesh=None, impl: str = "capacity"):
    """The MoE block: on one device (``_moe_local``), or over ``mesh`` (a
    ``launch.mesh.Mesh`` with a "model" axis, ``p`` this rank's leaves:
    gathered over "data", ``expert_ff`` and ``ff`` this rank's slices)
    the reference's sharded body: routing and capacity on this rank's
    tokens, the expert FFNs tensor-parallel, one sum over "model"."""
    tp = (TensorParallel.over(mesh) if mesh is not None
          and "model" in mesh.axis_names else None)
    return _moe_local(p, cfg, x, impl=impl, tp=tp)


def aux_load_balance_loss(p, cfg, x, *, mean=None) -> torch.Tensor:
    """Switch-style load-balancing auxiliary loss (fraction ×
    probability), 0-d f32.  ``mean``, where given, averages the expert
    counts and the mean router probabilities over the data-parallel
    ranks (a differentiable all-reduce, each rank holding as many
    tokens), so each rank computes the loss of the global batch, as
    the reference's GSPMD step does."""
    m = cfg.moe
    xt = x.reshape(-1, x.shape[-1])
    probs, _, idx = route(p, m, xt)
    counts = group_sizes(idx.reshape(-1), m.num_experts).float()
    imp = probs.mean(dim=0)
    if mean is not None:
        counts, imp = mean(counts), mean(imp)
    frac = counts / torch.clamp(counts.sum(), min=1.0)
    return m.num_experts * torch.sum(frac * imp)
