"""Shared token sampler: temperature / top-k / top-p with per-request seeds
(the port's copy of ``repro.runtime.sampler``).

Stochastic sampling is deterministic per ``(seed, rid, step)``: every
drawn token derives from a counter-based integer hash (fmix32) of the
request's :class:`SamplingParams.seed`, its engine-assigned ``rid`` and the
token index.  The algorithm is the Gumbel-max trick over filtered logits,
with interchangeable implementations that draw identical tokens:

- :meth:`Sampler.sample` — the numpy host oracle (one row at a time);
- :func:`sample_tokens_np` — its batched numpy twin;
- :func:`sample_tokens` — the batched torch device path, fused into the
  serving engine's decode tick (``models.model.fused_decode_tick``).

All compute, in float32: ``x = logits / T``; mask all but the top-k
logits; mask tokens outside the top-p nucleus (smallest prefix of the
descending-sorted softmax reaching ``top_p``); add Gumbel noise
``-log(-log(u))`` with ``u`` from the (seed, rid, step, token) hash; take
the argmax.  ``temperature <= 0`` is exact greedy argmax.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

#: fmix32 finalizer constants (MurmurHash3) — the per-token counter hash.
_M1, _M2, _GOLD = 0x85EBCA6B, 0xC2B2AE35, 0x9E3779B9
_MASK32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling configuration.

    temperature: 0 (default) = greedy argmax; > 0 scales logits.
    top_k: keep only the k highest logits (0 = off).
    top_p: nucleus sampling — keep the smallest set of tokens whose
        probability mass reaches ``top_p`` (1.0 = off).
    seed: base seed for the per-request token stream (>= 0).
    """
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0, got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if self.seed < 0:
            raise ValueError(f"seed must be >= 0, got {self.seed}")

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0


GREEDY = SamplingParams()


# ---------------------------------------------------------------------------
# Counter-based uniform/Gumbel noise — numpy and torch twins.
#
# numpy computes in uint32 with wraparound.  torch cannot right-shift
# uint32 on the CPU, so the torch twin carries the same values in int64
# and keeps the low 32 bits after every step; each multiply is split into
# 16-bit halves so no intermediate leaves int64's range.
# ---------------------------------------------------------------------------

def _mix_np(h: np.ndarray) -> np.ndarray:
    """fmix32 avalanche over a uint32 ndarray (wraparound multiply)."""
    h = h ^ (h >> np.uint32(16))
    h = h * np.uint32(_M1)
    h = h ^ (h >> np.uint32(13))
    h = h * np.uint32(_M2)
    return h ^ (h >> np.uint32(16))


def _gumbel_np(seed: int, rid: int, step: int, n: int) -> np.ndarray:
    """(n,) float32 Gumbel noise keyed by (seed, rid, step)."""
    k = _mix_np(np.asarray([seed & _MASK32], np.uint32) ^ np.uint32(_GOLD))
    k = _mix_np(k ^ np.uint32(rid & _MASK32))
    k = _mix_np(k ^ np.uint32(step & _MASK32))
    u32 = _mix_np(k ^ np.arange(n, dtype=np.uint32))
    # 24 mantissa-exact bits, offset off 0 and 1 so both logs are finite
    u = ((u32 >> np.uint32(8)).astype(np.float32) + np.float32(0.5)) \
        * np.float32(2.0 ** -24)
    return (-np.log(-np.log(u))).astype(np.float32)


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """``(h * c) mod 2**32`` for int64 ``h`` in [0, 2**32)."""
    lo = h * (c & 0xFFFF)                            # < 2**48
    hi = ((h * (c >> 16)) & 0xFFFF) << 16            # < 2**32
    return (lo + hi) & _MASK32


def _mix_torch(h: torch.Tensor) -> torch.Tensor:
    """fmix32 avalanche over int64 tensors holding uint32 values."""
    h = h ^ (h >> 16)
    h = _mul32(h, _M1)
    h = h ^ (h >> 13)
    h = _mul32(h, _M2)
    return h ^ (h >> 16)


def _gumbel_torch(seed, rid, step, n: int) -> torch.Tensor:
    """(B, n) float32 Gumbel noise; seed/rid/step are (B,) int64."""
    m = _MASK32
    k = _mix_torch((seed & m) ^ _GOLD)
    k = _mix_torch(k ^ (rid & m))
    k = _mix_torch(k ^ (step & m))
    u32 = _mix_torch(k[:, None] ^ torch.arange(n, dtype=torch.int64,
                                               device=k.device)[None, :])
    u = ((u32 >> 8).float() + 0.5) * (2.0 ** -24)
    return -torch.log(-torch.log(u))


# ---------------------------------------------------------------------------
# Device path: batched sampling inside the fused decode tick
# ---------------------------------------------------------------------------

def sample_tokens(logits, temperature, top_k, top_p, seed, rid, step):
    """Batched device sampler: one token per row, no host sync.

    Token-for-token identical to :func:`sample_tokens_np` and to looping
    :meth:`Sampler.sample` over the rows.

    Args:
      logits: (B, V) unnormalized log-probs (sampled in float32).
      temperature: (B,) float32; rows with ``temperature <= 0`` take the
          plain argmax and ignore every other parameter.
      top_k: (B,) int32 (0 = off).
      top_p: (B,) float32 (1.0 = off).
      seed, rid, step: (B,) int64 holding uint32 values — the RNG key.

    Returns:
      (B,) int32 token ids.
    """
    logits = logits.float()
    B, V = logits.shape
    greedy_tok = torch.argmax(logits, dim=-1).to(torch.int32)

    t_safe = torch.where(temperature > 0, temperature, 1.0).float()
    x = logits / t_safe[:, None]
    # top-k: drop everything below the k-th largest (ties at the
    # threshold survive, matching the oracle)
    kth_idx = (torch.clamp(top_k, 1, V) - 1).long()
    kth = torch.gather(torch.sort(x, dim=-1, descending=True).values, 1,
                       kth_idx[:, None])
    apply_k = ((top_k > 0) & (top_k < V))[:, None]
    x = torch.where(apply_k & (x < kth), -torch.inf, x)
    # top-p: keep the smallest descending-probability prefix reaching
    # top_p (the top token always survives: its exclusive cumsum is 0);
    # a stable sort orders ties as numpy's stable argsort does
    p = torch.exp(x - torch.amax(x, dim=-1, keepdim=True))
    p = p / torch.sum(p, dim=-1, keepdim=True)
    p_sorted, order = torch.sort(p, dim=-1, descending=True, stable=True)
    keep_sorted = (torch.cumsum(p_sorted, dim=-1) - p_sorted) < top_p[:, None]
    in_nucleus = torch.zeros((B, V), dtype=torch.bool, device=x.device)
    in_nucleus.scatter_(1, order, keep_sorted)
    x = torch.where((top_p < 1.0)[:, None] & ~in_nucleus, -torch.inf, x)

    g = _gumbel_torch(seed, rid, step, V)
    stoch_tok = torch.argmax(x + g, dim=-1).to(torch.int32)
    return torch.where(temperature > 0, stoch_tok, greedy_tok)


# ---------------------------------------------------------------------------
# Batched host path — numpy twin of sample_tokens
# ---------------------------------------------------------------------------

def sample_tokens_np(logits, temperature, top_k, top_p, seed, rid, step):
    """Batched *host* sampler: the numpy twin of :func:`sample_tokens`,
    token-for-token identical to both it and a per-row
    :meth:`Sampler.sample` loop (tests/test_torch_sampler.py pins all
    three).

    Args:
      logits: (B, V) float32 ndarray of unnormalized log-probs.
      temperature: (B,) float32; rows ``<= 0`` take the plain argmax.
      top_k: (B,) int32 (0 = off).
      top_p: (B,) float32 (1.0 = off).
      seed, rid, step: (B,) integer arrays — the per-row RNG key
        (hashed per row exactly like the scalar ``_gumbel_np``).

    Returns:
      (B,) int32 token ids.
    """
    x = np.asarray(logits, np.float32)
    B, V = x.shape
    temperature = np.asarray(temperature, np.float32)
    top_k = np.asarray(top_k, np.int32)
    top_p = np.asarray(top_p, np.float32)
    greedy_tok = np.argmax(x, axis=-1).astype(np.int32)
    stoch = temperature > 0
    if not stoch.any():
        return greedy_tok
    if not stoch.all():
        # run the stochastic path on just the stochastic rows: every
        # per-row quantity (threshold, nucleus, Gumbel key) is hashed
        # from (seed, rid, step), never from batch position, so the
        # subset call is bit-identical to the full-batch one — and in
        # mixed batches (the oracle default is 25% stochastic) it
        # skips the O(V log V) sort work for the greedy majority.
        out = greedy_tok.copy()
        idx = np.nonzero(stoch)[0]
        out[idx] = sample_tokens_np(
            x[idx], temperature[idx], np.asarray(top_k, np.int32)[idx],
            np.asarray(top_p, np.float32)[idx],
            np.asarray(seed)[idx], np.asarray(rid)[idx],
            np.asarray(step)[idx])
        return out
    t_safe = np.where(stoch, temperature, np.float32(1.0)).astype(np.float32)
    x = x / t_safe[:, None]
    # top-k: drop everything below the k-th largest (ties at the
    # threshold survive, matching the oracle); the O(V log V) sort is
    # skipped entirely when no row uses top-k
    apply_k = ((top_k > 0) & (top_k < V))[:, None]
    if apply_k.any():
        kth_idx = np.clip(top_k, 1, V) - 1
        kth = np.take_along_axis(np.sort(x, axis=-1)[:, ::-1],
                                 kth_idx[:, None], axis=-1)
        x = np.where(apply_k & (x < kth), -np.inf, x).astype(np.float32)
    # top-p: keep the smallest descending-probability prefix reaching
    # top_p (the top token always survives: its exclusive cumsum is 0)
    p = np.exp(x - np.max(x, axis=-1, keepdims=True))
    p = p / np.sum(p, axis=-1, keepdims=True)
    order = np.argsort(-p, axis=-1, kind="stable")
    p_sorted = np.take_along_axis(p, order, axis=-1)
    keep_sorted = (np.cumsum(p_sorted, axis=-1) - p_sorted) < top_p[:, None]
    in_nucleus = np.zeros((B, V), bool)
    np.put_along_axis(in_nucleus, order, keep_sorted, axis=-1)
    x = np.where((top_p < 1.0)[:, None] & ~in_nucleus,
                 -np.inf, x).astype(np.float32)
    # per-row Gumbel noise, hashed row-wise exactly like _gumbel_np
    k = _mix_np(np.asarray(seed, np.uint32) ^ np.uint32(_GOLD))
    k = _mix_np(k ^ np.asarray(rid, np.uint32))
    k = _mix_np(k ^ np.asarray(step, np.uint32))
    u32 = _mix_np(k[:, None] ^ np.arange(V, dtype=np.uint32)[None, :])
    u = ((u32 >> np.uint32(8)).astype(np.float32) + np.float32(0.5)) \
        * np.float32(2.0 ** -24)
    g = (-np.log(-np.log(u))).astype(np.float32)
    stoch_tok = np.argmax(x + g, axis=-1).astype(np.int32)
    return np.where(stoch, stoch_tok, greedy_tok)


# ---------------------------------------------------------------------------
# Host oracle
# ---------------------------------------------------------------------------

class Sampler:
    """Stateless sampler; all randomness derives from (seed, rid, step).

    This is the numpy *oracle* for :func:`sample_tokens`: the engine
    samples first tokens of stochastic requests with it, and the fused
    device path is pinned token-identical to it."""

    def sample(self, logits, params: SamplingParams = GREEDY, *,
               rid: int = 0, step: int = 0) -> int:
        """Draw one token id from a ``(V,)`` logits row.

        Args:
          logits: length-V array-like of unnormalized log-probs.
          params: sampling configuration; greedy (or None) returns the
              plain argmax with no RNG involved.
          rid: engine-assigned request id — part of the RNG key.
          step: token index within the request — part of the RNG key.

        Returns:
          The drawn token id in ``[0, V)``; identical for identical
          ``(logits, params.seed, rid, step)`` regardless of batch
          composition, scheduling order, or the request's SLO class."""
        # host oracle by contract: callers hand over rows they already
        # batch-transferred (see Scheduler._emit_first_tokens)
        x = np.asarray(logits, np.float32).reshape(-1)
        if params is None or params.greedy:
            return int(np.argmax(x))
        x = x / np.float32(params.temperature)
        if 0 < params.top_k < x.size:
            kth = np.sort(x)[::-1][params.top_k - 1]
            x = np.where(x < kth, -np.inf, x).astype(np.float32)
        if params.top_p < 1.0:
            p = np.exp(x - np.max(x))
            p = p / p.sum()
            order = np.argsort(-p, kind="stable")
            csum = np.cumsum(p[order])
            # keep the minimal nucleus; the top token always survives
            keep = np.zeros(p.size, bool)
            keep[order] = csum - p[order] < np.float32(params.top_p)
            x = np.where(keep, x, -np.inf).astype(np.float32)
        g = _gumbel_np(params.seed, rid, step, x.size)
        return int(np.argmax(x + g))
