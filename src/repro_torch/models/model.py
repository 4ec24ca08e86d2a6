"""Model assembly of the port, the paged serving subset of
``repro.models.model``: parameter specs, the paged KV pool, the paged
model step and the fused decode tick.

Parameters keep the JAX pytree layout — ``embed``, ``blocks/pos{i}/...``
with a leading stacked ``(G,)`` axis over ``num_layers = G × period``,
``final_norm``, and ``lm_head`` when untied — so weights convert 1:1.
Where JAX scans over the stacked axis, the port runs a Python loop over
it.  Where JAX returns a new KV pool, the port writes the pool in place.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import mixed_precision
from repro_torch.kernels import ops
from repro_torch.models import attention as attn_mod
from repro_torch.models.modules import (ParamSpec, init_params, mlp_specs,
                                        swiglu)
from repro_torch.runtime import sampler as sampler_mod

init_params = init_params          # re-export


def _dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return _dtype(cfg.compute_dtype)


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------

def _block_specs(cfg: ModelConfig) -> Dict[str, Any]:
    """Specs for ONE period of layers: {'pos0': {...}, 'pos1': {...}}."""
    if not paged_cache_supported(cfg) or cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.name}: the port has dense attention decoders only so far "
            "(MoE, SSM, encoder-decoder and frontend archs are later "
            "slices, see ROADMAP.md)")
    out: Dict[str, Any] = {}
    for i in range(cfg.scan_period()):
        out[f"pos{i}"] = {
            "ln1": ParamSpec((cfg.d_model,), ("embed",), "zeros"),
            "mixer": attn_mod.attn_specs(cfg),
            "ln2": ParamSpec((cfg.d_model,), ("embed",), "zeros"),
            "mlp": mlp_specs(cfg.d_model, cfg.d_ff),
        }
    return out


def _stack(specs, g: int):
    if isinstance(specs, ParamSpec):
        return ParamSpec((g,) + specs.shape, ("layers",) + specs.axes,
                         specs.init, specs.scale)
    return {k: _stack(v, g) for k, v in specs.items()}


def param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    g = cfg.num_layers // cfg.scan_period()
    specs: Dict[str, Any] = {
        "embed": ParamSpec((cfg.vocab_size, cfg.d_model), ("vocab", "embed")),
        "blocks": _stack(_block_specs(cfg), g),
        "final_norm": ParamSpec((cfg.d_model,), ("embed",), "zeros"),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec((cfg.d_model, cfg.vocab_size),
                                     ("embed", "vocab"))
    return specs


def _output_weight(params, cfg):
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["lm_head"]


# ---------------------------------------------------------------------------
# Paged KV pool
# ---------------------------------------------------------------------------

def paged_cache_supported(cfg: ModelConfig) -> bool:
    """The paged layout covers pure-attention decoders (global and
    sliding-window layers)."""
    return (not cfg.encoder_decoder and cfg.frontend is None
            and all(k in ("attn", "attn_local") for k in cfg.layer_kinds()))


def init_paged_cache(cfg: ModelConfig, num_pages: int, page_size: int,
                     kv_dtype: Optional[str] = None, device=None):
    """Zero paged KV pools: {posN: {k,v: (G, num_pages, page, KVH, hd)}},
    plus f32 ``ks``/``vs`` scales (G, num_pages, page, KVH) for fp8/int8
    pools.  ``num_pages`` counts physical pages including the scratch
    page 0; ``kv_dtype`` None keeps the config's compute dtype."""
    if not paged_cache_supported(cfg):
        raise ValueError(f"{cfg.name}: no paged KV layout")
    g = cfg.num_layers // cfg.scan_period()
    kvh, hd = cfg.padded_kv_heads, cfg.resolved_head_dim
    if kv_dtype is None:
        dt, quantized = compute_dtype(cfg), False
    else:
        dt = mixed_precision.kv_storage_dtype(kv_dtype)
        quantized = mixed_precision.kv_is_quantized(kv_dtype)
    shape = (g, num_pages, page_size, kvh, hd)

    def entry():
        ent = {"k": torch.zeros(shape, dtype=dt, device=device),
               "v": torch.zeros(shape, dtype=dt, device=device)}
        if quantized:
            sshape = shape[:-1]
            ent["ks"] = torch.zeros(sshape, dtype=torch.float32, device=device)
            ent["vs"] = torch.zeros(sshape, dtype=torch.float32, device=device)
        return ent

    return {f"pos{i}": entry() for i in range(cfg.scan_period())}


def paged_page_bytes(cfg: ModelConfig, page_size: int,
                     kv_dtype: Optional[str] = None) -> int:
    """Bytes one physical page costs across the whole paged cache (all
    layers, K and V, values plus scales for quantized dtypes)."""
    kvh, hd = cfg.padded_kv_heads, cfg.resolved_head_dim
    if kv_dtype is None:
        tok = kvh * hd * compute_dtype(cfg).itemsize
    else:
        tok = kvh * mixed_precision.kv_token_bytes(kv_dtype, hd)
    return cfg.num_layers * page_size * tok * 2      # K and V


def copy_paged_page(cache, src: int, dst: int):
    """Copy physical page ``src`` onto page ``dst`` in every K/V pool, in
    place (prefix-cache copy-on-write).  ``src == dst`` is a no-op: a
    self-copy must not read from the page it is overwriting."""
    if src == dst:
        return cache
    for ent in cache.values():
        for a in ent.values():
            a[:, dst].copy_(a[:, src])
    return cache


# ---------------------------------------------------------------------------
# Paged model step and fused tick
# ---------------------------------------------------------------------------

def _layer(tree, g: int):
    """Views of layer ``g`` of a stacked ``(G, ...)`` tree."""
    return {k: (_layer(v, g) if isinstance(v, dict) else v[g])
            for k, v in tree.items()}


def paged_decode_step(params, cfg: ModelConfig, cache, tokens, pos,
                      page_table, n_valid, *, impl: str = "auto"):
    """Advance every seat by up to C tokens against the paged KV pool.

    tokens: (A, C) int32 (C=1: batched decode; C>1: one prefill chunk);
    pos: (A,) int32 first position of each seat's chunk;
    page_table: (A, n) int32 logical->physical page map;
    n_valid: (A,) int32 valid tokens per seat (0 = idle seat; its writes
    go to the scratch page and its logits are garbage).
    ``impl`` selects kernel or plain version for the norms and the decode
    attention (see ``kernels.ops``).

    Writes the new K/V into ``cache`` in place and returns
    ``(logits (A, C, V) f32, cache)``.
    """
    kinds = cfg.layer_kinds()
    dt = compute_dtype(cfg)
    A, C = tokens.shape
    eps = cfg.norm_eps
    x = params["embed"][tokens.long()].to(dt)
    qpos = pos[:, None] + torch.arange(C, dtype=torch.int32,
                                       device=tokens.device)[None, :]
    for g in range(cfg.num_layers // cfg.scan_period()):
        blk = _layer(params["blocks"], g)
        for i, kind in enumerate(kinds):
            p = blk[f"pos{i}"]
            c = _layer(cache[f"pos{i}"], g)
            h = ops.rmsnorm(x, p["ln1"], eps=eps, impl=impl)
            x = x + attn_mod.paged_attention(
                p["mixer"], cfg, h, c, page_table, qpos, n_valid,
                kind=kind, impl=impl)
            hh = ops.rmsnorm(x, p["ln2"], eps=eps, impl=impl)
            x = x + swiglu(hh, p["mlp"]["wg"], p["mlp"]["wu"],
                           p["mlp"]["wd"], x.dtype)
    x = ops.rmsnorm(x, params["final_norm"], eps=eps, impl=impl)
    logits = x @ _output_weight(params, cfg).to(x.dtype)
    return logits.float(), cache


def fused_decode_tick(params, cfg: ModelConfig, cache, last_tok, pos,
                      page_table, n_valid, temperature, top_k, top_p,
                      seed, rid, step, *, impl: str = "auto"):
    """One whole serving decode tick on the device: the batched paged
    model step, batched sampling (``runtime.sampler.sample_tokens``,
    keyed per ``(seed, rid, step)``), and the advance of every active
    seat's state.

    last_tok: (A,) int32 — each seat's previous token (the tick's input);
    pos: (A,) int32 next write position; page_table: (A, n) int32;
    n_valid: (A,) int32 — 1 for seats decoding this tick, else 0;
    temperature/top_p: (A,) float32, top_k: (A,) int32;
    seed/rid/step: (A,) int64 holding uint32 values.

    The serving state is updated **in place** where the JAX function
    returned new arrays: the KV pool, ``pos += n_valid``,
    ``step += n_valid`` and ``last_tok`` ← this tick's tokens (idle
    seats keep theirs).  Returns ``(last_tok, logits (A, V) f32)``;
    ``last_tok`` is the tick's emission, the one vector the host reads.
    """
    logits, _ = paged_decode_step(params, cfg, cache, last_tok[:, None], pos,
                                  page_table, n_valid, impl=impl)
    logits = logits[:, 0]
    toks = sampler_mod.sample_tokens(logits, temperature, top_k, top_p,
                                     seed, rid, step)
    last_tok.copy_(torch.where(n_valid > 0, toks, last_tok))
    pos.add_(n_valid)
    step.add_(n_valid)
    return last_tok, logits
