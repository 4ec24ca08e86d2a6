"""Model assembly of the port (counterpart of ``repro.models.model``):
parameter specs; the training loss (``lm_loss``); the fixed-slot path
(the dense cache, the full-sequence backbone, ``prefill`` and
``decode_step``); the paged KV pool, the paged model step and the fused
decode tick.

Parameters keep the JAX pytree layout — ``embed``, ``blocks/pos{i}/...``
with a leading stacked ``(G,)`` axis over ``num_layers = G × period``,
``final_norm``, ``lm_head`` when untied, an encoder-decoder model's
``encoder/{blocks, final_norm}``, and ``frontend_proj`` where the model
has a frontend (audio or vision) — so weights convert 1:1.
Where JAX scans over the stacked axis, the port runs a Python loop over
it.  Where JAX returns a new KV pool, the port writes the pool in place.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.core import mixed_precision
from repro_torch.kernels import ops
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.modules import (ParamSpec, abstract_params,
                                        count_params, init_params, mlp_specs,
                                        softmax_xent_chunked, swiglu)
from repro_torch.parallel.tensor import embed_lookup
from repro_torch.runtime import sampler as sampler_mod
from repro_torch.tree import tree_map

init_params = init_params          # re-export
abstract_params = abstract_params  # re-export
count_params = count_params        # re-export


@dataclasses.dataclass(frozen=True)
class RunOptions:
    """Execution options: the fields of the JAX ``RunOptions`` that the
    port's paths read.

    - ``q_chunk``: query rows per chunk of the dense attention (training,
      and prefill on the CPU; the flash kernel tiles on its own);
    - ``remat``: recompute each layer in backward (``train=True`` only);
      ``remat_policy``: ``"dots"`` saves the outputs of the matmuls that
      have no batch dimensions (``mm``/``addmm``: the projections and the
      MLP; attention's and the experts' batched products are recomputed),
      as ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``
      does; any other value recomputes everything, as the reference's
      code does (its ``"none"`` too: only ``remat=False`` turns remat
      off);
    - ``xent_chunk``: sequence positions per cross-entropy chunk;
    - ``microbatches``: gradient-accumulation microbatches of a train
      step; ``bf16_weights``: cast the f32 params to bf16 once at the
      loss's entry;
    - ``moe_impl``: the MoE blocks' expert FFNs on the full-sequence
      path (``backbone``), ``"capacity"`` (the reference's default:
      capacity drops) or ``"ragged"`` (dropless); the serving steps run
      ``"capacity"``;
    - ``ring_local_cache``: the dense cache of a sliding-window layer
      keeps ``min(seq, W)`` rows, slot = position mod W (``init_cache``,
      ``prefill``), and ``decode_step`` attends to it with
      ``attention.ring_decode_attention``.  A model-level option, as in
      the reference: the serving engines never set it;
    - ``aux_loss_weight``: the weight of the MoE load-balancing aux loss
      in ``lm_loss`` (the reference's default, 0.01);
    - ``grad_sync``: the gradient synchronization of a train step on a
      mesh with a "pod" axis (``launch.steps.build_cell(mesh=)``):
      ``"auto"`` (reduce-scatter in-pod, all-reduce across pods, full
      precision) or ``"compressed"`` (int8 with error feedback on the
      cross-pod hop); ``pipeline``: pipeline stages over "pod", which
      ``build_cell`` refuses (ROADMAP.md queue 1 item 6c);
    - ``decode_kv_seq_axis``: a decode cell over a mesh
      (``launch.steps.build_cell``) gives its cache's sequence every mesh
      axis the batch leaves free, as the reference's does
      (flash-decoding over ranks: ``parallel.sequence``).
    """
    remat: bool = True
    remat_policy: str = "nothing"
    q_chunk: int = 1024
    xent_chunk: int = 512
    microbatches: int = 1
    bf16_weights: bool = False
    moe_impl: str = "capacity"
    ring_local_cache: bool = False
    aux_loss_weight: float = 0.01
    grad_sync: str = "auto"
    pipeline: bool = False
    decode_kv_seq_axis: bool = False


def _dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return _dtype(cfg.compute_dtype)


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------

def _block_specs(cfg: ModelConfig, *,
                 decoder_side: bool = True) -> Dict[str, Any]:
    """Specs for ONE period of layers: {'pos0': {...}, 'pos1': {...}},
    each a mixer (an SSM block on an ``ssm`` layer, else attention), in
    an encoder-decoder model's decoder (``decoder_side``) a
    cross-attention block behind ``ln_cross``, and a dense (``mlp``) or
    MoE (``moe``) MLP behind ``ln2``, or no MLP and no ``ln2`` where
    ``mlp_kinds()`` says ``"none"`` (a Mamba-2 layer).  A vision
    frontend adds nothing here: its one weight, ``frontend_proj``, sits
    at the top of the tree (``param_specs``)."""
    out: Dict[str, Any] = {}
    for i, (kind, mlpk) in enumerate(zip(cfg.layer_kinds(),
                                         cfg.mlp_kinds())):
        sub = {"ln1": ParamSpec((cfg.d_model,), ("embed",), "zeros"),
               "mixer": (ssm_mod.ssm_specs(cfg) if kind == "ssm"
                         else attn_mod.attn_specs(cfg))}
        if cfg.encoder_decoder and decoder_side:
            sub["ln_cross"] = ParamSpec((cfg.d_model,), ("embed",), "zeros")
            sub["cross"] = attn_mod.attn_specs(cfg, cross=True)
        if mlpk != "none":
            sub["ln2"] = ParamSpec((cfg.d_model,), ("embed",), "zeros")
        if mlpk == "moe":
            sub["moe"] = moe_mod.moe_specs(cfg)
        elif mlpk == "dense":
            sub["mlp"] = mlp_specs(cfg.d_model, cfg.d_ff)
        out[f"pos{i}"] = sub
    return out


def _encoder_cfg(cfg: ModelConfig) -> ModelConfig:
    """The config of an encoder-decoder model's encoder stack, as the
    reference derives it: ``num_encoder_layers`` dense attention layers,
    period 1, no cross-attention."""
    return dataclasses.replace(
        cfg, encoder_decoder=False, moe=None, attn_period=None,
        local_global_period=None, num_layers=cfg.num_encoder_layers)


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
    if cfg.encoder_decoder:
        specs["encoder"] = {
            "blocks": _stack(_block_specs(_encoder_cfg(cfg),
                                          decoder_side=False),
                             cfg.num_encoder_layers),
            "final_norm": ParamSpec((cfg.d_model,), ("embed",), "zeros"),
        }
    if cfg.frontend is not None:
        specs["frontend_proj"] = ParamSpec((cfg.frontend_dim, cfg.d_model),
                                           (None, "embed"))
    return specs


def _output_weight(params, cfg):
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["lm_head"]


# ---------------------------------------------------------------------------
# Fixed-slot path: full-sequence forward, dense cache, decode
# ---------------------------------------------------------------------------

def _layer(tree, g: int):
    """Views of layer ``g`` of a stacked ``(G, ...)`` tree."""
    return {k: (_layer(v, g) if isinstance(v, dict) else v[g])
            for k, v in tree.items()}


def _layers(params, cfg: ModelConfig):
    """``(g, i, kind, p)`` of every layer in order: ``p`` holds the views
    of period position ``i`` of stacked layer group ``g``, taken with one
    ``unbind(0)`` per stacked leaf: under autograd that is one ``stack``
    in backward, where a ``v[g]`` per layer would add a zero tensor of
    the whole leaf's size per layer."""
    blocks = tree_map(torch.unbind, params["blocks"])
    kinds = cfg.layer_kinds()
    out = []
    for g in range(cfg.num_layers // cfg.scan_period()):
        blk = _layer(blocks, g)
        out += [(g, i, kind, blk[f"pos{i}"]) for i, kind in enumerate(kinds)]
    return out


def _tp(shard, local: int, whole: int):
    """The "model" group of a sharded step (``shard``, a
    ``parallel.fsdp.Fsdp``) where a dimension of ``whole`` is held as
    slices of ``local``, else None."""
    if shard is None or shard.tp is None:
        return None
    return shard.tp.split(local, whole)


def _mlp(p, cfg: ModelConfig, h, moe_impl: str, shard=None):
    """The layer's MLP on its normed input ``h`` (B, S, D): the MoE block
    where the layer has one, else the dense SwiGLU; in a sharded step
    (``shard``) tensor-parallel over "model" where "model" splits its
    ff."""
    if "moe" in p:
        return moe_mod.moe_block(p["moe"], cfg, h,
                                 mesh=None if shard is None else shard.mesh,
                                 impl=moe_impl)
    mlp = p["mlp"]
    return swiglu(h, mlp["wg"], mlp["wu"], mlp["wd"], h.dtype,
                  tp=_tp(shard, mlp["wg"].shape[1], cfg.d_ff))


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """The ``"dots"`` remat policy: keep the outputs of the matmuls with
    no batch dimensions, recompute everything else."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat_kwargs(policy: str) -> dict:
    """``checkpoint``'s keywords for a remat policy."""
    if policy == "dots":
        return dict(context_fn=functools.partial(
            create_selective_checkpoint_contexts, _save_dots))
    return {}


def _residual_stream(params, cfg: ModelConfig, x, mixer, *, cross=None,
                     impl: str, remat: bool = False,
                     remat_policy: str = "nothing",
                     moe_impl: str = "capacity", aux: bool = False,
                     shard=None):
    """Run the residual stream ``x`` (B, S, D) through every layer of
    ``params["blocks"]`` and ``params["final_norm"]``;
    ``mixer(g, i, kind, p, h)`` returns the mixer output (attention or
    SSM block) of layer ``(g, i)`` for its normed input ``h``, and in a
    layer with cross-attention (an encoder-decoder model's decoder)
    ``cross(g, i, p, h)`` the cross-attention output for its normed input.

    The ops are the JAX model's (``h = ln1(x); x = x + mix(h); h =
    ln_cross(x); x = x + cross(h); h = ln2(x); x = x + mlp(h)``, then
    ``final_norm``; ``mlp`` the MoE block, by ``moe_impl``, in a layer
    that has one), with each residual add fused into the norm that reads
    its result (``ops.add_rmsnorm``): the mixer's add into ln_cross where
    the layer has cross-attention, else into ln2, the cross add into
    ln2, the MLP add into the next layer's ln1 or, after the last layer,
    into ``final_norm``; in a layer without an MLP (no ``ln2``) the
    mixer's add into that next norm.  Only layer 0's ln1 is a lone norm.
    Returns ``(h, aux)``: ``h`` the final norm's output; ``aux`` with
    ``aux=True`` (the loss's forward) the 0-d f32 sum, from zero in layer
    order, of each MoE layer's load-balancing loss
    (``moe.aux_load_balance_loss`` on the MLP's normed input, which
    routes a second time, as the reference does; a layer without an MoE
    block adds nothing), else None.

    ``remat`` runs each layer — ``(x, h)`` in, ``(x, h)`` and its aux
    loss out — under ``torch.utils.checkpoint``, so backward recomputes
    it from its two inputs instead of keeping its activations (all of
    them, or with ``remat_policy="dots"`` all but the saved matmul
    outputs).

    ``shard`` (a ``parallel.fsdp.Fsdp``), where given, holds the
    placement of ``params["blocks"]``: each layer gathers its leaves
    where it runs (``shard.layer``, inside the checkpointed function, so
    backward gathers again), and the next layer's ln1 with them; the MLP
    runs tensor-parallel where "model" splits it (``_mlp``); the aux
    loss's routing statistics are averaged over the data-parallel ranks
    (``shard.mean``, ``moe.aux_load_balance_loss``)."""
    eps = cfg.norm_eps
    layers = _layers(params, cfg)
    gather = None if shard is None else shard.layer

    def ln1(j):
        """Layer ``j``'s ln1 weight, whole; past the last layer the final
        norm's."""
        if j == len(layers):
            return params["final_norm"]
        _, i, _, p = layers[j]
        if gather is None:
            return p["ln1"]
        return gather(i, {"ln1": p["ln1"]})["ln1"]

    h = ops.rmsnorm(x, ln1(0), eps=eps, impl=impl)
    total = (torch.zeros((), dtype=torch.float32, device=x.device) if aux
             else None)
    for j, (g, i, kind, p) in enumerate(layers):

        def layer(x, h, g=g, i=i, kind=kind, p=p, j=j):
            w_next = ln1(j + 1)
            if gather is not None:
                p = gather(i, {k: v for k, v in p.items() if k != "ln1"})
            mix = mixer(g, i, kind, p, h)
            if "cross" in p:
                x, h = ops.add_rmsnorm(x, mix, p["ln_cross"], eps=eps,
                                       impl=impl)
                mix = cross(g, i, p, h)
            if "ln2" not in p:
                return (*ops.add_rmsnorm(x, mix, w_next, eps=eps, impl=impl),
                        None)
            x, h = ops.add_rmsnorm(x, mix, p["ln2"], eps=eps, impl=impl)
            a = None
            if aux and "moe" in p:
                kw = {} if shard is None else {"mean": shard.mean}
                a = moe_mod.aux_load_balance_loss(p["moe"], cfg, h, **kw)
            return (*ops.add_rmsnorm(x, _mlp(p, cfg, h, moe_impl, shard),
                                     w_next, eps=eps, impl=impl), a)
        x, h, a = (checkpoint(layer, x, h, use_reentrant=False,
                              **_remat_kwargs(remat_policy)) if remat
                   else layer(x, h))
        if a is not None:
            total = total + a
    return h, total


def backbone(params, cfg: ModelConfig, x, opts: RunOptions, *,
             enc_out=None, want_cache: bool = False, impl: str = "auto",
             train: bool = False, shard=None):
    """Forward through the layer stack at positions ``0..S-1`` and the
    final norm (``_residual_stream``; MoE blocks by ``opts.moe_impl``),
    an encoder-decoder model's decoder layers attending to ``enc_out``
    (B, L, D), the encoder's output.  ``train`` is the loss's forward:
    layers remat'd when ``opts.remat``, and the MoE layers' aux loss
    summed.  Returns ``(h, caches, aux)``: ``h`` the final norm's output
    (B, S, D); ``caches`` ``{posN: {k, v: (G, B, S, KVH, hd)}}`` (an SSM
    layer's ``{conv: (G, B, W - 1, C), ssm: (G, B, H, N, P)}``, the conv
    tail in the compute dtype and the state in f32; an encoder-decoder
    model's layers add the cross K/V ``ck``/``cv`` (G, B, L, KVH, hd))
    when ``want_cache``, else None; ``aux`` with ``train`` the 0-d f32
    sum of the MoE layers' load-balancing losses (0 without MoE layers),
    else None (serving computes no aux loss).  With
    ``opts.ring_local_cache`` a sliding-window layer of a prompt longer
    than its window W keeps its last W rows at slot = position mod W
    (``_ring_rows``).  ``shard`` is ``_residual_stream``'s (a sharded
    train step's placement, or a prefill cell's); under it the attention
    blocks run tensor-parallel where "model" splits their heads
    (``attention.attention``'s ``tp``; the cache holds this rank's KV
    heads, or every KV head where "model" does not divide them), the SSM
    blocks whole."""
    remat = train and opts.remat
    per_layer = {f"pos{i}": [] for i in range(cfg.scan_period())}
    tp = None if shard is None else shard.tp
    if enc_out is not None and tp is not None:
        # the encoder's output enters the split cross-attention blocks
        # through one copy: its gradient sums every layer's reads
        heads = params["blocks"]["pos0"]["cross"]["wq"].shape[2]
        if tp.split(heads, cfg.padded_heads) is not None:
            enc_out = tp.copy(enc_out)

    def mixer(g, i, kind, p, h):
        if kind == "ssm":
            mix, (conv, ssm) = ssm_mod.ssm_block(p["mixer"], cfg, h,
                                                 impl=impl)
            if want_cache:
                # the tail is a view of the conv's padded input: keep
                # only its rows
                per_layer[f"pos{i}"].append({"conv": conv.clone(),
                                             "ssm": ssm})
            return mix
        mix, (k, v) = attn_mod.attention(p["mixer"], cfg, h, kind=kind,
                                         q_chunk=opts.q_chunk, impl=impl,
                                         tp=tp, whole_kv=want_cache)
        if want_cache:
            if _ring(cfg, kind, opts):
                k, v = _ring_rows(k, cfg.sliding_window), \
                    _ring_rows(v, cfg.sliding_window)
            per_layer[f"pos{i}"].append({"k": k, "v": v})
        return mix

    def cross(g, i, p, h):
        mix, (ck, cv) = attn_mod.attention(p["cross"], cfg, h, x_kv=enc_out,
                                           causal=False,
                                           q_chunk=opts.q_chunk, impl=impl,
                                           tp=tp, whole_kv=want_cache)
        if want_cache:
            per_layer[f"pos{i}"][-1].update(ck=ck, cv=cv)
        return mix
    h, aux = _residual_stream(params, cfg, x, mixer, cross=cross,
                              impl=impl, remat=remat,
                              remat_policy=opts.remat_policy,
                              moe_impl=opts.moe_impl, aux=train,
                              shard=shard)
    if not want_cache:
        return h, None, aux
    return h, {pos: {key: torch.stack([c[key] for c in cs])
                     for key in cs[0]}
               for pos, cs in per_layer.items()}, aux


def _ring(cfg: ModelConfig, kind: str, opts: RunOptions) -> bool:
    """Whether a layer of ``kind`` keeps a ring-buffer cache."""
    return bool(kind == "attn_local" and opts.ring_local_cache
                and cfg.sliding_window)


def _ring_rows(k, window: int):
    """The ring-buffer rows of a prompt's K or V (B, S, KVH, hd): all S
    rows where S <= window, else the last ``window`` rolled by S mod
    window, so that position t sits at slot t mod window, the slot rule
    of ``attention.ring_decode_attention``.  (The reference keeps the
    last rows in position order, which agrees with that rule only where
    S is a multiple of the window.)"""
    S = k.shape[1]
    if S <= window:
        return k
    return torch.roll(k[:, -window:], shifts=S % window, dims=1)


def _embed_inputs(params, cfg: ModelConfig, batch, *, impl: str = "auto",
                  shard=None):
    """Token embedding of ``batch["tokens"]`` (B, S): x (B, S, D) in the
    compute dtype; where the batch holds ``tok_embeds`` (B, S, D), those
    precomputed embeddings in the compute dtype instead (the compressed
    train step gathers them outside the synced gradient, as the
    reference's does).  In a vision model, where the batch holds the stub
    patch embeddings ``batch["patches"]`` (B, P, frontend_dim), the
    patches in the compute dtype through ``frontend_proj`` are written
    over rows ``[0, P)`` of x, as the reference's
    ``dynamic_update_slice`` does (under autograd the embedding rows
    overwritten get no gradient from those positions, ``frontend_proj``
    all of it); without patches x is the text embedding alone.  In an
    encoder-decoder model, the encoder's output for the stub frame
    embeddings ``batch["audio"]`` (B, L, frontend_dim):
    the frames through ``frontend_proj`` in the compute dtype, the encoder
    stack (non-causal self-attention at positions 0..L-1, the dense MLP)
    and its final norm.  Returns ``(x, enc_out)``, ``enc_out`` (B, L, D)
    or None.  In a sharded step (``shard``) whose "model" axis splits the
    vocabulary, ``params["embed"]`` is this rank's rows and the lookup is
    vocab-parallel (``parallel.tensor.embed_lookup``); the encoder runs
    whole on every rank (its leaves gathered at the loss's entry).

    Raises:
      ValueError: patches longer than the prompt (the reference's
          ``dynamic_update_slice`` refuses them too, with a TypeError)."""
    dt = compute_dtype(cfg)
    if "tok_embeds" in batch:
        x = batch["tok_embeds"].to(dt, copy=True)
    else:
        x = _token_embedding(params, cfg, batch["tokens"], shard)
    if cfg.frontend == "vision" and "patches" in batch:
        patches = batch["patches"]
        n, S = patches.shape[1], x.shape[1]
        if n > S:
            raise ValueError(
                f"{cfg.name}: a prompt of {S} tokens is shorter than the "
                f"{n} patch embeddings written over its first rows "
                "(frontend_len)")
        x[:, :n] = patches.to(dt) @ params["frontend_proj"].to(dt)
    if not cfg.encoder_decoder:
        return x, None
    enc, enc_cfg = params["encoder"], _encoder_cfg(cfg)
    e = batch["audio"].to(dt) @ params["frontend_proj"].to(dt)

    def mixer(g, i, kind, p, h):
        return attn_mod.attention(p["mixer"], enc_cfg, h, causal=False,
                                  impl=impl)[0]
    return x, _residual_stream(enc, enc_cfg, e, mixer, impl=impl)[0]


def _token_embedding(params, cfg: ModelConfig, tokens, shard=None):
    """Rows ``tokens`` of the embedding in the compute dtype; in a sharded
    step or cell (``shard``) whose "model" axis splits the vocabulary,
    vocab-parallel over this rank's rows (``embed_lookup``)."""
    emb, tokens = params["embed"], tokens.long()
    tp = _tp(shard, emb.shape[0], cfg.vocab_size)
    x = emb[tokens] if tp is None else embed_lookup(emb, tokens, tp)
    return x.to(compute_dtype(cfg))


def _head_logits(h, params, cfg: ModelConfig, shard=None):
    """``h @ w_out`` in h's dtype, as f32: where a sharded cell's "model"
    axis splits the vocabulary, this rank's columns gathered over it, so
    every rank returns the logits whole."""
    w = _output_weight(params, cfg)
    logits = h @ w.to(h.dtype)
    tp = _tp(shard, w.shape[1], cfg.vocab_size)
    if tp is not None:
        logits = tp.gather(logits, logits.dim() - 1)
    return logits.float()


def _maybe_bf16(params, opts: RunOptions):
    """The optional one-shot bf16 cast of the f32 weights at the loss's
    entry (``opts.bf16_weights``): one cast per parameter instead of one
    per use."""
    if not opts.bf16_weights:
        return params
    return tree_map(
        lambda p: p.to(torch.bfloat16) if p.dtype == torch.float32 else p,
        params)


def lm_loss(params, cfg: ModelConfig, batch,
            opts: RunOptions = RunOptions(), *, shard=None):
    """Mean next-token cross-entropy of ``batch`` (``tokens``, ``labels``:
    (B, S) int32; labels < 0 are masked; a vision model's batch may
    carry ``patches`` (B, frontend_len, frontend_dim) f32, an
    encoder-decoder model's must carry ``audio`` (B, encoder_len,
    frontend_dim) f32), plus ``opts.aux_loss_weight`` times the MoE
    layers' summed load-balancing loss in an MoE config (a hybrid one
    too).  Returns ``(loss, {"xent", "aux_loss"})``, 0-d f32 tensors:
    ``xent`` the cross-entropy alone, ``aux_loss`` the unweighted sum (0
    without MoE layers), as the reference returns them.

    The forward is the reference's, in plain PyTorch throughout
    (``impl="plain"``: no kernel of the port has a backward, and neither
    has the reference's): the patch rows or the encoder stack
    (``_embed_inputs``; the encoder is not remat'd, as in the
    reference), the dense query-chunked attention (non-causal against
    the encoder's output in a decoder's cross-attention), the SSM
    block's chunked SSD, the MoE blocks by ``opts.moe_impl`` (the
    capacity path's drops included: backward runs through the stable
    sort, the capacity windows and the fixed-order combine), each
    residual add fused into the norm that reads it (the plain
    ``add_rmsnorm``, bit-equal to the reference's add, then norm), the
    decoder's layers remat'd per ``opts``, and the chunked cross-entropy
    against the output weight in the compute dtype
    (``softmax_xent_chunked`` then rounds it to bf16, as the reference
    does even in f32 configs).

    ``shard`` (a ``parallel.fsdp.Fsdp``), where given, holds the
    placement of ``params``, sharded over the mesh's "data" and "model"
    axes: every leaf outside the decoder's ``blocks`` is gathered at
    entry (the embedding's and the head's vocabulary slices kept), each
    decoder layer's leaves where the layer runs; the layers that "model"
    splits run tensor-parallel, the embedding and the cross-entropy
    vocab-parallel; the aux loss's routing statistics are averaged over
    the data-parallel ranks.

    Raises:
      KeyError: an encoder-decoder batch without ``audio``, as in the
          reference."""
    if shard is not None:
        params = shard.outside_blocks(params)
    params = _maybe_bf16(params, opts)
    x, enc_out = _embed_inputs(params, cfg, batch, impl="plain",
                               shard=shard)
    h, _, aux = backbone(params, cfg, x, opts, enc_out=enc_out,
                         impl="plain", train=True, shard=shard)
    w = _output_weight(params, cfg)
    total, count = softmax_xent_chunked(
        h, w.to(h.dtype), batch["labels"], chunk=opts.xent_chunk,
        tp=_tp(shard, w.shape[1], cfg.vocab_size))
    xent = total / torch.clamp(count, min=1.0)
    loss = (xent + opts.aux_loss_weight * aux if cfg.moe is not None
            else xent)
    return loss, {"xent": xent, "aux_loss": aux}


def prefill(params, cfg: ModelConfig, batch, opts: RunOptions = RunOptions(),
            *, impl: str = "auto", shard=None):
    """Run the prompts ``batch["tokens"]`` (B, S) through the model (a
    vision model's first rows the projected ``batch["patches"]`` where
    given, an encoder-decoder model's decoder attending to the encoder's
    output for ``batch["audio"]``, see ``_embed_inputs``).  Returns
    ``(last_logits (B, 1, V) f32, cache)``, the cache ``{posN: {k, v: (G,
    B, S, KVH, hd)}}`` in the compute dtype (a ring-buffer layer's ``min(S, W)``
    rows with ``opts.ring_local_cache``; an SSM layer's ``conv`` tail and
    f32 ``ssm`` state; an encoder-decoder model's ``ck``/``cv`` too, see
    ``backbone``).

    ``shard`` (a ``parallel.fsdp.Fsdp``): one rank's part of a prefill
    cell over a mesh (``launch.steps.build_cell``), ``params`` this
    rank's slices and ``batch`` its rows: the leaves are gathered where
    they are used, as in the sharded train step, the layers that "model"
    splits run tensor-parallel, and the logits come out whole over the
    vocabulary; the cache holds this rank's rows, and this rank's KV heads
    where "model" splits them (``backbone``)."""
    if shard is not None:
        params = shard.outside_blocks(params)
    x, enc_out = _embed_inputs(params, cfg, batch, impl=impl, shard=shard)
    h, caches, _ = backbone(params, cfg, x, opts, enc_out=enc_out,
                            want_cache=True, impl=impl, shard=shard)
    return _head_logits(h[:, -1:], params, cfg, shard), caches


def cache_entry_shapes(cfg: ModelConfig, pos_idx: int, batch: int, seq: int,
                       opts: RunOptions = RunOptions()):
    """Shape/axes template of one period position's cache entry
    (attention layers: ``k``/``v`` of (batch, seq, KVH, hd); a
    ring-buffer layer, ``opts.ring_local_cache``, ``min(seq, W)`` rows;
    an SSM layer: ``conv`` (batch, W - 1, conv_dim) and ``ssm`` (batch,
    H, N, P), whatever ``seq``; an encoder-decoder model's layers add
    ``ck``/``cv`` (batch, encoder_len, KVH, hd), whatever ``seq``)."""
    kind = cfg.layer_kinds()[pos_idx]
    kvh, hd = cfg.padded_kv_heads, cfg.resolved_head_dim
    if kind == "ssm":
        _, nheads, conv_dim = ssm_mod.ssm_dims(cfg)
        s = cfg.ssm
        ent = {"conv": ((batch, s.conv_width - 1, conv_dim),
                        ("batch", None, "ssm_inner")),
               "ssm": ((batch, nheads, s.d_state, s.head_dim),
                       ("batch", "ssm_heads", None, None))}
    else:
        t = min(seq, cfg.sliding_window) if _ring(cfg, kind, opts) else seq
        axes = ("batch", "seq_shard", "kv_heads", None)
        ent = {"k": ((batch, t, kvh, hd), axes),
               "v": ((batch, t, kvh, hd), axes)}
    if cfg.encoder_decoder:
        axes = ("batch", None, "kv_heads", None)
        ent["ck"] = ((batch, cfg.encoder_len, kvh, hd), axes)
        ent["cv"] = ((batch, cfg.encoder_len, kvh, hd), axes)
    return ent


def init_cache(cfg: ModelConfig, batch: int, seq: int,
               opts: RunOptions = RunOptions(), device=None):
    """Zero dense cache ``{posN: {k, v: (G, batch, seq, KVH, hd)}}`` in the
    compute dtype (``cache_entry_shapes``' rows); an SSM layer's ``ssm``
    state in f32, as the reference keeps it."""
    g = cfg.num_layers // cfg.scan_period()
    return {f"pos{i}": {
        key: torch.zeros((g,) + shape, device=device,
                         dtype=(torch.float32 if key == "ssm"
                                else compute_dtype(cfg)))
        for key, (shape, _) in cache_entry_shapes(cfg, i, batch, seq,
                                                  opts).items()}
        for i in range(cfg.scan_period())}


def grow_cache(cache, rows: int):
    """A prefill's cache with each ``k``/``v`` leaf (G, B, S, KVH, hd)
    zero-padded along the sequence to ``rows``, to hold the generation;
    every other leaf (an SSM layer's ``conv``/``ssm`` states, an
    encoder-decoder model's ``ck``/``cv``) has no sequence axis and is
    kept as it is."""
    return {pos: {key: (torch.cat([c, c.new_zeros(c.shape[:2]
                                                  + (rows - c.shape[2],)
                                                  + c.shape[3:])], dim=2)
                        if key in ("k", "v") else c)
                  for key, c in ent.items()}
            for pos, ent in cache.items()}


def decode_step(params, cfg: ModelConfig, cache, tokens, pos,
                opts: RunOptions = RunOptions(), *, impl: str = "auto",
                shard=None, layout=None):
    """One token for every slot.  tokens: (B, 1) int32; pos: (B,) int32
    next write position (the fixed-slot engine parks idle slots on the
    scratch index ``T - 1``).  A sliding-window layer whose cache holds
    exactly W rows under ``opts.ring_local_cache`` decodes against it as
    a ring (``attention.ring_decode_attention``), as the reference
    chooses.  An SSM layer runs one step of its recurrence from the
    slot's ``conv`` and ``ssm`` states (``pos`` unread).  An
    encoder-decoder model's layers attend to the slot's cached encoder
    K/V (``ck``/``cv``), which no step writes.

    Writes the new K/V, and the new SSM states, into ``cache`` in place
    (``copy_``: a captured step replays on fixed addresses) and returns
    ``(logits (B, 1, V) f32, cache)``.

    ``shard`` and ``layout``: one rank's part of a decode cell over a
    mesh (``launch.steps.build_cell``): ``params`` this rank's slices
    (``shard``, a ``parallel.fsdp.Fsdp``, gathers them where they are
    used), ``tokens``/``pos`` its rows, ``cache`` its slice of the cache
    and ``layout`` ``{posN: {leaf: parallel.sequence.LeafSplit}}`` how
    that slice lies: the attention blocks split their heads over "model"
    and, where a leaf's sequence is split, attend this rank's rows and
    merge the ranks' states (``attention.decode_attention``'s ``seq``);
    an SSM block runs whole on states gathered over "model" and keeps
    this rank's slice of the new ones.  The logits come out whole."""
    if shard is not None:
        params = shard.outside_blocks(params)
    x = _token_embedding(params, cfg, tokens, shard)
    tp = None if shard is None else shard.tp

    def mixer(g, i, kind, p, h):
        c = _layer(cache[f"pos{i}"], g)
        lay = {} if layout is None else layout[f"pos{i}"]
        if kind == "ssm":
            mix, (conv, ssm) = ssm_mod.ssm_block(
                p["mixer"], cfg, h,
                conv_state=_model_whole(c["conv"], lay.get("conv"), tp),
                ssm_state=_model_whole(c["ssm"], lay.get("ssm"), tp),
                decode=True, impl=impl)
            c["conv"].copy_(_model_slice(conv, lay.get("conv"), tp))
            c["ssm"].copy_(_model_slice(ssm, lay.get("ssm"), tp))
            return mix
        seq = lay["k"].seq if "k" in lay else None
        if (_ring(cfg, kind, opts) and c["k"].shape[1] * (
                1 if seq is None else seq.n) == cfg.sliding_window):
            return attn_mod.ring_decode_attention(
                p["mixer"], cfg, h, c["k"], c["v"], pos, impl=impl, tp=tp,
                seq=seq)[0]
        return attn_mod.decode_attention(p["mixer"], cfg, h, c["k"], c["v"],
                                         pos, kind=kind, impl=impl, tp=tp,
                                         seq=seq)[0]

    # every slot attends to all encoder_len rows of its ck/cv: one
    # lengths tensor for every layer
    enc_len = (torch.full_like(pos, cfg.encoder_len)
               if cfg.encoder_decoder else None)

    def cross(g, i, p, h):
        c = _layer(cache[f"pos{i}"], g)
        return attn_mod.decode_attention(p["cross"], cfg, h, c["ck"],
                                         c["cv"], pos, cross=True,
                                         lengths=enc_len, impl=impl,
                                         tp=tp)[0]
    h, _ = _residual_stream(params, cfg, x, mixer, cross=cross, impl=impl,
                            shard=shard)
    return _head_logits(h, params, cfg, shard), cache


def _model_whole(t, split, tp):
    """A layer's cache leaf whole over "model" where ``split`` (a
    ``parallel.sequence.LeafSplit``) says "model" splits one of its
    dimensions."""
    if split is None or split.model_dim is None:
        return t
    return tp.gather(t, split.model_dim)


def _model_slice(t, split, tp):
    """This rank's "model" slice of a whole leaf (see ``_model_whole``)."""
    if split is None or split.model_dim is None:
        return t
    return t.chunk(tp.n, split.model_dim)[tp.rank]


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

def paged_decode_step(params, cfg: ModelConfig, cache, tokens, pos,
                      page_table, n_valid, *, impl: str = "auto"):
    """Advance every seat by up to C tokens against the paged KV pool.

    tokens: (A, C) int32 (C=1: batched decode; C>1: one prefill chunk);
    pos: (A,) int32 first position of each seat's chunk;
    page_table: (A, n) int32 logical->physical page map;
    n_valid: (A,) int32 valid tokens per seat (0 = idle seat; its writes
    go to the scratch page and its logits are garbage).
    ``impl`` selects kernel or plain version for the norms and the decode
    attention (see ``kernels.ops``).  Each residual add is fused into the
    norm that reads it (``_residual_stream``).  In an MoE model every row
    routes, an idle seat's and a chunk's padding too, and takes expert
    capacity after the rows of lower seats and positions, as in the
    reference.

    Writes the new K/V into ``cache`` in place and returns
    ``(logits (A, C, V) f32, cache)``.
    """
    C = tokens.shape[1]
    x = params["embed"][tokens.long()].to(compute_dtype(cfg))
    qpos = pos[:, None] + torch.arange(C, dtype=torch.int32,
                                       device=tokens.device)[None, :]

    def mixer(g, i, kind, p, h):
        return attn_mod.paged_attention(
            p["mixer"], cfg, h, _layer(cache[f"pos{i}"], g), page_table,
            qpos, n_valid, kind=kind, impl=impl)
    h, _ = _residual_stream(params, cfg, x, mixer, impl=impl)
    logits = h @ _output_weight(params, cfg).to(h.dtype)
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
