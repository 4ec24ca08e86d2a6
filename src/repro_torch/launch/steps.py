"""The cells of the port (counterpart of ``repro.launch.steps.build_cell``):
the train step, the prefill step and the decode step of one (arch ×
shape), on one device or over a mesh of ranks.

``build_cell(cfg, shape, opts)`` returns a :class:`Cell` whose ``fn(params,
opt_state, batch)`` takes one AdamW step on ``models.model.lm_loss`` (the
mean next-token cross-entropy, plus the weighted load-balancing aux loss
of an MoE config), with ``opts.microbatches`` gradient accumulation (the
loss, ``xent`` and ``aux_loss`` averaged over the microbatches, as the
reference's scan does) and the lr from ``wsd_schedule`` at the
optimizer's count.  Its metrics carry the reference's keys: ``xent``,
``aux_loss``, AdamW's ``grad_norm``, ``loss`` and ``lr``.  Where the
reference's jitted step donates params and optimizer state and returns
new ones, the port updates them in place and returns them.

A prefill shape's cell runs ``fn(params, batch)``, ``models.model.
prefill``, and a decode shape's ``fn(params, cache, tokens, pos)``,
``models.model.decode_step``; their params are bf16
(``Cell.param_dtype``), as the reference's serving cells lay them out.
The serving engines call ``models.model`` directly.

``build_cell(..., mesh=mesh)`` is the step over a ``launch.mesh.Mesh``
with ``"data"`` (and ``"pod"``, ``"model"``) axes: the params, the
AdamW moments (and the error feedback) are sharded over "data" and
"model" by the rules (``parallel.fsdp``); each rank takes its rows of
the global batch (``Cell.rows``; ``fn`` takes those rows; the ranks of
one "model" group take the same rows) and the loss is their mean.  The
layers split over "model" (attention heads, MLP and expert ff, the
vocabulary of the embedding and the cross-entropy) run tensor-parallel
(``parallel.tensor``), so every gradient comes out whole, or as this
rank's slice, on each model rank and needs no sum over "model"; the
grad norm sums each leaf's squares over the axes that split it.  Two
gradient syncs, by ``opts.grad_sync``:

- ``"auto"``: the gathers' backward reduce-scatters the gradients over
  "data", an all-reduce over "pod" sums the shards across pods, and the
  sum is divided by the data-parallel size: the hierarchical schedule
  of ``core.collectives.hierarchical_psum`` with the shard kept for the
  optimizer.  AdamW runs on the shards.
- ``"compressed"`` (a mesh with "pod"): the reference's rail-optimized
  step.  The in-pod mean of each leaf is divided by the number of pods,
  the error feedback ``ef`` added, and the sum quantized to int8 with
  one scale per whole tensor; the int8 payloads and scales cross the
  pods (an all-gather) and are dequantized and summed; the new ``ef`` is
  what quantization left out.  The token embedding is gathered outside
  the synced gradient (``tok_embeds``) and its input-path gradient is
  summed exactly and added to the embedding's.  Loss and metrics are
  averaged over the pods.

The serving cells over a mesh place their params as the train step does
(FSDP over "data", tensor parallelism over "model"; the SSM and an
encoder gathered and run whole) and take this rank's rows of the batch
(``Cell.rows``: every rank the same rows where the batch is below the
data-parallel size).  Each returns the logits of its rows, whole over the
vocabulary.  The decode cell's cache is laid out by the rules
(``("layers", "batch", "seq_shard", "kv_heads", None)``; with
``RunOptions.decode_kv_seq_axis`` the sequence takes every axis the batch
leaves free, and a batch below the data-parallel size puts it on "data"):
``Cell.shard_cache`` cuts a whole cache to this rank's slice and
``Cell.init_cache`` makes a zero one.  Where the sequence is split, each
rank attends its rows and the ranks' states are merged
(``parallel.sequence``).  The prefill cell's cache is this rank's rows,
laid out by the same rules at the prompt's length.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.collectives import all_gather, int8_compress
from repro_torch.models import model as M
from repro_torch.optim.adamw import (AdamWConfig, adamw_update,
                                     init_opt_state)
from repro_torch.optim.schedules import wsd_schedule
from repro_torch.parallel.fsdp import Fsdp, Split, local_rows
from repro_torch.parallel.sequence import LeafSplit, SeqSplit
from repro_torch.parallel.sharding import (DEFAULT_RULES, LogicalRules,
                                           activation_rules, rules_for_mesh,
                                           shardings_for_tree)
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

KINDS = ("train", "prefill", "decode")


@dataclasses.dataclass(frozen=True)
class Cell:
    """One (arch × shape) step.  A train cell's ``fn(params, opt_state,
    batch) -> (params, opt_state, metrics)``; a prefill cell's
    ``fn(params, batch) -> (logits, cache)``; a decode cell's
    ``fn(params, cache, tokens, pos) -> (logits, cache)``.  On a mesh
    also: ``rules``; ``fsdp``, the params' placement; ``rows``, this
    rank's rows ``(lo, hi)`` of the global batch; a train cell's
    ``grads(params, opt_state, batch, keep=False)``, the step's loss and
    synced gradients before AdamW (``fn`` is ``grads`` then AdamW); a
    serving cell's ``cache_splits``, the cache's placement (a tree like
    the cache of ``parallel.fsdp.Split``, None for a leaf whole on every
    rank), and a decode cell's ``layout``, the same placement in the
    layers' view (``parallel.sequence.LeafSplit``)."""
    name: str
    fn: Any
    cfg: ModelConfig
    shape: ShapeConfig
    mesh: Any = None
    rules: Optional[LogicalRules] = None
    fsdp: Optional[Fsdp] = None
    rows: Optional[Tuple[int, int]] = None
    grads: Any = None
    compressed: bool = False
    opts: Optional[M.RunOptions] = None
    cache_splits: Any = None
    layout: Any = None

    @property
    def param_dtype(self) -> torch.dtype:
        """The params' dtype: f32 for training, bf16 for serving, as the
        reference's cells lay them out."""
        return torch.float32 if self.shape.kind == "train" else \
            torch.bfloat16

    def shard_params(self, params):
        """This rank's slices of a whole params tree (a copy of each), or
        the tree as it is without a mesh."""
        return params if self.fsdp is None else self.fsdp.shard(params)

    def init_opt(self, params):
        """A zero AdamW state built on ``params`` (this rank's slices on a
        mesh: ``optim.adamw.init_opt_state`` never sees a whole leaf), and,
        for the compressed sync, a zero f32 error feedback ``ef``."""
        return self._with_ef(init_opt_state(params), params)

    def shard_state(self, params, opt_state):
        """This rank's slices of a whole params tree and AdamW state
        (``optim.adamw.init_opt_state``, or a restored one), and, for the
        compressed sync, a zero error feedback ``ef`` (f32) sharded like
        the params."""
        opt = {"mu": self.fsdp.shard(opt_state["mu"]),
               "nu": self.fsdp.shard(opt_state["nu"]),
               "count": opt_state["count"].clone()}
        params = self.fsdp.shard(params)
        return params, self._with_ef(opt, params)

    def _with_ef(self, opt, params):
        """``opt`` with, for the compressed sync, a zero f32 error
        feedback ``ef`` like ``params``."""
        if self.compressed:
            opt["ef"] = tree_map(
                lambda p: torch.zeros_like(p, dtype=torch.float32), params)
        return opt

    def cache_shapes(self):
        """The whole cache's leaf shapes (a serving cell's), ``{posN:
        {leaf: (G, B, T, ...)}}``."""
        return _cache_shapes_axes(self.cfg, self.shape, self.opts)[0]

    def shard_cache(self, cache):
        """This rank's slice of a whole cache (a copy of each leaf; without
        a mesh the cache as it is)."""
        if self.cache_splits is None:
            return cache
        return {pos: {key: (t.clone() if self.cache_splits[pos][key] is None
                            else self.cache_splits[pos][key].slice(t))
                      for key, t in ent.items()}
                for pos, ent in cache.items()}

    def init_cache(self, device=None):
        """A zero cache of this rank's shape (the whole one without a
        mesh), in the compute dtype with an SSM layer's ``ssm`` state in
        f32, as ``models.model.init_cache``."""
        splits = self.cache_splits or {}
        dt = M.compute_dtype(self.cfg)
        return {pos: {key: torch.zeros(
            _local_shape(shape, splits.get(pos, {}).get(key)),
            device=device, dtype=torch.float32 if key == "ssm" else dt)
            for key, shape in ent.items()}
            for pos, ent in self.cache_shapes().items()}

    def state_shardings(self):
        """The placement of ``{"params", "opt"}`` for
        ``CheckpointManager.save``/``restore``."""
        splits = self.fsdp.splits()
        opt = {"mu": splits, "nu": splits, "count": None}
        if self.compressed:
            opt["ef"] = splits
        return {"params": splits, "opt": opt}


def _grads(params, cfg: ModelConfig, batch, opts: M.RunOptions, *,
           shard=None, wrt=()):
    """``((loss, metrics), grads, wrt_grads)`` of ``lm_loss`` at
    ``params`` (sharded by ``shard`` where given), and the gradients of
    the extra inputs ``wrt`` (name -> tensor, added to the batch)."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    extra = {k: v.detach().requires_grad_(True) for k, v in wrt}
    loss, metrics = M.lm_loss(leaves, cfg, {**batch, **extra}, opts,
                              shard=shard)
    inputs = tree_leaves(leaves) + list(extra.values())
    gs = torch.autograd.grad(loss, inputs, materialize_grads=True)
    n = len(inputs) - len(extra)
    return ((loss.detach(), {k: v.detach() for k, v in metrics.items()}),
            tree_unflatten(leaves, gs[:n]), list(gs[n:]))


def value_and_grad(params, cfg: ModelConfig, batch, opts: M.RunOptions):
    """``((loss, metrics), grads)`` of ``lm_loss`` at ``params``: the
    grads a tree like ``params``, everything detached; a leaf the loss
    does not read (a vision model's ``frontend_proj`` on a batch without
    ``patches``) gets zeros, as ``jax.grad`` gives it."""
    out, grads, _ = _grads(params, cfg, batch, opts)
    return out, grads


def _accumulated(params, cfg, batch, opts, k: int, rows: int, shard=None):
    """Loss and grads, accumulated over ``k`` microbatches when the
    ``rows`` rows divide: grads and metrics summed ``/k``, the loss
    too."""
    if k <= 1 or rows % k != 0:
        out, grads, _ = _grads(params, cfg, batch, opts, shard=shard)
        return out, grads
    mb = rows // k
    acc_g = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                     params)
    zero = lambda: torch.zeros((), dtype=torch.float32,  # noqa: E731
                               device=batch["tokens"].device)
    acc_l, acc_m = zero(), {"xent": zero(), "aux_loss": zero()}
    for j in range(k):
        mbatch = {key: v[j * mb:(j + 1) * mb] for key, v in batch.items()}
        (loss, metrics), grads, _ = _grads(params, cfg, mbatch, opts,
                                           shard=shard)
        for a, g in zip(tree_leaves(acc_g), tree_leaves(grads)):
            a.add_(g / k)
        acc_l = acc_l + loss / k
        acc_m = {key: acc_m[key] + v / k for key, v in metrics.items()}
    return (acc_l, acc_m), acc_g


def _cache_shapes_axes(cfg: ModelConfig, shape: ShapeConfig, opts):
    """The whole cache's stacked leaf shapes and logical axes, ``{posN:
    {leaf: ...}}``, of a serving cell (``models.model.
    cache_entry_shapes`` with the stacked ``("layers",)`` axis first)."""
    g = cfg.num_layers // cfg.scan_period()
    shapes, axes = {}, {}
    for i in range(cfg.scan_period()):
        ent = M.cache_entry_shapes(cfg, i, shape.global_batch,
                                   shape.seq_len, opts)
        shapes[f"pos{i}"] = {k: (g,) + s for k, (s, _) in ent.items()}
        axes[f"pos{i}"] = {k: ("layers",) + a for k, (_, a) in ent.items()}
    return shapes, axes


def _local_shape(shape, split):
    """A leaf's shape on this rank under ``split`` (None: whole)."""
    out = list(shape)
    for dim, n, _, _ in (split.parts if split is not None else ()):
        out[dim] //= n
    return tuple(out)


def _cache_placement(cfg, shape, opts, mesh, rules):
    """``(splits, layout)`` of a serving cell's cache over ``mesh`` by
    ``rules`` (``spec_for_shape``: an axis that does not divide a
    dimension, or is used already, is dropped): per leaf its ``Split``,
    and its ``LeafSplit`` in a layer's view (the stacked axis dropped:
    the sequence is dimension 1 of ``k``/``v``)."""
    shapes, axes = _cache_shapes_axes(cfg, shape, opts)
    placements = shardings_for_tree(axes, mesh, rules, shapes)
    splits, layout = {}, {}
    for pos, ent in placements.items():
        splits[pos], layout[pos] = {}, {}
        for key, pl in ent.items():
            parts = tuple((dim, mesh.shape[a], mesh.coordinate(a),
                           mesh.group(a)) for a, dim in pl.splits)
            splits[pos][key] = Split(parts) if parts else None
            seq = ([a for a, dim in pl.splits if dim == 2]
                   if key in ("k", "v") else [])
            model = [dim for a, dim in pl.splits
                     if a == "model" and a not in seq]
            layout[pos][key] = LeafSplit(
                seq=SeqSplit.over(mesh, seq) if seq else None,
                model_dim=model[0] - 1 if model else None)
    return splits, layout


def build_cell(cfg: ModelConfig, shape: ShapeConfig,
               opts: Optional[M.RunOptions] = None, *, mesh=None,
               base_rules: Optional[LogicalRules] = None,
               lr_peak: float = 3e-4, total_steps: int = 10_000,
               adamw: AdamWConfig = AdamWConfig(),
               pad_heads: Optional[int] = None) -> Cell:
    """The cell of ``cfg`` at ``shape``: its train, prefill or decode step
    by ``shape.kind``, on one device, or over ``mesh`` with the rules
    ``base_rules`` (default ``DEFAULT_RULES``) restricted to it.
    ``pad_heads`` pads the attention heads to that count
    (``cfg.pad_heads_to``: the padded heads are masked to zero, so the
    function is the unpadded model's) so that they divide the model
    axis, as the reference's does.

    Raises:
      ValueError: an unknown ``shape.kind`` or ``grad_sync``, or a mesh
          without "data" (on a mesh, ``fn`` raises it for a batch whose
          rows differ from ``Cell.rows``).
      NotImplementedError: ``opts.pipeline`` (ROADMAP.md queue 1 item
          6c), or a train or prefill shape whose batch is too small for
          the data-parallel axes (sequence-parallel activations, item
          6b-iii)."""
    if shape.kind not in KINDS:
        raise ValueError(f"{shape.name}: kind {shape.kind!r}; one of "
                         f"{KINDS}")
    if pad_heads is not None:
        cfg = dataclasses.replace(cfg, pad_heads_to=pad_heads)
    opts = opts or M.RunOptions()
    if shape.kind != "train":
        return (_serving_cell(cfg, shape, opts, mesh, base_rules)
                if mesh is not None else _meshless_serving_cell(cfg, shape,
                                                                opts))
    if opts.grad_sync not in ("auto", "compressed"):
        raise ValueError(f"grad_sync={opts.grad_sync!r}: 'auto' or "
                         "'compressed'")
    if opts.pipeline:
        raise NotImplementedError(
            "pipeline parallelism over 'pod' is not ported yet: ROADMAP.md "
            "queue 1 item 6c")
    schedule = dict(peak=lr_peak, warmup_steps=total_steps // 100,
                    total_steps=total_steps)
    if mesh is not None:
        return _sharded_cell(cfg, shape, opts, mesh, base_rules, schedule,
                             adamw)
    k = opts.microbatches

    def train_step(params, opt_state, batch):
        (loss, metrics), grads = _accumulated(params, cfg, batch, opts, k,
                                              shape.global_batch)
        lr = wsd_schedule(opt_state["count"], **schedule)
        params, opt_state, om = adamw_update(grads, opt_state, params, lr,
                                             adamw)
        return params, opt_state, {**metrics, **om, "loss": loss, "lr": lr}

    return Cell(f"{cfg.name}:{shape.name}", train_step, cfg, shape,
                opts=opts)


def _meshless_serving_cell(cfg, shape, opts) -> Cell:
    name = f"{cfg.name}:{shape.name}"
    if shape.kind == "prefill":
        def prefill_step(params, batch):
            with torch.no_grad():
                return M.prefill(params, cfg, batch, opts)
        return Cell(name, prefill_step, cfg, shape, opts=opts)

    def decode_fn(params, cache, tokens, pos):
        with torch.no_grad():
            return M.decode_step(params, cfg, cache, tokens, pos, opts)
    return Cell(name, decode_fn, cfg, shape, opts=opts)


def _placement(shape, mesh, base_rules):
    """``(rules, batch_axes, rows)`` of a cell over ``mesh``:
    the rules restricted to the mesh and adjusted for a small batch
    (``activation_rules``), the mesh axes the batch is split over, and
    this rank's rows of the global batch.

    Raises:
      ValueError: a mesh without "data"."""
    if "data" not in mesh.axis_names:
        raise ValueError(f"{mesh}: a cell over a mesh needs a 'data' axis")
    rules = rules_for_mesh(mesh, base_rules or DEFAULT_RULES)
    rules, seq_sharded = activation_rules(rules, shape.global_batch, mesh)
    if seq_sharded and shape.kind != "decode":
        raise NotImplementedError(
            f"a {shape.kind} batch of {shape.global_batch} over "
            f"{mesh.shape}: sequence-parallel activations in the "
            "full-sequence path are not ported yet (ROADMAP.md queue 1 "
            "item 6b-iii)")
    b = rules.mesh_axes("batch")
    batch_axes = (b,) if isinstance(b, str) else tuple(b or ())
    return rules, batch_axes, local_rows(mesh, batch_axes,
                                         shape.global_batch)


def _check_rows(n: int, rows, shape) -> None:
    if n != rows[1] - rows[0]:
        raise ValueError(f"a batch of {n} rows; this rank's share of the "
                         f"global {shape.global_batch} is {rows[1] - rows[0]}"
                         f" (Cell.rows {rows})")


def _serving_cell(cfg, shape, opts, mesh, base_rules) -> Cell:
    rules, _, rows = _placement(shape, mesh, base_rules)
    if shape.is_decode and opts.decode_kv_seq_axis:
        # the reference's flash-decoding partition: the cache's sequence
        # takes every mesh axis the batch leaves free (``spec_for_shape``
        # drops the ones it uses)
        rules = rules.with_overrides(seq_shard=tuple(
            a for a in ("data", "model") if a in mesh.axis_names))
    fsdp = Fsdp.for_specs(M.param_specs(cfg), mesh, rules)
    splits, layout = _cache_placement(cfg, shape, opts, mesh, rules)
    wholes = _cache_shapes_axes(cfg, shape, opts)[0]
    name = f"{cfg.name}:{shape.name}"
    common = dict(mesh=mesh, rules=rules, fsdp=fsdp, rows=rows, opts=opts,
                  cache_splits=splits)
    if shape.kind == "prefill":
        def prefill_step(params, batch):
            _check_rows(batch["tokens"].shape[0], rows, shape)
            with torch.no_grad():
                logits, cache = M.prefill(params, cfg, batch, opts,
                                          shard=fsdp)
            return logits, _placed(cache, splits, wholes)
        return Cell(name, prefill_step, cfg, shape, **common)

    def decode_fn(params, cache, tokens, pos):
        _check_rows(tokens.shape[0], rows, shape)
        with torch.no_grad():
            return M.decode_step(params, cfg, cache, tokens, pos, opts,
                                 shard=fsdp, layout=layout)
    return Cell(name, decode_fn, cfg, shape, layout=layout, **common)


def _placed(cache, splits, wholes):
    """A prefill cell's cache on this rank's placement: a leaf this rank
    computed whole along a dimension that an axis splits (an SSM layer's
    states, run whole on every model rank) cut to its slice; its batch
    rows (dimension 1) and its KV heads are this rank's already, and no
    axis splits its sequence (a prefill cell that would is refused)."""
    def place(t, split, whole):
        for dim, n, rank, _ in (split.parts if split is not None else ()):
            if dim != 1 and n > 1 and t.shape[dim] == whole[dim]:
                t = t.chunk(n, dim)[rank]
        return t
    return {pos: {key: place(t, splits[pos][key], wholes[pos][key])
                  for key, t in ent.items()}
            for pos, ent in cache.items()}


def _mean_over(values, groups, size: int):
    """The mean over ``groups`` of 0-d tensors, each rank's own."""
    t = torch.stack(values)
    for g in groups:
        dist.all_reduce(t, group=g)
    return (t / size).unbind()


def _sharded_cell(cfg, shape, opts, mesh, base_rules, schedule,
                  adamw) -> Cell:
    rules, batch_axes, rows = _placement(shape, mesh, base_rules)
    if "data" not in batch_axes:
        raise ValueError(f"rules put the batch on {batch_axes}; the "
                         "sharded train step needs 'data' among them")
    dp = math.prod(mesh.shape[a] for a in batch_axes)
    batch_groups = [mesh.group(a) for a in batch_axes]
    pod = mesh.group("pod") if "pod" in batch_axes else None
    compressed = opts.grad_sync == "compressed" and pod is not None
    fsdp = Fsdp.for_specs(M.param_specs(cfg), mesh, rules,
                          mean_axes=("data",) if compressed else batch_axes)
    sharded = fsdp.sharded()
    groups = fsdp.groups()
    data = mesh.group("data")
    ndata = mesh.shape["data"]
    k = opts.microbatches
    keys = ("loss", "xent", "aux_loss")

    def _averaged(loss, metrics):
        vals = _mean_over([loss, metrics["xent"], metrics["aux_loss"]],
                          batch_groups, dp)
        out = dict(zip(keys, vals))
        return out.pop("loss"), out

    def grads_auto(params, opt_state, batch, keep=False):
        (loss, metrics), grads = _accumulated(params, cfg, batch, opts, k,
                                              rows[1] - rows[0], shard=fsdp)
        for g, split in zip(tree_leaves(grads), sharded):
            if not split:             # a leaf whole over "data": its part
                dist.all_reduce(g, group=data)
            if pod is not None:
                dist.all_reduce(g, group=pod)
            g.div_(dp)
        return _averaged(loss, metrics), grads, {}

    npods = mesh.shape["pod"] if pod is not None else 1
    emb_split = fsdp.splits()["embed"]
    emb_dim, emb_mdim = fsdp.dims["embed"], fsdp.mdims["embed"]

    def grads_compressed(params, opt_state, batch, keep=False):
        tokens = batch["tokens"].long()
        with torch.no_grad():
            emb = params["embed"]
            x_emb = (emb if emb_split is None
                     else emb_split.gather(emb))[tokens]
        (loss, metrics), gp, (gx,) = _grads(
            params, cfg, batch, opts, shard=fsdp, wrt=(("tok_embeds",
                                                        x_emb),))
        del x_emb
        raw, synced, new_ef = [], [], []
        for g, e, split, gs in zip(tree_leaves(gp),
                                   tree_leaves(opt_state["ef"]), sharded,
                                   groups):
            if not split:
                dist.all_reduce(g, group=data)
            g = g / ndata                            # the in-pod mean
            g32 = g.float() / npods + e
            q, s = int8_compress(g32, groups=gs)
            qs = [q] if npods == 1 else all_gather(q, pod).unbind()
            ss = [s] if npods == 1 else all_gather(s, pod).unbind()
            total = qs[0].float() * ss[0]
            for qp, sp in zip(qs[1:], ss[1:]):
                total += qp.float() * sp
            synced.append(total.to(g.dtype))
            new_ef.append(g32 - q.float() * s)
            if keep:
                raw.append(g)
        # the input-path embedding gradient of the whole table, summed
        # exactly over the data-parallel ranks (every model rank holds
        # the same ``gx``), then this rank's slice
        contrib = (gx / ndata / npods).reshape(-1, gx.shape[-1]).to(
            emb.dtype)
        emb_in = torch.zeros((cfg.vocab_size, contrib.shape[-1]),
                             dtype=emb.dtype, device=emb.device)
        emb_in.index_put_((tokens.reshape(-1),), contrib, accumulate=True)
        if emb_dim is None:
            dist.all_reduce(emb_in, group=data)
        else:
            emb_in = fsdp.reduce_scatter(emb_in, emb_dim)
        if emb_mdim is not None:
            emb_in = emb_in.chunk(fsdp.tp.n, emb_mdim)[fsdp.tp.rank]
        if pod is not None:
            dist.all_reduce(emb_in, group=pod)
        grads = tree_unflatten(gp, synced)
        grads["embed"] = grads["embed"] + emb_in
        extra = {"ef": tree_unflatten(gp, new_ef)}
        if keep:
            extra.update(grad=tree_unflatten(gp, raw),
                         synced=tree_unflatten(gp, synced), emb_in=emb_in)
        return _averaged(loss, metrics), grads, extra

    grads_fn = grads_compressed if compressed else grads_auto

    def train_step(params, opt_state, batch):
        _check_rows(batch["tokens"].shape[0], rows, shape)
        (loss, metrics), grads, extra = grads_fn(params, opt_state, batch)
        lr = wsd_schedule(opt_state["count"], **schedule)
        base = {key: opt_state[key] for key in ("mu", "nu", "count")}
        params, _, om = adamw_update(grads, base, params, lr, adamw,
                                     groups=groups)
        if compressed:
            for e, new in zip(tree_leaves(opt_state["ef"]),
                              tree_leaves(extra["ef"])):
                e.copy_(new)
        return params, opt_state, {**metrics, **om, "loss": loss, "lr": lr}

    return Cell(f"{cfg.name}:{shape.name}", train_step, cfg, shape,
                mesh=mesh, rules=rules, fsdp=fsdp, rows=rows,
                grads=grads_fn, compressed=compressed, opts=opts)

