"""The train step of the port (counterpart of the ``shape.kind ==
"train"`` branch of ``repro.launch.steps.build_cell``), on one device.

``build_cell(cfg, shape, opts)`` returns a :class:`Cell` whose ``fn(params,
opt_state, batch)`` takes one AdamW step on ``models.model.lm_loss`` (the
mean next-token cross-entropy, plus the weighted load-balancing aux loss
of an MoE config), with ``opts.microbatches`` gradient accumulation (the
loss, ``xent`` and ``aux_loss`` averaged over the microbatches, as the
reference's scan does) and the lr from ``wsd_schedule`` at the
optimizer's count.  Its metrics carry the reference's keys: ``xent``,
``aux_loss``, AdamW's ``grad_norm``, ``loss`` and ``lr``.  Where the reference's jitted step donates params and optimizer
state and returns new ones, the port updates them in place and returns
them.  Serving needs no cell: it calls ``models.model`` directly.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import model as M
from repro_torch.optim.adamw import AdamWConfig, adamw_update
from repro_torch.optim.schedules import wsd_schedule
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class Cell:
    """One (arch × shape) train step: ``fn(params, opt_state, batch) ->
    (params, opt_state, metrics)``."""
    name: str
    fn: Any
    cfg: ModelConfig
    shape: ShapeConfig


def value_and_grad(params, cfg: ModelConfig, batch, opts: M.RunOptions):
    """``((loss, metrics), grads)`` of ``lm_loss`` at ``params``: the
    grads a tree like ``params``, everything detached; a leaf the loss
    does not read (a vision model's ``frontend_proj`` on a batch without
    ``patches``) gets zeros, as ``jax.grad`` gives it."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, metrics = M.lm_loss(leaves, cfg, batch, opts)
    grads = tree_unflatten(leaves, torch.autograd.grad(
        loss, tree_leaves(leaves), materialize_grads=True))
    return ((loss.detach(), {k: v.detach() for k, v in metrics.items()}),
            grads)


def build_cell(cfg: ModelConfig, shape: ShapeConfig,
               opts: Optional[M.RunOptions] = None, *,
               lr_peak: float = 3e-4, total_steps: int = 10_000,
               adamw: AdamWConfig = AdamWConfig()) -> Cell:
    """The train step of ``cfg`` at ``shape`` (``kind == "train"``).

    Raises:
      ValueError: a prefill or decode shape (serving calls the model)."""
    if shape.kind != "train":
        raise ValueError(f"{shape.name}: the port builds train cells only; "
                         "serving runs models.model.prefill/decode_step")
    opts = opts or M.RunOptions()
    k = opts.microbatches

    def _value_and_grad_mb(params, batch):
        """Loss and grads, accumulated over ``k`` microbatches when the
        batch divides: grads and metrics summed ``/k``, the loss too."""
        if k <= 1 or shape.global_batch % k != 0:
            return value_and_grad(params, cfg, batch, opts)
        mb = shape.global_batch // k
        acc_g = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                         params)
        zero = lambda: torch.zeros((), dtype=torch.float32,  # noqa: E731
                                   device=batch["tokens"].device)
        acc_l, acc_m = zero(), {"xent": zero(), "aux_loss": zero()}
        for j in range(k):
            mbatch = {key: v[j * mb:(j + 1) * mb] for key, v in batch.items()}
            (loss, metrics), grads = value_and_grad(params, cfg, mbatch, opts)
            for a, g in zip(tree_leaves(acc_g), tree_leaves(grads)):
                a.add_(g / k)
            acc_l = acc_l + loss / k
            acc_m = {key: acc_m[key] + v / k for key, v in metrics.items()}
        return (acc_l, acc_m), acc_g

    def train_step(params, opt_state, batch):
        (loss, metrics), grads = _value_and_grad_mb(params, batch)
        lr = wsd_schedule(opt_state["count"], peak=lr_peak,
                          warmup_steps=total_steps // 100,
                          total_steps=total_steps)
        params, opt_state, om = adamw_update(grads, opt_state, params, lr,
                                             adamw)
        return params, opt_state, {**metrics, **om, "loss": loss, "lr": lr}

    return Cell(f"{cfg.name}:{shape.name}", train_step, cfg, shape)
