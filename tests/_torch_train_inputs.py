"""Inputs and checks shared by the port's training tests: the frontends'
batch entries drawn from numpy, the true fan-in scaling of the configs
that are ill-conditioned at the reference's initialization, the loss at
initialization of a family's reduced config, the gradient check against
JAX's, and the train steps against JAX's ``build_cell(...).fn``.

Test modules do ``from _torch_train_inputs import ...`` (``tests/`` is on
``sys.path``, as for ``_hypothesis_compat``).
"""
import dataclasses

import jax
import numpy as np
import torch

from repro.configs import get_config, reduced_config
from repro.configs.base import ShapeConfig
from repro.data.pipeline import TokenPipeline as JPipeline
from repro.launch.mesh import make_host_mesh
from repro.launch.steps import build_cell as jbuild_cell
from repro.models import model as JM
from repro.optim.adamw import init_opt_state as jinit_opt_state
from repro_torch.configs import ShapeConfig as TShapeConfig
from repro_torch.configs import get_config as tget
from repro_torch.configs import reduced_config as treduced
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch.steps import build_cell, value_and_grad
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_jax
from repro_torch.optim.adamw import init_opt_state
from repro_torch.tree import tree_leaves

#: The configs whose training tests scale stacked ``(G, d_model, ...)``
#: weights to their true fan-in, and which leaves.  The reference's
#: ``init_params`` takes a stacked leaf's fan-in to be its first axis (G =
#: 2 in a reduced config), so these weights draw with std 0.7 where
#: 1/sqrt(d_model) = 0.125 was meant.  Without qk-norm the scores then
#: reach tens and the softmax is nearly one-hot; there the f32 sums' ulps,
#: summed in another order by XLA and torch, part the gradients by 2.7e-3
#: of the largest (whisper-base), 1.1e-3 (qwen2-moe-a2.7b at capacity
#: factor 0.5), the head's by 1.4e-3 (grok-1-314b), and three AdamW steps
#: by 7e-3 of the update (phi-3-vision-4.2b).  jamba-v0.1-52b's SSM
#: ``in_proj`` makes each of its 14 SSM blocks amplify its input's
#: relative error ~25 times, and its gradients part by 2.9e-4 even where
#: nothing drops.  ``test_torch_minicpm.py`` scales its weights for the
#: same reason.
TRUE_FAN_IN = {"phi-3-vision-4.2b": ("wq", "wk"),
               "whisper-base": ("wq", "wk"),
               "qwen2-moe-a2.7b": ("wq", "wk"),
               "grok-1-314b": ("wq", "wk"),
               "jamba-v0.1-52b": ("wq", "wk", "in_proj")}

#: Three train steps against JAX's (``train_steps_vs_jax``).  f32
#: compute: losses rtol 1e-5, grad norms rtol 1e-3, lr rtol 1e-6; params
#: within 5e-5 and the whole update ``p_3 - p_0`` within 1e-3 of its norm
#: (XLA and torch sum the f32 matmuls in other orders; llama's third step
#: meets a grad-norm jump that carries those ulps to 2e-4).  bf16 compute:
#: XLA-CPU and torch-CPU bf16 matmuls may round each product's output one
#: bf16 step apart, and AdamW's normalized update turns a grad's rounding
#: into a step of the full lr where the moments nearly cancel: losses rtol
#: 2e-4, grad norms rtol 5e-3, lr rtol 1e-6, the update within 0.1 of its
#: norm.
TOL = {"float32": dict(loss=1e-5, grad_norm=1e-3, param=5e-5, update=1e-3),
       "bfloat16": dict(loss=2e-4, grad_norm=5e-3, param=None, update=0.1)}


def moe_cfgs(arch: str, cf: float, dtype: str = "float32"):
    """The reduced MoE config ``arch`` at capacity factor ``cf`` in the JAX
    package and in the port, equal field by field."""
    out = []
    for get, reduce in ((get_config, reduced_config), (tget, treduced)):
        cfg = reduce(get(arch), compute_dtype=dtype)
        out.append(dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cf)))
    assert dataclasses.asdict(out[0]) == dataclasses.asdict(out[1])
    return out


def true_fan_in(tree, d_model: int, leaves=("wq", "wk")):
    """A numpy params tree with each stacked leaf named in ``leaves``
    ((G, d_model, ...): an attention block's ``wq``/``wk``, an SSM
    block's ``in_proj``) scaled by sqrt(G / d_model)."""
    return {k: true_fan_in(v, d_model, leaves) if isinstance(v, dict) else
            (v * np.float32(np.sqrt(v.shape[0] / d_model))
             if k in leaves else v)
            for k, v in tree.items()}


def frontend_inputs(cfg, batch: int, seed: int):
    """A vision model's ``patches`` (batch, frontend_len, frontend_dim) or
    an encoder-decoder model's ``audio`` (batch, encoder_len,
    frontend_dim): standard-normal f32 numpy arrays at ``seed``; {} for
    a text-only model."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "vision":
        return {"patches": rng.standard_normal(
            (batch, cfg.frontend_len, cfg.frontend_dim)).astype(np.float32)}
    if cfg.encoder_decoder:
        return {"audio": rng.standard_normal(
            (batch, cfg.encoder_len, cfg.frontend_dim)).astype(np.float32)}
    return {}


def loss_at_init(params, cfg, *, batch: int = 2, seq: int = 32,
                 seed: int = 0, frontend: bool = True):
    """The port's ``lm_loss`` and gradients on random tokens (and, with
    ``frontend``, the frontend's inputs) at ``seed``: the loss must be
    finite and within 1.5 of ln(vocab), the reference's criterion at
    initialization (``tests/test_archs.py``).  Returns the grads."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (batch, seq + 1)).astype(np.int32)
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if frontend:
        b.update(frontend_inputs(cfg, batch, seed))
    (loss, metrics), grads = value_and_grad(
        params, cfg, {k: torch.from_numpy(v) for k, v in b.items()},
        TM.RunOptions(q_chunk=16, xent_chunk=16))
    assert np.isfinite(float(loss))
    assert abs(float(metrics["xent"]) - np.log(cfg.vocab_size)) < 1.5, \
        float(metrics["xent"])
    return grads


def assert_grads(jgrads, tgrads, head: str):
    """Every leaf within 1e-4 of its largest magnitude; the output
    weight's leaf (``head``) within one bf16 step per element."""
    flat, _ = jax.tree_util.tree_flatten_with_path(jgrads)
    tleaves = tree_leaves(tgrads)
    assert len(flat) == len(tleaves)
    for (path, a), t in zip(flat, tleaves):
        name = "/".join(str(p.key) for p in path)
        a, t = np.asarray(a), t.numpy()
        assert a.shape == t.shape, name
        big = np.abs(a).max()
        lim = 1e-4 * big + (2.0 ** -7 * np.abs(a) if name == head else 0)
        err = np.abs(a - t)
        assert (err <= lim).all(), (name, err.max(), big)


def train_steps_vs_jax(cfg, tcfg, jp, tol, *, steps: int = 3,
                       microbatches: int = 1, batch: int = 4,
                       seq: int = 32, **run_kw):
    """``steps`` train steps of the port's ``build_cell(...).fn`` against
    JAX's from the JAX params ``jp`` (carried across by
    ``params_from_jax``) on the token pipelines' batches (bit-equal) with
    the frontend's inputs at seed ``step``: lr 3e-3 peak with warmup over
    3 of 300 steps (``run_kw``: more ``RunOptions`` fields, on both
    sides).  Each step's loss, xent and aux loss within
    ``tol["loss"]``, grad norm within ``tol["grad_norm"]`` and lr within
    1e-6 relative; then each param within ``tol["param"]`` (unless None)
    and its update within ``tol["update"]`` of the update's norm."""
    mesh = make_host_mesh()
    kw = dict(q_chunk=16, xent_chunk=16, microbatches=microbatches,
              **run_kw)
    cell = jbuild_cell(cfg, ShapeConfig("custom", seq, batch, "train"), mesh,
                       opts=JM.RunOptions(**kw), lr_peak=3e-3,
                       total_steps=300)
    tcell = build_cell(tcfg, TShapeConfig("custom", seq, batch, "train"),
                       TM.RunOptions(**kw), lr_peak=3e-3, total_steps=300)
    p0 = jax.tree.leaves(jax.tree.map(np.asarray, jp))
    jo = jinit_opt_state(jp)
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    to = init_opt_state(tp)
    jpipe = JPipeline(cfg.vocab_size, seq, batch)
    tpipe = TokenPipeline(cfg.vocab_size, seq, batch, device="cpu")
    with mesh:
        fn = jax.jit(cell.fn)
        for step in range(steps):
            extra = frontend_inputs(cfg, batch, step)
            jp, jo, jm = fn(jp, jo, {**jpipe.get_batch(step), **extra})
            tp, to, tm = tcell.fn(tp, to, {
                **tpipe.get_batch(step),
                **{k: torch.from_numpy(v) for k, v in extra.items()}})
            for key, rtol in (("loss", tol["loss"]), ("xent", tol["loss"]),
                              ("aux_loss", tol["loss"]),
                              ("grad_norm", tol["grad_norm"]), ("lr", 1e-6)):
                np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                           rtol=rtol, err_msg=key)
    assert int(to["count"]) == int(jo["count"]) == steps
    for a, t, start in zip(jax.tree.leaves(jp), tree_leaves(tp), p0):
        a, t = np.asarray(a), t.numpy()
        if tol["param"] is not None:
            np.testing.assert_allclose(t, a, atol=tol["param"])
        update_err = np.linalg.norm(a - t) / np.linalg.norm(a - start)
        assert update_err < tol["update"], (a.shape, update_err)
