"""Inputs and checks shared by the port's training tests: the frontends'
batch entries drawn from numpy, the ``wq``/``wk`` scaling of the configs
whose scores are near one-hot at the reference's initialization, and
the loss at initialization of a family's reduced config.

Test modules do ``from _torch_train_inputs import ...`` (``tests/`` is on
``sys.path``, as for ``_hypothesis_compat``).
"""
import numpy as np
import torch

from repro_torch.launch.steps import value_and_grad
from repro_torch.models import model as TM

#: Configs without qk-norm whose training tests scale ``wq`` and ``wk`` to
#: their true fan-in.  The reference's ``init_params`` takes a stacked
#: leaf's fan-in to be its first axis (G = 2 in a reduced config), so
#: their scores reach tens and the softmax is nearly one-hot; there the
#: f32 sums' ulps, summed in another order by XLA and torch, part the
#: gradients by 2.7e-3 of the largest (whisper-base) and three AdamW steps
#: by 7e-3 of the update (phi-3-vision-4.2b).  ``test_torch_minicpm.py``
#: scales its weights for the same reason.
TRUE_FAN_IN = ("phi-3-vision-4.2b", "whisper-base")


def true_fan_in(tree, d_model: int):
    """A numpy params tree with each attention block's ``wq`` and ``wk``
    (stacked: (G, d_model, heads, hd)) scaled by sqrt(G / d_model)."""
    return {k: true_fan_in(v, d_model) if isinstance(v, dict) else
            (v * np.float32(np.sqrt(v.shape[0] / d_model))
             if k in ("wq", "wk") else v)
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
