"""The MoE family's train step in the port against JAX's
``build_cell(...).fn``, on the CPU: three f32 steps of qwen2-moe-a2.7b
and grok-1-314b and two steps of qwen2-moe-a2.7b over two microbatches,
each at capacity factor 0.5 (pairs drop in every MoE layer,
``tests/test_torch_moe_train.py``), held to
``_torch_train_inputs.TOL["float32"]``, the limits of the dense
configs' steps; and ``train()`` of the reduced qwen2-moe-a2.7b.

JAX-initialized params carried across by ``params_from_jax`` with
``wq``/``wk`` at their true fan-in on both sides
(``_torch_train_inputs.TRUE_FAN_IN`` says why), the token pipelines'
batches (bit-equal).  The loss adds 0.01 times the aux loss, whose
gradient reaches every router, and the step averages ``xent`` and
``aux_loss`` over the microbatches as the reference's accumulation does.
"""
import jax
import numpy as np
import pytest
from _torch_train_inputs import (TOL, TRUE_FAN_IN, moe_cfgs,
                                 train_steps_vs_jax, true_fan_in)

from repro.models import model as JM
from repro_torch.launch import train as T

CF = 0.5


def _setup(arch):
    """The reduced f32 ``arch`` at capacity factor ``CF`` in both packages
    and JAX's params."""
    cfg, tcfg = moe_cfgs(arch, CF)
    jp = JM.init_params(JM.param_specs(cfg), jax.random.PRNGKey(0))
    jp = jax.tree.map(jax.numpy.asarray, true_fan_in(
        jax.tree.map(np.asarray, jp), cfg.d_model, TRUE_FAN_IN[arch]))
    return cfg, tcfg, jp


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "grok-1-314b"])
def test_train_step_matches_jax_over_three_steps(arch):
    train_steps_vs_jax(*_setup(arch), TOL["float32"])


def test_microbatches_match_jax_accumulation():
    train_steps_vs_jax(*_setup("qwen2-moe-a2.7b"), TOL["float32"], steps=2,
                       microbatches=2)


def test_train_runs_qwen2_moe_on_cpu():
    losses = T.train("qwen2-moe-a2.7b", steps=3, batch=2, seq=32,
                     log_every=1000, device="cpu")
    assert len(losses) == 3 and np.isfinite(losses).all(), losses
