"""``remat_policy="dots"``: each remat'd layer keeps the outputs of its
matmuls without batch dimensions (``mm``/``addmm``) and recomputes the
rest, as ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``
does in the reference.

Against JAX with ``"dots"`` on reduced f32 qwen3-1.7b: the loss (rtol
1e-5) and every gradient (``_torch_train_inputs.assert_grads``: 1e-4 of
the leaf's largest, the output weight one bf16 step), and three train
steps (``TOL["float32"]``).  Within the port: ``"dots"`` bit-equal to
``"nothing"`` on the MoE config (recomputing or keeping a product gives
the same bits; the dense config's in ``tests/test_torch_train_parts.py``),
and backward recomputes fewer matmuls with ``"dots"`` (the policy does
save them).
"""
import jax
import numpy as np
import torch
from _torch_train_inputs import TOL, assert_grads, train_steps_vs_jax
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config, reduced_config
from repro.data.pipeline import TokenPipeline as JPipeline
from repro.models import model as JM
from repro.parallel.sharding import SINGLE_DEVICE_RULES
from repro_torch.configs import get_config as tget
from repro_torch.configs import reduced_config as treduced
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch.steps import value_and_grad
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_jax
from repro_torch.tree import tree_leaves, tree_map

B, S = 4, 32
KW = dict(q_chunk=16, xent_chunk=16)


def _setup(arch="qwen3-1.7b"):
    cfg = reduced_config(get_config(arch), compute_dtype="float32")
    tcfg = treduced(tget(arch), compute_dtype="float32")
    jp = JM.init_params(JM.param_specs(cfg), jax.random.PRNGKey(0))
    return cfg, tcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp))


def test_dots_loss_and_grads_match_jax():
    cfg, tcfg, jp, tp = _setup()
    batch = JPipeline(cfg.vocab_size, S, B).get_batch(1)
    jopts = JM.RunOptions(remat_policy="dots", **KW)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: JM.lm_loss(p, cfg, b, SINGLE_DEVICE_RULES, jopts),
        has_aux=True))(jp, batch)
    (tl, _), tg = value_and_grad(
        tp, tcfg, {k: torch.from_numpy(np.array(v)) for k, v in
                   batch.items()}, TM.RunOptions(remat_policy="dots", **KW))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert_grads(jg, tg, "embed")


def test_dots_train_steps_match_jax():
    cfg, tcfg, jp, _ = _setup()
    train_steps_vs_jax(cfg, tcfg, jp, TOL["float32"], batch=B, seq=S,
                       remat_policy="dots")


class _CountMatmuls(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


def test_dots_is_bit_equal_to_nothing_and_keeps_the_matmuls():
    # the dense config's bit-equality: tests/test_torch_train_parts.py
    for arch in ("qwen2-moe-a2.7b",):
        _, tcfg, _, tp = _setup(arch)
        batch = TokenPipeline(tcfg.vocab_size, S, B, device="cpu"
                              ).get_batch(2)
        runs, backward_mms = [], []
        for policy in ("nothing", "dots"):
            opts = TM.RunOptions(remat_policy=policy, **KW)
            runs.append(value_and_grad(tp, tcfg, batch, opts))
            params = tree_map(lambda t: t.detach().requires_grad_(True), tp)
            loss, _ = TM.lm_loss(params, tcfg, batch, opts)
            with _CountMatmuls() as count:
                torch.autograd.grad(loss, tree_leaves(params))
            backward_mms.append(count.n)
        (l0, m0), g0 = runs[0]
        (l1, m1), g1 = runs[1]
        assert torch.equal(l0, l1) and torch.equal(m0["aux_loss"],
                                                   m1["aux_loss"])
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(g0),
                                                     tree_leaves(g1)))
        # "nothing" recomputes each layer's projections in backward
        assert backward_mms[1] < backward_mms[0], (arch, backward_mms)
