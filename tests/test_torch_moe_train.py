"""Training the MoE family in the port against the JAX package, on the
CPU: ``lm_loss`` with the load-balancing aux loss and its gradients
through the capacity dispatch, for qwen2-moe-a2.7b, the hybrid
jamba-v0.1-52b and grok-1-314b.

Reduced f32 configs, JAX-initialized params carried across by
``params_from_jax``, the token pipeline's batch at step 0 (4 × 32), each
side's ``value_and_grad`` of its ``lm_loss``.  At capacity factor 0.5 a
layer's 256 (token, expert) pairs meet 4 experts of 40 slots, so pairs
drop in every MoE layer (asserted from the group sizes; the ragged path
keeps them); at 4.0, ``reduced_config``'s, nothing drops.

Before any tolerance, every MoE layer's router top-k ids must equal
JAX's, so that a failure says whether routing flipped.  Then, in f32:
``loss``, ``xent`` and ``aux_loss`` rtol 1e-5; every gradient leaf within
1e-4 of its largest magnitude, the head within one bf16 step
(``_torch_train_inputs.assert_grads``).  The three configs' ``wq``/``wk``
and jamba-v0.1-52b's SSM ``in_proj`` are scaled to their true fan-in on
both sides (``_torch_train_inputs.TRUE_FAN_IN`` says why).  bf16: the
loss within 2e-3 relative (XLA's bf16 ``silu`` rounds after each of its
operations, ``tests/test_torch_moe.py``; it read 5.2e-4).  Remat on and
off: bit-equal (backward recomputes the same ops).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_train_inputs import (TRUE_FAN_IN, assert_grads, moe_cfgs,
                                 true_fan_in)

from repro.configs import get_config, reduced_config
from repro.data.pipeline import TokenPipeline as JPipeline
from repro.models import model as JM
from repro.models import moe as jmoe
from repro.parallel.sharding import SINGLE_DEVICE_RULES
from repro_torch.launch.steps import value_and_grad
from repro_torch.models import model as TM
from repro_torch.models import moe as tmoe
from repro_torch.models.convert import params_from_jax
from repro_torch.tree import tree_leaves

B, S = 4, 32
DROPS = 0.5                       # capacity factor at which pairs drop
CASES = [("qwen2-moe-a2.7b", 4.0, "capacity"),
         ("qwen2-moe-a2.7b", DROPS, "capacity"),
         ("qwen2-moe-a2.7b", DROPS, "ragged"),
         ("jamba-v0.1-52b", DROPS, "capacity"),
         ("grok-1-314b", DROPS, "capacity")]

#: JAX's router top-k ids of each ``aux_load_balance_loss`` call, in call
#: order, appended by ``_jax_ids_spy``'s ordered callback
_JAX_IDS = []


@pytest.fixture(scope="module", autouse=True)
def _jax_ids_spy():
    """Wrap the reference's ``aux_load_balance_loss`` (called once per MoE
    layer on the MLP's normed input) for this module: it also sends the
    layer's router top-k ids, computed as the reference's router does,
    to ``_JAX_IDS``.  The loss is unchanged."""
    orig = jmoe.aux_load_balance_loss

    def spy(p, cfg, x):
        xt = x.reshape(-1, x.shape[-1])
        logits = (xt @ p["router"].astype(x.dtype)).astype(jnp.float32)
        _, idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1),
                               cfg.moe.top_k)
        jax.debug.callback(lambda i: _JAX_IDS.append(np.asarray(i)), idx,
                           ordered=True)
        return orig(p, cfg, x)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmoe, "aux_load_balance_loss", spy)
        yield


@functools.lru_cache(maxsize=None)
def _params(arch):
    """JAX's params (weights in ``TRUE_FAN_IN`` scaled) as numpy arrays."""
    cfg = reduced_config(get_config(arch), compute_dtype="float32")
    jp = jax.tree.map(np.asarray, JM.init_params(JM.param_specs(cfg),
                                                 jax.random.PRNGKey(0)))
    return true_fan_in(jp, cfg.d_model, TRUE_FAN_IN[arch])


def _batch(cfg):
    return {k: np.array(v) for k, v in
            JPipeline(cfg.vocab_size, S, B).get_batch(0).items()}


def _moe_layers(cfg) -> int:
    g = cfg.num_layers // cfg.scan_period()
    return g * cfg.mlp_kinds().count("moe")


@functools.lru_cache(maxsize=None)
def _jax_fn(arch, cf, impl):
    """JAX's ``value_and_grad(lm_loss)`` with the aux weight an argument,
    jitted once per case."""
    cfg, _ = moe_cfgs(arch, cf)

    def loss(p, b, w):
        opts = JM.RunOptions(q_chunk=16, xent_chunk=16, moe_impl=impl,
                             aux_loss_weight=w)
        return JM.lm_loss(p, cfg, b, SINGLE_DEVICE_RULES, opts)
    return jax.jit(jax.value_and_grad(loss, has_aux=True))


def _jax(arch, cf, impl, w=0.01):
    """JAX's ``((loss, metrics), grads)`` and each MoE layer's top-k ids
    (the forward's calls: remat's recomputation calls again)."""
    cfg, _ = moe_cfgs(arch, cf)
    _JAX_IDS.clear()
    out = _jax_fn(arch, cf, impl)(_params(arch), _batch(cfg), np.float32(w))
    jax.effects_barrier()
    return out, list(_JAX_IDS[:_moe_layers(cfg)])


@functools.lru_cache(maxsize=None)
def _port(arch, cf, impl, w=0.01, remat=True):
    """The port's ``((loss, metrics), grads)`` and each MoE layer's top-k
    ids, read in the forward's ``aux_load_balance_loss`` calls."""
    _, tcfg = moe_cfgs(arch, cf)
    ids = []
    orig = tmoe.aux_load_balance_loss

    def spy(p, cfg, x):
        with torch.no_grad():
            ids.append(tmoe.route(p, cfg.moe,
                                  x.reshape(-1, x.shape[-1]))[2].numpy())
        return orig(p, cfg, x)
    opts = TM.RunOptions(q_chunk=16, xent_chunk=16, moe_impl=impl,
                         aux_loss_weight=w, remat=remat)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tmoe, "aux_load_balance_loss", spy)
        out = value_and_grad(params_from_jax(_params(arch)), tcfg,
                             {k: torch.from_numpy(v) for k, v in
                              _batch(tcfg).items()}, opts)
    return out, ids[:_moe_layers(tcfg)]


def _assert_matches(jax_out, port_out, cfg, head):
    """Routing ids first, then the losses and the gradients."""
    ((jl, jm), jg), jids = jax_out
    ((tl, tm), tg), tids = port_out
    assert len(jids) == len(tids) == _moe_layers(cfg)
    for layer, (a, t) in enumerate(zip(jids, tids)):
        np.testing.assert_array_equal(t, a, err_msg=f"routing, layer {layer}")
    for got, want in ((tl, jl), (tm["xent"], jm["xent"]),
                      (tm["aux_loss"], jm["aux_loss"])):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert_grads(jg, tg, head)


@pytest.mark.parametrize("arch,cf,impl", CASES)
def test_loss_and_grads_match_jax(arch, cf, impl):
    cfg, tcfg = moe_cfgs(arch, cf)
    jax_out, port_out = _jax(arch, cf, impl), _port(arch, cf, impl)
    (_, metrics), _ = port_out[0]
    assert float(metrics["aux_loss"]) > 0
    cap = tmoe.capacity(cfg.moe, B * S * cfg.moe.top_k)
    over = [int(np.maximum(np.bincount(ids.reshape(-1),
                                       minlength=cfg.moe.num_experts)
                           - cap, 0).sum()) for ids in port_out[1]]
    if cf == DROPS:
        # the capacity path drops pairs in every layer; the ragged one keeps them
        assert all(n > 0 for n in over), over
    else:
        assert not any(over), over
    _assert_matches(jax_out, port_out, cfg,
                    "embed" if cfg.tie_embeddings else "lm_head")


@pytest.mark.parametrize("w", [0.0, 0.05])
def test_aux_loss_weight_matches_jax(w):
    """At weight 0 the loss is the cross-entropy alone; at 0.05 five times
    the default's share of the aux loss (and its gradient)."""
    arch = "qwen2-moe-a2.7b"
    cfg, _ = moe_cfgs(arch, DROPS)
    port_out = _port(arch, DROPS, "capacity", w=w)
    (loss, metrics), _ = port_out[0]
    if w == 0.0:
        assert torch.equal(loss, metrics["xent"])
    else:
        np.testing.assert_allclose(
            float(loss), float(metrics["xent"] + w * metrics["aux_loss"]),
            rtol=1e-6)
    _assert_matches(_jax(arch, DROPS, "capacity", w=w), port_out, cfg,
                    "lm_head")


def test_jamba_remat_on_equals_off():
    """The hybrid's SSM, attention, dense and MoE layers, each under
    ``torch.utils.checkpoint`` with its aux loss beside ``(x, h)``, give
    the loss and gradients of the model without remat, bit for bit."""
    arch = "jamba-v0.1-52b"
    (l_on, m_on), g_on = _port(arch, DROPS, "capacity")[0]
    (l_off, m_off), g_off = _port(arch, DROPS, "capacity", remat=False)[0]
    assert torch.equal(l_on, l_off)
    assert torch.equal(m_on["aux_loss"], m_off["aux_loss"])
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(g_on),
                                                 tree_leaves(g_off)))


def test_bf16_loss_matches_jax():
    arch = "qwen2-moe-a2.7b"
    cfg, tcfg = moe_cfgs(arch, DROPS, "bfloat16")
    batch = _batch(cfg)
    opts = dict(q_chunk=16, xent_chunk=16)
    jl, jm = jax.jit(lambda p, b: JM.lm_loss(
        p, cfg, b, SINGLE_DEVICE_RULES, JM.RunOptions(**opts)))(
            _params(arch), batch)
    with torch.no_grad():
        tl, tm = TM.lm_loss(params_from_jax(_params(arch)), tcfg,
                            {k: torch.from_numpy(v) for k, v in
                             batch.items()}, TM.RunOptions(**opts))
    assert np.isfinite(float(tl)) and float(tm["aux_loss"]) > 0
    np.testing.assert_allclose(float(tl), float(jl), rtol=2e-3)


def test_prefill_computes_no_aux_loss(monkeypatch):
    """Serving routes once per MoE layer (the block's own ``route``) and
    never calls the aux loss."""
    _, tcfg = moe_cfgs("qwen2-moe-a2.7b", DROPS)
    calls = {"route": 0, "aux_load_balance_loss": 0}
    for name in calls:
        fn = getattr(tmoe, name)

        def spy(*a, _n=name, _f=fn, **k):
            calls[_n] += 1
            return _f(*a, **k)
        monkeypatch.setattr(tmoe, name, spy)
    toks = np.random.default_rng(0).integers(0, tcfg.vocab_size, (2, 12))
    logits, _ = TM.prefill(params_from_jax(_params("qwen2-moe-a2.7b")),
                           tcfg, {"tokens": torch.from_numpy(toks)},
                           impl="plain")
    assert torch.isfinite(logits).all()
    assert calls == {"route": _moe_layers(tcfg), "aux_load_balance_loss": 0}
