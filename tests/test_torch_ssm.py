"""The port's Mamba-2 block (``models/ssm.py``) and the mamba2-130m model
(reduced: 2 layers, d_model 64, d_state 16, head_dim 16, chunk 16)
against the JAX package on the CPU, with JAX-initialized weights carried
across by ``params_from_jax`` and inputs from numpy seeds.  In the block
tests the per-head and per-channel vectors (``A_log``, ``dt_bias``,
``D``, ``conv_b``, ``norm``) are drawn anew, since their initial values
(ones and zeros) would hide a wrong repeat of ``D`` or a bias left out.

Tolerances:

- f32: block outputs and states within 1e-5 of the largest |value|
  (the port sums the inter-chunk recurrence chunk by chunk where JAX
  runs an associative scan; measured ~1e-6), logits within 1e-4 of the
  largest |logit|; against the per-step recurrence in f64,
  ``tests/test_ssm.py``'s rtol/atol 1e-4;
- bf16: block outputs within 2^-6 of the largest output (the MoE
  slice's figure; XLA rounds each bf16 op of ``silu`` and the conv's
  sum on its own, one bf16 step apart from torch's; measured ~2^-7).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_train_inputs import loss_at_init

from repro.configs import get_config, reduced_config
from repro.models import model as JM
from repro.models import ssm as jssm
from repro.models.modules import init_params as jinit
from repro.parallel.sharding import SINGLE_DEVICE_RULES
from repro_torch.configs import get_config as tget
from repro_torch.configs import reduced_config as treduced
from repro_torch.kernels import ops as tops
from repro_torch.models import model as TM
from repro_torch.models import ssm as tssm
from repro_torch.models.convert import (cast_for_compute,
                                        init_params_for_compute,
                                        params_from_jax)

ARCH = "mamba2-130m"
F32_REL = 1e-5
LOGIT_REL = 1e-4
BF16_REL = 2.0 ** -6


def _close(got, want, rel, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= rel * scale, f"{what}: max|Δ| {err:.3e} > {rel} × {scale:.3e}"


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.array(jnp.asarray(t, jnp.float32))


def _jblock(cfg, decode=False):
    """JAX's ``ssm_block`` under ``jax.jit`` (one compile instead of one
    per op)."""
    return jax.jit(lambda p, x, **kw: jssm.ssm_block(p, cfg, x,
                                                     decode=decode, **kw))


@pytest.fixture(scope="module")
def block_setup():
    """The reduced config in f32, the block's JAX weights as numpy (the
    vector leaves redrawn) and the same weights as tensors."""
    cfg = reduced_config(get_config(ARCH), compute_dtype="float32")
    tcfg = treduced(tget(ARCH), compute_dtype="float32")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(tcfg)
    d_inner, H, C = jssm.ssm_dims(cfg)
    assert (d_inner, H, C) == tssm.ssm_dims(tcfg) == (128, 8, 160)
    jp = jax.tree.map(np.asarray, jinit(jssm.ssm_specs(cfg),
                                        jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    jp.update(D=rng.normal(1.0, 0.5, H), A_log=rng.normal(0.0, 0.5, H),
              dt_bias=rng.normal(0.0, 0.5, H),
              conv_b=rng.normal(0.0, 0.1, C),
              norm=rng.normal(0.0, 0.1, d_inner))
    jp = {k: np.asarray(v, np.float32) for k, v in jp.items()}
    return cfg, tcfg, jp, params_from_jax(jp)


def _ssd_inputs(seed, B=2, S=32, H=4, P=8, G=1, N=8):
    """``tests/test_ssm.py``'s SSD inputs, drawn with numpy."""
    rng = np.random.default_rng(seed)
    xh = rng.normal(size=(B, S, H, P))
    dt = np.log1p(np.exp(rng.normal(size=(B, S, H))))
    A = -np.exp(rng.normal(size=(H,)) * 0.3)
    Bm = rng.normal(size=(B, S, G, N)) * 0.5
    Cm = rng.normal(size=(B, S, G, N)) * 0.5
    return [np.asarray(a, np.float32) for a in (xh, dt, A, Bm, Cm)]


def _sequential(xh, dt, A, Bm, Cm):
    """The per-step recurrence h_t = exp(dt A) h_{t-1} + dt B x in f64
    (``tests/test_ssm.py::sequential_reference``)."""
    xh, dt, A, Bm, Cm = (np.asarray(a, np.float64)
                         for a in (xh, dt, A, Bm, Cm))
    B, S, H, P = xh.shape
    rep = H // Bm.shape[2]
    h = np.zeros((B, H, Bm.shape[3], P))
    ys = []
    for t in range(S):
        dA = np.exp(dt[:, t] * A[None])
        Bh = np.repeat(Bm[:, t], rep, axis=1)
        Ch = np.repeat(Cm[:, t], rep, axis=1)
        h = h * dA[..., None, None] + (dt[:, t][..., None, None]
                                       * Bh[..., None] * xh[:, t][..., None, :])
        ys.append(np.einsum("bhn,bhnp->bhp", Ch, h))
    return np.stack(ys, axis=1), h


@pytest.mark.parametrize("chunk", [4, 8, 16, 32])
def test_ssd_chunked_matches_jax_and_the_recurrence(chunk):
    """``_ssd_chunked`` (the inter-chunk recurrence chunk by chunk)
    against JAX's (an associative scan) and the per-step recurrence,
    with two groups of two heads (the group -> head repeat)."""
    ins = _ssd_inputs(chunk, G=2)
    y, state = tssm._ssd_chunked(*map(torch.from_numpy, ins), chunk)
    jy, jstate = jax.jit(jssm._ssd_chunked, static_argnums=5)(*ins, chunk)
    _close(y, jy, F32_REL, "y vs JAX")
    _close(state, jstate, F32_REL, "state vs JAX")
    y_ref, state_ref = _sequential(*ins)
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(state.numpy(), state_ref, rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("S", [7, 16, 37, 48],
                         ids=["below-chunk", "one-chunk", "padded", "chunks"])
def test_ssm_block_prefill_matches_jax(block_setup, S):
    """Prefill at S < chunk (one chunk of S), S = chunk, S = 37 (zero-
    padded to 48) and S = 48: output, conv tail and f32 state."""
    cfg, tcfg, jp, tp = block_setup
    x = np.random.default_rng(S).normal(size=(2, S, cfg.d_model)) \
        .astype(np.float32)
    jy, (jconv, jstate) = _jblock(cfg)(jp, x)
    y, (conv, state) = tssm.ssm_block(tp, tcfg, torch.from_numpy(x))
    assert conv.shape == (2, 3, 160) and state.dtype == torch.float32
    for what, got, want in (("y", y, jy), ("conv", conv, jconv),
                            ("state", state, jstate)):
        _close(_np(got), np.asarray(want), F32_REL, what)


def test_ssm_block_decode_from_given_states_matches_jax(block_setup):
    cfg, tcfg, jp, tp = block_setup
    rng = np.random.default_rng(3)
    x = rng.normal(size=(3, 1, cfg.d_model)).astype(np.float32)
    conv = rng.normal(size=(3, 3, 160)).astype(np.float32)
    state = rng.normal(size=(3, 8, 16, 16)).astype(np.float32)
    jy, (jconv, jstate) = _jblock(cfg, decode=True)(
        jp, x, conv_state=conv, ssm_state=state)
    y, (tconv, tstate) = tssm.ssm_block(
        tp, tcfg, torch.from_numpy(x), conv_state=torch.from_numpy(conv),
        ssm_state=torch.from_numpy(state), decode=True)
    for what, got, want in (("y", y, jy), ("conv", tconv, jconv),
                            ("state", tstate, jstate)):
        _close(_np(got), np.asarray(want), F32_REL, what)


def test_ssm_block_prefill_state_continues_into_decode(block_setup):
    """Prefill of 24 tokens, then 3 decode steps on its states, equals
    prefill of 27 tokens at each of the last 3 rows."""
    _, tcfg, _, tp = block_setup
    x = torch.from_numpy(np.random.default_rng(4).normal(
        0.0, 0.5, (2, 27, tcfg.d_model)).astype(np.float32))
    full, _ = tssm.ssm_block(tp, tcfg, x)
    _, (conv, state) = tssm.ssm_block(tp, tcfg, x[:, :24])
    for t in range(24, 27):
        y, (conv, state) = tssm.ssm_block(tp, tcfg, x[:, t:t + 1],
                                          conv_state=conv, ssm_state=state,
                                          decode=True)
        _close(y[:, 0], full[:, t], F32_REL, f"row {t}")


@pytest.mark.parametrize("decode", [False, True], ids=["prefill", "decode"])
def test_ssm_block_bf16_matches_jax(block_setup, decode):
    """bf16 compute: the block within 2^-6 of the largest output, the
    f32 state within 2^-6 of its largest value; the weights cast once
    (``cast_for_compute``) give the same bits as the per-use casts."""
    cfg, tcfg, jp, tp = block_setup
    bcfg = dataclasses.replace(cfg, compute_dtype="bfloat16")
    tbcfg = dataclasses.replace(tcfg, compute_dtype="bfloat16")
    rng = np.random.default_rng(5)
    S = 1 if decode else 37
    x = jnp.asarray(rng.normal(size=(2, S, cfg.d_model)), jnp.bfloat16)
    jkw, kw = {}, {}
    if decode:
        conv = jnp.asarray(rng.normal(size=(2, 3, 160)), jnp.bfloat16)
        state = rng.normal(size=(2, 8, 16, 16)).astype(np.float32)
        jkw = dict(conv_state=conv, ssm_state=state)
        kw = dict(conv_state=torch.from_numpy(_np(conv)).bfloat16(),
                  ssm_state=torch.from_numpy(state), decode=True)
    jy, (_, jstate) = _jblock(bcfg, decode=decode)(jp, x, **jkw)
    tx = torch.from_numpy(_np(x)).bfloat16()
    y, (_, state) = tssm.ssm_block(tp, tbcfg, tx, **kw)
    assert y.dtype == torch.bfloat16 and state.dtype == torch.float32
    _close(_np(y), _np(jy), BF16_REL, "bf16 y")
    _close(_np(state), np.asarray(jstate), BF16_REL, "bf16 state")
    cast = cast_for_compute(tp, torch.bfloat16)
    assert {k for k, v in cast.items() if v.dtype == torch.bfloat16} == \
        {"in_proj", "out_proj", "conv_w", "conv_b", "D"}
    y2, (_, state2) = tssm.ssm_block(cast, tbcfg, tx, **kw)
    assert torch.equal(y2, y) and torch.equal(state2, state)


# ---------------------------------------------------------------------------
# The model: prefill, decode_step, the cache
# ---------------------------------------------------------------------------

OPTS = JM.RunOptions(q_chunk=32, xent_chunk=32)


@pytest.fixture(scope="module")
def model_setup():
    cfg = reduced_config(get_config(ARCH), compute_dtype="float32")
    tcfg = treduced(tget(ARCH), compute_dtype="float32")
    jp = JM.init_params(JM.param_specs(cfg), jax.random.PRNGKey(1))
    return cfg, tcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp))


def test_model_specs_match_jax_and_the_full_size(model_setup):
    """``param_specs`` equal to JAX's leaf for leaf (no ``ln2``, no MLP);
    the full config's 128 983 488 parameters."""
    cfg, tcfg, _, _ = model_setup
    is_spec = dict(is_leaf=lambda s: hasattr(s, "axes"))
    jshapes = jax.tree.map(lambda s: s.shape, JM.param_specs(cfg), **is_spec)
    tshapes = jax.tree.map(lambda s: s.shape, TM.param_specs(tcfg),
                           **is_spec)
    assert jshapes == tshapes
    assert set(tshapes["blocks"]["pos0"]) == {"ln1", "mixer"}
    full = tget(ARCH)
    assert TM.count_params(TM.param_specs(full)) == 128_983_488
    gen = torch.Generator().manual_seed(2)
    a = init_params_for_compute(TM.param_specs(tcfg), gen, torch.bfloat16)
    b = cast_for_compute(TM.init_params(TM.param_specs(tcfg),
                                        torch.Generator().manual_seed(2)),
                         torch.bfloat16)
    mix = a["blocks"]["pos0"]["mixer"]
    assert mix["A_log"].dtype == mix["norm"].dtype == torch.float32
    assert mix["in_proj"].dtype == mix["D"].dtype == torch.bfloat16
    assert jax.tree.map(lambda x, y: bool(torch.equal(x, y)), a, b) == \
        jax.tree.map(lambda _: True, a)


def _tokens(seed, B, S):
    return np.random.default_rng(seed).integers(0, 256, (B, S)) \
        .astype(np.int32)


@pytest.mark.parametrize("S", [9, 37])
def test_prefill_logits_and_caches_match_jax(model_setup, S):
    cfg, tcfg, jp, tp = model_setup
    toks = _tokens(S, 2, S)
    jl, jcache = JM.prefill(jp, cfg, {"tokens": jnp.asarray(toks)},
                            SINGLE_DEVICE_RULES, OPTS)
    tl, tcache = TM.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)},
                            TM.RunOptions(q_chunk=32))
    _close(tl, jl, LOGIT_REL, "logits")
    assert set(tcache["pos0"]) == {"conv", "ssm"}
    assert tcache["pos0"]["conv"].shape == (2, 2, 3, 160)
    assert tcache["pos0"]["ssm"].shape == (2, 2, 8, 16, 16)
    assert tcache["pos0"]["ssm"].dtype == torch.float32
    for key in ("conv", "ssm"):
        _close(tcache["pos0"][key], np.asarray(jcache["pos0"][key]),
               F32_REL, key)


def test_init_cache_keeps_the_ssm_state_in_f32():
    """The cache's ``ssm`` state is f32 in a bf16 config and its size does
    not depend on the sequence length; the conv tail is bf16."""
    tcfg = treduced(tget(ARCH))
    short, long = (TM.init_cache(tcfg, 3, seq) for seq in (8, 4096))
    for c in (short, long):
        assert c["pos0"]["ssm"].dtype == torch.float32
        assert c["pos0"]["ssm"].shape == (2, 3, 8, 16, 16)
        assert c["pos0"]["conv"].dtype == torch.bfloat16
        assert c["pos0"]["conv"].shape == (2, 3, 3, 160)
    cfg = reduced_config(get_config(ARCH))
    jc = JM.init_cache(cfg, 3, 8)
    assert jc["pos0"]["ssm"].dtype == jnp.float32
    assert jc["pos0"]["conv"].dtype == jnp.bfloat16


def test_decode_step_matches_prefill_and_jax(model_setup):
    """``decode_step`` after a prefill of S - 1 tokens equals the prefill
    of S tokens (``tests/test_archs.py``'s method), and JAX's
    ``decode_step`` on the same cache; the new states are written into
    the cache in place, equal to JAX's returned ones."""
    cfg, tcfg, jp, tp = model_setup
    B, S = 2, 21
    toks = _tokens(7, B, S)
    want, _ = TM.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    _, cache = TM.prefill(tp, tcfg,
                          {"tokens": torch.from_numpy(toks[:, :-1])})
    _, jcache = JM.prefill(jp, cfg, {"tokens": jnp.asarray(toks[:, :-1])},
                           SINGLE_DEVICE_RULES, OPTS)
    held = {k: t for k, t in cache["pos0"].items()}
    tok, pos = toks[:, -1:], np.full((B,), S - 1, np.int32)
    got, out = TM.decode_step(tp, tcfg, cache, torch.from_numpy(tok),
                              torch.from_numpy(pos))
    assert out is cache and all(cache["pos0"][k] is t
                                for k, t in held.items())
    _close(got, want, LOGIT_REL, "decode vs prefill")
    jl, jnew = JM.decode_step(jp, cfg, jcache, jnp.asarray(tok),
                              jnp.asarray(pos), SINGLE_DEVICE_RULES, OPTS)
    _close(got, jl, LOGIT_REL, "decode vs JAX")
    for key in ("conv", "ssm"):
        _close(cache["pos0"][key], np.asarray(jnew["pos0"][key]), F32_REL,
               key)


def test_norm_launches_per_ssm_layer(model_setup, monkeypatch):
    """Per model step one lone ``rmsnorm`` at d_model (layer 0's ln1), per
    layer one ``add_rmsnorm`` at d_model (the mixer's add fused into the
    next norm: no ln2) and one ``rmsnorm`` at d_inner (the gated norm)."""
    _, tcfg, _, tp = model_setup
    calls = []
    for name in ("rmsnorm", "add_rmsnorm"):
        fn = getattr(tops, name)
        monkeypatch.setattr(tops, name, lambda *a, _n=name, _f=fn, **k: (
            calls.append((_n, a[0].shape[-1])), _f(*a, **k))[1])
    cache = TM.init_cache(tcfg, 2, 8)
    TM.decode_step(tp, tcfg, cache, torch.zeros((2, 1), dtype=torch.int32),
                   torch.zeros((2,), dtype=torch.int32))
    L = tcfg.num_layers
    assert sorted(calls) == sorted([("rmsnorm", 64)] + [("add_rmsnorm", 64)]
                                   * L + [("rmsnorm", 128)] * L)


def test_lm_loss_refuses_ssm(model_setup):
    """(The name is from when ``lm_loss`` refused SSM configs.)  The loss
    at initialization over two SSD chunks is finite and near ln(vocab),
    and the gradient reaches the SSM's own leaves through the chunked
    SSD's backward (JAX's gradients: ``test_torch_train_parts.py``)."""
    _, tcfg, _, tp = model_setup
    grads = loss_at_init(tp, tcfg, seq=2 * tcfg.ssm.chunk_size)
    mixer = grads["blocks"]["pos0"]["mixer"]
    assert all(mixer[k].abs().max() > 0 for k in ("A_log", "dt_bias", "D"))
