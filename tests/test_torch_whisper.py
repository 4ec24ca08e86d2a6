"""The port's encoder-decoder path (whisper-base, reduced: 2 encoder and
2 decoder layers, d_model 64, 4 heads of 16 over 4 kv heads, encoder_len
32, frontend_dim 64) against the JAX package on the CPU, with
JAX-initialized weights carried across by ``params_from_jax`` and
tokens and frames from numpy seeds: non-causal and cross attention,
cross decode, the encoder's output, ``prefill`` with every cache leaf,
several ``decode_step``s, bf16, prefill/decode consistency, the norm
calls per layer, and the loss at initialization (the encoder's
gradients; the vision frontend's too).

Tolerances:

- f32: attention outputs and K/V within 1e-5 of the largest |value|
  (the same products summed in another order), the encoder's output
  and every cache leaf within 1e-4 of the leaf's largest |value| (ulp
  differences grow through the layers, as ``test_torch_model.py``
  states for its second layer's K/V), logits within 1e-4 of the
  largest |logit|;
- bf16: the port's logits within 0.05 of JAX's largest |logit| of
  JAX's bf16 logits (``test_torch_model.py``'s bound), on weights whose
  wq and wk are scaled to their true fan-in (see the test);
- prefill(S) against prefill(S - 1) + ``decode_step``: the port within
  1e-4 of the largest |logit|, and the reference's own check
  (``tests/test_archs.py``: rtol = atol = 2e-2).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_train_inputs import loss_at_init

from repro.configs import get_config, reduced_config
from repro.models import attention as jattn
from repro.models import model as JM
from repro.models.modules import count_params as jcount
from repro.parallel.sharding import SINGLE_DEVICE_RULES
from repro_torch.configs import get_config as tget
from repro_torch.configs import reduced_config as treduced
from repro_torch.kernels import ops as tops
from repro_torch.models import attention as tattn
from repro_torch.models import model as TM
from repro_torch.models.convert import (cast_for_compute,
                                        init_params_for_compute,
                                        params_from_jax)
from repro_torch.tree import tree_leaves

ARCH = "whisper-base"
F32_REL = 1e-5
LEAF_REL = 1e-4
LOGIT_REL = 1e-4
BF16_REL = 0.05
OPTS = JM.RunOptions(q_chunk=32, xent_chunk=32)
TOPTS = TM.RunOptions(q_chunk=32)


def _close(got, want, rel, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= rel * scale, f"{what}: max|Δ| {err:.3e} > {rel} × {scale:.3e}"


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.array(jnp.asarray(t, jnp.float32))


def _setup(compute):
    cfg = reduced_config(get_config(ARCH), compute_dtype=compute)
    tcfg = treduced(tget(ARCH), compute_dtype=compute)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(tcfg)
    jp = JM.init_params(JM.param_specs(cfg), jax.random.PRNGKey(0))
    return cfg, tcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp))


@pytest.fixture(scope="module")
def setup():
    return _setup("float32")


@pytest.fixture(scope="module")
def jfns(setup):
    """JAX's prefill and decode step, jitted once for the module."""
    cfg = setup[0]
    prefill = jax.jit(lambda p, b: JM.prefill(p, cfg, b, SINGLE_DEVICE_RULES,
                                              OPTS))
    decode = jax.jit(lambda p, c, t, q: JM.decode_step(
        p, cfg, c, t, q, SINGLE_DEVICE_RULES, OPTS))
    return prefill, decode


def _batch(seed, B, S, cfg):
    """Tokens (B, S) and standard-normal frames (B, encoder_len,
    frontend_dim) from one numpy seed, as numpy arrays."""
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S))
            .astype(np.int32),
            "audio": rng.standard_normal(
                (B, cfg.encoder_len, cfg.frontend_dim)).astype(np.float32)}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _layer0(tree):
    return jax.tree.map(lambda a: a[0], tree)


def test_specs_match_jax_and_the_full_size(setup):
    """``param_specs`` equal to JAX's leaf for leaf (the encoder stack,
    ``frontend_proj``, each decoder layer's ``ln_cross`` and ``cross``);
    a cross block has no q/k norm even where the config has qk-norm; the
    full config's parameter count equal to the reference's; weights
    drawn cast equal to the cast of the drawn tree, ``frontend_proj``
    cast with the matmul weights."""
    cfg, tcfg, _, _ = setup
    is_spec = dict(is_leaf=lambda s: hasattr(s, "axes"))
    jshapes = jax.tree.map(lambda s: s.shape, JM.param_specs(cfg), **is_spec)
    tshapes = jax.tree.map(lambda s: s.shape, TM.param_specs(tcfg),
                           **is_spec)
    assert jshapes == tshapes
    assert set(tshapes["blocks"]["pos0"]) == {"ln1", "mixer", "ln_cross",
                                              "cross", "ln2", "mlp"}
    assert set(tshapes["encoder"]["blocks"]["pos0"]) == {"ln1", "mixer",
                                                         "ln2", "mlp"}
    assert tshapes["encoder"]["blocks"]["pos0"]["mixer"]["wq"] == \
        (2, 64, 4, 16)
    assert tshapes["frontend_proj"] == (64, 64)
    qk = dataclasses.replace(tcfg, qk_norm=True)
    jqk = dataclasses.replace(cfg, qk_norm=True)
    assert set(tattn.attn_specs(qk, cross=True)) == \
        set(jattn.attn_specs(jqk, cross=True)) == {"wq", "wk", "wv", "wo"}
    assert "q_norm" in tattn.attn_specs(qk)
    full = TM.count_params(TM.param_specs(tget(ARCH)))
    assert full == jcount(JM.param_specs(get_config(ARCH)))
    assert 100e6 < full < 120e6
    a = init_params_for_compute(TM.param_specs(tcfg),
                                torch.Generator().manual_seed(2),
                                torch.bfloat16)
    b = cast_for_compute(TM.init_params(TM.param_specs(tcfg),
                                        torch.Generator().manual_seed(2)),
                         torch.bfloat16)
    assert a["frontend_proj"].dtype == torch.bfloat16
    assert a["encoder"]["final_norm"].dtype == torch.float32
    assert a["blocks"]["pos0"]["cross"]["wq"].dtype == torch.bfloat16
    assert jax.tree.map(lambda x, y: bool(torch.equal(x, y)), a, b) == \
        jax.tree.map(lambda _: True, a)


@pytest.mark.parametrize("mode", ["encoder", "causal", "cross"])
def test_attention_matches_jax(setup, mode):
    """``attention`` as the encoder calls it (non-causal, RoPE at
    positions 0..S-1), as the decoder calls it (causal), and as
    cross-attention (K/V from ``x_kv``, no RoPE, every key kept): output
    and K/V against JAX's."""
    cfg, tcfg, jp, tp = setup
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    x_kv = rng.standard_normal((2, cfg.encoder_len, cfg.d_model)) \
        .astype(np.float32)
    key = "cross" if mode == "cross" else "mixer"
    jpar, tpar = _layer0(jp["blocks"]["pos0"][key]), \
        _layer0(tp["blocks"]["pos0"][key])
    jkw, tkw = {}, {}
    if mode == "encoder":
        jkw = tkw = dict(causal=False)
    elif mode == "cross":
        jkw, tkw = dict(x_kv=jnp.asarray(x_kv), causal=False), \
            dict(x_kv=torch.from_numpy(x_kv), causal=False)
    jout, (jk, jv) = jattn.attention(jpar, cfg, jnp.asarray(x), **jkw)
    out, (k, v) = tattn.attention(tpar, tcfg, torch.from_numpy(x), **tkw)
    rows = cfg.encoder_len if mode == "cross" else 9
    assert k.shape == (2, rows, 4, 16)
    for what, got, want in (("out", out, jout), ("k", k, jk), ("v", v, jv)):
        _close(_np(got), _np(want), F32_REL, f"{mode} {what}")


def test_cross_decode_attention_matches_jax_and_leaves_the_cache(setup):
    """``decode_attention(cross=True)`` on random encoder K/V: the output
    against JAX's, the cache tensors returned as given and unchanged."""
    cfg, tcfg, jp, tp = setup
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
    ck, cv = (rng.standard_normal((3, cfg.encoder_len, 4, 16))
              .astype(np.float32) for _ in range(2))
    pos = np.array([0, 5, 31], np.int32)
    jpar = _layer0(jp["blocks"]["pos0"]["cross"])
    tpar = _layer0(tp["blocks"]["pos0"]["cross"])
    jout, _, _ = jattn.decode_attention(jpar, cfg, jnp.asarray(x),
                                        jnp.asarray(ck), jnp.asarray(cv),
                                        jnp.asarray(pos), cross=True)
    tck, tcv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    out, rk, rv = tattn.decode_attention(tpar, tcfg, torch.from_numpy(x),
                                         tck, tcv, torch.from_numpy(pos),
                                         cross=True)
    _close(_np(out), _np(jout), F32_REL, "cross decode")
    assert rk is tck and rv is tcv
    assert np.array_equal(tck.numpy(), ck) and np.array_equal(tcv.numpy(), cv)


def test_encoder_output_matches_jax_and_is_zero_on_zero_frames(setup):
    """``_embed_inputs``' token embedding and encoder output against
    JAX's; on the engines' stub frames (zeros) the encoder output is
    exactly zero in both packages (``rms_norm(0) = 0``, no biases)."""
    cfg, tcfg, jp, tp = setup
    batch = _batch(5, 2, 7, cfg)
    jx, _, jenc = JM._embed_inputs(jp, cfg, _jb(batch), SINGLE_DEVICE_RULES)
    x, enc = TM._embed_inputs(tp, tcfg, _tb(batch))
    _close(_np(x), _np(jx), F32_REL, "token embedding")
    assert enc.shape == (2, cfg.encoder_len, cfg.d_model)
    _close(_np(enc), _np(jenc), LEAF_REL, "enc_out")
    zero = {**batch, "audio": np.zeros_like(batch["audio"])}
    _, _, jz = JM._embed_inputs(jp, cfg, _jb(zero), SINGLE_DEVICE_RULES)
    _, z = TM._embed_inputs(tp, tcfg, _tb(zero))
    assert not np.any(_np(jz)) and not torch.any(z)


def _grow(cache, rows):
    """A prefill's cache (either package's) as tensors, grown by the
    port's ``grow_cache``: each ``k``/``v`` leaf zero-padded along the
    sequence to ``rows``, ``ck``/``cv`` as they are."""
    return TM.grow_cache({pos: {key: t if isinstance(t, torch.Tensor)
                                else torch.from_numpy(_np(t))
                                for key, t in ent.items()}
                          for pos, ent in cache.items()}, rows)


@pytest.mark.parametrize("S", [5, 19])
def test_prefill_logits_and_caches_match_jax(setup, jfns, S):
    """Last logits and every cache leaf (``k``, ``v`` of S rows and
    ``ck``, ``cv`` of ``encoder_len`` rows) against JAX's."""
    cfg, tcfg, jp, tp = setup
    batch = _batch(S, 2, S, cfg)
    jl, jcache = jfns[0](jp, _jb(batch))
    tl, tcache = TM.prefill(tp, tcfg, _tb(batch), TOPTS)
    _close(tl, jl, LOGIT_REL, "logits")
    assert set(tcache["pos0"]) == {"k", "v", "ck", "cv"}
    assert tcache["pos0"]["k"].shape == (2, 2, S, 4, 16)
    assert tcache["pos0"]["ck"].shape == (2, 2, cfg.encoder_len, 4, 16)
    for key in ("k", "v", "ck", "cv"):
        _close(tcache["pos0"][key], _np(jcache["pos0"][key]), LEAF_REL, key)


def test_decode_steps_match_jax_and_never_write_the_cross_cache(setup, jfns):
    """Prefill of 11 tokens into caches of 16 rows, then 4 greedy
    ``decode_step``s fed JAX's tokens, one slot parked on the scratch
    row 15 as the fixed-slot engine parks an idle slot: the logits of
    the live slots at every step and every cache leaf at the end against
    JAX's; ``ck``/``cv`` bit-equal to what the prefill wrote."""
    cfg, tcfg, jp, tp = setup
    prefill, decode = jfns
    batch = _batch(6, 3, 11, cfg)
    _, jcache = prefill(jp, _jb(batch))
    _, tcache = TM.prefill(tp, tcfg, _tb(batch), TOPTS)
    jcache = {p: {k: jnp.asarray(v.numpy()) for k, v in ent.items()}
              for p, ent in _grow(jcache, 16).items()}
    tcache = _grow(tcache, 16)
    cross = {k: tcache["pos0"][k].clone() for k in ("ck", "cv")}
    tok = batch["tokens"][:, -1:]
    pos = np.array([11, 11, 15], np.int32)
    for _ in range(4):
        jl, jcache = decode(jp, jcache, jnp.asarray(tok), jnp.asarray(pos))
        tl, out = TM.decode_step(tp, tcfg, tcache, torch.from_numpy(tok),
                                 torch.from_numpy(pos))
        assert out is tcache
        _close(tl[:2], np.asarray(jl)[:2], LOGIT_REL, f"step at {pos[0]}")
        tok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)[:, None]
        pos = pos + np.array([1, 1, 0], np.int32)
    for key in ("k", "v"):
        _close(tcache["pos0"][key][:, :2], _np(jcache["pos0"][key])[:, :2],
               LEAF_REL, key)
    for key, t in cross.items():
        assert torch.equal(tcache["pos0"][key], t), key
        _close(t, _np(jcache["pos0"][key]), LEAF_REL, key)


def _scale_qk(jp, d_model: int):
    """JAX params with every attention block's ``wq`` and ``wk``
    (encoder, decoder and cross) scaled by sqrt(G / d_model).  The
    reference's ``init_params`` takes a stacked leaf's fan-in to be its
    first axis, G, so at d_model / G times the true fan-in's variance the
    scores reach tens and the softmax is nearly one-hot: one bf16
    rounding then moves a logit by about its own size, in either package.
    Scaled, q and k have unit-variance entries and the scores are O(1),
    as the qk-norm of ``test_torch_model.py``'s archs keeps them."""
    def walk(t):
        return {k: walk(v) if isinstance(v, dict) else
                (v * np.float32(np.sqrt(v.shape[0] / d_model))
                 if k in ("wq", "wk") else v)
                for k, v in t.items()}
    return jax.tree.map(jnp.asarray, walk(jax.tree.map(np.asarray, jp)))


@pytest.mark.parametrize("seed", [7, 8, 9])
def test_bf16_prefill_and_decode_match_jax(seed):
    """bf16 compute on weights with scaled q and k (``_scale_qk``),
    prefill of 13 tokens and one ``decode_step`` on each package's own
    bf16 cache: the port's logits within BF16_REL of JAX's largest
    |logit| of JAX's bf16 logits (``test_torch_model.py``'s bound:
    XLA-CPU and torch-CPU need not round bf16 alike); the cross cache in
    bf16."""
    bcfg, tbcfg, jp, _ = _setup("bfloat16")
    jp = _scale_qk(jp, bcfg.d_model)
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    batch = _batch(seed, 2, 13, bcfg)
    tok = batch["tokens"][:, -1:]
    pos = np.full((2,), 13, np.int32)
    jl, jcache = JM.prefill(jp, bcfg, _jb(batch), SINGLE_DEVICE_RULES, OPTS)
    tl, tcache = TM.prefill(tp, tbcfg, _tb(batch), TOPTS)
    assert tcache["pos0"]["ck"].dtype == torch.bfloat16
    jcache = {p: {k: jnp.asarray(v.numpy()).astype(jnp.bfloat16)
                  for k, v in ent.items()}
              for p, ent in _grow(jcache, 14).items()}
    jd, _ = JM.decode_step(jp, bcfg, jcache, jnp.asarray(tok),
                           jnp.asarray(pos), SINGLE_DEVICE_RULES, OPTS)
    td, _ = TM.decode_step(tp, tbcfg, _grow(tcache, 14),
                           torch.from_numpy(tok), torch.from_numpy(pos))
    for what, mine, ref in (("prefill", tl, jl), ("decode", td, jd)):
        assert np.isfinite(_np(mine)).all()
        _close(_np(mine), _np(ref), BF16_REL, f"bf16 {what}")


def test_prefill_decode_consistency(setup):
    """``tests/test_archs.py``'s check on the port: prefill of S = 32
    tokens against prefill of S - 1 and one ``decode_step`` on its
    cache, the same frames."""
    _, tcfg, _, tp = setup
    batch = _tb(_batch(8, 2, 32, tcfg))
    want, _ = TM.prefill(tp, tcfg, batch, TOPTS)
    _, cache = TM.prefill(tp, tcfg, {**batch,
                                     "tokens": batch["tokens"][:, :31]},
                          TOPTS)
    got, _ = TM.decode_step(tp, tcfg, _grow(cache, 32),
                            batch["tokens"][:, 31:],
                            torch.full((2,), 31, dtype=torch.int32))
    _close(got, want, LOGIT_REL, "decode vs prefill")
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-2,
                               atol=2e-2)


def test_norm_calls_per_layer(setup, monkeypatch):
    """Per decode step one lone ``rmsnorm`` (layer 0's ln1) and three
    ``add_rmsnorm`` per decoder layer (into ln_cross, ln2 and the next
    norm); per prefill besides the encoder's chain: one lone norm and
    two fused per encoder layer (into ln2 and the next norm, the last
    into the encoder's final norm)."""
    _, tcfg, _, tp = setup
    calls = []
    for name in ("rmsnorm", "add_rmsnorm"):
        fn = getattr(tops, name)
        monkeypatch.setattr(tops, name, lambda *a, _n=name, _f=fn, **k: (
            calls.append(_n), _f(*a, **k))[1])
    batch = _tb(_batch(9, 2, 6, tcfg))
    _, cache = TM.prefill(tp, tcfg, batch, TOPTS)
    L, E = tcfg.num_layers, tcfg.num_encoder_layers
    assert sorted(calls) == sorted(["rmsnorm"] * 2
                                   + ["add_rmsnorm"] * (3 * L + 2 * E))
    calls.clear()
    TM.decode_step(tp, tcfg, _grow(cache, 8), batch["tokens"][:, :1],
                   torch.full((2,), 6, dtype=torch.int32))
    assert sorted(calls) == sorted(["rmsnorm"] + ["add_rmsnorm"] * 3 * L)


def test_lm_loss_and_the_vision_frontend_refuse(setup):
    """(The name is from when ``lm_loss`` refused both.)  The
    encoder-decoder model and the vision model (phi-3-vision-4.2b) train:
    the loss at initialization is finite and near ln(vocab), the
    gradient reaches every encoder leaf and ``frontend_proj`` (whisper)
    and ``frontend_proj`` through the patch rows (vision); a whisper batch
    without ``audio`` raises KeyError naming it, as the reference's loss
    does (JAX's gradients: ``test_torch_train_parts.py``)."""
    _, tcfg, _, tp = setup
    grads = loss_at_init(tp, tcfg)
    assert all(g.abs().max() > 0 for g in
               [grads["frontend_proj"], *tree_leaves(grads["encoder"])])
    with pytest.raises(KeyError, match="audio"):
        loss_at_init(tp, tcfg, frontend=False)
    vision = treduced(tget("phi-3-vision-4.2b"), compute_dtype="float32")
    vp = TM.init_params(TM.param_specs(vision),
                        torch.Generator().manual_seed(0))
    assert loss_at_init(vp, vision)["frontend_proj"].abs().max() > 0
