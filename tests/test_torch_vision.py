"""The port's vision frontend (phi-3-vision-4.2b, reduced: 2 layers,
d_model 64, 4 heads of 16 over 4 kv heads, frontend_len 8 patches of
frontend_dim 64) against the JAX package on the CPU, with
JAX-initialized weights carried across by ``params_from_jax`` and
tokens and patches from numpy seeds: the parameter tree, the embedding
with the projected patches written over the first rows, ``prefill``
with every cache leaf, several ``decode_step``s, a reduced config at
the full model's head dim of 96, bf16, prefill/decode consistency, the
refusal of a prompt shorter than the patches, and the loss at
initialization.

Tolerances:

- f32: the embedding within 1e-5 of its largest |value| (one small
  matmul summed in another order), every cache leaf within 1e-4 of the
  leaf's largest |value| and logits within 1e-4 of the largest |logit|
  (ulp differences grow through the layers, as ``test_torch_model.py``
  and ``test_torch_whisper.py`` state);
- bf16: the port's logits within 0.05 of JAX's largest |logit| of
  JAX's bf16 logits, on weights whose wq and wk are scaled to their
  true fan-in (``test_torch_whisper.py``'s bound and reason);
- prefill(S) against prefill(S - 1) + ``decode_step``: within 1e-4 of
  the largest |logit|, and the reference's own check
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
from repro.models import model as JM
from repro.models.modules import count_params as jcount
from repro.parallel.sharding import SINGLE_DEVICE_RULES
from repro_torch.configs import get_config as tget
from repro_torch.configs import reduced_config as treduced
from repro_torch.models import model as TM
from repro_torch.models.convert import (cast_for_compute,
                                        init_params_for_compute,
                                        params_from_jax)

ARCH = "phi-3-vision-4.2b"
EMB_REL = 1e-5
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


def _setup(compute, **overrides):
    cfg = reduced_config(get_config(ARCH), compute_dtype=compute, **overrides)
    tcfg = treduced(tget(ARCH), compute_dtype=compute, **overrides)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(tcfg)
    jp = JM.init_params(JM.param_specs(cfg), jax.random.PRNGKey(0))
    return cfg, tcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp))


@pytest.fixture(scope="module")
def setup():
    return _setup("float32")


def _jfns(cfg):
    """JAX's prefill and decode step for ``cfg``, jitted."""
    prefill = jax.jit(lambda p, b: JM.prefill(p, cfg, b, SINGLE_DEVICE_RULES,
                                              OPTS))
    decode = jax.jit(lambda p, c, t, q: JM.decode_step(
        p, cfg, c, t, q, SINGLE_DEVICE_RULES, OPTS))
    return prefill, decode


@pytest.fixture(scope="module")
def jfns(setup):
    return _jfns(setup[0])


def _batch(seed, B, S, cfg):
    """Tokens (B, S) and standard-normal patches (B, frontend_len,
    frontend_dim) from one numpy seed, as numpy arrays."""
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S))
            .astype(np.int32),
            "patches": rng.standard_normal(
                (B, cfg.frontend_len, cfg.frontend_dim)).astype(np.float32)}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _grow(cache, rows):
    """A prefill's cache (either package's) as tensors, each ``k``/``v``
    leaf zero-padded along the sequence to ``rows``."""
    return TM.grow_cache({pos: {key: t if isinstance(t, torch.Tensor)
                                else torch.from_numpy(_np(t))
                                for key, t in ent.items()}
                          for pos, ent in cache.items()}, rows)


def _jcache(cache):
    return {p: {k: jnp.asarray(v.numpy()) for k, v in ent.items()}
            for p, ent in cache.items()}


def test_specs_match_jax_and_the_full_size(setup):
    """``param_specs`` equal to JAX's leaf for leaf, ``frontend_proj``
    (frontend_dim, d_model) at the top and no encoder; the full config's
    parameter count equal to the reference's (the CLIP tower is the
    reference's stub, so ~3.82 B of the name's 4.2 B); weights drawn
    cast equal to the cast of the drawn tree, ``frontend_proj`` cast
    with the matmul weights."""
    cfg, tcfg, _, _ = setup
    is_spec = dict(is_leaf=lambda s: hasattr(s, "axes"))
    jshapes = jax.tree.map(lambda s: s.shape, JM.param_specs(cfg), **is_spec)
    tshapes = jax.tree.map(lambda s: s.shape, TM.param_specs(tcfg),
                           **is_spec)
    assert jshapes == tshapes
    assert tshapes["frontend_proj"] == (64, 64)
    assert "encoder" not in tshapes
    assert set(tshapes["blocks"]["pos0"]) == {"ln1", "mixer", "ln2", "mlp"}
    full = TM.count_params(TM.param_specs(tget(ARCH)))
    assert full == jcount(JM.param_specs(get_config(ARCH)))
    assert 3.80e9 < full < 3.84e9
    a = init_params_for_compute(TM.param_specs(tcfg),
                                torch.Generator().manual_seed(2),
                                torch.bfloat16)
    b = cast_for_compute(TM.init_params(TM.param_specs(tcfg),
                                        torch.Generator().manual_seed(2)),
                         torch.bfloat16)
    assert a["frontend_proj"].dtype == torch.bfloat16
    assert jax.tree.map(lambda x, y: bool(torch.equal(x, y)), a, b) == \
        jax.tree.map(lambda _: True, a)


def test_patches_change_their_rows_and_nothing_else(setup, jfns):
    """``_embed_inputs`` with drawn patches against JAX's; against the
    same tokens without patches, the embedding differs in every row of
    ``[0, frontend_len)`` and is bit-equal past it, and so are layer 0's
    K/V (a row's K/V read only its own normed embedding), while the
    last layer's K/V past it differ (attention carries the patches
    forward)."""
    cfg, tcfg, jp, tp = setup
    P = cfg.frontend_len
    batch = _batch(5, 2, 13, cfg)
    jx, _, _ = JM._embed_inputs(jp, cfg, _jb(batch), SINGLE_DEVICE_RULES)
    x, enc = TM._embed_inputs(tp, tcfg, _tb(batch))
    assert enc is None
    _close(_np(x), _np(jx), EMB_REL, "embedding with patches")
    text = {"tokens": batch["tokens"]}
    x0, _ = TM._embed_inputs(tp, tcfg, _tb(text))
    assert torch.equal(x[:, P:], x0[:, P:])
    assert bool((x[:, :P] != x0[:, :P]).any(dim=-1).all())
    _, cache = TM.prefill(tp, tcfg, _tb(batch), TOPTS)
    _, cache0 = TM.prefill(tp, tcfg, _tb(text), TOPTS)
    for key in ("k", "v"):
        first, last = cache["pos0"][key][0], cache["pos0"][key][-1]
        first0, last0 = cache0["pos0"][key][0], cache0["pos0"][key][-1]
        assert torch.equal(first[:, P:], first0[:, P:]), key
        assert bool((first[:, :P] != first0[:, :P]).flatten(2).any(-1)
                    .all()), key
        assert not torch.equal(last[:, P:], last0[:, P:]), key
    jl, _ = jfns[0](jp, _jb(text))
    tl, _ = TM.prefill(tp, tcfg, _tb(text), TOPTS)
    _close(tl, jl, LOGIT_REL, "logits without patches")


@pytest.mark.parametrize("S", [8, 19])
def test_prefill_logits_and_caches_match_jax(setup, jfns, S):
    """Last logits and every cache leaf against JAX's, with drawn
    patches, at a prompt exactly as long as the patches and a longer
    one."""
    cfg, tcfg, jp, tp = setup
    batch = _batch(S, 2, S, cfg)
    jl, jcache = jfns[0](jp, _jb(batch))
    tl, tcache = TM.prefill(tp, tcfg, _tb(batch), TOPTS)
    _close(tl, jl, LOGIT_REL, "logits")
    assert set(tcache["pos0"]) == {"k", "v"}
    assert tcache["pos0"]["k"].shape == (2, 2, S, 4, 16)
    for key in ("k", "v"):
        _close(tcache["pos0"][key], _np(jcache["pos0"][key]), LEAF_REL, key)


def _decode_against_jax(cfg, tcfg, jp, tp, jfns, batch, rows, steps):
    """Prefill ``batch`` into caches of ``rows`` rows, then ``steps``
    greedy ``decode_step``s fed JAX's tokens, the last slot parked on
    the scratch row ``rows - 1``: the live slots' logits at every step
    and their K/V at the end against JAX's."""
    prefill, decode = jfns
    B, S = batch["tokens"].shape
    _, jcache = prefill(jp, _jb(batch))
    _, tcache = TM.prefill(tp, tcfg, _tb(batch), TOPTS)
    jcache = _jcache(_grow(jcache, rows))
    tcache = _grow(tcache, rows)
    tok = batch["tokens"][:, -1:]
    pos = np.array([S] * (B - 1) + [rows - 1], np.int32)
    live = np.array([1] * (B - 1) + [0], np.int32)
    for _ in range(steps):
        jl, jcache = decode(jp, jcache, jnp.asarray(tok), jnp.asarray(pos))
        tl, out = TM.decode_step(tp, tcfg, tcache, torch.from_numpy(tok),
                                 torch.from_numpy(pos))
        assert out is tcache
        _close(tl[:B - 1], np.asarray(jl)[:B - 1], LOGIT_REL,
               f"step at {pos[0]}")
        tok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)[:, None]
        pos = pos + live
    for key in ("k", "v"):
        _close(tcache["pos0"][key][:, :B - 1],
               _np(jcache["pos0"][key])[:, :B - 1], LEAF_REL, key)


def test_decode_steps_match_jax(setup, jfns):
    """Prefill of 11 tokens with drawn patches into caches of 16 rows,
    then 4 greedy ``decode_step``s, one slot parked on the scratch row:
    logits and K/V against JAX's."""
    cfg, tcfg, jp, tp = setup
    _decode_against_jax(cfg, tcfg, jp, tp, jfns, _batch(6, 3, 11, cfg), 16, 4)


def test_head_dim_96_matches_jax_on_the_plain_path():
    """The reduced config at the full model's head dim of 96 (4 heads of
    96 over d_model 64, the layout K4 and K5 see on the card at d 96):
    the parameter shapes, prefill with drawn patches and 3 decode steps
    against JAX's."""
    cfg, tcfg, jp, tp = _setup("float32", head_dim=96)
    assert TM.param_specs(tcfg)["blocks"]["pos0"]["mixer"]["wq"].shape == \
        (2, 64, 4, 96)
    fns = _jfns(cfg)
    batch = _batch(11, 3, 14, cfg)
    jl, _ = fns[0](jp, _jb(batch))
    tl, tcache = TM.prefill(tp, tcfg, _tb(batch), TOPTS)
    _close(tl, jl, LOGIT_REL, "d 96 prefill logits")
    assert tcache["pos0"]["k"].shape == (2, 3, 14, 4, 96)
    _decode_against_jax(cfg, tcfg, jp, tp, fns, batch, 20, 3)


def _scale_qk(jp, d_model: int):
    """JAX params with every block's ``wq`` and ``wk`` scaled by
    sqrt(G / d_model), to their true fan-in (``test_torch_whisper.py``:
    the reference's init takes a stacked leaf's first axis, G, as its
    fan-in, and the near one-hot scores that follow let one bf16
    rounding move a logit by its own size, in either package)."""
    def walk(t):
        return {k: walk(v) if isinstance(v, dict) else
                (v * np.float32(np.sqrt(v.shape[0] / d_model))
                 if k in ("wq", "wk") else v)
                for k, v in t.items()}
    return jax.tree.map(jnp.asarray, walk(jax.tree.map(np.asarray, jp)))


@pytest.mark.parametrize("seed", [7, 8])
def test_bf16_prefill_and_decode_match_jax(seed):
    """bf16 compute on weights with scaled q and k, prefill of 13 tokens
    with drawn patches and one ``decode_step`` on each package's own
    bf16 cache: the port's logits within BF16_REL of JAX's largest
    |logit|."""
    bcfg, tbcfg, jp, _ = _setup("bfloat16")
    jp = _scale_qk(jp, bcfg.d_model)
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    batch = _batch(seed, 2, 13, bcfg)
    tok = batch["tokens"][:, -1:]
    pos = np.full((2,), 13, np.int32)
    jl, jcache = JM.prefill(jp, bcfg, _jb(batch), SINGLE_DEVICE_RULES, OPTS)
    tl, tcache = TM.prefill(tp, tbcfg, _tb(batch), TOPTS)
    assert tcache["pos0"]["k"].dtype == torch.bfloat16
    jcache = {p: {k: v.astype(jnp.bfloat16) for k, v in ent.items()}
              for p, ent in _jcache(_grow(jcache, 14)).items()}
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
    cache, the same patches."""
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


def test_short_prompt_is_refused_by_both(setup):
    """A prompt shorter than the patches: the reference's
    ``dynamic_update_slice`` raises TypeError, the port a ValueError
    naming both lengths."""
    cfg, tcfg, jp, tp = setup
    batch = _batch(9, 2, cfg.frontend_len - 3, cfg)
    with pytest.raises(TypeError):
        JM.prefill(jp, cfg, _jb(batch), SINGLE_DEVICE_RULES, OPTS)
    with pytest.raises(ValueError, match=r"prompt of 5 tokens .* 8 patch"):
        TM.prefill(tp, tcfg, _tb(batch), TOPTS)


def test_lm_loss_refuses_the_vision_model(setup):
    """(The name is from when ``lm_loss`` refused the vision model.)  With
    ``patches`` the loss at initialization is finite and near ln(vocab)
    and ``frontend_proj`` takes a gradient through the patch rows; on
    text alone it takes zeros, as ``jax.grad`` gives an unread leaf
    (JAX's gradients with patches: ``test_torch_train_parts.py``)."""
    _, tcfg, _, tp = setup
    assert loss_at_init(tp, tcfg)["frontend_proj"].abs().max() > 0
    text = loss_at_init(tp, tcfg, frontend=False)
    assert not text["frontend_proj"].any()
