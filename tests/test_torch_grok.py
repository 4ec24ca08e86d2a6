"""grok-1-314b (reduced) in the port against the JAX package on the CPU.

The reduced config keeps what sets grok-1-314b apart from the models the
port served before it: a GQA group of 6 (12 query heads over 2 kv heads
here, 48 over 8 at full size), which the card's decode kernels run on
their MG = 8 instantiation with the last two rows of every group empty
(their plain versions here); an MoE MLP on every layer, top-2 with no
shared expert; and an untied LM head.  ``reduced_config`` alone would
give 4 heads over 4, a group of 1.  JAX-initialized weights are carried
across by ``params_from_jax``; inputs come from numpy with a seed.

Tolerances, as in ``test_torch_minicpm.py``: f32 logits within 1e-4 of
the largest logit (XLA and torch take the f32 sums in other orders);
cache and f32 pool leaves rtol 2e-4 plus 1e-4 of the leaf's largest
value; bf16 pool leaves one bf16 step; bf16 compute within 0.05 of the
largest logit.  Quantized pages: ``quantize_kv_page`` on the same f32
pages gives JAX's bytes and scales bit for bit.  ``paged_attention``
quantizes the K/V its projections make, which carry the f32 sums' ulps:
its bytes are JAX's, its scales within rtol 2e-4.  Written through the
whole model a code may land one apart at a rounding boundary: one int8
code of layer 1's K does in the prefill chunk below, and moves that
chunk's logits by 2.5e-3 of the largest (at JAX's init, without
qk-norm, the scores are nearly one-hot), so logits on quantized pools
are held within 5e-3 (``QUANT_LOGIT_TOL``).  Without that code the two
agree to 3e-6 (the fp8 pool, and the decode step after it).

The capacity factor is set back to the config's own 1.25 (the reduced
config lifts it to 4.0, so that nothing drops) where a test needs
drops: a prefill of 12 tokens routes 24 (token, expert) pairs into 4
experts of 8 slots.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced_config
from repro.core import mixed_precision as jmp
from repro.models import attention as jattn
from repro.models import model as JM
from repro.models.modules import count_params as jcount
from repro.models.modules import init_params as jinit
from repro.parallel.sharding import SINGLE_DEVICE_RULES
from repro_torch.configs import get_config as tget
from repro_torch.configs import reduced_config as treduced
from repro_torch.models import attention as tattn
from repro_torch.models import model as TM
from repro_torch.models import moe as tmoe
from repro_torch.models.convert import cast_for_compute, params_from_jax

ARCH = "grok-1-314b"
SMALL = dict(num_heads=12, num_kv_heads=2)
P, PAGE, N = 16, 4, 6
LOGIT_TOL = 1e-4           # of the largest logit
QUANT_LOGIT_TOL = 5e-3     # of the largest logit, quantized pools
CF = 1.25                  # grok-1-314b's own capacity factor


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _cf(cfg, cf):
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cf))


def _cfgs(compute="float32"):
    cfg = reduced_config(get_config(ARCH), compute_dtype=compute, **SMALL)
    tcfg = treduced(tget(ARCH), compute_dtype=compute, **SMALL)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(tcfg)
    return cfg, tcfg


def _setup(compute="float32"):
    cfg, tcfg = _cfgs(compute)
    jp = JM.init_params(JM.param_specs(cfg), jax.random.PRNGKey(0))
    tp = cast_for_compute(params_from_jax(_np_tree(jp)),
                          TM.compute_dtype(tcfg))
    return cfg, tcfg, jp, tp


@pytest.fixture(scope="module")
def setup():
    return _setup()


@pytest.fixture
def drops(monkeypatch):
    """(T·k, dropped pairs) of every capacity-path call of the port."""
    seen = []
    inner = tmoe._expert_gemms_capacity

    def counting(p, m, xs, sizes, dt):
        C = tmoe.capacity(m, xs.shape[0])
        seen.append((xs.shape[0], int((sizes - C).clamp(min=0).sum())))
        return inner(p, m, xs, sizes, dt)
    monkeypatch.setattr(tmoe, "_expert_gemms_capacity", counting)
    return seen


def _close_logits(got, want, what="", tol=LOGIT_TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * np.abs(want).max(), err_msg=what)


def test_group_of_six_untied_head_and_full_size_count():
    """The reduced config has a GQA group of 6, an untied ``lm_head`` and
    an MoE MLP on every layer with no shared expert; the full config's
    parameters count 316 489 340 928 in both packages: per layer
    4 919 980 032 (8 experts of 3 x 6144 x 32 768, attention 2 x 6144 x
    (48 + 8) x 128, the router, two norms), the untied embedding and head
    of 131 072 x 6144 each, the final norm.  Four layers, the depth the
    card holds at full width, come to 21 290 539 008."""
    cfg, tcfg = _cfgs()
    assert (tcfg.num_heads, tcfg.num_kv_heads) == (12, 2)
    assert tcfg.num_heads // tcfg.num_kv_heads == 6
    assert tcfg.mlp_kinds() == ("moe",) and tcfg.moe.num_shared_experts == 0
    specs = TM.param_specs(tcfg)
    assert specs["lm_head"].shape == (64, 256) and "shared" not in \
        specs["blocks"]["pos0"]["moe"]
    full, tfull = get_config(ARCH), tget(ARCH)
    per_layer = (3 * 8 * 6144 * 32_768 + 2 * 6144 * (48 + 8) * 128
                 + 6144 * 8 + 2 * 6144)
    assert per_layer == 4_919_980_032
    ends = 2 * 131_072 * 6144 + 6144
    assert TM.count_params(TM.param_specs(tfull)) == 64 * per_layer + ends \
        == jcount(JM.param_specs(full)) == 316_489_340_928
    cut = dataclasses.replace(tfull, num_layers=4)
    assert TM.count_params(TM.param_specs(cut)) == 4 * per_layer + ends \
        == 21_290_539_008


def test_prefill_then_decode_steps_match_jax(setup):
    """Two prompts through ``prefill`` (query-chunked), the cache grown
    as ``serve`` grows it, then four greedy ``decode_step``s at the
    group of 6: logits and every cache leaf after each call."""
    cfg, tcfg, jp, tp = setup
    rng = np.random.default_rng(3)
    B, S, gen = 2, 21, 4
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    jl, jc = JM.prefill(jp, cfg, {"tokens": jnp.asarray(tokens)},
                        SINGLE_DEVICE_RULES, JM.RunOptions(q_chunk=8))
    tl, tc = TM.prefill(tp, tcfg, {"tokens": _t(tokens)},
                        TM.RunOptions(q_chunk=8))
    assert tl.shape == (B, 1, 256) and tl.dtype == torch.float32
    _close_logits(tl.numpy(), jl, "prefill")
    assert tc["pos0"]["k"].shape[-2:] == (2, 16)
    tc = TM.grow_cache(tc, S + gen)
    jc = jax.tree.map(lambda a: jnp.concatenate(
        [a, jnp.zeros(a.shape[:2] + (gen,) + a.shape[3:], a.dtype)], axis=2),
        jc)
    jstep = jax.jit(lambda p, c, t, q: JM.decode_step(
        p, cfg, c, t, q, SINGLE_DEVICE_RULES))
    tok = np.argmax(np.asarray(jl)[:, -1], axis=-1).astype(np.int32)[:, None]
    for i in range(gen):
        pos = np.full((B,), S + i, np.int32)
        jl, jc = jstep(jp, jc, tok, pos)
        tl, tc = TM.decode_step(tp, tcfg, tc, _t(tok), _t(pos))
        _close_logits(tl.numpy(), jl, f"decode step {i}")
        for pk, ent in jc.items():
            for leaf, a in ent.items():
                a = np.asarray(a)
                np.testing.assert_allclose(
                    tc[pk][leaf].numpy(), a, rtol=2e-4,
                    atol=1e-4 * np.abs(a).max(), err_msg=f"{pk}/{leaf}")
        assert np.argmax(tl.numpy()[:, -1], -1).tolist() == \
            np.argmax(np.asarray(jl)[:, -1], -1).tolist()
        tok = np.argmax(np.asarray(jl)[:, -1], axis=-1).astype(
            np.int32)[:, None]


def test_prefill_with_capacity_drops_matches_jax(drops):
    """At grok-1-314b's capacity factor of 1.25 a prefill of 1 x 12
    tokens overflows its experts (2 x 12 fills windows of 16 here):
    logits equal JAX's with the dropped pairs' rows zero on both
    sides."""
    cfg, tcfg = (_cf(c, CF) for c in _cfgs())
    jp = JM.init_params(JM.param_specs(cfg), jax.random.PRNGKey(0))
    tp = params_from_jax(_np_tree(jp))
    rng = np.random.default_rng(12)
    for B in (2, 1):
        tokens = rng.integers(0, cfg.vocab_size, (B, 12)).astype(np.int32)
        jl, _ = JM.prefill(jp, cfg, {"tokens": jnp.asarray(tokens)},
                           SINGLE_DEVICE_RULES, JM.RunOptions(q_chunk=8))
        tl, _ = TM.prefill(tp, tcfg, {"tokens": _t(tokens)},
                           TM.RunOptions(q_chunk=8))
        _close_logits(tl.numpy(), jl, f"prefill B={B}")
    assert sum(n for tk, n in drops if tk == 2 * 12) > 0


def test_untied_head_is_its_own_weight(setup):
    """The logits are the final norm's output against ``lm_head``, not
    the embedding: a zeroed head column zeroes its logit alone."""
    _, tcfg, _, tp = setup
    tokens = torch.tensor([[255, 0, 17, 9]], dtype=torch.int32)
    logits, _ = TM.prefill(tp, tcfg, {"tokens": tokens})
    head = tp["lm_head"].clone()
    head[:, 17] = 0
    cut, _ = TM.prefill(dict(tp, lm_head=head), tcfg, {"tokens": tokens})
    assert cut[0, -1, 17] == 0 and logits[0, -1, 17] != 0
    keep = torch.arange(256) != 17
    assert torch.equal(cut[0, -1, keep], logits[0, -1, keep])


# -- the paged path: K1/K2's plain versions at a group of 6 -------------------

def _pools(rng, P_, cfg, kv_dtype):
    shape = (P_, PAGE, cfg.num_kv_heads, cfg.head_dim)
    k, v = (jnp.asarray(rng.normal(size=shape).astype(np.float32))
            for _ in range(2))
    if kv_dtype == "f32":
        return {"k": k, "v": v}
    if kv_dtype == "bf16":
        return {"k": k.astype(jnp.bfloat16), "v": v.astype(jnp.bfloat16)}
    (kq, ks), (vq, vs) = (jmp.quantize_kv_page(k, kv_dtype),
                          jmp.quantize_kv_page(v, kv_dtype))
    return {"k": kq, "v": vq, "ks": ks, "vs": vs}


@pytest.mark.parametrize("kv_dtype", ["f32", "bf16", "fp8", "int8"])
def test_paged_attention_at_a_group_of_six_matches_jax(kv_dtype):
    """One decode token per seat through ``paged_attention`` at 12 heads
    over 2 (the plain versions of K1/K2 in the port): the output, the
    written pages, their quantized bytes bit for bit and their f32
    scales within the projections' f32 ulps."""
    cfg, tcfg = _cfgs()
    jp = jinit(jattn.attn_specs(cfg), jax.random.PRNGKey(1))
    tp = params_from_jax(_np_tree(jp))
    rng = np.random.default_rng(4)
    lengths = (1, 4, 5, 17, 23)
    A, n = len(lengths), -(-max(lengths) // PAGE)
    table = (rng.permutation(A * n) + 1).astype(np.int32).reshape(A, n)
    qpos = (np.asarray(lengths, np.int32) - 1)[:, None]
    nv = np.ones(A, np.int32)
    x = rng.normal(size=(A, 1, cfg.d_model)).astype(np.float32)
    entry = _pools(rng, 1 + A * n, cfg, kv_dtype)
    jout, jentry = jattn.paged_attention(jp, cfg, x, entry, table, qpos, nv,
                                         kind="attn")
    tentry = {k: _t(a) for k, a in entry.items()}
    tout = tattn.paged_attention(tp, tcfg, _t(x), tentry, _t(table),
                                 _t(qpos), _t(nv), kind="attn")
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=2e-5,
                               rtol=0)
    for leaf, a in jentry.items():
        a, b = np.asarray(a), tentry[leaf]
        if kv_dtype == "f32":
            np.testing.assert_allclose(b.numpy(), a, rtol=2e-4, atol=1e-6)
        elif kv_dtype == "bf16":
            diff = np.abs(a.view(np.uint16).astype(np.int32)
                          - b.view(torch.int16).numpy().view(np.uint16)
                          .astype(np.int32))
            assert diff.max() <= 1, leaf
        elif leaf in ("k", "v"):
            assert b.numpy().tobytes() == a.tobytes(), leaf
        else:
            # the new token's K/V come out of the projections with the f32
            # sums' ulps, and so do their page scales
            np.testing.assert_allclose(b.numpy(), a, rtol=2e-4, atol=0,
                                       err_msg=leaf)


@pytest.mark.parametrize("kv_dtype", ["fp8", "int8"])
def test_kv_page_quantizer_is_bit_identical_at_two_kv_heads(kv_dtype):
    """``quantize_kv_page`` on the same f32 pages of 2 kv heads of 16
    (rows spread over 2^-8..2^8, a page of zeros): bytes, f32 scales and
    the dequantized pages equal JAX's bit for bit."""
    from repro_torch.core import mixed_precision as tmp
    rng = np.random.default_rng(6)
    x = rng.normal(size=(9, PAGE, 2, 16)).astype(np.float32)
    x *= np.float32(2.0) ** rng.integers(-8, 9, size=(9, PAGE, 1, 1))
    x[3] = 0.0
    jq, js = jmp.quantize_kv_page(jnp.asarray(x), kv_dtype)
    tq, ts = tmp.quantize_kv_page(torch.from_numpy(x), kv_dtype)
    assert tq.numpy().tobytes() == np.asarray(jq).tobytes()
    assert ts.numpy().tobytes() == np.asarray(js).tobytes()
    jd = np.asarray(jmp.dequantize_kv_page(jq, js))
    td = tmp.dequantize_kv_page(tq, ts).numpy()
    assert td.tobytes() == jd.tobytes()


def _paged_inputs(cfg):
    rng = np.random.default_rng(0)
    table = np.zeros((3, N), np.int32)
    table[0, :3] = [3, 7, 11]
    table[1, :3] = [2, 9, 4]
    table[2, :2] = [5, 1]
    prefill = dict(tokens=rng.integers(0, cfg.vocab_size, (3, 5)).astype(
        np.int32), pos=np.zeros(3, np.int32),
        n_valid=np.array([5, 3, 0], np.int32))
    decode = dict(tokens=rng.integers(0, cfg.vocab_size, (3, 1)).astype(
        np.int32), pos=np.array([5, 3, 0], np.int32),
        n_valid=np.array([1, 1, 0], np.int32))
    return table, prefill, decode


def _jax_step(jp, cfg, cache, table, tokens, pos, n_valid):
    fn = jax.jit(lambda p, c, t, q, pt, nv: JM.paged_decode_step(
        p, cfg, c, t, q, pt, nv, SINGLE_DEVICE_RULES))
    logits, cache = fn(jp, cache, tokens, pos, table, n_valid)
    return np.asarray(logits), cache


def _one_code_at_most(a, b, what):
    """Quantized pages ``b`` against ``a``: equal but for at most one
    value in 1000, each one code apart (int8: by one; fp8 e4m3: the same
    sign bit and magnitude codes one apart)."""
    if b.dtype == np.int8:
        gap = np.abs(a.astype(np.int32) - b.astype(np.int32))
    else:
        gap = np.where((a ^ b) & 0x80, 99,
                       np.abs((a & 0x7F).astype(np.int32)
                              - (b & 0x7F).astype(np.int32)))
    assert gap.max() <= 1 and (gap > 0).sum() <= max(1, a.size // 1000), \
        (what, int((gap > 0).sum()), int(gap.max()))


def _assert_pools(jcache, tcache):
    """Every pool leaf but the scratch page 0: f32 leaves and scales
    within rtol 2e-4 plus 1e-4 of the leaf's largest value, bf16 within
    one step of the value plus that (a K value of -1.44e-3 in a leaf
    reaching 18.9 lies 7.6e-6, three bf16 steps at its magnitude, from
    JAX's: the f32 sums' ulps), quantized bytes equal but at a rounding
    boundary (``_one_code_at_most``)."""
    for pk, ent in jcache.items():
        for leaf, a in ent.items():
            a, b = np.asarray(a)[:, 1:], tcache[pk][leaf][:, 1:]
            if b.dtype == torch.bfloat16:
                # one bf16 step of the value, or the f32 leaves' bound
                a = a.astype(np.float32)
                np.testing.assert_allclose(
                    b.float().numpy(), a, rtol=2.0 ** -8,
                    atol=1e-4 * np.abs(a).max(), err_msg=f"{pk}/{leaf}")
            elif b.dtype in (torch.uint8, torch.int8):
                _one_code_at_most(a, b.numpy(), (pk, leaf))
            else:
                np.testing.assert_allclose(
                    b.numpy(), a, rtol=2e-4, atol=1e-4 * np.abs(a).max(),
                    err_msg=f"{pk}/{leaf}")


@pytest.mark.parametrize("kv_dtype", [None, "bf16", "fp8", "int8"])
def test_paged_decode_step_matches_jax(setup, kv_dtype):
    """A prefill chunk (C = 5, one seat idle, one padded) and then a
    decode step (C = 1) on the same pool: valid logits and the pool."""
    cfg, tcfg, jp, tp = setup
    table, prefill, decode = _paged_inputs(cfg)
    jc = JM.init_paged_cache(cfg, P, PAGE, kv_dtype=kv_dtype)
    tc = params_from_jax(_np_tree(jc))
    for step in (prefill, decode):
        jl, jc = _jax_step(jp, cfg, jc, table, **step)
        tl, tc = TM.paged_decode_step(
            tp, tcfg, tc, *(torch.from_numpy(step[k])
                            for k in ("tokens", "pos")),
            torch.from_numpy(table), torch.from_numpy(step["n_valid"]))
        assert tl.shape == jl.shape
        valid = np.arange(tl.shape[1])[None, :] < step["n_valid"][:, None]
        _close_logits(tl.numpy()[valid], jl[valid], tol=LOGIT_TOL if kv_dtype
                      in (None, "bf16") else QUANT_LOGIT_TOL)
        _assert_pools(jc, tc)


@pytest.mark.parametrize("kv_dtype", [None, "bf16", "fp8", "int8"])
def test_fused_decode_tick_matches_jax(setup, kv_dtype):
    """Three fused ticks after a prefill, a greedy seat, a top-k seat and
    a top-p seat: tokens, advanced positions and sampler steps equal
    JAX's; the pool in place."""
    cfg, tcfg, jp, tp = setup
    table, prefill, _ = _paged_inputs(cfg)
    jc = JM.init_paged_cache(cfg, P, PAGE, kv_dtype=kv_dtype)
    _, jc = _jax_step(jp, cfg, jc, table, **prefill)
    tc = params_from_jax(_np_tree(jc))
    temp = np.array([0.0, 0.9, 0.7], np.float32)
    top_k = np.array([0, 5, 0], np.int32)
    top_p = np.array([1.0, 1.0, 0.8], np.float32)
    seed = np.array([0, 11, 33], np.int64)
    rid = np.array([0, 1, 2], np.int64)
    step = np.array([1, 1, 1], np.int64)
    last = np.array([17, 255, 99], np.int32)
    pos = np.array([5, 3, 0], np.int32)
    nv = np.array([1, 1, 1], np.int32)
    jfn = jax.jit(lambda p, c, *a: JM.fused_decode_tick(
        p, cfg, c, *a, SINGLE_DEVICE_RULES))
    jstate = (last, pos, table, nv, temp, top_k, top_p,
              seed.astype(np.uint32), rid.astype(np.uint32),
              step.astype(np.uint32))
    t = torch.from_numpy
    tlast, tpos, tstep = t(last.copy()), t(pos.copy()), t(step.copy())
    for _ in range(3):
        jtoks, jc, jpos, jstep, _ = jfn(jp, jc, *jstate)
        jstate = (jtoks, jpos) + jstate[2:9] + (jstep,)
        toks, logits = TM.fused_decode_tick(
            tp, tcfg, tc, tlast, tpos, t(table), t(nv), t(temp), t(top_k),
            t(top_p), t(seed), t(rid), tstep)
        assert toks is tlast and logits.shape == (3, 256)
        np.testing.assert_array_equal(tlast.numpy(), np.asarray(jtoks))
        np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
        np.testing.assert_array_equal(tstep.numpy(),
                                      np.asarray(jstep).astype(np.int64))
        _assert_pools(jc, tc)


def test_bf16_steps_lie_as_near_f32_as_jaxs():
    """bf16 compute through ``paged_decode_step``, a prefill chunk and a
    decode step, each held to the f32 step of the same weights: the
    port's bf16 logits lie no further from JAX's f32 logits than 1.5x
    JAX's bf16 logits lie, and within 0.1 of the largest logit.
    The two bf16 runs are not held to each other: XLA and torch round
    bf16 at other places (XLA's ``silu`` per operation,
    ``test_torch_moe.py``), and at JAX's init the router meets near-ties
    (a 2nd and 3rd expert 2e-5 apart in probability), so they part by
    0.29 of a largest logit of 3.1 in one row of the chunk, while each
    lies 0.22 and 0.34 from f32."""
    cfg, tcfg, jp, tp = _setup("bfloat16")
    cfg32, _, jp32, _ = _setup("float32")
    table, prefill, decode = _paged_inputs(cfg)
    jc = JM.init_paged_cache(cfg, P, PAGE)
    jc32 = JM.init_paged_cache(cfg32, P, PAGE)
    tc = params_from_jax(_np_tree(jc))
    for step in (prefill, decode):
        jl, jc = _jax_step(jp, cfg, jc, table, **step)
        jl32, jc32 = _jax_step(jp32, cfg32, jc32, table, **step)
        tl, tc = TM.paged_decode_step(
            tp, tcfg, tc, *(torch.from_numpy(step[k])
                            for k in ("tokens", "pos")),
            torch.from_numpy(table), torch.from_numpy(step["n_valid"]))
        valid = np.arange(tl.shape[1])[None, :] < step["n_valid"][:, None]
        want = jl32[valid]
        mine = np.abs(tl.numpy()[valid] - want).max()
        theirs = np.abs(jl[valid].astype(np.float32) - want).max()
        scale = np.abs(want).max()
        assert mine <= 1.5 * theirs and mine <= 0.1 * scale, \
            (mine, theirs, scale)
