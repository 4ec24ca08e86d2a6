"""The port's paged model step and fused decode tick against the JAX
package, with JAX-initialized weights carried across by
``params_from_jax``: reduced qwen3-1.7b (qk-norm) and llama3-8b, f32
compute, f32/bf16/fp8/int8 pools, a prefill chunk (C>1) and a decode step
(C=1).  The port runs its plain versions on the CPU.

Tolerances: logits agree to 1e-4 — the f32 matmuls and softmax sums are
taken in another order by XLA and torch.  The same ulp-level differences
reach the K/V written to the pool and grow through the first layer, so
the second layer's K/V differ by up to ~3e-5 of the leaf's largest
value: f32 pools and the f32 scales of quantized pools (the amax carries
the differences) agree to rtol 2e-4 plus 1e-4 of the leaf's largest
magnitude, bf16 pools to one bf16 rounding step, and quantized pools
store byte-equal values (the rounding to 3 or 7 bits absorbs the
differences).  Page 0 is the scratch page, which
idle seats and chunk padding all write, in an order neither framework
defines; it is left out.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced_config
from repro.models import model as JM
from repro.parallel.sharding import SINGLE_DEVICE_RULES
from repro_torch.configs import get_config as tget
from repro_torch.configs import reduced_config as treduced
from repro_torch.models import model as TM
from repro_torch.models.convert import cast_for_compute, params_from_jax

P, PAGE, N = 16, 4, 6


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _setup(arch, compute="float32"):
    cfg = reduced_config(get_config(arch), compute_dtype=compute)
    tcfg = treduced(tget(arch), compute_dtype=compute)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(tcfg)
    jp = JM.init_params(JM.param_specs(cfg), jax.random.PRNGKey(0))
    tp = cast_for_compute(params_from_jax(_np_tree(jp)),
                          TM.compute_dtype(tcfg))
    return cfg, tcfg, jp, tp


@pytest.fixture(scope="module", params=["qwen3-1.7b", "llama3-8b"])
def arch_setup(request):
    return _setup(request.param)


def _inputs(cfg):
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


def _torch_step(tp, tcfg, cache, table, tokens, pos, n_valid):
    t = torch.from_numpy
    logits, cache = TM.paged_decode_step(tp, tcfg, cache, t(tokens), t(pos),
                                         t(table), t(n_valid))
    return logits.numpy(), cache


def assert_pools_match(jcache, tcache):
    for pk, ent in jcache.items():
        for leaf, a in ent.items():
            a = np.asarray(a)[:, 1:]                      # skip scratch page
            b = tcache[pk][leaf]
            if b.dtype == torch.bfloat16:
                ab = a.view(np.uint16).astype(np.int32)
                bb = b[:, 1:].view(torch.int16).numpy().view(
                    np.uint16).astype(np.int32)
                assert np.abs(ab - bb).max() <= 1, (pk, leaf)
                continue
            b = b[:, 1:].numpy()
            assert b.dtype == a.dtype, (pk, leaf, b.dtype, a.dtype)
            if leaf in ("k", "v") and a.dtype in (np.uint8, np.int8):
                assert a.tobytes() == b.tobytes(), (pk, leaf)
            else:
                np.testing.assert_allclose(
                    b, a, rtol=2e-4, atol=1e-4 * np.abs(a).max(),
                    err_msg=f"{pk}/{leaf}")


def test_param_specs_and_pool_layout_match_jax(arch_setup):
    cfg, tcfg, jp, tp = arch_setup
    jshapes = jax.tree.map(lambda s: s.shape, JM.param_specs(cfg),
                           is_leaf=lambda s: hasattr(s, "axes"))
    tshapes = jax.tree.map(lambda s: s.shape, TM.param_specs(tcfg),
                           is_leaf=lambda s: hasattr(s, "axes"))
    assert jshapes == tshapes
    assert jax.tree.structure(_np_tree(jp)) == jax.tree.structure(
        jax.tree.map(lambda t: t.numpy(), tp))
    for kv in (None, "f32", "bf16", "fp8", "int8"):
        jc = JM.init_paged_cache(cfg, P, PAGE, kv_dtype=kv)
        tc = TM.init_paged_cache(tcfg, P, PAGE, kv_dtype=kv)
        assert jax.tree.map(lambda a: (a.shape, a.dtype.itemsize), jc) == \
            jax.tree.map(lambda a: (tuple(a.shape), a.element_size()), tc)
        assert JM.paged_page_bytes(cfg, PAGE, kv) == \
            TM.paged_page_bytes(tcfg, PAGE, kv)


def test_cast_for_compute_casts_matmul_weights_only():
    cfg, tcfg, jp, _ = _setup("qwen3-1.7b", compute="bfloat16")
    tp = cast_for_compute(params_from_jax(_np_tree(jp)), torch.bfloat16)
    blk = tp["blocks"]["pos0"]
    assert tp["embed"].dtype == torch.bfloat16
    assert blk["mixer"]["wq"].dtype == torch.bfloat16
    assert blk["mlp"]["wd"].dtype == torch.bfloat16
    for norm in (tp["final_norm"], blk["ln1"], blk["ln2"],
                 blk["mixer"]["q_norm"], blk["mixer"]["k_norm"]):
        assert norm.dtype == torch.float32
    # the same values JAX's per-use astype gives
    want = np.asarray(jp["blocks"]["pos0"]["mixer"]["wq"].astype(
        jax.numpy.bfloat16)).view(np.uint16)
    got = blk["mixer"]["wq"].view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kv_dtype", [None, "bf16", "fp8", "int8"])
def test_paged_decode_step_matches_jax(arch_setup, kv_dtype):
    """A prefill chunk (C=5, one seat idle, one padded) and then a decode
    step (C=1) on the same pool."""
    cfg, tcfg, jp, tp = arch_setup
    table, prefill, decode = _inputs(cfg)
    jc = JM.init_paged_cache(cfg, P, PAGE, kv_dtype=kv_dtype)
    tc = params_from_jax(_np_tree(jc))
    for step in (prefill, decode):
        jl, jc = _jax_step(jp, cfg, jc, table, **step)
        tl, tc = _torch_step(tp, tcfg, tc, table, **step)
        assert tl.shape == jl.shape and tl.dtype == np.float32
        valid = np.arange(tl.shape[1])[None, :] < step["n_valid"][:, None]
        np.testing.assert_allclose(tl[valid], jl[valid], atol=1e-4, rtol=0)
        assert_pools_match(jc, tc)


def test_copy_paged_page_matches_jax_and_guards_self_copy(arch_setup):
    cfg, tcfg, jp, tp = arch_setup
    table, prefill, _ = _inputs(cfg)
    jc = JM.init_paged_cache(cfg, P, PAGE, kv_dtype="fp8")
    _, jc = _jax_step(jp, cfg, jc, table, **prefill)
    tc = params_from_jax(_np_tree(jc))
    jc = JM.copy_paged_page(jc, 3, 12)
    TM.copy_paged_page(tc, 3, 12)
    before = {k: v.clone() for k, v in tc["pos0"].items()}
    TM.copy_paged_page(tc, 7, 7)
    for k, v in tc["pos0"].items():
        assert torch.equal(v, before[k])
    for pk, ent in jc.items():
        for leaf, a in ent.items():
            assert np.asarray(a).tobytes() == tc[pk][leaf].numpy().tobytes()


def _sampling_state(A):
    return dict(temperature=np.array([0.0, 0.9, 0.7][:A], np.float32),
                top_k=np.array([0, 5, 0][:A], np.int32),
                top_p=np.array([1.0, 1.0, 0.8][:A], np.float32),
                seed=np.array([0, 11, 33][:A], np.int64),
                rid=np.array([0, 1, 2][:A], np.int64),
                step=np.array([1, 1, 0][:A], np.int64))


@pytest.mark.parametrize("kv_dtype", [None, "fp8"])
def test_fused_decode_tick_matches_jax(arch_setup, kv_dtype):
    """Two fused ticks after a prefill: tokens, advanced positions and
    sampler steps equal JAX's, for greedy and stochastic seats; the
    pool is updated in place."""
    cfg, tcfg, jp, tp = arch_setup
    table, prefill, _ = _inputs(cfg)
    jc = JM.init_paged_cache(cfg, P, PAGE, kv_dtype=kv_dtype)
    _, jc = _jax_step(jp, cfg, jc, table, **prefill)
    tc = params_from_jax(_np_tree(jc))
    s = _sampling_state(3)
    last = np.array([17, 42, 99], np.int32)
    pos = np.array([5, 3, 0], np.int32)
    nv = np.array([1, 1, 0], np.int32)
    jfn = jax.jit(lambda p, c, *a: JM.fused_decode_tick(
        p, cfg, c, *a, SINGLE_DEVICE_RULES))
    jstate = (last, pos, table, nv, s["temperature"], s["top_k"],
              s["top_p"], s["seed"].astype(np.uint32),
              s["rid"].astype(np.uint32), s["step"].astype(np.uint32))
    t = torch.from_numpy
    tlast, tpos, tstep = t(last.copy()), t(pos.copy()), t(s["step"].copy())
    for _ in range(2):
        jtoks, jc, jpos, jstep, _ = jfn(jp, jc, *jstate)
        jstate = (jtoks, jpos) + jstate[2:9] + (jstep,)
        toks, logits = TM.fused_decode_tick(
            tp, tcfg, tc, tlast, tpos, t(table), t(nv), t(s["temperature"]),
            t(s["top_k"]), t(s["top_p"]), t(s["seed"]), t(s["rid"]), tstep)
        assert toks is tlast and logits.shape == (3, cfg.vocab_size)
        np.testing.assert_array_equal(tlast.numpy(), np.asarray(jtoks))
        np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
        np.testing.assert_array_equal(tstep.numpy(),
                                      np.asarray(jstep).astype(np.int64))
        assert_pools_match(jc, tc)
    assert tlast[2] == 99                      # idle seat keeps its token


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "llama3-8b"])
def test_paged_decode_step_bf16_compute_within_tolerance(arch):
    """bf16 compute: XLA-CPU and torch-CPU need not round bf16 alike, so
    logits are held by tolerance only (a few bf16 steps of the logits'
    scale)."""
    cfg, tcfg, jp, tp = _setup(arch, compute="bfloat16")
    table, prefill, decode = _inputs(cfg)
    jc = JM.init_paged_cache(cfg, P, PAGE)
    tc = params_from_jax(_np_tree(jc))
    for step in (prefill, decode):
        jl, jc = _jax_step(jp, cfg, jc, table, **step)
        tl, tc = _torch_step(tp, tcfg, tc, table, **step)
        valid = np.arange(tl.shape[1])[None, :] < step["n_valid"][:, None]
        scale = np.abs(jl[valid]).max()
        np.testing.assert_allclose(tl[valid], jl[valid], rtol=0,
                                   atol=0.05 * scale)
