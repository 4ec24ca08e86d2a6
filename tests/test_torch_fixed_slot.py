"""The port's fixed-slot path against the JAX package on the CPU: the
plain versions of the dense decode (K4) and flash (K5) kernels against
the Pallas kernels in interpret mode; the model's ``attention`` and
``decode_attention``; ``prefill`` and ``decode_step``; the fixed-slot
``ServingEngine``; and the static-batch ``serve`` behind ``--engine
batch``.  JAX-initialized weights are carried across by
``params_from_jax``, inputs come from numpy with a seed, and compute is
f32 unless a test says otherwise.

Tolerances: the kernels' plain versions hold the JAX tests' own bounds
(``tests/test_kernels.py``: 2e-5 in f32, 2e-2 in bf16 — the bf16 inputs
round once on each side); the attention functions 2e-5 (f32 sums taken
in another order); logits 1e-4 and cache leaves rtol 2e-4 plus 1e-4 of
the leaf's largest value, as in ``test_torch_model.py``.  Token streams
and traces of the engines are compared exactly: the logits differ by
~1e-6, which could flip a greedy near-tie, and none occurs here.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced_config
from repro.kernels import ops as jops
from repro.models import attention as jattn
from repro.models import model as JM
from repro.models.modules import init_params as jinit
from repro.parallel.sharding import SINGLE_DEVICE_RULES
from repro.runtime.sampler import SamplingParams as JSamplingParams
from repro.runtime.serving import ServingEngine as JEngine
from repro_torch.configs import get_config as tget
from repro_torch.configs import reduced_config as treduced
from repro_torch.kernels import ops as tops
from repro_torch.models import attention as tattn
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_jax
from repro_torch.runtime.sampler import SamplingParams as TSamplingParams
from repro_torch.runtime.serving import SchedulerStallError
from repro_torch.runtime.serving import ServingEngine as TEngine

STOCHASTIC = dict(temperature=0.8, top_p=0.9, seed=11)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _normal(rng, shape, dtype):
    x = rng.normal(size=shape).astype(np.float32)
    return x.astype(jnp.bfloat16) if dtype == "bf16" else x


# -- K4: dense decode attention ---------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("t,h,kvh,d", [(64, 4, 4, 32), (160, 8, 2, 64),
                                       (96, 4, 1, 32)])
def test_decode_attention_plain_matches_pallas(t, h, kvh, d, dtype):
    rng = np.random.default_rng(t + h)
    B = 3
    q = _normal(rng, (B, 1, h, d), dtype)
    k = _normal(rng, (B, t, kvh, d), dtype)
    v = _normal(rng, (B, t, kvh, d), dtype)
    lengths = np.array([t, t // 2, 1], np.int32)
    want = jops.decode_attention(q, k, v, lengths, bk=32, interpret=True)
    got = tops.decode_attention(_t(q), _t(k), _t(v), _t(lengths),
                                impl="plain")
    assert got.shape == (B, 1, h, d) and got.dtype == _t(q).dtype
    atol = 2e-2 if dtype == "bf16" else 2e-5
    np.testing.assert_allclose(_f32(got), _f32(want), atol=atol)


@pytest.mark.parametrize("t", [37, 65, 100, 192, 255])
def test_decode_attention_plain_odd_cache_lengths(t):
    """Caches whose length is no multiple of the key tile (the fixed-slot
    ``max_len + 1`` layouts): the Pallas wrapper pads, the plain version
    masks by length alone."""
    rng = np.random.default_rng(t)
    q = rng.normal(size=(4, 1, 4, 32)).astype(np.float32)
    k = rng.normal(size=(4, t, 2, 32)).astype(np.float32)
    v = rng.normal(size=(4, t, 2, 32)).astype(np.float32)
    lengths = np.array([t, max(1, t // 2), max(1, t - 1), 1], np.int32)
    want = jops.decode_attention(q, k, v, lengths, bk=64, interpret=True)
    got = tops.decode_attention(_t(q), _t(k), _t(v), _t(lengths),
                                impl="plain")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


# -- K5: flash attention ----------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("sq,skv,h,kvh,d", [
    (64, 64, 4, 4, 32), (128, 128, 8, 2, 64), (96, 200, 4, 1, 32)])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 32),
                                           (False, None)])
def test_flash_attention_plain_matches_pallas(dtype, sq, skv, h, kvh, d,
                                              causal, window):
    rng = np.random.default_rng(sq + skv + h)
    q = _normal(rng, (2, sq, h, d), dtype)
    k = _normal(rng, (2, skv, kvh, d), dtype)
    v = _normal(rng, (2, skv, kvh, d), dtype)
    want = jops.flash_attention(q, k, v, causal=causal, window=window,
                                bq=32, bk=32, interpret=True)
    got = tops.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                               window=window, impl="plain")
    assert got.shape == (2, sq, h, d) and got.dtype == _t(q).dtype
    atol = 2e-2 if dtype == "bf16" else 2e-5
    np.testing.assert_allclose(_f32(got), _f32(want), atol=atol)


def test_kernel_impl_needs_cuda_tensors():
    q = torch.zeros((1, 1, 2, 8))
    k = torch.zeros((1, 4, 1, 8))
    with pytest.raises(ValueError, match="CUDA"):
        tops.decode_attention(q, k, k, torch.ones(1, dtype=torch.int32),
                              impl="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        tops.flash_attention(q, k, k, impl="kernel")
    with pytest.raises(ValueError, match="impl"):
        tops.flash_attention(q, k, k, impl="pallas")


# -- attention and decode_attention -----------------------------------------

def _attn_setup(arch="qwen3-1.7b", **over):
    cfg = reduced_config(get_config(arch), compute_dtype="float32", **over)
    tcfg = treduced(tget(arch), compute_dtype="float32", **over)
    jp = jinit(jattn.attn_specs(cfg), jax.random.PRNGKey(0))
    return cfg, tcfg, jp, params_from_jax(_np_tree(jp))


@pytest.mark.parametrize("case", ["causal", "window", "chunked"])
def test_attention_matches_jax(case):
    cfg, tcfg, jp, tp = _attn_setup()
    kind, S, q_chunk = "attn", 24, 1024
    if case == "window":
        cfg = dataclasses.replace(cfg, sliding_window=8)
        tcfg = dataclasses.replace(tcfg, sliding_window=8)
        kind = "attn_local"
    if case == "chunked":
        S, q_chunk = 32, 8              # S % q_chunk == 0, S > q_chunk
    x = np.random.default_rng(1).normal(size=(2, S, cfg.d_model)).astype(
        np.float32)
    jout, (jk, jv) = jattn.attention(jp, cfg, x, kind=kind, q_chunk=q_chunk)
    tout, (tk, tv) = tattn.attention(tp, tcfg, _t(x), kind=kind,
                                     q_chunk=q_chunk)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=2e-5)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=2e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=2e-5)


@pytest.mark.parametrize("kind", ["attn", "attn_local"])
def test_decode_attention_matches_jax_and_writes_in_place(kind):
    cfg, tcfg, jp, tp = _attn_setup("llama3-8b", sliding_window=8)
    rng = np.random.default_rng(2)
    B, T = 3, 33
    x = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    ck = (rng.normal(size=(B, T, cfg.num_kv_heads, cfg.head_dim)) * 0.5
          ).astype(np.float32)
    cv = (rng.normal(size=(B, T, cfg.num_kv_heads, cfg.head_dim)) * 0.5
          ).astype(np.float32)
    pos = np.array([10, 31, 32], np.int32)     # the last: the scratch index
    jout, jk, jv = jattn.decode_attention(jp, cfg, x, ck, cv, pos, kind=kind)
    tk, tv = _t(ck), _t(cv)
    tout, rk, rv = tattn.decode_attention(tp, tcfg, _t(x), tk, tv, _t(pos),
                                          kind=kind)
    assert rk is tk and rv is tv
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=2e-5)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=2e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=2e-5)


# -- prefill and decode_step ------------------------------------------------

def _model_setup(arch, compute="float32"):
    cfg = reduced_config(get_config(arch), compute_dtype=compute)
    tcfg = treduced(tget(arch), compute_dtype=compute)
    jp = JM.init_params(JM.param_specs(cfg), jax.random.PRNGKey(0))
    return cfg, tcfg, jp, params_from_jax(_np_tree(jp))


@pytest.fixture(scope="module", params=["qwen3-1.7b", "llama3-8b"])
def model_setup(request):
    return _model_setup(request.param)


def _assert_leaves_match(jcache, tcache):
    for pk, ent in jcache.items():
        assert set(ent) == set(tcache[pk]) == {"k", "v"}
        for leaf, a in ent.items():
            a = np.asarray(a)
            b = tcache[pk][leaf]
            assert tuple(b.shape) == a.shape and b.dtype == torch.float32
            np.testing.assert_allclose(b.numpy(), a, rtol=2e-4,
                                       atol=1e-4 * np.abs(a).max(),
                                       err_msg=f"{pk}/{leaf}")


def test_prefill_then_decode_steps_match_jax(model_setup):
    """A batch of prompts through ``prefill`` (query-chunked), the cache
    grown as ``serve`` grows it, then three ``decode_step``s: logits and
    every cache leaf after each call."""
    cfg, tcfg, jp, tp = model_setup
    rng = np.random.default_rng(3)
    B, S, gen = 2, 16, 3
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    jopts = JM.RunOptions(q_chunk=8)
    jl, jc = JM.prefill(jp, cfg, {"tokens": jnp.asarray(tokens)},
                        SINGLE_DEVICE_RULES, jopts)
    tl, tc = TM.prefill(tp, tcfg, {"tokens": _t(tokens)},
                        TM.RunOptions(q_chunk=8))
    assert tl.shape == (B, 1, cfg.vocab_size) and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    _assert_leaves_match(jc, tc)

    def grow(c):
        return np.concatenate([c, np.zeros(c.shape[:2] + (gen,) + c.shape[3:],
                                           c.dtype)], axis=2)
    tc = {p: {k: _t(grow(a.numpy())) for k, a in e.items()}
          for p, e in tc.items()}
    jc = {p: {k: jnp.asarray(grow(np.asarray(a))) for k, a in e.items()}
          for p, e in jc.items()}
    jstep = jax.jit(lambda p, c, t, q: JM.decode_step(
        p, cfg, c, t, q, SINGLE_DEVICE_RULES))
    tok = np.argmax(np.asarray(jl)[:, -1], axis=-1).astype(np.int32)[:, None]
    for i in range(gen):
        pos = np.full((B,), S + i, np.int32)
        jl, jc = jstep(jp, jc, tok, pos)
        tl, tc2 = TM.decode_step(tp, tcfg, tc, _t(tok), _t(pos))
        assert tc2 is tc                       # written in place
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
        _assert_leaves_match(jc, tc)
        tok = np.argmax(np.asarray(jl)[:, -1], axis=-1).astype(
            np.int32)[:, None]


def test_init_cache_layout_matches_jax(model_setup):
    cfg, tcfg, _, _ = model_setup
    jc = JM.init_cache(cfg, 3, 17)
    tc = TM.init_cache(tcfg, 3, 17)
    assert jax.tree.map(lambda a: a.shape, jc) == \
        jax.tree.map(lambda a: tuple(a.shape), tc)
    assert all(not a.any() for e in tc.values() for a in e.values())
    for i in range(tcfg.scan_period()):
        assert TM.cache_entry_shapes(tcfg, i, 3, 17) == \
            JM.cache_entry_shapes(cfg, i, 3, 17)


# -- the fixed-slot engine ----------------------------------------------------

@pytest.fixture(scope="module")
def engine_setup():
    return _model_setup("qwen3-1.7b")


def _drive(eng, sp_cls, reqs, sampling, steps_between=0):
    for r in reqs:
        kw = dict(r)
        prompt = kw.pop("prompt")
        eng.submit(prompt, sampling=None if sampling is None
                   else sp_cls(**sampling), **kw)
        for _ in range(steps_between):
            eng.step()
    eng.run()
    return {r.rid: list(r.generated) for r in eng.finished}


def _pair(setup, reqs, *, sampling=None, steps_between=0, **kw):
    cfg, tcfg, jp, tp = setup
    jeng = JEngine(cfg, jp, **kw)
    teng = TEngine(tcfg, tp, device="cpu", **kw)
    jout = _drive(jeng, JSamplingParams, reqs, sampling, steps_between)
    tout = _drive(teng, TSamplingParams, reqs, sampling, steps_between)
    assert tout == jout
    assert teng.trace == jeng.trace
    np.testing.assert_array_equal(teng.pos, np.asarray(jeng.pos))
    for key in ("prefill_tokens", "decode_tokens", "completed", "admitted"):
        assert getattr(teng.metrics, key) == getattr(jeng.metrics, key), key
    _assert_leaves_match(jeng.cache, teng.cache)
    return jeng, teng


def _greedy_reference(setup, prompt, n):
    """Full re-prefill per generated token, in the port."""
    _, tcfg, _, tp = setup
    toks, out = list(prompt), []
    for _ in range(n):
        logits, _ = TM.prefill(tp, tcfg, {"tokens": _t(np.asarray(
            toks, np.int32))[None]}, TM.RunOptions(q_chunk=512))
        out.append(int(torch.argmax(logits[0, -1])))
        toks.append(out[-1])
    return out


@pytest.mark.parametrize("sampling", [None, STOCHASTIC],
                         ids=["greedy", "stochastic"])
def test_engine_matches_jax_and_naive_greedy(engine_setup, sampling):
    prompt = np.arange(7, dtype=np.int32) % 256
    _, teng = _pair(engine_setup, [dict(prompt=prompt, max_new_tokens=5)],
                    sampling=sampling, slots=2, max_len=32)
    if sampling is None:
        assert teng.finished[0].generated == _greedy_reference(
            engine_setup, prompt, 5)


@pytest.mark.parametrize("sampling", [None, STOCHASTIC],
                         ids=["greedy", "stochastic"])
def test_slot_reuse_matches_jax(engine_setup, sampling):
    reqs = [dict(prompt=np.arange(3 + i, dtype=np.int32),
                 max_new_tokens=2 + (i % 3)) for i in range(5)]
    _, teng = _pair(engine_setup, reqs, sampling=sampling, slots=2,
                    max_len=48)
    assert sorted(r.rid for r in teng.finished) == list(range(5))
    for r in teng.finished:
        assert len(r.generated) == r.max_new_tokens


def test_mixed_lengths_isolated_and_match_jax(engine_setup):
    prompt = (np.arange(9, dtype=np.int32) * 3) % 256
    _, solo = _pair(engine_setup, [dict(prompt=prompt, max_new_tokens=6)],
                    slots=2, max_len=40)
    reqs = [dict(prompt=(np.arange(5, dtype=np.int32) * 7) % 256,
                 max_new_tokens=9),
            dict(prompt=prompt, max_new_tokens=6),
            dict(prompt=(np.arange(4, dtype=np.int32) * 11) % 256,
                 max_new_tokens=3)]
    _, busy = _pair(engine_setup, reqs, slots=2, max_len=40)
    got = next(r for r in busy.finished if len(r.prompt) == 9).generated
    assert got == solo.finished[0].generated


def test_slo_admission_and_staggered_submits_match_jax(engine_setup):
    rng = np.random.default_rng(5)
    prios = ["batch", "standard", "premium", "batch", "premium", "standard"]
    reqs = [dict(prompt=rng.integers(0, 256, int(rng.integers(3, 9))).astype(
        np.int32), max_new_tokens=int(rng.integers(2, 7)), priority=p)
        for p in prios]
    _, teng = _pair(engine_setup, reqs, steps_between=1, admission="slo",
                    aging_ticks=3, slots=2, max_len=20)
    assert len(teng.finished) == 6


@pytest.mark.parametrize("sampling", [None, STOCHASTIC],
                         ids=["greedy", "stochastic"])
def test_preemption_replay_matches_jax(engine_setup, sampling):
    """``Scheduler.preempt`` on a decoding fixed-slot request: the slot
    parks on scratch and re-admission replays prompt + generated[:-1],
    the replayed stream equal to JAX's and to an uncontended run."""
    cfg, tcfg, jp, tp = engine_setup
    prompt = (np.arange(6, dtype=np.int32) * 5) % 256
    streams = []
    for E, c, p, sp_cls, kw in ((JEngine, cfg, jp, JSamplingParams, {}),
                                (TEngine, tcfg, tp, TSamplingParams,
                                 {"device": "cpu"})):
        eng = E(c, p, slots=1, max_len=24, **kw)
        sp = None if sampling is None else sp_cls(**sampling)
        eng.submit(prompt, max_new_tokens=8, sampling=sp)
        for _ in range(3):
            eng.step()
        eng.preempt(eng.seats[0])
        assert int(np.asarray(eng.pos)[0]) == 24
        eng.run()
        streams.append((eng.finished[0].generated, eng.trace))
        solo = E(c, p, slots=1, max_len=24, **kw)
        solo.submit(prompt, max_new_tokens=8, sampling=sp)
        assert solo.run()[0].generated == eng.finished[0].generated
    assert streams[0] == streams[1]
    assert ("preempt" in [ev for _, ev, _ in streams[1][1]])


def test_rejects_cache_overflow(engine_setup):
    _, tcfg, _, tp = engine_setup
    eng = TEngine(tcfg, tp, slots=1, max_len=16, device="cpu")
    with pytest.raises(ValueError):
        eng.submit(np.arange(10, dtype=np.int32), max_new_tokens=8)
    with pytest.raises(ValueError):
        eng.submit(np.arange(16, dtype=np.int32), max_new_tokens=1)
    with pytest.raises(ValueError):
        eng.submit(np.asarray([], np.int32), max_new_tokens=2)
    eng.submit(np.arange(10, dtype=np.int32), max_new_tokens=6)  # == max_len
    assert len(eng.run()) == 1


def test_run_raises_on_stall(engine_setup):
    _, tcfg, _, tp = engine_setup
    eng = TEngine(tcfg, tp, slots=1, max_len=32, device="cpu")
    eng.submit(np.arange(4, dtype=np.int32), max_new_tokens=8)
    with pytest.raises(SchedulerStallError, match="active"):
        eng.run(max_ticks=2)


def test_release_parks_pos_on_scratch_and_idle_writes_stay_there(
        engine_setup):
    """A finished slot's write position parks on the scratch index
    (also when it finishes mid-tick), and its live region stays
    byte-identical while its sibling decodes on, in both packages."""
    reqs = [dict(prompt=np.arange(6, dtype=np.int32), max_new_tokens=2),
            dict(prompt=np.arange(9, dtype=np.int32) + 20,
                 max_new_tokens=10)]
    cfg, tcfg, jp, tp = engine_setup
    eng = TEngine(tcfg, tp, slots=2, max_len=32, device="cpu")
    for r in reqs:
        eng.submit(**r)
    eng.step()
    assert 0 not in eng.seats and 1 in eng.seats
    assert int(eng.pos[0]) == 32
    snap = {p: {k: a[:, 0, :32].clone() for k, a in e.items()}
            for p, e in eng.cache.items()}
    eng.run()
    for p, e in snap.items():
        for k, before in e.items():
            assert torch.equal(eng.cache[p][k][:, 0, :32], before), (p, k)
    assert list(eng.pos) == [32, 32]
    assert eng.policy.decode_ticks == 9 and bool(eng.policy.logits_finite)
    _pair(engine_setup, reqs, slots=2, max_len=32)


# -- the static batch behind --engine batch ----------------------------------

def test_serve_static_batch_matches_the_engine(monkeypatch):
    """``serve`` on the CPU: greedy tokens of each batch row equal the
    fixed-slot engine's on the same prompt and weights (f32 compute)."""
    from repro_torch.launch import serve as S
    cfg = treduced(tget("qwen3-1.7b"), compute_dtype="float32")
    monkeypatch.setattr(S, "reduced_config", lambda c: cfg)
    r = S.serve("qwen3-1.7b", batch=3, prompt_len=10, gen=5, seed=4,
                device="cpu")
    assert r["generated"].shape == (3, 5) and r["generated"].dtype == np.int32
    assert r["tokens_per_s"] > 0
    params = TM.init_params(TM.param_specs(cfg),
                            torch.Generator().manual_seed(4))
    prompts = np.random.default_rng(4).integers(0, cfg.vocab_size, (3, 10))
    eng = TEngine(cfg, params, slots=3, max_len=15, device="cpu")
    for p in prompts:
        eng.submit(p.astype(np.int32), max_new_tokens=5)
    done = sorted(eng.run(), key=lambda q: q.rid)
    np.testing.assert_array_equal(
        r["generated"], np.array([q.generated for q in done], np.int32))


def test_serve_cli_batch_engine_on_cpu(capsys):
    from repro_torch.launch.serve import main
    main(["--engine", "batch", "--device", "cpu", "--batch", "2", "--gen",
          "3", "--prompt-len", "8"])
    out = capsys.readouterr().out
    assert "[serve] prefill=" in out and "throughput=" in out
    main(["--device", "cpu", "--batch", "1", "--gen", "2",
          "--temperature", "0.7"])                  # batch is the default
    assert "[serve] sample tokens:" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        main(["--device", "cpu", "--gen", "0"])
