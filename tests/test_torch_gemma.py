"""The sliding-window family (gemma3-12b, reduced) in the port against the
JAX package on the CPU: the windowed plain versions of the decode kernels
(K1/K2 over f32, bf16, fp8 and int8 pools, K4 over f32 and bf16 caches)
through the model's ``paged_attention`` and ``decode_attention`` on
``attn_local`` layers; ``paged_decode_step`` with seats crossing the
window in prefill chunks and in ticks; ``prefill`` + ``decode_step``
crossing it; ``ring_decode_attention``; and the ring-buffer local cache
(``RunOptions(ring_local_cache=True)``) from ``prefill`` through
``decode_step``.

The reduced config keeps gemma3's pattern (5 local layers, then a global
one) with a window of 32; ``num_layers=6`` (one period) keeps XLA's
compile time down, and ``num_kv_heads=2`` gives gemma3-12b's GQA group of
2.  JAX-initialized weights are carried across by ``params_from_jax``;
compute is f32 unless a test says otherwise.

Tolerances, as in ``test_torch_fixed_slot.py`` and ``test_torch_model.py``:
attention outputs 2e-5 in f32 (sums taken in another order) and 2e-2 in
bf16 (one rounding of a bf16 output on each side); pool and cache leaves
rtol 2e-4 plus 1e-4 of the leaf's largest value.  Logits 5e-4
(``LOGIT_TOL``), not the 1e-4 of the dense models' tests: at these
weights the model is sensitive to rounding, and its f32 logits at a
52-token prompt lie up to 1.4e-4 (the port) and 7.9e-5 (JAX) from the
same weights evaluated in f64, at a largest logit of 2.0.  For the same
reason quantized pools are held where both sides quantize the same
projections, one attention call (byte-equal): through the model a value
at a rounding boundary can land one fp8 code apart in a later layer and
move later logits by a few 1e-3, so the model steps run an f32 pool.

The ring path starts from a prompt's last W rows at slot = position mod
W (``models/model.py::_ring_rows``), which is where its decode writes.
The reference keeps them in position order, which agrees with its own
decode's slot rule only where S <= W or S is a multiple of W; elsewhere
(S = 40, 70 here) the reference's ring path leaves its full-cache path,
and the port's must not.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced_config
from repro.core import mixed_precision as jmp
from repro.models import attention as jattn
from repro.models import model as JM
from repro.models.modules import init_params as jinit
from repro.parallel.sharding import SINGLE_DEVICE_RULES
from repro_torch.configs import get_config as tget
from repro_torch.configs import reduced_config as treduced
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import ops as tops
from repro_torch.models import attention as tattn
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_jax

ARCH = "gemma3-12b"
W = 32                 # the reduced config's window
SMALL = dict(num_layers=6, num_kv_heads=2)
PAGE = 4
LOGIT_TOL = 5e-4


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


def _cfgs(compute="float32"):
    cfg = reduced_config(get_config(ARCH), compute_dtype=compute, **SMALL)
    tcfg = treduced(tget(ARCH), compute_dtype=compute, **SMALL)
    assert cfg.sliding_window == tcfg.sliding_window == W
    assert cfg.layer_kinds() == ("attn_local",) * 5 + ("attn",)
    return cfg, tcfg


def _attn_setup(compute="float32"):
    cfg, tcfg = _cfgs(compute)
    jp = jinit(jattn.attn_specs(cfg), jax.random.PRNGKey(0))
    return cfg, tcfg, jp, params_from_jax(_np_tree(jp))


# -- K1/K2: paged decode on attn_local layers --------------------------------

# lengths below, at and past W; the window starts at 1, 3, 14 and 38, inside
# pages of 4
SEAT_LENGTHS = (1, 13, 32, 33, 35, 46, 70)


def _pools(rng, P, cfg, kv_dtype):
    """Random K/V pools (P, PAGE, KVH, hd) of ``kv_dtype`` in the JAX
    package's layout, with scales for quantized ones."""
    shape = (P, PAGE, cfg.num_kv_heads, cfg.head_dim)
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
def test_windowed_paged_decode_matches_jax(kv_dtype):
    """One decode token per seat on an ``attn_local`` layer: the port's
    ``paged_attention`` takes K1/K2's windowed plain version, JAX's its
    jnp gather; outputs and the written pool agree, and the window bites
    (a global layer's output differs past W)."""
    cfg, tcfg, jp, tp = _attn_setup()
    rng = np.random.default_rng(0)
    A = len(SEAT_LENGTHS)
    n = -(-max(SEAT_LENGTHS) // PAGE)
    P = 1 + A * n
    table = (rng.permutation(A * n) + 1).astype(np.int32).reshape(A, n)
    qpos = (np.asarray(SEAT_LENGTHS, np.int32) - 1)[:, None]
    nv = np.ones(A, np.int32)
    x = rng.normal(size=(A, 1, cfg.d_model)).astype(np.float32)
    entry = _pools(rng, P, cfg, kv_dtype)
    out = {}
    for kind in ("attn_local", "attn"):
        jout, jentry = jattn.paged_attention(jp, cfg, x, entry, table, qpos,
                                             nv, kind=kind)
        tentry = {k: _t(a) for k, a in entry.items()}
        tout = tattn.paged_attention(tp, tcfg, _t(x), tentry, _t(table),
                                     _t(qpos), _t(nv), kind=kind)
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout),
                                   atol=2e-5, rtol=0)
        for leaf, a in jentry.items():
            if tentry[leaf].dtype in (torch.uint8, torch.int8):
                assert tentry[leaf].numpy().tobytes() == \
                    np.asarray(a).tobytes(), leaf
            else:
                np.testing.assert_allclose(_f32(tentry[leaf]), _f32(a),
                                           rtol=2e-4, atol=1e-6)
        out[kind] = tout.numpy()
    past = np.asarray(SEAT_LENGTHS) > W
    gap = np.abs(out["attn_local"] - out["attn"]).max(axis=(1, 2))
    assert (gap[past] > 1e-3).all() and (gap[~past] < 1e-5).all(), gap


def test_windowed_paged_plain_equals_the_gathered_window():
    """K1's windowed plain version on a bf16 pool equals the unwindowed
    one over a table that starts at the window: the keys it keeps are
    exactly the last W."""
    rng = np.random.default_rng(1)
    A, H, KVH, d, n = 3, 4, 2, 16, 12
    lengths = np.array([40, 33, 45], np.int32)
    q = torch.from_numpy(rng.normal(size=(A, 1, H, d)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(1 + A * n, PAGE, KVH, d))
                             .astype(np.float32)).bfloat16()
            for _ in range(2))
    table = torch.arange(1, 1 + A * n, dtype=torch.int32).reshape(A, n)
    got = tops.paged_decode_attention(q, k, v, table, _t(lengths), window=8)
    for a, L in enumerate(lengths):
        kd = k[table[a].long()].reshape(-1, KVH, d)[L - 8:L]
        vd = v[table[a].long()].reshape(-1, KVH, d)[L - 8:L]
        want = tops.decode_attention(q[a:a + 1], kd[None], vd[None],
                                     torch.tensor([8], dtype=torch.int32))
        np.testing.assert_allclose(got[a].numpy(), want[0].numpy(),
                                   atol=1e-6)


# -- K4: dense decode on attn_local layers -----------------------------------

@pytest.mark.parametrize("compute,tol", [("float32", 2e-5),
                                         ("bfloat16", 2e-2)])
def test_windowed_dense_decode_matches_jax(compute, tol):
    """One decode token per slot against a dense cache on an
    ``attn_local`` layer (K4's windowed plain version in the port): write
    positions below, at and past W and the scratch index."""
    cfg, tcfg, jp, tp = _attn_setup(compute)
    rng = np.random.default_rng(2)
    B, T = 6, 80
    dt = jnp.dtype(compute)
    x = jnp.asarray(rng.normal(size=(B, 1, cfg.d_model)), dt)
    ck, cv = (jnp.asarray(rng.normal(size=(B, T, cfg.num_kv_heads,
                                           cfg.head_dim)) * 0.5, dt)
              for _ in range(2))
    pos = np.array([0, 20, 31, 32, 45, 79], np.int32)
    out = {}
    for kind in ("attn_local", "attn"):
        jout, jk, jv = jattn.decode_attention(jp, cfg, x, ck, cv, pos,
                                              kind=kind)
        tk, tv = _t(ck), _t(cv)
        tout, rk, rv = tattn.decode_attention(tp, tcfg, _t(x), tk, tv,
                                              _t(pos), kind=kind)
        assert rk is tk and rv is tv
        np.testing.assert_allclose(_f32(tout), _f32(jout), atol=tol, rtol=0)
        np.testing.assert_allclose(_f32(tk), _f32(jk), atol=tol, rtol=0)
        np.testing.assert_allclose(_f32(tv), _f32(jv), atol=tol, rtol=0)
        out[kind] = _f32(tout)
    gap = np.abs(out["attn_local"] - out["attn"]).max(axis=(1, 2))
    past = pos + 1 > W
    assert (gap[past] > 5 * tol).all() and (gap[~past] == 0).all(), gap


# -- the model steps ----------------------------------------------------------

@pytest.fixture(scope="module")
def model_setup():
    cfg, tcfg = _cfgs()
    jp = JM.init_params(JM.param_specs(cfg), jax.random.PRNGKey(0))
    return cfg, tcfg, jp, params_from_jax(_np_tree(jp))


def _assert_pools_match(jcache, tcache):
    """Every pool leaf outside the scratch page 0, within the model
    tolerance."""
    for pk, ent in jcache.items():
        for leaf, a in ent.items():
            a = np.asarray(a)[:, 1:]
            np.testing.assert_allclose(tcache[pk][leaf][:, 1:].numpy(), a,
                                       rtol=2e-4, atol=1e-4 * np.abs(a).max(),
                                       err_msg=f"{pk}/{leaf}")


def test_paged_decode_step_crossing_the_window_matches_jax(model_setup):
    """Two seats prefilled in chunks of 16 (45 and 26 prompt tokens: the
    first crosses W inside its third chunk), then 8 greedy ticks (the
    second crosses W in them): logits of every valid row and every pool
    leaf after every step equal JAX's."""
    cfg, tcfg, jp, tp = model_setup
    rng = np.random.default_rng(3)
    n, C = 20, 16
    table = (rng.permutation(2 * n) + 1).astype(np.int32).reshape(2, n)
    step = jax.jit(lambda p, c, t, q, pt, nv: JM.paged_decode_step(
        p, cfg, c, t, q, pt, nv, SINGLE_DEVICE_RULES))
    jc = JM.init_paged_cache(cfg, 1 + 2 * n, PAGE)
    tc = params_from_jax(_np_tree(jc))
    prompts = [rng.integers(0, cfg.vocab_size, n_).astype(np.int32)
               for n_ in (45, 26)]

    def both(tokens, pos, nv):
        nonlocal jc
        jl, jc = step(jp, jc, tokens, pos, table, nv)
        tl, _ = TM.paged_decode_step(tp, tcfg, tc, _t(tokens), _t(pos),
                                     _t(table), _t(nv))
        valid = np.arange(tokens.shape[1])[None, :] < nv[:, None]
        np.testing.assert_allclose(tl.numpy()[valid], np.asarray(jl)[valid],
                                   atol=LOGIT_TOL, rtol=0)
        _assert_pools_match(jc, tc)
        return np.asarray(jl)

    last = np.zeros(2, np.int32)
    for start in range(0, 48, C):
        tok = np.zeros((2, C), np.int32)
        nv = np.zeros(2, np.int32)
        for a, p in enumerate(prompts):
            part = p[start:start + C]
            tok[a, :len(part)] = part
            nv[a] = len(part)
        jl = both(tok, np.full(2, start, np.int32), nv)
        for a in range(2):
            if nv[a]:
                last[a] = np.argmax(jl[a, nv[a] - 1])
    pos = np.array([len(p) for p in prompts], np.int32)
    for _ in range(8):
        jl = both(last[:, None], pos, np.ones(2, np.int32))
        last = np.argmax(jl[:, 0], axis=-1).astype(np.int32)
        pos = pos + 1
    assert pos[1] > W + 1


def _pad(a, T):
    a = np.asarray(a)
    return np.concatenate([a, np.zeros(a.shape[:2] + (T - a.shape[2],)
                                       + a.shape[3:], a.dtype)], axis=2)


def test_prefill_then_decode_steps_crossing_the_window_match_jax(
        model_setup):
    """``prefill`` of 28 tokens then 8 ``decode_step``s (positions 28-35,
    across W) on the full dense cache: logits and every cache leaf."""
    cfg, tcfg, jp, tp = model_setup
    rng = np.random.default_rng(4)
    B, S, gen = 2, 28, 8
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    jl, jc = JM.prefill(jp, cfg, {"tokens": jnp.asarray(tokens)},
                        SINGLE_DEVICE_RULES, JM.RunOptions(q_chunk=8))
    tl, tc = TM.prefill(tp, tcfg, {"tokens": _t(tokens)},
                        TM.RunOptions(q_chunk=8))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL)
    jc = {p: {k: jnp.asarray(_pad(a, S + gen)) for k, a in e.items()}
          for p, e in jc.items()}
    tc = {p: {k: _t(_pad(a.numpy(), S + gen)) for k, a in e.items()}
          for p, e in tc.items()}
    jstep = jax.jit(lambda p, c, t, q: JM.decode_step(
        p, cfg, c, t, q, SINGLE_DEVICE_RULES))
    tok = np.argmax(np.asarray(jl)[:, -1], axis=-1).astype(np.int32)[:, None]
    for i in range(gen):
        pos = np.full((B,), S + i, np.int32)
        jl, jc = jstep(jp, jc, tok, pos)
        tl, _ = TM.decode_step(tp, tcfg, tc, _t(tok), _t(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_TOL)
        for pk, ent in jc.items():
            for leaf, a in ent.items():
                a = np.asarray(a)
                np.testing.assert_allclose(tc[pk][leaf].numpy(), a,
                                           rtol=2e-4,
                                           atol=1e-4 * np.abs(a).max())
        tok = np.argmax(np.asarray(jl)[:, -1], axis=-1).astype(
            np.int32)[:, None]


# -- the ring-buffer local cache ---------------------------------------------

RING_POS = np.array([3, 31, 32, 50, 77], np.int32)


def test_ring_decode_attention_matches_jax(monkeypatch):
    """One ``ring_decode_attention`` call on a ring of W rows, write
    positions before and after the ring fills: the plain route (the
    reference's mask) and the kernel route (K4 over the first
    ``min(pos + 1, W)`` slots, its launch stood in for by the plain
    version) both equal JAX's output and ring."""
    cfg, tcfg, jp, tp = _attn_setup()
    rng = np.random.default_rng(5)
    B = len(RING_POS)
    x = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    ck, cv = (rng.normal(size=(B, W, cfg.num_kv_heads, cfg.head_dim))
              .astype(np.float32) for _ in range(2))
    jout, jk, jv = jattn.ring_decode_attention(jp, cfg, x, ck, cv, RING_POS)

    def check():
        tk, tv = _t(ck), _t(cv)
        tout, rk, rv = tattn.ring_decode_attention(tp, tcfg, _t(x), tk, tv,
                                                   _t(RING_POS))
        assert rk is tk and rv is tv
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout),
                                   atol=2e-5, rtol=0)
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=2e-5)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=2e-5)

    check()
    import contextlib
    seen = []

    def dense(q, k, v, lengths, out, window=None):
        seen.append((lengths.tolist(), window))
        out.copy_(tda.decode_attention_plain(q, k, v, lengths, window))
    monkeypatch.setattr(tops, "use_kernel", lambda impl, x: True)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(tda, "decode_attention_cuda", dense)
    check()
    assert seen == [(np.minimum(RING_POS + 1, W).tolist(), None)]


@pytest.fixture(scope="module")
def ring_setup(model_setup):
    """The model and JAX's jitted prefill and decode step, full cache and
    ring cache, compiled once for the module."""
    cfg, tcfg, jp, tp = model_setup
    opts = {ring: JM.RunOptions(q_chunk=8, ring_local_cache=ring)
            for ring in (False, True)}
    prefill = {ring: jax.jit(lambda p, b, o=o: JM.prefill(
        p, cfg, b, SINGLE_DEVICE_RULES, o)) for ring, o in opts.items()}
    decode = {ring: jax.jit(lambda p, c, t, q, o=o: JM.decode_step(
        p, cfg, c, t, q, SINGLE_DEVICE_RULES, o)) for ring, o in opts.items()}
    return cfg, tcfg, jp, tp, prefill, decode


RING_T, RING_GEN = 80, 8


def _jax_decode_cache(cfg, cache, ring: bool):
    """JAX's prefill cache padded to a decode cache: RING_T rows, or W
    rows on the local layers of a ring."""
    kinds = cfg.layer_kinds()
    out = {}
    for pk, ent in cache.items():
        local = ring and kinds[int(pk[3:])] == "attn_local"
        out[pk] = {k: jnp.asarray(_pad(a, W if local else RING_T))
                   for k, a in ent.items()}
    return out


def _jax_run(setup, tokens, ring: bool, teacher=None):
    """JAX's prefill then RING_GEN decode steps, fed ``teacher`` (or its
    own greedy tokens); returns the logits of every step and the tokens
    fed."""
    cfg, _, jp, _, prefill, decode = setup
    S = tokens.shape[1]
    jl, jc = prefill[ring](jp, {"tokens": jnp.asarray(tokens)})
    jc = _jax_decode_cache(cfg, jc, ring)
    logits, fed = [np.asarray(jl)], []
    for i in range(RING_GEN):
        tok = (teacher[i] if teacher is not None else
               np.argmax(logits[-1][:, -1], axis=-1).astype(np.int32)[:, None])
        fed.append(tok)
        jl, jc = decode[ring](jp, jc, tok, np.full(len(tokens), S + i,
                                                   np.int32))
        logits.append(np.asarray(jl))
    return logits, fed


def _torch_ring_run(setup, tokens, fed):
    """The port's prefill and RING_GEN decode steps with the ring cache:
    the prefill rows placed at the head of a cache of ``init_cache``'s
    shapes (W rows on the local layers).  Returns every step's logits."""
    _, tcfg, _, tp, _, _ = setup
    B, S = tokens.shape
    opts = TM.RunOptions(q_chunk=8, ring_local_cache=True)
    tl, rows = TM.prefill(tp, tcfg, {"tokens": _t(tokens)}, opts)
    cache = TM.init_cache(tcfg, B, RING_T, opts)
    for pk, ent in cache.items():
        local = tcfg.layer_kinds()[int(pk[3:])] == "attn_local"
        for key, full in ent.items():
            r = rows[pk][key]
            assert r.shape[2] == (min(S, W) if local else S), (pk, r.shape)
            assert full.shape[2] == (W if local else RING_T)
            full[:, :, :r.shape[2]] = r
    logits = [tl.numpy()]
    for i, tok in enumerate(fed):
        tl, _ = TM.decode_step(tp, tcfg, cache, _t(tok),
                               _t(np.full(B, S + i, np.int32)), opts)
        logits.append(tl.numpy())
    return logits


def _max_gap(a, b):
    return max(float(np.abs(x - y).max()) for x, y in zip(a, b))


@pytest.mark.parametrize("S", [24, 32, 40, 64, 70])
def test_ring_cache_equals_jax_full_cache(ring_setup, S):
    """``prefill`` + 8 ``decode_step``s with the ring cache on equal JAX's
    full-cache run at every prompt length, S % W == 0 or not (tokens fed
    are JAX's greedy ones).  Where S > W and S % W != 0, JAX's own ring
    path leaves its full-cache path (the reference's slot-order fault):
    the lengths where the port's roll is what keeps the two equal."""
    tokens = np.random.default_rng(S).integers(
        0, ring_setup[0].vocab_size, (2, S)).astype(np.int32)
    full, fed = _jax_run(ring_setup, tokens, ring=False)
    mine = _torch_ring_run(ring_setup, tokens, fed)
    assert _max_gap(mine, full) < LOGIT_TOL
    if S > W and S % W:
        jring, _ = _jax_run(ring_setup, tokens, ring=True, teacher=fed)
        assert _max_gap(jring, full) > 1e-2


@pytest.mark.parametrize("S", [24, 32, 64])
def test_ring_cache_equals_jax_ring_where_its_slot_rule_holds(ring_setup, S):
    """Where the reference's ring keeps slot = position mod W (S <= W or
    S % W == 0) the port's ring path equals JAX's ring path too."""
    tokens = np.random.default_rng(S + 1).integers(
        0, ring_setup[0].vocab_size, (2, S)).astype(np.int32)
    jring, fed = _jax_run(ring_setup, tokens, ring=True)
    mine = _torch_ring_run(ring_setup, tokens, fed)
    assert _max_gap(mine, jring) < LOGIT_TOL


def test_ring_cache_shapes_match_jax():
    """``cache_entry_shapes`` and ``init_cache`` with the ring option equal
    JAX's: the local layers keep min(seq, W) rows."""
    cfg, tcfg = _cfgs()
    for seq in (20, W, 100):
        for ring in (False, True):
            jo = JM.RunOptions(ring_local_cache=ring)
            to = TM.RunOptions(ring_local_cache=ring)
            for i in range(cfg.scan_period()):
                assert TM.cache_entry_shapes(tcfg, i, 3, seq, to) == \
                    JM.cache_entry_shapes(cfg, i, 3, seq, jo)
            jc, tc = JM.init_cache(cfg, 3, seq, jo), TM.init_cache(tcfg, 3,
                                                                  seq, to)
            for pk, ent in jc.items():
                for k, a in ent.items():
                    assert tuple(tc[pk][k].shape) == a.shape
