"""minicpm-2b (reduced) in the port against the JAX package on the CPU.

The reduced config keeps what sets minicpm-2b apart from the dense models
the port served before it: MHA (4 heads over 4 here, 36 over 36 at full
size), head dim 64 (K1/K2 and K4 on their E = 2 instantiations on the
card; their plain versions here), a tied embedding, and an odd
vocabulary (251 here, 122 753 at full size), which reaches the tied LM
head, the sampler's sort, top-p scatter and Gumbel row, and the chunked
cross-entropy.  JAX-initialized weights are carried across by
``params_from_jax``; inputs come from numpy with a seed.

Tolerances, as in ``test_torch_model.py`` and ``test_torch_fixed_slot.py``:
f32 logits within 1e-4 of the largest logit (XLA and torch take the f32
sums in other orders); cache and f32 pool leaves rtol 2e-4 plus 1e-4 of
the leaf's largest value; bf16 pool leaves one bf16 step; bf16 compute
within 0.05 of the largest logit.

Quantized pages: ``quantize_kv_page`` on the same f32 pages gives the
same bytes and the same f32 scales, bit for bit.  Written by the model,
the pages quantize K/V that carry the f32 sums' ulps, so the scales are
held as f32 pool leaves are; the bytes are equal but where a value lies
within those ulps of a rounding boundary and lands one code apart (one
fp8 V byte of the prefill chunk below).  One fp8 code moves later
logits by up to ~2e-4 of the largest here, so the model steps on
quantized pools hold logits within 5e-4 (``QUANT_LOGIT_TOL``,
``test_torch_gemma.py``'s bound).

Training: the reference's ``init_params`` takes a stacked leaf's fan-in
to be its first axis (G = 2 here), so without qk-norm the scores reach
tens and the softmax is nearly one-hot; there AdamW's first updates
carry the f32 sums' ulps into grad norms 2e-3 apart by the third step
(qwen3-1.7b's qk-norm keeps them at 1e-7).  The training tests scale
``wq`` and ``wk`` to their true fan-in (``test_torch_whisper.py``'s
``_scale_qk``) on both sides and then hold ``test_torch_train.py``'s and
``test_torch_train_parts.py``'s f32 tolerances.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced_config
from repro.configs.base import ShapeConfig
from repro.core import mixed_precision as jmp
from repro.data.pipeline import TokenPipeline as JPipeline
from repro.launch.mesh import make_host_mesh
from repro.launch.steps import build_cell as jbuild_cell
from repro.models import attention as jattn
from repro.models import model as JM
from repro.models.modules import count_params as jcount
from repro.models.modules import init_params as jinit
from repro.optim.adamw import init_opt_state as jinit_opt_state
from repro.parallel.sharding import SINGLE_DEVICE_RULES
from repro_torch.configs import ShapeConfig as TShapeConfig
from repro_torch.configs import get_config as tget
from repro_torch.configs import reduced_config as treduced
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch.steps import build_cell, value_and_grad
from repro_torch.models import attention as tattn
from repro_torch.models import model as TM
from repro_torch.models.convert import cast_for_compute, params_from_jax
from repro_torch.optim.adamw import init_opt_state
from repro_torch.tree import tree_leaves

ARCH = "minicpm-2b"
SMALL = dict(vocab_size=251, head_dim=64)
P, PAGE, N = 16, 4, 6
LOGIT_TOL = 1e-4           # of the largest logit
QUANT_LOGIT_TOL = 5e-4     # of the largest logit, quantized pools


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


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


def _close_logits(got, want, what="", tol=LOGIT_TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * np.abs(want).max(), err_msg=what)


def _scale_qk(jp, d_model: int):
    """JAX params with each block's ``wq`` and ``wk`` scaled by
    sqrt(G / d_model), their true fan-in (module docstring)."""
    def walk(t):
        return {k: walk(v) if isinstance(v, dict) else
                (v * np.float32(np.sqrt(v.shape[0] / d_model))
                 if k in ("wq", "wk") else v)
                for k, v in t.items()}
    return jax.tree.map(jnp.asarray, walk(_np_tree(jp)))


def test_shapes_odd_vocabulary_and_full_size_count():
    """The reduced config is MHA at head dim 64 with a tied embedding of
    an odd number of rows (no ``lm_head``); the full config's parameters
    count 2 724 880 896 in both packages (40 layers of 4 x 2304^2 + 3 x
    2304 x 5760 and two norms, the 122 753 x 2304 embedding, the final
    norm)."""
    cfg, tcfg = _cfgs()
    assert (tcfg.num_heads, tcfg.num_kv_heads, tcfg.resolved_head_dim,
            tcfg.vocab_size) == (4, 4, 64, 251)
    assert tcfg.tie_embeddings and tcfg.vocab_size % 2 == 1
    specs = TM.param_specs(tcfg)
    assert "lm_head" not in specs and specs["embed"].shape == (251, 64)
    full, tfull = get_config(ARCH), tget(ARCH)
    per_layer = 4 * 2304 ** 2 + 3 * 2304 * 5760 + 2 * 2304
    want = 40 * per_layer + 122_753 * 2304 + 2304
    assert want == 2_724_880_896
    assert TM.count_params(TM.param_specs(tfull)) == want == \
        jcount(JM.param_specs(full))


def test_prefill_then_decode_steps_match_jax(setup):
    """Two prompts through ``prefill`` (query-chunked), the cache grown
    as ``serve`` grows it, then four greedy ``decode_step``s: logits
    (251 wide) and every cache leaf after each call."""
    cfg, tcfg, jp, tp = setup
    rng = np.random.default_rng(3)
    B, S, gen = 2, 21, 4
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    jl, jc = JM.prefill(jp, cfg, {"tokens": jnp.asarray(tokens)},
                        SINGLE_DEVICE_RULES, JM.RunOptions(q_chunk=8))
    tl, tc = TM.prefill(tp, tcfg, {"tokens": _t(tokens)},
                        TM.RunOptions(q_chunk=8))
    assert tl.shape == (B, 1, 251) and tl.dtype == torch.float32
    _close_logits(tl.numpy(), jl, "prefill")
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


def test_tied_head_at_the_odd_vocabulary(setup):
    """The logits are the final norm's output against every one of the
    251 embedding rows: the last row (past any 16-byte-aligned width) is
    as live as the first."""
    _, tcfg, _, tp = setup
    tokens = torch.tensor([[250, 0, 249, 7]], dtype=torch.int32)
    logits, _ = TM.prefill(tp, tcfg, {"tokens": tokens})
    emb = tp["embed"].clone()
    emb[-1] = 0
    cut, _ = TM.prefill(dict(tp, embed=emb), tcfg, {"tokens": tokens})
    assert logits.shape[-1] == 251
    assert cut[0, -1, -1] == 0 and logits[0, -1, -1] != 0
    # every other logit moves only through row 250's use as an input
    assert not torch.equal(cut[0, -1, :-1], logits[0, -1, :-1])


# -- the paged path: K1/K2's plain versions at d 64 ---------------------------

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
def test_paged_attention_at_head_dim_64_matches_jax(kv_dtype):
    """One decode token per seat through ``paged_attention`` at 4 heads
    over 4 of 64 (the plain versions of K1/K2 in the port): the output,
    and the written pages, quantized bytes and f32 scales bit for bit."""
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
            np.testing.assert_allclose(b.numpy(), a, rtol=2e-4, atol=0,
                                       err_msg=leaf)


@pytest.mark.parametrize("kv_dtype", ["fp8", "int8"])
def test_kv_page_quantizer_is_bit_identical_at_head_dim_64(kv_dtype):
    """``quantize_kv_page`` on the same f32 pages of 4 heads of 64 (a
    page's rows spread over 2^-8..2^8, and rows of zeros): the port's
    bytes and f32 scales equal JAX's bit for bit, and so do the
    dequantized pages."""
    from repro_torch.core import mixed_precision as tmp
    rng = np.random.default_rng(6)
    x = rng.normal(size=(9, PAGE, 4, 64)).astype(np.float32)
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
    one step, quantized bytes equal but at a rounding boundary
    (``_one_code_at_most``)."""
    for pk, ent in jcache.items():
        for leaf, a in ent.items():
            a, b = np.asarray(a)[:, 1:], tcache[pk][leaf][:, 1:]
            if b.dtype == torch.bfloat16:
                diff = np.abs(a.view(np.uint16).astype(np.int32)
                              - b.view(torch.int16).numpy().view(np.uint16)
                              .astype(np.int32))
                assert diff.max() <= 1, (pk, leaf)
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
        assert tl.shape == jl.shape and tl.shape[-1] == 251
        valid = np.arange(tl.shape[1])[None, :] < step["n_valid"][:, None]
        _close_logits(tl.numpy()[valid], jl[valid], tol=LOGIT_TOL if kv_dtype
                      in (None, "bf16") else QUANT_LOGIT_TOL)
        _assert_pools(jc, tc)


@pytest.mark.parametrize("kv_dtype", [None, "bf16", "fp8", "int8"])
def test_fused_decode_tick_matches_jax(setup, kv_dtype):
    """Three fused ticks after a prefill, a greedy seat, a top-k seat and
    a top-p seat sampling over the 251-wide row: tokens, advanced
    positions and sampler steps equal JAX's; the pool in place."""
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
    last = np.array([17, 250, 99], np.int32)
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
        assert toks is tlast and logits.shape == (3, 251)
        np.testing.assert_array_equal(tlast.numpy(), np.asarray(jtoks))
        np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
        np.testing.assert_array_equal(tstep.numpy(),
                                      np.asarray(jstep).astype(np.int64))
        assert ((tlast >= 0) & (tlast < 251)).all()
        _assert_pools(jc, tc)


def test_bf16_compute_within_tolerance():
    """bf16 compute through ``paged_decode_step`` and ``prefill``: XLA-CPU
    and torch-CPU need not round bf16 alike, so logits are held within
    0.05 of the largest (``test_torch_model.py``'s bound)."""
    cfg, tcfg, jp, tp = _setup("bfloat16")
    table, prefill, decode = _paged_inputs(cfg)
    jc = JM.init_paged_cache(cfg, P, PAGE)
    tc = params_from_jax(_np_tree(jc))
    for step in (prefill, decode):
        jl, jc = _jax_step(jp, cfg, jc, table, **step)
        tl, tc = TM.paged_decode_step(
            tp, tcfg, tc, *(torch.from_numpy(step[k])
                            for k in ("tokens", "pos")),
            torch.from_numpy(table), torch.from_numpy(step["n_valid"]))
        valid = np.arange(tl.shape[1])[None, :] < step["n_valid"][:, None]
        scale = np.abs(jl[valid]).max()
        np.testing.assert_allclose(tl.numpy()[valid], jl[valid], rtol=0,
                                   atol=0.05 * scale)
    tokens = np.random.default_rng(5).integers(0, 251, (2, 12)).astype(
        np.int32)
    jl, _ = JM.prefill(jp, cfg, {"tokens": jnp.asarray(tokens)},
                       SINGLE_DEVICE_RULES)
    tl, _ = TM.prefill(tp, tcfg, {"tokens": _t(tokens)})
    jl = np.asarray(jl).astype(np.float32)
    np.testing.assert_allclose(tl.float().numpy(), jl, rtol=0,
                               atol=0.05 * np.abs(jl).max())


# -- training: WSD steps and the tied embedding's gradient --------------------

B, S = 4, 32


def test_train_steps_match_jax_under_wsd():
    """Four f32 train steps through ``build_cell(...).fn`` against JAX's
    from the same params (``wq``/``wk`` at their true fan-in) and
    batches, the lr on the WSD schedule (a warmup of 2 steps at
    total_steps 200): losses, cross-entropy, grad
    norms and lr after each step, and the params and update after the
    last (``test_torch_train.py``'s f32 tolerances)."""
    cfg, tcfg = _cfgs()
    mesh = make_host_mesh()
    kw = dict(lr_peak=3e-3, total_steps=200)
    cell = jbuild_cell(cfg, ShapeConfig("custom", S, B, "train"), mesh,
                       opts=JM.RunOptions(q_chunk=16, xent_chunk=16), **kw)
    tcell = build_cell(tcfg, TShapeConfig("custom", S, B, "train"),
                       TM.RunOptions(q_chunk=16, xent_chunk=16), **kw)
    jp = _scale_qk(JM.init_params(JM.param_specs(cfg),
                                  jax.random.PRNGKey(0)), cfg.d_model)
    p0 = jax.tree.leaves(_np_tree(jp))
    jo = jinit_opt_state(jp)
    tp = params_from_jax(_np_tree(jp))
    to = init_opt_state(tp)
    jpipe = JPipeline(cfg.vocab_size, S, B)
    tpipe = TokenPipeline(tcfg.vocab_size, S, B, device="cpu")
    lrs = []
    with mesh:
        fn = jax.jit(cell.fn)
        for step in range(4):
            jp, jo, jm = fn(jp, jo, jpipe.get_batch(step))
            tp, to, tm = tcell.fn(tp, to, tpipe.get_batch(step))
            for key, rtol in (("loss", 1e-5), ("xent", 1e-5),
                              ("grad_norm", 1e-3), ("lr", 1e-6)):
                np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                           rtol=rtol, err_msg=key)
            lrs.append(float(tm["lr"]))
    assert lrs == pytest.approx([0.0, 1.5e-3, 3e-3, 3e-3])
    assert int(to["count"]) == int(jo["count"]) == 4
    for a, t, start in zip(jax.tree.leaves(jp), tree_leaves(tp), p0):
        a, t = np.asarray(a), t.numpy()
        np.testing.assert_allclose(t, a, atol=5e-5)
        assert np.linalg.norm(a - t) / np.linalg.norm(a - start) < 1e-3


def test_tied_embedding_grads_match_jax():
    """``lm_loss`` and its gradients against ``jax.value_and_grad``: the
    tied embedding takes the input rows' and the head's gradient over
    all 251 rows (the chunked cross-entropy chunks the sequence, each
    chunk's logits 251 wide); every leaf within 1e-4 of its largest
    magnitude, the embedding (its head gradient rounded to bf16 chunk by
    chunk on both sides) within one bf16 step per element plus that."""
    cfg, tcfg = _cfgs()
    jp = _scale_qk(JM.init_params(JM.param_specs(cfg),
                                  jax.random.PRNGKey(0)), cfg.d_model)
    tp = params_from_jax(_np_tree(jp))
    batch = JPipeline(cfg.vocab_size, S, B).get_batch(0)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: JM.lm_loss(p, cfg, b, SINGLE_DEVICE_RULES,
                                JM.RunOptions(q_chunk=16, xent_chunk=16)),
        has_aux=True))(jp, batch)
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    (tl, tm), tg = value_and_grad(tp, tcfg, tb,
                                  TM.RunOptions(q_chunk=16, xent_chunk=16))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(tm["xent"]), float(jm["xent"]),
                               rtol=1e-5)
    flat, _ = jax.tree_util.tree_flatten_with_path(jg)
    assert len(flat) == len(tree_leaves(tg))
    for (path, a), t in zip(flat, tree_leaves(tg)):
        name = "/".join(str(p.key) for p in path)
        a, t = np.asarray(a), t.numpy()
        assert a.shape == t.shape, name
        lim = 1e-4 * np.abs(a).max() + (2.0 ** -7 * np.abs(a)
                                        if name == "embed" else 0)
        assert (np.abs(a - t) <= lim).all(), (name, np.abs(a - t).max())
    assert tg["embed"].shape == (251, 64) and bool(tg["embed"][-1].any())
