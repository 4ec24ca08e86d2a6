"""The arithmetic of the tensor-core flash kernel (K5) and of the split-K
paged decode kernel (K1/K2), emulated in torch on the CPU and held
against the JAX package on the same numpy inputs.

The kernels run only on the card, where ``chip_smoke.py`` holds them
against their plain versions.  Here each one's own arithmetic is
emulated step by step, so that the tolerance the card holds them to is
shown to admit it and to reject a planted fault:

- K5: 64-row query tiles, the key tiles of 64 each tile can see in the
  kernel's order, scores in base 2, P carried as two bf16 terms (hi =
  bf16(p), lo = bf16(p - hi)) and l summed from hi + lo; against
  ``repro.kernels.ops.flash_attention`` (Pallas, interpret mode) and
  ``ref.attention_ref`` within the chip's bf16 tolerance (1e-3 +
  2^-7·|ref|).  P rounded once to e4m3 must fail it, and so does P
  rounded once to bf16 on the causal and windowed cases, which is why
  the kernel carries the second term.
- K1/K2: one partial (m, l, acc) per chunk of ``split_plan`` tokens,
  the empty state (-1e30, 0, 0) for a chunk past the length, merged in
  split order; against the Pallas paged kernels in interpret mode.
  Dropping one split must fail.
- K4: the same split-K on the dense fixed-slot cache, planned from the
  cache width, for GQA groups 1, 2, 4 and 8 in bf16 and f32, with an
  idle slot parked on the scratch index walking the whole cache; against
  ``decode_attention_pallas`` in interpret mode and the jnp oracle.
  Dropping one split must fail.
"""
import math

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import mixed_precision as jmp
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import flash_attention as tfa

NEG_INF = -1e30
BF16_ATOL, BF16_RTOL = 1e-3, 2.0 ** -7      # chip_smoke.py's bf16 tolerance
ROWS = KEYS = 64                             # K5's query and key tiles


def _bf16(rng, shape):
    return rng.normal(size=shape).astype(np.float32).astype(
        ml_dtypes.bfloat16)


def _f32(x):
    return np.asarray(x).astype(np.float32)


# -- K5: the tensor-core flash kernel ------------------------------------

def emulate_flash_tc(q, k, v, *, causal, window, p_dtype=torch.bfloat16,
                     p_terms=2):
    """K5's tensor-core route in torch: q (B, Sq, H, d), k/v (B, Skv,
    KVH, d) hold bf16 values; returns (B, Sq, H, d) bf16.  P enters the
    product as ``p_terms`` terms in ``p_dtype`` (the kernel: two bf16)."""
    q, k, v = (torch.from_numpy(_f32(a)) for a in (q, k, v))
    B, Sq, H, d = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    qh = q.permute(0, 2, 1, 3)                             # (B, H, Sq, d)
    kh = k.permute(0, 2, 1, 3).repeat_interleave(G, dim=1)
    vh = v.permute(0, 2, 1, 3).repeat_interleave(G, dim=1)
    pad = (-Skv) % KEYS                                    # TMA's zero fill
    kh = torch.nn.functional.pad(kh, (0, 0, 0, pad))
    vh = torch.nn.functional.pad(vh, (0, 0, 0, pad))
    scale_log2 = math.log2(math.e) / math.sqrt(d)
    out = torch.empty((B, H, Sq, d))
    for q0 in range(0, Sq, ROWS):
        rows = torch.arange(q0, min(q0 + ROWS, Sq))
        qt = qh[:, :, rows]
        kt_end = -(-Skv // KEYS)
        if causal:
            kt_end = min(kt_end, (q0 + ROWS - 1) // KEYS + 1)
        kt_begin = max(0, q0 - window + 1) // KEYS if window else 0
        m = torch.full((B, H, len(rows)), NEG_INF)
        l = torch.zeros((B, H, len(rows)))
        acc = torch.zeros((B, H, len(rows), d))
        for kt in range(kt_begin, kt_end):
            kp = torch.arange(kt * KEYS, (kt + 1) * KEYS)
            s = qt @ kh[:, :, kp].transpose(-1, -2) * scale_log2
            keep = (kp < Skv)[None, :].expand(len(rows), -1)
            if causal:
                keep = keep & (kp[None, :] <= rows[:, None])
            if window:
                keep = keep & (kp[None, :] > rows[:, None] - window)
            s = torch.where(keep, s, torch.tensor(NEG_INF))
            mx = torch.maximum(m, s.amax(-1))
            alpha = torch.exp2(m - mx)
            p32 = torch.exp2(s - mx[..., None])
            p = p32.to(p_dtype).float()
            if p_terms == 2:
                p = p + (p32 - p).to(p_dtype).float()
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + p @ vh[:, :, kp]
            m = mx
        out[:, :, rows] = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(torch.bfloat16)


def _flash_case(d, case, heads=4):
    """bf16 inputs of one mask case at head dim d (B 1, H ``heads``, KVH
    2)."""
    sq, skv, causal, window = {
        "causal": (100, 100, True, None),
        "window": (150, 150, True, 40),
        "full": (96, 200, False, None)}[case]
    rng = np.random.default_rng(d * 7 + sq if heads == 4
                                else (d * 7 + sq, heads))
    q = _bf16(rng, (1, sq, heads, d))
    k = _bf16(rng, (1, skv, 2, d))
    v = _bf16(rng, (1, skv, 2, d))
    return q, k, v, causal, window


def _flash_wants(q, k, v, causal, window):
    pallas = jops.flash_attention(q, k, v, causal=causal, window=window,
                                  bq=32, bk=32, interpret=True)
    B, Sq, H, d = q.shape
    rep = H // k.shape[2]
    flat = [np.repeat(a, rep, axis=2).transpose(0, 2, 1, 3).reshape(
        B * H, a.shape[1], d) if a is not q else
        a.transpose(0, 2, 1, 3).reshape(B * H, Sq, d) for a in (q, k, v)]
    oracle = jref.attention_ref(*flat, causal=causal, window=window)
    oracle = np.asarray(oracle).reshape(B, H, Sq, d).transpose(0, 2, 1, 3)
    return _f32(pallas), _f32(oracle)


def _beyond(got, want):
    """Elements of ``got`` outside the chip's bf16 tolerance of ``want``."""
    err = np.abs(_f32(got) - want)
    return int((err > BF16_ATOL + BF16_RTOL * np.abs(want)).sum())


@pytest.mark.parametrize("d", [32, 64, 96, 128])
@pytest.mark.parametrize("case", ["causal", "window", "full"])
def test_tensor_core_flash_arithmetic_within_the_chip_tolerance(d, case):
    q, k, v, causal, window = _flash_case(d, case)
    got = emulate_flash_tc(q, k, v, causal=causal, window=window)
    assert got.shape == q.shape and bool(torch.isfinite(got.float()).all())
    for want in _flash_wants(q, k, v, causal, window):
        assert _beyond(got.float().numpy(), want) == 0
    # out is a convex combination of v rows: |out| <= max |v|
    assert got.float().abs().max() <= np.abs(_f32(v)).max()


@pytest.mark.parametrize("case", ["causal", "window", "full"])
def test_tensor_core_flash_arithmetic_at_a_group_of_6(case):
    """grok-1-314b's GQA group: 12 query heads over 2 kv heads at d 128,
    head h reading kv head h // 6, within the chip's tolerance of the
    Pallas kernel and the oracle."""
    q, k, v, causal, window = _flash_case(128, case, heads=12)
    got = emulate_flash_tc(q, k, v, causal=causal, window=window)
    assert got.shape == q.shape and bool(torch.isfinite(got.float()).all())
    for want in _flash_wants(q, k, v, causal, window):
        assert _beyond(got.float().numpy(), want) == 0
    # a wrong group mapping (head h on kv head h // 4) fails it
    bad = emulate_flash_tc(q, np.repeat(k, 3, axis=2)[:, :, ::2],
                           np.repeat(v, 3, axis=2)[:, :, ::2], causal=causal,
                           window=window)
    assert _beyond(bad.float().numpy(), _flash_wants(
        q, k, v, causal, window)[0]) > 0


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("case", ["causal", "window", "full"])
def test_flash_tolerance_rejects_p_rounded_to_e4m3(d, case):
    """The planted fault: P rounded once to e4m3 (3 mantissa bits) must
    fail the tolerance the kernel's two bf16 terms pass."""
    q, k, v, causal, window = _flash_case(d, case)
    pallas, _ = _flash_wants(q, k, v, causal, window)
    bad = emulate_flash_tc(q, k, v, causal=causal, window=window,
                           p_dtype=torch.float8_e4m3fn, p_terms=1)
    assert _beyond(bad.float().numpy(), pallas) > 0


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("case", ["causal", "window"])
def test_one_bf16_term_of_p_breaks_the_tolerance(d, case):
    """P rounded once to bf16 (2^-9 per weight) fails the same tolerance
    at the short rows of causal and windowed prompts, as it did on the
    card: the reason the kernel adds the second term."""
    q, k, v, causal, window = _flash_case(d, case)
    pallas, _ = _flash_wants(q, k, v, causal, window)
    one = emulate_flash_tc(q, k, v, causal=causal, window=window, p_terms=1)
    assert _beyond(one.float().numpy(), pallas) > 0


@pytest.mark.parametrize("dtype,d,expect", [
    (torch.bfloat16, 128, "tensor cores"), (torch.bfloat16, 32,
                                            "tensor cores"),
    (torch.bfloat16, 256, "tensor cores"), (torch.bfloat16, 16,
                                            "cuda cores"),
    (torch.bfloat16, 96, "tensor cores"), (torch.float32, 128, "cuda cores"),
    (torch.bfloat16, 80, "cuda cores"), (torch.float32, 96, "cuda cores")])
def test_flash_route_is_chosen_by_dtype_and_head_dim(dtype, d, expect):
    assert tfa.route(dtype, d) == expect


def test_tma_checks_name_what_the_tensor_core_route_cannot_read():
    q = torch.zeros((2, 64, 4, 64), dtype=torch.bfloat16)
    assert tfa.tma_problem(q, q, q) is None
    # a size-1 batch is never stepped: its stride does not matter
    q1 = torch.zeros((1, 64, 4, 64), dtype=torch.bfloat16)
    assert tfa.tma_strides(q1)[0] == 64 and tfa.tma_problem(q1, q1, q1) is None
    odd = torch.zeros((2, 64, 4, 68), dtype=torch.bfloat16)[..., :64]
    assert "strides" in tfa.tma_problem(odd, q, q)
    shifted = torch.zeros(2 * 64 * 4 * 64 + 1,
                          dtype=torch.bfloat16)[1:].view(2, 64, 4, 64)
    assert "aligned" in tfa.tma_problem(q, shifted, q)


# -- K1/K2: the split-K paged decode kernel -------------------------------

PAGE, N_TABLE, KVH, GROUP, D = 16, 16, 2, 2, 32
SPLITS, CHUNK = tda.split_plan(6, KVH, N_TABLE * PAGE, sms=132)
LENGTHS = (1, CHUNK - 1, CHUNK, CHUNK + 1, N_TABLE * PAGE, 0)


def _split_case(seed, pool):
    """Six seats: 1, chunk - 1, chunk, chunk + 1, the full table width,
    and a seat with no valid token; pages scattered over the pool."""
    rng = np.random.default_rng(seed)
    lengths = np.array(LENGTHS, np.int32)
    need = [-(-int(n) // PAGE) for n in lengths]
    P = 1 + sum(need) + 2
    perm = rng.permutation(np.arange(1, P)).astype(np.int32)
    table = np.zeros((len(lengths), N_TABLE), np.int32)
    at = 0
    for a, n in enumerate(need):
        table[a, :n] = perm[at:at + n]
        at += n
    q = rng.normal(size=(len(lengths), 1, KVH * GROUP, D)).astype(np.float32)
    k = rng.normal(size=(P, PAGE, KVH, D)).astype(np.float32)
    v = rng.normal(size=(P, PAGE, KVH, D)).astype(np.float32)
    ks = vs = None
    if pool == "bf16":
        k, v = (a.astype(ml_dtypes.bfloat16) for a in (k, v))
    else:
        (k, ks), (v, vs) = ((np.asarray(x), np.asarray(s)) for x, s in (
            jmp.quantize_kv_page(k, pool), jmp.quantize_kv_page(v, pool)))
    return q, k, v, ks, vs, table, lengths


def _dequantized(x, scale):
    if x.dtype == np.uint8:
        x = jnp.asarray(x).view(jnp.float8_e4m3fn)
    x = torch.from_numpy(_f32(x))
    return x if scale is None else x * torch.from_numpy(
        np.array(scale))[..., None]


def emulate_split_k(q, k, v, ks, vs, table, lengths, *, splits=SPLITS,
                    chunk=CHUNK, drop=None):
    """K1/K2's split-K in torch: per (seat, split) the partial (m, l, acc)
    of tokens [s·chunk, min((s+1)·chunk, length)) for every query head,
    the empty state past the length, then the merge in split order.
    ``drop``: a split left out of the merge (the planted fault)."""
    kf, vf = _dequantized(k, ks), _dequantized(v, vs)
    q = torch.from_numpy(q[:, 0])                              # (A, H, d)
    A, H, d = q.shape
    G = H // kf.shape[2]
    out = torch.empty((A, H, d))
    for a in range(A):
        n = int(lengths[a])
        pages = torch.from_numpy(table[a]).long()
        kt = kf[pages].reshape(-1, kf.shape[2], d)             # (T, KVH, d)
        vt = vf[pages].reshape(-1, kf.shape[2], d)
        kt = kt.repeat_interleave(G, dim=1)                    # (T, H, d)
        vt = vt.repeat_interleave(G, dim=1)
        parts = []
        for s in range(splits):
            lo, hi = s * chunk, min((s + 1) * chunk, n)
            if lo >= hi:
                parts.append((torch.full((H,), NEG_INF), torch.zeros(H),
                              torch.zeros((H, d))))
                continue
            sc = torch.einsum("hd,thd->ht", q[a], kt[lo:hi]) / math.sqrt(d)
            m = sc.amax(-1)
            p = torch.exp(sc - m[:, None])
            parts.append((m, p.sum(-1), torch.einsum("ht,thd->hd", p,
                                                     vt[lo:hi])))
        parts = [pt for s, pt in enumerate(parts) if s != drop]
        mx = torch.stack([m for m, _, _ in parts]).amax(0)
        lsum, o = torch.zeros(H), torch.zeros((H, d))
        for m, l, acc in parts:                               # split order
            c = torch.exp(m - mx)
            lsum = lsum + l * c
            o = o + acc * c[:, None]
        out[a] = o / torch.clamp(lsum, min=1e-30)[:, None]
    return out[:, None].numpy()


def _paged_pallas(q, k, v, ks, vs, table, lengths):
    return np.asarray(jops.paged_decode_attention(
        q, k, v, table, lengths, k_scale=ks, v_scale=vs, interpret=True))


@pytest.mark.parametrize("pool", ["bf16", "fp8", "int8"])
def test_split_k_merge_matches_the_pallas_paged_kernel(pool):
    assert SPLITS > 2 and CHUNK < N_TABLE * PAGE      # the case splits
    case = _split_case(11, pool)
    want = _paged_pallas(*case)
    got = emulate_split_k(*case)
    # f32 values on both sides; only the order of the sums differs
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    # the seat with no valid token: every split empty, out = 0 (no NaN)
    assert np.all(got[LENGTHS.index(0)] == 0)


@pytest.mark.parametrize("pool", ["bf16", "fp8", "int8"])
@pytest.mark.parametrize("drop", [0, 1, SPLITS - 1])
def test_split_k_check_rejects_a_dropped_split(pool, drop):
    case = _split_case(12, pool)
    want = _paged_pallas(*case)
    bad = emulate_split_k(*case, drop=drop)
    # the seats whose tokens reach the dropped split change, the others
    # cannot
    reach = [a for a, n in enumerate(LENGTHS) if n > drop * CHUNK]
    assert reach
    for a in range(len(LENGTHS)):
        err = np.abs(bad[a] - want[a]).max()
        if a in reach:
            assert err > BF16_ATOL
        else:
            assert err <= 2e-5


@pytest.mark.parametrize("seats,kv_heads,width,sms", [
    (8, 8, 2048, 132), (8, 8, 544, 132), (1, 8, 16, 132), (64, 8, 4096, 132),
    (3, 1, 1000, 114), (6, 2, 256, 132)])
def test_split_plan_covers_the_table_from_shapes_alone(seats, kv_heads,
                                                       width, sms):
    splits, chunk = tda.split_plan(seats, kv_heads, width, sms)
    assert chunk % tda.SPLIT_ALIGN == 0 and chunk >= tda.MIN_CHUNK
    assert splits * chunk >= width and (splits - 1) * chunk < width
    # no more blocks than the aim, unless one chunk per seat exceeds it
    aim = tda.BLOCKS_PER_SM * sms
    assert splits == 1 or seats * kv_heads * (splits - 1) < aim


def test_split_plan_at_the_serving_shapes():
    """The smoke run's timed shape (8 seats, 8 kv heads, 2048 tokens) and
    the serving tick's (tables of 34 pages of 16) on 132 SMs."""
    assert tda.split_plan(8, 8, 2048, 132) == (8, 256)
    assert tda.split_plan(8, 8, 34 * 16, 132) == (9, 64)


# -- K4: split-K on the dense fixed-slot cache ---------------------------

MAX_LEN = 199                     # a fixed-slot engine's max_len
T_DENSE = MAX_LEN + 1             # the cache holds the scratch index too
DENSE_SEATS, DENSE_KVH = 6, 2
DENSE_SPLITS, DENSE_CHUNK = tda.split_plan(DENSE_SEATS, DENSE_KVH, T_DENSE,
                                           sms=132)
# 1, the edges of a chunk, a full slot, and an idle slot parked on the
# scratch index (length max_len + 1: it walks its whole cache)
DENSE_LENGTHS = (1, DENSE_CHUNK - 1, DENSE_CHUNK, DENSE_CHUNK + 1, MAX_LEN,
                 MAX_LEN + 1)


def _dense_case(seed, group, dtype):
    """Six slots of a (B, T, KVH, d) cache at ``DENSE_LENGTHS``, q of
    ``group`` heads per kv head; bf16 or f32 values."""
    rng = np.random.default_rng(seed)
    cast = ((lambda a: a.astype(ml_dtypes.bfloat16)) if dtype == "bf16"
            else (lambda a: a))
    q = cast(rng.normal(size=(DENSE_SEATS, 1, DENSE_KVH * group, D))
             .astype(np.float32))
    k, v = (cast(rng.normal(size=(DENSE_SEATS, T_DENSE, DENSE_KVH, D))
                 .astype(np.float32)) for _ in range(2))
    return q, k, v, np.array(DENSE_LENGTHS, np.int32)


def emulate_dense_split_k(q, k, v, lengths, *, splits=DENSE_SPLITS,
                          chunk=DENSE_CHUNK, drop=None):
    """K4's split-K in torch: per (slot, split) the partial (m, l, acc) of
    tokens [s·chunk, min((s+1)·chunk, length)) of the slot's own cache
    for every query head, the empty state past the length, merged in
    split order, rounded once to q's dtype.  ``drop``: a split left out
    of the merge (the planted fault)."""
    B, _, H, d = q.shape
    G = H // k.shape[2]
    qt = torch.from_numpy(_f32(q)[:, 0])                      # (B, H, d)
    kt = torch.from_numpy(_f32(k)).repeat_interleave(G, dim=2)  # (B, T, H, d)
    vt = torch.from_numpy(_f32(v)).repeat_interleave(G, dim=2)
    out = torch.empty((B, H, d))
    for b in range(B):
        n = int(lengths[b])
        parts = []
        for s in range(splits):
            lo, hi = s * chunk, min((s + 1) * chunk, n)
            if lo >= hi:
                parts.append((torch.full((H,), NEG_INF), torch.zeros(H),
                              torch.zeros((H, d))))
                continue
            sc = torch.einsum("hd,thd->ht", qt[b], kt[b, lo:hi]) / math.sqrt(d)
            m = sc.amax(-1)
            p = torch.exp(sc - m[:, None])
            parts.append((m, p.sum(-1), torch.einsum("ht,thd->hd", p,
                                                     vt[b, lo:hi])))
        parts = [pt for s, pt in enumerate(parts) if s != drop]
        mx = torch.stack([m for m, _, _ in parts]).amax(0)
        lsum, o = torch.zeros(H), torch.zeros((H, d))
        for m, l, acc in parts:                               # split order
            c = torch.exp(m - mx)
            lsum = lsum + l * c
            o = o + acc * c[:, None]
        out[b] = o / torch.clamp(lsum, min=1e-30)[:, None]
    out = out[:, None]
    return out.to(torch.bfloat16).float().numpy() if q.dtype != np.float32 \
        else out.numpy()


def _dense_wants(q, k, v, lengths):
    """``decode_attention_pallas`` (interpret mode) through the JAX ops
    wrapper, and the jnp oracle on the wrapper's GQA repeat."""
    pallas = jops.decode_attention(q, k, v, lengths, bk=64, interpret=True)
    B, _, H, d = q.shape
    rep = H // k.shape[2]
    kf, vf = (np.repeat(a, rep, axis=2).transpose(0, 2, 1, 3).reshape(
        B * H, -1, d) for a in (k, v))
    oracle = jref.decode_attention_ref(q[:, 0].reshape(B * H, d), kf, vf,
                                       np.repeat(lengths, H))
    return _f32(pallas), _f32(oracle).reshape(B, 1, H, d)


def _dense_within(got, want, dtype):
    """Elements outside the chip's tolerance of the dtype (bf16: 1e-3 +
    2^-7·|want|; f32: 2e-5 + 1e-4·|want|)."""
    atol, rtol = (BF16_ATOL, BF16_RTOL) if dtype == "bf16" else (2e-5, 1e-4)
    err = np.abs(_f32(got) - want)
    return int((err > atol + rtol * np.abs(want)).sum())


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("group", [1, 2, 4, 6, 8])
def test_dense_split_k_matches_the_pallas_decode_kernel(group, dtype):
    assert DENSE_SPLITS > 2 and DENSE_CHUNK < MAX_LEN     # the case splits
    case = _dense_case(20 + group, group, dtype)
    got = emulate_dense_split_k(*case)
    assert got.shape == case[0].shape and np.isfinite(got).all()
    for want in _dense_wants(*case):
        assert _dense_within(got, want, dtype) == 0
    # the idle slot's row is the softmax over its whole cache: a convex
    # combination of v rows, as every other row
    assert np.abs(got).max() <= np.abs(_f32(case[2])).max()


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("drop", [0, 1, DENSE_SPLITS - 1])
def test_dense_split_k_check_rejects_a_dropped_split(drop, dtype):
    case = _dense_case(31, 2, dtype)
    pallas, _ = _dense_wants(*case)
    bad = emulate_dense_split_k(*case, drop=drop)
    # the slots whose tokens reach the dropped split fail the tolerance,
    # the others still pass it
    reach = [b for b, n in enumerate(DENSE_LENGTHS) if n > drop * DENSE_CHUNK]
    assert reach
    for b in range(len(DENSE_LENGTHS)):
        beyond = _dense_within(bad[b], pallas[b], dtype)
        assert (beyond > 0) == (b in reach)


@pytest.mark.parametrize("seats,kv_heads,width,want", [
    (8, 8, 545, (9, 64)),          # the fixed-slot smoke shape, qwen3-1.7b
    (8, 8, 33, (1, 64)),           # a short cache: one split
    (4, 8, 4097, (17, 256)),       # llama3-8b's kv heads, a long cache
    (DENSE_SEATS, DENSE_KVH, T_DENSE, (4, 64))])
def test_split_plan_at_the_dense_widths(seats, kv_heads, width, want):
    """The dense kernel plans from the cache width T = max_len + 1, which
    the host knows, so the idle slot's walk to T is spread over splits."""
    assert tda.split_plan(seats, kv_heads, width, 132) == want


@pytest.mark.parametrize("d,elems", [(16, 1), (32, 1), (48, 2), (64, 2),
                                     (96, 4), (128, 4), (256, 8)])
def test_lane_elems_covers_the_head_dim_in_one_warp(d, elems):
    assert tda.lane_elems(d) == elems and 32 * elems >= d


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.uint8, torch.int8])
def test_one_load_per_lane_refuses_what_the_decode_kernels_cannot_read(
        dtype):
    """The decode kernels read a lane's E elements of a K/V row as one
    word: a pool, a cache or one layer of a stacked pool can be read so;
    a head dim that E does not divide, a stride that E does not divide
    and a row that starts off the word cannot."""
    pools = torch.zeros((3, 5, 16, 2, 128), dtype=dtype)
    assert tda.one_load_per_lane(pools[1])
    cache = torch.zeros((4, 37, 2, 128), dtype=dtype)
    assert tda.one_load_per_lane(cache)
    assert not tda.one_load_per_lane(torch.zeros((4, 37, 2, 66),
                                                 dtype=dtype))
    assert not tda.one_load_per_lane(
        torch.zeros((4, 37, 2, 130), dtype=dtype)[..., :128])
    flat = torch.zeros(4 * 37 * 2 * 128 + 1, dtype=dtype)
    assert not tda.one_load_per_lane(flat[1:].view(4, 37, 2, 128))
