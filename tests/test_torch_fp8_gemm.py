"""The fp8 GEMM (K6) on the CPU: the error bound of its tensor-core
accumulation (``fp8_matmul.error_bound``) and the operand layout its
wrapper hands the kernel (``fp8_matmul.kernel_operands``).

The kernel itself runs only on the card (``chip_smoke.py`` holds it to
the same bound there); here the bound is held against a numpy emulation
of sums cut to 14 bits within each promotion chunk, with the JAX Pallas
kernel (interpret mode) and the port's plain version as the f32 sums, and
must reject the emulation with a fault planted: a scale of the wrong
block, a dropped k-step, no promotion, a narrower accumulator.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fp8_matmul import fp8_matmul_pallas
from repro_torch.core import mixed_precision as tmp
from repro_torch.kernels import fp8_matmul as fm
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref


def _t(a):
    return torch.from_numpy(np.array(a))


def _operands(m: int, k: int, n: int, seed: int):
    """e4m3 operands and per-tensor scales from seeded normals, as the
    HPL-MxP path quantizes them."""
    rng = np.random.default_rng(seed)
    a_q, sa = tmp.quantize_fp8(_t(rng.normal(size=(m, k)).astype(np.float32)))
    b_q, sb = tmp.quantize_fp8(_t(rng.normal(size=(k, n)).astype(np.float32)))
    return a_q, b_q, sa, sb


#: The model of the card's fp8 tensor-core sums that the emulation
#: follows: the running sum is cut toward zero to 14 significant bits
#: (an FP22 accumulator) after every 4 products.  On operands of one
#: sign it errs by ~6e-4·S_c per chunk, as the H100 does (``chip_smoke.py``
#: logs the kernel's ratio on such operands).
HW_BITS, HW_GROUP = 14, 4


def _truncate(x: np.ndarray, bits: int) -> np.ndarray:
    """``x`` cut to ``bits`` significant bits, toward zero."""
    m, e = np.frexp(x)
    return np.ldexp(np.trunc(np.ldexp(m, bits)), e - bits)


def _chunked_tensor_core(a_q, b_q, sa_rows, sb_cols, *, bits: int = HW_BITS,
                         chunk: int = fm.PROMOTE_K, group: int = HW_GROUP,
                         skip: int | None = None) -> np.ndarray:
    """The kernel's accumulation, emulated: within each ``chunk`` of K the
    products are added ``group`` at a time (exactly) and the running sum
    is cut to ``bits`` significant bits after each group; each chunk's
    sum is then added into an f32 accumulator, and the result scaled as
    the reference does, ``acc · (sa · sb)`` with ``sa_rows`` (M,) and
    ``sb_cols`` (N,).  ``chunk`` = K is a kernel that never promotes;
    ``skip`` drops the 32 products from that k to k + 31."""
    a = a_q.float().double().numpy()
    b = b_q.float().double().numpy()
    k_all = a.shape[1]
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for c0 in range(0, k_all, chunk):
        s = np.zeros_like(acc, dtype=np.float64)
        for g0 in range(c0, min(c0 + chunk, k_all), group):
            if skip is not None and skip <= g0 < skip + 32:
                continue
            g1 = min(g0 + group, c0 + chunk, k_all)
            s = _truncate(s + a[:, g0:g1] @ b[g0:g1], bits)
        acc = (acc + s.astype(np.float32)).astype(np.float32)
    scale = (sa_rows.numpy()[:, None] * sb_cols.numpy()[None, :])
    return acc * scale.astype(np.float32)


def _bound(a_q, b_q, sa, sb, plain):
    m, n = plain.shape
    mag = fm.magnitude(a_q, b_q, sa.expand(m), sb.expand(n))
    return fm.error_bound(mag, plain, a_q.shape[1])


def _emulated(a_q, b_q, sa, sb, **kw):
    m, n = a_q.shape[0], b_q.shape[1]
    return _t(_chunked_tensor_core(a_q, b_q, sa.expand(m), sb.expand(n),
                                   **kw))


def test_tensor_core_coefficient():
    """The limit is 2^-9; the worst case the docstring derives,
    c·2^-p with c = 2·(L + 2·L/32) = 272 for L = 128 and p = 13, is 17×
    larger and stays documentation."""
    assert fm.PROMOTE_K == 128 and fm.TC_LIMIT == 2.0 ** -9
    assert fm.TC_WORST == (fm.PROMOTE_K // 32) * 34 * 2 * 2.0 ** -13
    assert 16 * fm.TC_LIMIT < fm.TC_WORST < 32 * fm.TC_LIMIT


@pytest.mark.parametrize("k", [1024, 4096])
def test_bound_admits_chunked_tensor_core_sums(k):
    a_q, b_q, sa, sb = _operands(24, k, 16, seed=k)
    plain = fm.fp8_matmul_plain(a_q, b_q, sa.reshape(1), sb.reshape(1),
                                bm=24, bn=16, bk=k)
    got = _emulated(a_q, b_q, sa, sb)
    err = (got - plain).abs()
    assert bool((err > 0).any())               # the emulation does round
    assert bool((err <= _bound(a_q, b_q, sa, sb, plain)).all())


def _one_sign_operands(m: int, k: int, n: int, seed: int):
    rng = np.random.default_rng(seed)
    a_q, sa = tmp.quantize_fp8(_t(rng.uniform(size=(m, k)).astype(np.float32)))
    b_q, sb = tmp.quantize_fp8(_t(rng.uniform(size=(k, n)).astype(np.float32)))
    return a_q, b_q, sa, sb


@pytest.mark.parametrize("k", [64, 1024, 4096])
def test_bound_admits_one_sign_chunked_sums(k):
    """Every product positive: each cut loses toward zero and none cancels
    another, the emulation's largest error.  It lies between 2^-12 and
    2^-10 of (|a|·|b|)·s, as the card's does, inside the 2^-9 limit."""
    a_q, b_q, sa, sb = _one_sign_operands(32, k, 24, seed=k)
    m, n = 32, 24
    plain = fm.fp8_matmul_plain(a_q, b_q, sa.reshape(1), sb.reshape(1),
                                bm=m, bn=n, bk=k)
    mag = fm.magnitude(a_q, b_q, sa.expand(m), sb.expand(n))
    err = (_emulated(a_q, b_q, sa, sb) - plain).abs()
    assert 2.0 ** -12 < (err / mag).max().item() < 2.0 ** -10
    assert bool((err <= fm.error_bound(mag, plain, k)).all())


def test_bound_admits_emulation_against_pallas_sums():
    """The same emulation held against the JAX Pallas kernel's f32 sums
    (interpret mode) on the same e4m3 operands."""
    m, k, n = 128, 1024, 128
    a_q, b_q, sa, sb = _operands(m, k, n, seed=7)
    want = np.asarray(fp8_matmul_pallas(
        jnp.asarray(a_q.float().numpy()).astype(jnp.float8_e4m3fn),
        jnp.asarray(b_q.float().numpy()).astype(jnp.float8_e4m3fn),
        jnp.asarray(sa.reshape(1).numpy()), jnp.asarray(sb.reshape(1).numpy()),
        bm=m, bn=n, bk=128, interpret=True))
    plain = fm.fp8_matmul_plain(a_q, b_q, sa.reshape(1), sb.reshape(1),
                                bm=m, bn=n, bk=k)
    np.testing.assert_allclose(plain.numpy(), want, rtol=1e-5, atol=1e-5)
    got = _emulated(a_q, b_q, sa, sb)
    want = _t(want)
    assert bool(((got - want).abs()
                 <= _bound(a_q, b_q, sa, sb, want)).all())


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_bound_rejects_twice_the_bound(sign):
    a_q, b_q, sa, sb = _operands(32, 1024, 24, seed=3)
    plain = fm.fp8_matmul_plain(a_q, b_q, sa.reshape(1), sb.reshape(1),
                                bm=32, bn=24, bk=1024)
    lim = _bound(a_q, b_q, sa, sb, plain)
    assert bool(((plain - plain).abs() <= lim).all())
    off = plain.clone()
    off[5, 7] += sign * 2 * lim[5, 7]
    err = (off - plain).abs()
    assert bool((err > lim).any()) and int((err > lim).sum()) == 1


def _faulty(fault: str, k: int):
    """A planted fault of the emulated kernel, the emulation without it
    and what both are held to: ``(got, clean, plain, limit)``.  The scale and k-step faults run on signed
    per-block operands (4 row and 3 column blocks of 8); the
    accumulation faults on one-sign operands, where promotion and the
    accumulator's width show (on signed operands their cuts cancel)."""
    m, n, bm, bn = 32, 24, 8, 8
    if fault in ("a scale of the wrong block", "b scale of the wrong block",
                 "dropped k-step"):
        rng = np.random.default_rng(k)
        a_q, b_q, sa, sb = ops.quantize_blocks(
            _t(rng.normal(size=(m, k)).astype(np.float32)),
            _t(rng.normal(size=(k, n)).astype(np.float32)), bm=bm, bn=bn)
    else:
        a_q, b_q, sa1, sb1 = _one_sign_operands(m, k, n, seed=k)
        sa, sb = sa1.expand(m // bm).contiguous(), sb1.expand(n // bn).contiguous()
    rows, cols = sa.repeat_interleave(bm), sb.repeat_interleave(bn)
    plain = fm.fp8_matmul_plain(a_q, b_q, sa, sb, bm=bm, bn=bn, bk=k)
    kw = {"a scale of the wrong block":
          dict(sa_rows=sa.roll(1).repeat_interleave(bm)),
          "b scale of the wrong block":
          dict(sb_cols=sb.roll(1).repeat_interleave(bn)),
          "dropped k-step": dict(skip=32),
          "no promotion": dict(chunk=k),
          "fewer accumulator bits (fp16's 11)": dict(bits=11)}[fault]
    clean = _t(_chunked_tensor_core(a_q, b_q, rows, cols))
    args = dict(sa_rows=rows, sb_cols=cols)
    args.update(kw)
    got = _t(_chunked_tensor_core(a_q, b_q, **args))
    mag = fm.magnitude(a_q, b_q, rows, cols)
    return got, clean, plain, fm.error_bound(mag, plain, k)


@pytest.mark.parametrize("k", [1024, 4096])
@pytest.mark.parametrize("fault", [
    "a scale of the wrong block", "b scale of the wrong block",
    "dropped k-step", "no promotion", "fewer accumulator bits (fp16's 11)"])
def test_bound_rejects_planted_fault(fault, k):
    """Each fault the check on the card plants, and two more of the
    accumulation, fails the limit, while the same operands without the
    fault pass it."""
    got, clean, plain, lim = _faulty(fault, k)
    assert bool(((clean - plain).abs() <= lim).all())
    assert bool(((got - plain).abs() > lim).any()), fault


def _exact_operands(m: int, k: int, n: int, seed: int, col_major: bool):
    """e4m3 operands holding small integers, whose f32 sums are exact in
    any order and at any K: a layout or padding fault changes the result,
    a summation order does not."""
    rng = np.random.default_rng(seed)
    a_q = _t(rng.integers(-16, 17, (m, k)).astype(np.float32)).to(fm.E4M3)
    b = _t(rng.integers(-16, 17, (k, n)).astype(np.float32))
    if col_major:
        b = b.t().contiguous().t()
    return a_q, b.to(fm.E4M3)


@pytest.mark.parametrize("col_major", [False, True])
@pytest.mark.parametrize("m,k,n,bm,bn", [
    (192, 64, 192, 192, 192), (96, 70, 40, 96, 40), (64, 200, 48, 32, 16),
    (33, 1, 17, 33, 17), (128, 1024, 64, 64, 32)])
def test_kernel_operands_are_k_major_and_exact(m, k, n, bm, bn, col_major):
    a_q, b_q = _exact_operands(m, k, n, seed=m + k + n, col_major=col_major)
    rng = np.random.default_rng(k)
    sa = _t(rng.uniform(0.5, 2.0, m // bm).astype(np.float32))
    sb = _t(rng.uniform(0.5, 2.0, n // bn).astype(np.float32))
    a_k, bt_k = fm.kernel_operands(a_q, b_q)
    kp = a_k.shape[1]
    assert kp % fm.K_ALIGN == 0 and k <= kp < k + fm.K_ALIGN
    assert a_k.shape == (m, kp) and bt_k.shape == (n, kp)
    for x in (a_k, bt_k):
        assert x.dtype == fm.E4M3 and x.is_contiguous()
        assert x.data_ptr() % 16 == 0
        assert not x.view(torch.uint8)[:, k:].any()      # zero padding
    # a column-major b with K already aligned is read as it lies
    assert (bt_k.data_ptr() == b_q.data_ptr()) == (col_major and kp == k)
    want = fm.fp8_matmul_plain(a_q, b_q, sa, sb, bm=bm, bn=bn, bk=k)
    got = tref.fp8_matmul_ref(a_k, bt_k.t(), sa, sb, bm=bm, bn=bn)
    assert torch.equal(got, want)


def test_kernel_operands_realign_an_odd_view():
    """A contiguous view at an offset that is not 16-byte aligned is
    copied: TMA needs aligned rows."""
    base = torch.zeros(16 * 33, dtype=torch.uint8).view(fm.E4M3)
    a_q = base[1:1 + 16 * 32].view(16, 32)
    assert a_q.is_contiguous() and a_q.data_ptr() % 16
    a_k, _ = fm.kernel_operands(a_q, torch.zeros((32, 8), dtype=fm.E4M3))
    assert a_k.data_ptr() % 16 == 0 and torch.equal(
        a_k.view(torch.uint8), a_q.view(torch.uint8))


def test_per_tensor_path_keeps_a_column_major_row_panel():
    """The HPL row panel comes out of a triangular solve column-major;
    its e4m3 copy keeps that layout, so the kernel's K-major B is its
    transpose without a copy."""
    rng = np.random.default_rng(0)
    diag = _t(np.tril(rng.normal(size=(64, 64))).astype(np.float32)
              + 8 * np.eye(64, dtype=np.float32))
    u = torch.linalg.solve_triangular(
        diag, _t(rng.normal(size=(64, 96)).astype(np.float32)),
        upper=False, unitriangular=True)
    assert u.t().is_contiguous()
    qb, _ = tmp.quantize_fp8(u)
    assert qb.t().is_contiguous()
    _, bt_k = fm.kernel_operands(torch.zeros((8, 64), dtype=fm.E4M3), qb)
    assert bt_k.data_ptr() == qb.data_ptr()
