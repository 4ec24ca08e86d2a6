"""The port's HPC path (HPL, HPL-MxP, HPCG, the fp8 GEMM) against the JAX
package on the CPU.

The fp8 GEMM kernel (K6) runs only on the card; here its plain version,
which the wrappers take for CPU tensors, is held against the Pallas
kernel in interpret mode and the jnp oracles.  Inputs are made with numpy
(or by the JAX package) and handed to both sides: the port's own
``torch.Generator`` draws cannot reproduce ``jax.random``'s.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hpcg as jhpcg
from repro.core import hpl as jhpl
from repro.core import io500 as jio500
from repro.core import mixed_precision as jmp
from repro.core import topology as jtopo
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import hpcg as thpcg
from repro_torch.core import hpl as thpl
from repro_torch.core import io500 as tio500
from repro_torch.core import mixed_precision as tmp
from repro_torch.core import topology as ttopo
from repro_torch.core.hplmxp import run_hplmxp
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

# the fp8 GEMMs: identical quantized operands on both sides, f32 sums in
# another order (tests/test_kernels.py's tolerance)
FP8_TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _bits(q):
    """e4m3 values (either package) as their uint8 bit patterns."""
    if isinstance(q, torch.Tensor):
        return q.view(torch.uint8).numpy()
    return np.asarray(jax.lax.bitcast_convert_type(q, jnp.uint8))


@pytest.fixture(scope="module")
def jax_matrix():
    """The JAX package's HPL test matrix at n = 256, as numpy."""
    a, b = jhpl.make_test_matrix(256)
    return np.asarray(a), np.asarray(b)


# --- quantize_fp8 -----------------------------------------------------------

@pytest.mark.parametrize("axis", [None, 0, 1, (0, 1)])
@pytest.mark.parametrize("scale", [1e-3, 1.0, 3e4])
def test_quantize_fp8_bit_identical(axis, scale):
    rng = np.random.default_rng(int(scale * 7) + 3)
    x = (rng.normal(size=(48, 80)) * scale).astype(np.float32)
    qj, sj = jmp.quantize_fp8(jnp.asarray(x), axis=axis)
    qt, st = tmp.quantize_fp8(_t(x), axis=axis)
    assert qt.dtype == torch.float8_e4m3fn and st.dtype == torch.float32
    assert tuple(st.shape) == sj.shape
    assert (st.dim() == 0) == (axis is None)
    np.testing.assert_array_equal(_bits(qt), _bits(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


def test_quantize_fp8_never_reaches_the_overflow_range():
    """x / scale peaks just above 448, far below 464, where torch's cast
    saturates and JAX's gives NaN: no value the path makes can overflow,
    so the two casts agree on all of them."""
    rng = np.random.default_rng(0)
    peak = 0.0
    for trial in range(50):
        x = rng.normal(size=(64, 64)).astype(np.float32)
        x *= np.float32(10.0 ** rng.uniform(-30, 30))
        xt = _t(x)
        _, s = tmp.quantize_fp8(xt)
        peak = max(peak, float((xt / s).abs().max()))
        _, _, sa, sb = tops.quantize_blocks(xt, xt, bm=16, bn=32, bk=16)
        peak = max(peak, float((xt / sa.repeat_interleave(16)[:, None])
                               .abs().max()))
    assert 448.0 <= peak <= 448.0001
    # the one place the casts differ, for the record: past 464
    big = np.array([450.0, 463.0, 480.0], np.float32)
    assert list(_bits(_t(big).to(torch.float8_e4m3fn))[:2]) == \
        list(_bits(jnp.asarray(big).astype(jnp.float8_e4m3fn))[:2])


# --- the fp8 GEMMs ----------------------------------------------------------

@pytest.mark.parametrize("m,k,n", [(100, 70, 50), (192, 64, 192),
                                   (128, 256, 128), (3, 5, 7)])
def test_per_tensor_fp8_matmul_matches_jax(m, k, n):
    rng = np.random.default_rng(m + k + n)
    a = rng.normal(size=(m, k)).astype(np.float32)
    b = rng.normal(size=(k, n)).astype(np.float32)
    want = np.asarray(jmp.fp8_matmul(jnp.asarray(a), jnp.asarray(b)))
    tops.reset_launches()
    got = tmp.fp8_matmul(_t(a), _t(b))
    assert got.dtype == torch.float32 and got.shape == (m, n)
    assert tops.launches["fp8_matmul[e4m3]"] == 0      # plain on the CPU
    np.testing.assert_allclose(got.numpy(), want, **FP8_TOL)
    x3 = rng.normal(size=(2, 4, k)).astype(np.float32)
    np.testing.assert_allclose(
        tmp.fp8_einsum_2d(_t(x3), _t(b)).numpy(),
        np.asarray(jmp.fp8_einsum_2d(jnp.asarray(x3), jnp.asarray(b))),
        **FP8_TOL)


def _jax_blocks(a, b, bm, bn, bk):
    """The JAX wrapper's padding and per-block quantization
    (tests/test_kernels.py), for comparing operands."""
    pad = lambda x, mult, ax: jnp.pad(
        x, [(0, (-x.shape[0]) % mult if ax == 0 else 0),
            (0, (-x.shape[1]) % mult if ax == 1 else 0)])
    ap = pad(pad(jnp.asarray(a), bm, 0), bk, 1)
    bp = pad(pad(jnp.asarray(b), bk, 0), bn, 1)
    mm, kk = ap.shape
    nn = bp.shape[1]
    sa = jnp.maximum(jnp.max(jnp.abs(ap.reshape(mm // bm, bm, kk)),
                             axis=(1, 2)), 1e-12) / jmp.F8_MAX
    sb = jnp.maximum(jnp.max(jnp.abs(bp.reshape(kk, nn // bn, bn)),
                             axis=(0, 2)), 1e-12) / jmp.F8_MAX
    aq = (ap / jnp.repeat(sa, bm)[:, None]).astype(jnp.float8_e4m3fn)
    bq = (bp / jnp.repeat(sb, bn)[None, :]).astype(jnp.float8_e4m3fn)
    return aq, bq, sa, sb


@pytest.mark.parametrize("m,k,n,blocks", [
    (128, 128, 128, (128, 128, 128)), (256, 384, 128, (128, 128, 128)),
    (100, 70, 50, (128, 128, 128)), (33, 128, 257, (128, 128, 128)),
    (100, 70, 50, (64, 32, 64))])
def test_blocked_fp8_matmul_matches_pallas(m, k, n, blocks):
    bm, bn, bk = blocks
    key = jax.random.PRNGKey(m * 1000 + k + n)
    a = np.asarray(jax.random.normal(key, (m, k), jnp.float32))
    b = np.asarray(jax.random.normal(jax.random.fold_in(key, 1), (k, n),
                                     jnp.float32))
    aq, bq, sa, sb = tops.quantize_blocks(_t(a), _t(b), bm=bm, bn=bn, bk=bk)
    jaq, jbq, jsa, jsb = _jax_blocks(a, b, bm, bn, bk)
    np.testing.assert_array_equal(_bits(aq), _bits(jaq))
    np.testing.assert_array_equal(_bits(bq), _bits(jbq))
    np.testing.assert_array_equal(sa.numpy(), np.asarray(jsa))
    np.testing.assert_array_equal(sb.numpy(), np.asarray(jsb))
    want = np.asarray(jops.fp8_matmul(jnp.asarray(a), jnp.asarray(b), bm=bm,
                                      bn=bn, bk=bk, interpret=True))
    got = tops.fp8_matmul(_t(a), _t(b), bm=bm, bn=bn, bk=bk)
    assert got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), want, **FP8_TOL)
    # the plain K6 on the quantized operands is the jnp oracle
    np.testing.assert_allclose(
        tref.fp8_matmul_ref(aq, bq, sa, sb, bm=bm, bn=bn).numpy(),
        np.asarray(jref.fp8_matmul_ref(jaq, jbq, jsa, jsb, bm=bm, bn=bn)),
        **FP8_TOL)


def test_scaled_fp8_matmul_rejects_ragged_shapes():
    q = lambda shape: torch.zeros(shape, dtype=torch.float8_e4m3fn)
    s = lambda n: torch.ones((n,), dtype=torch.float32)
    for args, msg in (
            ((q((100, 128)), q((128, 128)), s(1), s(1)),
             r"M=100 is not a multiple of bm=128"),
            ((q((128, 128)), q((128, 257)), s(1), s(3)),
             r"N=257 is not a multiple of bn=128"),
            ((q((128, 70)), q((70, 128)), s(1), s(1)),
             r"K=70 is not a multiple of bk=128"),
            ((q((128, 128)), q((256, 128)), s(1), s(1)),
             "contraction mismatch")):
        with pytest.raises(ValueError, match=msg):
            tops.scaled_fp8_matmul(*args)
    with pytest.raises(ValueError, match=r"M=100"):
        tref.fp8_matmul_ref(q((100, 128)), q((128, 128)), s(1), s(1))
    with pytest.raises(ValueError, match="needs CUDA"):
        tops.scaled_fp8_matmul(q((128, 128)), q((128, 128)), s(1), s(1),
                               impl="kernel")
    a = torch.randn((100, 70))
    assert tops.fp8_matmul(a, torch.randn((70, 50))).shape == (100, 50)
    # column-major inputs (a triangular solve's result) quantize to
    # row-major operands
    aq, bq, _, _ = tops.quantize_blocks(torch.randn((128, 128)).t(),
                                        torch.randn((128, 128)).t())
    assert aq.is_contiguous() and bq.is_contiguous()


def test_iterative_refinement_matches_jax():
    """The reference's test system with a deliberately bad inner solver."""
    rng = np.random.default_rng(1)
    n = 64
    a = (rng.uniform(-0.5, 0.5, (n, n)) + 0.4 * n * np.eye(n)).astype(
        np.float32)
    b = rng.uniform(-1, 1, n).astype(np.float32)
    aj, bj = jnp.asarray(a), jnp.asarray(b)
    xj, hj = jmp.iterative_refinement(lambda v: aj @ v,
                                      lambda r: r / jnp.diag(aj), bj,
                                      iters=30)
    at, bt = _t(a), _t(b)
    xt, ht = tmp.iterative_refinement(lambda v: at @ v,
                                      lambda r: r / torch.diag(at), bt,
                                      iters=30)
    assert ht.shape == (30,)
    assert float(torch.linalg.vector_norm(at @ xt - bt)
                 / torch.linalg.vector_norm(bt)) < 1e-4
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-5,
                               atol=1e-7)
    # the history falls from 0.5 to f32 noise; compare where it is above it
    hj = np.asarray(hj)
    keep = hj > 1e-5
    np.testing.assert_allclose(ht.numpy()[keep], hj[keep], rtol=1e-3)


# --- HPL --------------------------------------------------------------------

def test_make_test_matrix_distribution():
    a, b = thpl.make_test_matrix(128, device="cpu")
    a2, b2 = thpl.make_test_matrix(128, device="cpu")
    assert torch.equal(a, a2) and torch.equal(b, b2)
    off = a - torch.diag(torch.diagonal(a))
    assert float(off.abs().max()) <= 0.5 and float(b.abs().max()) <= 0.5
    d = torch.diagonal(a) - 0.3 * 128
    assert float(d.abs().max()) <= 0.5
    assert abs(float(off.mean())) < 0.01
    g = torch.Generator().manual_seed(5)
    a3, _ = thpl.make_test_matrix(128, generator=g, device="cpu")
    assert not torch.equal(a, a3)


def test_lu_panel_matches_jax(jax_matrix):
    block = jax_matrix[0][:64, :64]
    want = np.asarray(jhpl._lu_panel(jnp.asarray(block)))
    got = thpl._lu_panel(_t(block))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("matmul", ["fp32", "bf16", "fp8"])
def test_blocked_lu_matches_jax(jax_matrix, matmul):
    """fp32: the factors within 1e-4.  bf16/fp8: the low-precision factors
    may differ where one rounding flips, so hold what HPL-MxP uses them
    for, the refined solutions (8 iterations, f32)."""
    a, b = jax_matrix
    luj = jhpl.blocked_lu(jnp.asarray(a), nb=64, matmul=matmul)
    at = _t(a)
    lut = thpl.blocked_lu(at, nb=64, matmul=matmul)
    assert torch.equal(at, _t(a))                       # input untouched
    if matmul == "fp32":
        np.testing.assert_allclose(lut.numpy(), np.asarray(luj), rtol=1e-4,
                                   atol=1e-4)
        l = torch.tril(lut, -1) + torch.eye(256)
        np.testing.assert_allclose((l @ torch.triu(lut)).numpy(), a,
                                   rtol=1e-4, atol=1e-3)
        return
    np.testing.assert_allclose(lut.numpy(), np.asarray(luj), rtol=1e-2,
                               atol=1e-3)
    aj, bj = jnp.asarray(a), jnp.asarray(b)
    xj, _ = jmp.iterative_refinement(lambda v: aj @ v,
                                     lambda r: jhpl.lu_solve(luj, r), bj,
                                     iters=8)
    bt = _t(b)
    xt, _ = tmp.iterative_refinement(lambda v: at @ v,
                                     lambda r: thpl.lu_solve(lut, r), bt,
                                     iters=8)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-5,
                               atol=1e-9)


def test_lu_solve_and_residual_match_jax(jax_matrix):
    """On the JAX factor: the packed-factor solves equal the reference's
    tril/triu solves, and the scaled residuals agree."""
    a, b = jax_matrix
    lu = np.asarray(jhpl.blocked_lu(jnp.asarray(a), nb=64))
    xj = np.asarray(jhpl.lu_solve(jnp.asarray(lu), jnp.asarray(b)))
    xt = thpl.lu_solve(_t(lu), _t(b))
    np.testing.assert_allclose(xt.numpy(), xj, rtol=1e-6, atol=1e-10)
    l = torch.tril(_t(lu), -1) + torch.eye(256)
    y = torch.linalg.solve_triangular(l, _t(b)[:, None], upper=False,
                                      unitriangular=True)
    x_copies = torch.linalg.solve_triangular(torch.triu(_t(lu)), y,
                                             upper=True)[:, 0]
    assert torch.equal(xt, x_copies)
    rj = float(jhpl.hpl_residual(jnp.asarray(a), jnp.asarray(xj),
                                 jnp.asarray(b)))
    rt = float(thpl.hpl_residual(_t(a), _t(xj), _t(b)))
    # |Ax - b| is f32 rounding noise summed in another order: same size
    assert 0.2 < rt / rj < 5 and rt < 16
    assert thpl.hpl_flops(256) == jhpl.hpl_flops(256)


def test_blocked_lu_rejects_bad_arguments():
    a = torch.eye(96)
    with pytest.raises(ValueError, match="n=96 is not a multiple of nb=64"):
        thpl.blocked_lu(a, nb=64)
    with pytest.raises(ValueError, match="unknown matmul"):
        thpl.blocked_lu(a, nb=32, matmul="tf32")
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="full float32"):
            thpl.blocked_lu(a, nb=32)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def test_run_hpl_validates():
    r = thpl.run_hpl(256, 64, device="cpu")
    assert r["passed"] and r["residual"] < 16.0
    assert set(r) == {"N", "NB", "matmul", "time_s", "flops", "gflops",
                      "residual", "passed"}


@pytest.mark.parametrize("prec", ["bf16", "fp8"])
def test_hplmxp_low_precision_refines_to_pass(prec):
    r = run_hplmxp(256, 64, lowprec=prec, ir_iters=8, device="cpu")
    assert r["passed"], r
    hist = r["ir_history"]
    assert len(hist) == 8 and hist[-1] <= hist[0]
    assert r["residual"] < r["residual_no_ir"]


def test_hplmxp_fp8_lu_alone_is_inaccurate(jax_matrix):
    a, b = map(_t, jax_matrix)
    x8 = thpl.lu_solve(thpl.blocked_lu(a, nb=64, matmul="fp8"), b)
    x32 = thpl.lu_solve(thpl.blocked_lu(a, nb=64), b)
    r8 = float(thpl.hpl_residual(a, x8, b))
    r32 = float(thpl.hpl_residual(a, x32, b))
    assert r8 > 5 * r32


# --- HPCG -------------------------------------------------------------------

def test_stencil_matches_jax_and_is_symmetric():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(8, 8, 8)).astype(np.float32)
    y = rng.normal(size=(8, 8, 8)).astype(np.float32)
    sx = thpcg.stencil_apply(_t(x))
    np.testing.assert_allclose(
        sx.numpy(), np.asarray(jhpcg.stencil_apply(jnp.asarray(x))),
        rtol=1e-6, atol=1e-6)
    lhs = float(torch.dot(sx.reshape(-1), _t(y).reshape(-1)))
    rhs = float(torch.dot(_t(x).reshape(-1),
                          thpcg.stencil_apply(_t(y)).reshape(-1)))
    assert lhs == pytest.approx(rhs, rel=1e-4)
    # the Jacobi smoother with two sweeps goes through the stencil too
    np.testing.assert_allclose(
        thpcg.jacobi_precondition(_t(x), iters=2).numpy(),
        np.asarray(jhpcg.jacobi_precondition(jnp.asarray(x), iters=2)),
        rtol=1e-6, atol=1e-6)


def test_hpcg_cg_history_matches_jax():
    """24³, 50 iterations: the residual norms agree to 1e-3 down to 1e-5
    of |b|, below which both recurrences run on f32 rounding noise (the
    true residual stalls near 1e-5 of |b|)."""
    rng = np.random.default_rng(0)
    b = rng.uniform(size=(24, 24, 24)).astype(np.float32)
    xj, hj = jhpcg.hpcg_cg(jnp.asarray(b), max_iters=50)
    xt, ht = thpcg.hpcg_cg(_t(b), max_iters=50)
    hj = np.asarray(hj)
    assert ht.shape == (50,)
    keep = hj > 1e-5 * np.linalg.norm(b)
    assert keep.sum() >= 30
    np.testing.assert_allclose(ht.numpy()[keep], hj[keep], rtol=1e-3)
    assert float(ht[-1]) / np.linalg.norm(b) < 1e-4
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-3,
                               atol=1e-4)


def test_run_hpcg_converges_and_is_memory_bound():
    r = thpcg.run_hpcg(24, 24, 24, max_iters=50, device="cpu")
    assert r["converged"] and r["true_rel_residual"] < 1e-4
    assert r["gflops"] / max(r["bandwidth_gbs"], 1e-9) < 4.0
    assert thpcg.hpcg_flops_per_iter(1000) == jhpcg.hpcg_flops_per_iter(1000)
    assert thpcg.hpcg_bytes_per_iter(1000) == jhpcg.hpcg_bytes_per_iter(1000)


# --- the copied modules and the CLI -----------------------------------------

@pytest.mark.parametrize("case", ["hier", "flat", "hops", "roofline"])
def test_topology_copy_matches_reference(case):
    if case == "hier":
        assert ttopo.hierarchical_allreduce_cost(1e9, 16, 2) == \
            jtopo.hierarchical_allreduce_cost(1e9, 16, 2)
    elif case == "flat":
        for args in ((1e9, 16, 2), (1e9, 16, 1)):
            assert ttopo.flat_allreduce_cost(*args) == \
                jtopo.flat_allreduce_cost(*args)
    elif case == "hops":
        t, j = ttopo.RailTopology(), jtopo.RailTopology()
        assert t.num_gpus == 800
        assert [t.hops(0, d) for d in (1, 8, 9, 400)] == \
            [j.hops(0, d) for d in (1, 8, 9, 400)] == [0, 1, 3, 3]
        assert t.bisection_bw() == j.bisection_bw()
    else:
        kw = dict(hlo_flops=1e15, hlo_bytes=1e12, collective_bytes=1e11,
                  n_chips=256)
        assert ttopo.roofline(**kw).step_s == jtopo.roofline(**kw).step_s


def test_io500_copy_runs_and_scores(tmp_path):
    r = tio500.run_io500(nproc=2, mb_per_proc=4, files_per_proc=20,
                         workdir=str(tmp_path))
    assert r["total_score"] > 0
    assert r["bandwidth_score_gibs"] > 0 and r["iops_score_kiops"] > 0
    for phase in ("ior_easy", "ior_hard"):
        assert r[phase]["write_gibs"] > 0 and r[phase]["read_gibs"] > 0
    assert set(r) == set(jio500.run_io500(nproc=1, mb_per_proc=1,
                                          files_per_proc=2,
                                          workdir=str(tmp_path / "j")))


def test_hpc_cli_needs_cuda_unless_told_cpu(monkeypatch, capsys):
    from repro_torch.launch.hpc import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for table in ("hpl", "hplmxp", "hpcg"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main([table, "--n", "64", "--nb", "32"])
    main(["hplmxp", "--device", "cpu", "--n", "128", "--nb", "32",
          "--ir-iters", "3"])
    main(["hpcg", "--device", "cpu", "--n", "8", "--iters", "5"])
    main(["interconnect"])
    rows = capsys.readouterr().out.strip().splitlines()
    names = [r.split(",")[0] for r in rows]
    assert names[:3] == ["table9.hplmxp_bf16", "table9.hplmxp_fp8",
                         "table8.hpcg"]
    assert "passed=True" in rows[0] and "passed=True" in rows[1]
    assert names[3].startswith("interconnect.")
