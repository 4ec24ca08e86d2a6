"""HPL: blocked right-looking LU without pivoting (paper Table 7), the
counterpart of ``repro.core.hpl``.

A panel factor of the diagonal block, two triangular solves for the
column and row panels, and the trailing GEMM update, the phase HPL
measures.  ``matmul`` sets the trailing update's precision, the knob HPL
versus HPL-MxP turns: ``"fp32"``, ``"bf16"`` (bf16-rounded operands, f32
products and sums) or ``"fp8"`` (per-tensor e4m3 operands through the fp8
GEMM kernel on CUDA, ``core.mixed_precision.fp8_matmul``).

Float32 is the high precision, as in the reference; the diagonally
dominant test matrices make pivot-free LU safe.  Where JAX rebuilds the
matrix with ``dynamic_update_slice``, the port updates one working copy
in place; the input matrix is kept for the residual and for iterative
refinement.  Triangular solves run on the packed factor, without the
n x n ``tril``/``triu`` copies the reference builds.  ``distributed_hpl_
setup`` (the mesh-sharded variant) waits for the port's parallelism slice.
"""
from __future__ import annotations

import time

import torch

from repro_torch.core.mixed_precision import fp8_matmul

MATMULS = ("fp32", "bf16", "fp8")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def check_f32_matmul() -> None:
    """HPL's high precision is full float32: refuse to run with TF32
    matmuls switched on.

    Raises:
      RuntimeError: ``torch.get_float32_matmul_precision()`` is not
          ``"highest"`` or ``torch.backends.cuda.matmul.allow_tf32`` is
          set."""
    if (torch.get_float32_matmul_precision() != "highest"
            or torch.backends.cuda.matmul.allow_tf32):
        raise RuntimeError(
            "HPL needs full float32 matmuls: set torch.set_float32_matmul_"
            "precision('highest') and torch.backends.cuda.matmul."
            "allow_tf32 = False")


def make_test_matrix(n: int, generator: torch.Generator | None = None,
                     device="cuda", dtype=torch.float32):
    """Random diagonally dominant matrix (pivot-free LU is safe) and its
    right-hand side: ``a`` from U(-0.5, 0.5) plus 0.3·n on the diagonal,
    ``b`` from U(-0.5, 0.5), drawn with ``generator`` (seed 0 on
    ``device`` when none is given).  The draws are torch's, not
    ``jax.random``'s: the tests hand both packages the same numpy data."""
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    a = torch.empty((n, n), device=device).uniform_(-0.5, 0.5,
                                                    generator=generator)
    a.diagonal().add_(0.3 * n)
    b = torch.empty(n, device=device).uniform_(-0.5, 0.5,
                                               generator=generator)
    return a.to(dtype), b.to(dtype)


def _lu_panel(p: torch.Tensor) -> torch.Tensor:
    """Unblocked pivot-free LU of a square panel, in place (f32); returns
    ``p``.  Column i of L is divided by the pivot, then the rank-1 update
    of the lower right block: the reference's masked ``fori_loop`` body,
    restricted to the entries it changes."""
    n = p.shape[0]
    for i in range(n - 1):
        col = p[i + 1:, i]
        col.div_(p[i, i])
        p[i + 1:, i + 1:].sub_(torch.outer(col, p[i, i + 1:]))
    return p


def _trailing_matmul(l_col, u_row, matmul: str, impl: str):
    if matmul == "bf16":
        # bf16 operands, f32 result: products of bf16 values are exact in
        # f32, so multiplying the rounded operands in f32 is the
        # reference's bf16 dot with an f32 accumulator
        return l_col.bfloat16().float() @ u_row.bfloat16().float()
    if matmul == "fp8":
        return fp8_matmul(l_col, u_row, impl=impl)
    return l_col @ u_row


def blocked_lu(a: torch.Tensor, *, nb: int = 128, matmul: str = "fp32",
               impl: str = "auto") -> torch.Tensor:
    """Blocked right-looking LU; returns the packed factors (unit lower L
    below the diagonal, U on and above it) in a new tensor, ``a`` is left
    as it is.  ``matmul``: the trailing update's precision (``MATMULS``);
    ``impl`` picks the fp8 GEMM's kernel or plain version as in
    ``kernels.ops``.  The trailing update does the canonical 2/3·n³
    operations: step k multiplies the (n-(k+1)·nb, nb) column panel by
    the (nb, n-(k+1)·nb) row panel.

    Raises:
      ValueError: ``n`` is not a multiple of ``nb``, or an unknown
          ``matmul``.
      RuntimeError: TF32 matmuls are switched on (``check_f32_matmul``)."""
    n = a.shape[0]
    if nb < 1 or n % nb != 0:
        raise ValueError(f"blocked_lu: n={n} is not a multiple of nb={nb}")
    if matmul not in MATMULS:
        raise ValueError(f"blocked_lu: unknown matmul {matmul!r}; expected "
                         f"one of {MATMULS}")
    check_f32_matmul()
    a = a.clone()
    for off in range(0, n, nb):
        end = off + nb
        diag = _lu_panel(a[off:end, off:end])
        if end == n:
            break
        a_col = a[end:, off:end]                          # L21 = A21 U11^-1
        l_col = torch.linalg.solve_triangular(diag, a_col, upper=True,
                                              left=False)
        a_col.copy_(l_col)
        a_row = a[off:end, end:]                          # U12 = L11^-1 A12
        u_row = torch.linalg.solve_triangular(diag, a_row, upper=False,
                                              unitriangular=True)
        a_row.copy_(u_row)
        # trailing update: A22 -= L21 @ U12 (the GEMM HPL measures)
        a[end:, end:].sub_(_trailing_matmul(l_col, u_row, matmul, impl))
    return a


def lu_solve(lu: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``L U x = b`` on the packed factors: the same two triangular
    solves as the reference, reading L's and U's triangles in place."""
    y = torch.linalg.solve_triangular(lu, b[:, None], upper=False,
                                      unitriangular=True)
    return torch.linalg.solve_triangular(lu, y, upper=True)[:, 0]


def hpl_residual(a: torch.Tensor, x: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """HPL's scaled residual ``|Ax-b|∞ / (eps·(|A|∞·|x|∞ + |b|∞)·n)`` with
    the f32 eps.  ``|A|∞`` is summed over row chunks, so no n x n
    temporary is made."""
    r = (a @ x - b).abs().amax()
    rows = max(1, (1 << 28) // max(a.shape[1], 1))
    na = torch.stack([a[i:i + rows].abs().sum(dim=1).amax()
                      for i in range(0, a.shape[0], rows)]).amax()
    nx = x.abs().amax()
    nb = b.abs().amax()
    eps = torch.finfo(torch.float32).eps
    return r / (eps * (na * nx + nb) * a.shape[0])


def hpl_flops(n: int) -> float:
    """Canonical HPL operation count 2/3 n³ + 3/2 n²."""
    return 2.0 / 3.0 * n ** 3 + 1.5 * n ** 2


def warm_up(n: int, nb: int, matmul: str, device) -> None:
    """One factorization at ``min(n, 2·nb)``: it loads the libraries and
    kernels the timed run uses (and makes one trailing update) without
    factoring the full matrix twice, as the reference's compile-and-time
    pattern would."""
    dev = torch.device(device)
    a, _ = make_test_matrix(min(n, 2 * nb), device=dev)
    blocked_lu(a, nb=nb, matmul=matmul)
    _sync(dev)


def run_hpl(n: int = 1024, nb: int = 128, matmul: str = "fp32", *,
            device="cuda") -> dict:
    """Factor + solve + validate; returns the Table-7-shaped record.  The
    factorization is timed after a warm-up at ``min(n, 2·nb)``
    (``warm_up``), on the card unless ``device`` says otherwise."""
    dev = torch.device(device)
    warm_up(n, nb, matmul, dev)
    a, b = make_test_matrix(n, device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    lu = blocked_lu(a, nb=nb, matmul=matmul)
    _sync(dev)
    dt = time.perf_counter() - t0
    x = lu_solve(lu, b)
    resid = float(hpl_residual(a, x, b))
    return {
        "N": n, "NB": nb, "matmul": matmul,
        "time_s": dt, "flops": hpl_flops(n),
        "gflops": hpl_flops(n) / dt / 1e9,
        "residual": resid, "passed": resid < 16.0,
    }
