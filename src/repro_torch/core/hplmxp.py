"""HPL-MxP: low-precision blocked LU plus iterative refinement (paper
Table 9), the counterpart of ``repro.core.hplmxp``.

The benchmark's method (Haidar et al. 2019): factor A once in low
precision (fp8 through the hand-written fp8 GEMM on the card, or bf16),
then recover float32 accuracy with refinement iterations, each O(n²)
against the O(n³) factorization.  The validation criterion is the
paper's: scaled residual < 16.
"""
from __future__ import annotations

import time

import torch

from repro_torch.core.hpl import (_sync, blocked_lu, hpl_flops, hpl_residual,
                                  lu_solve, make_test_matrix, warm_up)
from repro_torch.core.mixed_precision import iterative_refinement


def run_hplmxp(n: int = 1024, nb: int = 128, *, lowprec: str = "fp8",
               ir_iters: int = 8, device="cuda") -> dict:
    """LU in ``lowprec`` plus ``ir_iters`` refinement iterations to f32;
    returns the Table-9-shaped record of the reference, plus
    ``residual_no_ir``: the scaled residual of the low-precision factor's
    own solution, before any refinement (what refinement has to repair).
    The factorization is timed after a warm-up at ``min(n, 2·nb)``
    (``core.hpl.warm_up``), on the card unless ``device`` says
    otherwise."""
    dev = torch.device(device)
    warm_up(n, nb, lowprec, dev)
    a, b = make_test_matrix(n, device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    lu = blocked_lu(a, nb=nb, matmul=lowprec)
    _sync(dev)
    t_lu = time.perf_counter() - t0
    resid_lu = float(hpl_residual(a, lu_solve(lu, b), b))

    _sync(dev)
    t0 = time.perf_counter()
    x, hist = iterative_refinement(lambda v: a @ v, lambda r: lu_solve(lu, r),
                                   b, iters=ir_iters)
    _sync(dev)
    t_ir = time.perf_counter() - t0

    resid = float(hpl_residual(a, x, b))
    total = t_lu + t_ir
    return {
        "N": n, "NB": nb, "precision": lowprec,
        "lu_time_s": t_lu, "ir_time_s": t_ir, "time_s": total,
        "gflops": hpl_flops(n) / total / 1e9,
        "gflops_lu_only": hpl_flops(n) / t_lu / 1e9,
        "residual": resid, "passed": resid < 16.0,
        "ir_history": [float(h) for h in hist],
        "residual_no_ir": resid_lu,
    }
