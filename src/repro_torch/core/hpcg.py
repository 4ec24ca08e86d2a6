"""HPCG: preconditioned conjugate gradient on a 27-point 3-D stencil
(paper Table 8), the counterpart of ``repro.core.hpcg``, in plain
PyTorch (the reference has no Pallas kernel here).

Matrix-free as in the reference: ``y = 26·x − Σ neighbours`` with a zero
Dirichlet halo.  Where the reference pads 26 shifted copies, the port
subtracts each neighbour's slice from the overlapping slice of ``y`` in
place; the entries a padded copy would reach hold zeros there, so each
entry gets the same subtractions in the same order.  The smoother is
Jacobi (diag = 26), as in the reference.
"""
from __future__ import annotations

import time
from typing import Tuple

import torch


def _shift_slices(d: int, n: int) -> Tuple[slice, slice]:
    """(destination, source) slices along one axis for neighbour offset
    ``d``: ``y[i] -= x[i - d]`` wherever ``i - d`` is inside."""
    return slice(max(d, 0), n - max(-d, 0)), slice(max(-d, 0), n - max(d, 0))


def stencil_apply(x: torch.Tensor) -> torch.Tensor:
    """27-point stencil: y = 26·x − Σ_{neighbours} x (zero Dirichlet halo).
    x: (nx, ny, nz).  Memory-bound, as HPCG intends."""
    y = 26.0 * x
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                if dx == dy == dz == 0:
                    continue
                dst, src = zip(*(_shift_slices(d, n)
                                 for d, n in zip((dx, dy, dz), x.shape)))
                y[dst].sub_(x[src])
    return y


def jacobi_precondition(r: torch.Tensor, *, iters: int = 1) -> torch.Tensor:
    """Jacobi smoother (diag = 26), the reference's stand-in for HPCG's
    symmetric Gauss-Seidel."""
    z = r / 26.0
    for _ in range(iters - 1):
        z = z + (r - stencil_apply(z)) / 26.0
    return z


def _dot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.dot(u.reshape(-1), v.reshape(-1))


def hpcg_cg(b: torch.Tensor, *,
            max_iters: int = 50) -> Tuple[torch.Tensor, torch.Tensor]:
    """Preconditioned CG from x = 0.  Returns ``(x, history)``: the norm of
    the updated residual after each of the ``max_iters`` iterations.  The
    scalars stay on the device, so the loop never waits for it."""
    x = torch.zeros_like(b)
    r = b
    z = jacobi_precondition(r)
    p = z
    hist = []
    for _ in range(max_iters):
        ap = stencil_apply(p)
        rz = _dot(r, z)
        alpha = rz / _dot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        z = jacobi_precondition(r)
        beta = _dot(r, z) / rz
        p = z + beta * p
        hist.append(torch.linalg.vector_norm(r))
    return x, (torch.stack(hist) if hist
               else torch.empty(0, device=b.device))


def hpcg_flops_per_iter(nnodes: int) -> float:
    """~27·2 operations per node for the stencil, as many for the
    preconditioner, and ~10 for the vector updates."""
    return nnodes * (27 * 2 + 27 * 2 + 10)


def hpcg_bytes_per_iter(nnodes: int, dtype_bytes: int = 4) -> float:
    """The reference's nominal traffic: ~12 array passes per iteration."""
    return nnodes * dtype_bytes * 12.0


def run_hpcg(nx: int = 64, ny: int = 64, nz: int = 64,
             max_iters: int = 50, *, device="cuda") -> dict:
    """CG on a random right-hand side (U(0, 1) from a generator seeded 7
    on ``device``), timed on the second of two runs as in the reference;
    on the card unless ``device`` says otherwise.  Returns the
    Table-8-shaped record of the reference, plus ``true_rel_residual``:
    ``|b − A x| / |b|`` computed again from the solution, against which
    the recurrence's ``rel_residual`` can be checked."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(7)
    b = torch.rand((nx, ny, nz), generator=gen, device=dev)
    hpcg_cg(b, max_iters=max_iters)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    x, hist = hpcg_cg(b, max_iters=max_iters)
    r_final = float(hist[-1])              # waits for the device
    dt = time.perf_counter() - t0
    nnodes = nx * ny * nz
    r0 = float(torch.linalg.vector_norm(b))
    true = float(torch.linalg.vector_norm(b - stencil_apply(x)))
    return {
        "dims": (nx, ny, nz), "equations": nnodes, "iters": max_iters,
        "time_s": dt,
        "gflops": hpcg_flops_per_iter(nnodes) * max_iters / dt / 1e9,
        "bandwidth_gbs": hpcg_bytes_per_iter(nnodes) * max_iters / dt / 1e9,
        "rel_residual": r_final / r0,
        "converged": r_final / r0 < 1e-4,
        "true_rel_residual": true / r0,
    }
