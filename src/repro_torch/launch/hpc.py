"""The paper's HPC benchmarks on the port (counterpart of ``benchmarks/run.py``
tables 7-10 and ``interconnect``, and of ``examples/hplmxp_demo.py``).

Prints ``name,us_per_call,derived`` rows, one per run, as the reference
harness does.  HPL, HPCG and HPL-MxP run on the card unless ``--device
cpu`` is given; IO500 measures the local filesystem and ``interconnect``
evaluates the topology cost model, so neither takes a device.

  PYTHONPATH=src python -m repro_torch.launch.hpc hplmxp --n 65536 --nb 1024
  PYTHONPATH=src python -m repro_torch.launch.hpc hplmxp --device cpu \\
      --n 512 --nb 128
  PYTHONPATH=src python -m repro_torch.launch.hpc hpcg --n 256 --iters 50
"""
from __future__ import annotations

import argparse

from repro_torch.runtime.serving import resolve_device

TABLES = ("hpl", "hpcg", "hplmxp", "io500", "interconnect")


def emit(name: str, us_per_call: float, derived: str) -> None:
    print(f"{name},{us_per_call:.1f},{derived}", flush=True)


def table_hpl(n: int, nb: int, device) -> None:
    """Paper Table 7: HPL (float32 blocked LU)."""
    from repro_torch.core.hpl import run_hpl
    r = run_hpl(n, nb, device=device)
    emit("table7.hpl_fp32", r["time_s"] * 1e6,
         f"gflops={r['gflops']:.2f};residual={r['residual']:.2e};"
         f"passed={r['passed']}")


def table_hpcg(n: int, iters: int, device) -> None:
    """Paper Table 8: HPCG (27-point stencil, preconditioned CG) on an
    n³ grid."""
    from repro_torch.core.hpcg import run_hpcg
    r = run_hpcg(n, n, n, max_iters=iters, device=device)
    emit("table8.hpcg", r["time_s"] * 1e6,
         f"gflops={r['gflops']:.2f};bw_gbs={r['bandwidth_gbs']:.2f};"
         f"rel_resid={r['rel_residual']:.2e};converged={r['converged']}")


def table_hplmxp(n: int, nb: int, ir_iters: int, device) -> None:
    """Paper Table 9: HPL-MxP (bf16 and fp8 LU plus iterative
    refinement), with the speed of the float32 LU beside it."""
    from repro_torch.core.hpl import run_hpl
    from repro_torch.core.hplmxp import run_hplmxp
    hi = run_hpl(n, nb, device=device)
    for prec in ("bf16", "fp8"):
        r = run_hplmxp(n, nb, lowprec=prec, ir_iters=ir_iters, device=device)
        emit(f"table9.hplmxp_{prec}", r["time_s"] * 1e6,
             f"gflops={r['gflops']:.2f};"
             f"lu_only_gflops={r['gflops_lu_only']:.2f};"
             f"lu_speedup_vs_fp32={hi['time_s'] / r['lu_time_s']:.2f};"
             f"residual={r['residual']:.2e};passed={r['passed']}")


def table_io500() -> None:
    """Paper Table 10: IO500 phases with few and many workers."""
    from repro_torch.core.io500 import run_io500
    for nproc in (2, 8):
        r = run_io500(nproc=nproc, mb_per_proc=16, files_per_proc=150)
        emit(f"table10.io500_np{nproc}", 0.0,
             f"score={r['total_score']:.2f};"
             f"bw_gibs={r['bandwidth_score_gibs']:.2f};"
             f"kiops={r['iops_score_kiops']:.2f};"
             f"easy_w={r['ior_easy']['write_gibs']:.2f};"
             f"hard_w={r['ior_hard']['write_gibs']:.3f};"
             f"stat_kiops={r['mdtest']['stat_kiops']:.1f}")


def table_interconnect() -> None:
    """Rail-optimized vs flat all-reduce on the topology cost model."""
    from repro_torch.core import topology
    for gb, label in ((0.5e9, "0.5GB"), (4e9, "4GB"), (16e9, "16GB")):
        per_chip = gb / 512
        hier, parts = topology.hierarchical_allreduce_cost(per_chip, 16, 2)
        flat = topology.flat_allreduce_cost(per_chip, 16, 2)
        comp = (parts["reduce_scatter"] + parts["all_gather"]
                + parts["cross_pod"] / 4)          # int8 cross-pod payload
        emit(f"interconnect.allreduce_{label}", hier * 1e6,
             f"flat_us={flat * 1e6:.1f};hier_us={hier * 1e6:.1f};"
             f"hier_int8_us={comp * 1e6:.1f};speedup={flat / hier:.1f}x")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.hpc",
        description="The paper's HPC benchmarks on the PyTorch port.")
    ap.add_argument("table", choices=TABLES)
    ap.add_argument("--n", type=int, default=None,
                    help="HPL/HPL-MxP matrix order (default 768) or HPCG "
                    "grid edge (default 48)")
    ap.add_argument("--nb", type=int, default=128, help="LU block size")
    ap.add_argument("--ir-iters", type=int, default=8,
                    help="HPL-MxP refinement iterations")
    ap.add_argument("--iters", type=int, default=90,
                    help="HPCG CG iterations")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    return ap


def main(argv=None) -> None:
    """Runs one table.

    Raises:
      RuntimeError: HPL, HPCG or HPL-MxP asked for CUDA (the default)
          where there is none."""
    args = build_parser().parse_args(argv)
    if args.table == "io500":
        return table_io500()
    if args.table == "interconnect":
        return table_interconnect()
    dev = resolve_device(args.device)
    if args.table == "hpcg":
        return table_hpcg(args.n or 48, args.iters, dev)
    n = args.n or 768
    if args.table == "hpl":
        return table_hpl(n, args.nb, dev)
    return table_hplmxp(n, args.nb, args.ir_iters, dev)


if __name__ == "__main__":
    main()
