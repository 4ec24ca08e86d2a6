#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA H100.

  python3 chip_smoke.py

Phases, each printed as it runs:

1. device — the card's name and power limit (nvidia-smi), torch and CUDA
   versions; TF32 is switched off for float32 matmuls and convolutions;
2. build — the CUDA kernels compile from ``src/repro_torch/kernels/csrc``
   with nvcc, and the Triton kernels compile at their first launch; the
   fp8 GEMM's and the flash kernel's registers and spills are logged (no
   spill allowed) and their SASS must hold warpgroup MMAs (``cuobjdump``):
   on e4m3 operands for the fp8 GEMM, on bf16 ones (HGMMA) for flash; every
   instantiation of the decode kernel (paged and dense libraries) is named
   from ptxas's report and none may spill, and the widths of the serving
   instantiations' loads are counted in the SASS (qwen3-1.7b's GQA group
   of 2 over every pool, llama3-8b's group of 4 over its bf16 and fp8
   pools);
3. kernels — every kernel of the serving paths against its plain PyTorch
   version at the serving shapes of qwen3-1.7b (H=16, KVH=8, d=128;
   paged decode: page 16, 8 seats with lengths from 1 to 2048; dense
   decode: 8 slots of 545 keys, lengths 1 to 545, split over the sequence;
   flash prefill: one causal prompt of 511 tokens; RMSNorm at D=2048 and
   D=128; the fused add + RMSNorm at M=8, D=2048, whose sum must be
   bit-equal to torch's add; the q/k norm in one launch at 128 + 64 rows
   of D=128), with its time, the plain version's time, one PyTorch
   library call's time as a yardstick (``F.scaled_dot_product_attention``
   pinned to one backend, ``F.rms_norm``; none for the fused norms), and
   the least time the card could take; untimed,
   the norms at the k-norm and prefill-chunk shapes, flash prefill at 64
   and 37 tokens, and paged (every pool type) and dense (bf16 and f32)
   decode at the edges of their split-K plans (lengths chunk - 1, chunk,
   chunk + 1, seats whose later splits are all empty, the full width; the
   tickets must be back at zero after the launches); then the same checks
   off those shapes (f32 queries, pools and caches, GQA groups 1 and 4,
   head dims 16 to 256, odd cache lengths, sliding-window and non-causal
   flash on both routes, f32 RMSNorm);
4. serve — ``serve_paged`` at the full width of qwen3-1.7b (28 layers,
   d_model 2048, vocab 151936, bf16 compute, weights from a seeded
   torch.Generator), 16 requests with prompts of 64-511 tokens and 32
   new tokens each, served with a bf16, an fp8 and an int8 KV pool;
   checks for each run that every request finished, every token is in
   the vocabulary, no logit was NaN, and that the kernels carried the
   path (launch counts, set to 0 before the run and read after it; the
   engine replays the fused tick and the prefill chunk as CUDA graphs
   captured at construction, and each replay adds the launches its
   capture recorded); the same requests through the ``fused=False``
   engine (eager, host-side sampling), whose greedy streams and trace
   must equal the graphed run's; each graph replayed against the
   function it captured, run eagerly on the same inputs and a copy of
   the pool, bit for bit (tokens, logits, pool bytes, the advanced
   state); the split tickets back at 0; then one fused tick on the same
   state with the kernels and with the plain versions, whose logits must
   agree, and the steady tick's wall time, device busy time, kernels and
   top kernels (torch.profiler; bf16 and fp8 pools), run eagerly and as
   a graph replay;
5. serve-fixed — the fixed-slot path at the same width: ``serve`` (the
   static batch behind ``--engine batch``: 4 prompts of 128 tokens, 16
   new tokens each), then a ``ServingEngine`` (8 slots, max_len 544) over
   the same 16 requests as the paged runs, with the same checks and the
   launch counts of the dense decode and flash kernels (the decode step
   a graph replay, the whole-prompt prefill eager); one decode step
   with the kernels and with the plain versions, whose logits must agree;
   the captured decode step against the eager one, bit for bit (logits,
   cache); the split tickets back at 0; the steady decode step's wall
   time, device busy time and idle share, eager and as a graph replay;
   and, as information, how many greedy tokens the fixed-slot and bf16
   paged engines share;
6. telemetry — the serving telemetry plane on the graphed paged engine
   at the same width, over the same 16 requests and weights, with a bf16
   and an fp8 pool: the engine with ``telemetry=None``,
   ``Telemetry(ring=4096)`` and ``Telemetry(profile=True)`` gives the
   streams and flat trace of phase 4's run and its launch counts; in a
   steady window (every request seated and decoding) the three give the
   same kernels and copies per tick under torch.profiler and the same
   synchronizing calls per tick under
   ``torch.cuda.set_sync_debug_mode("warn")``, and only the profiled one
   has ``fused_decode_tick`` ranges; the recorder's events project onto
   the flat trace and its Perfetto export validates; a ``MetricsServer``
   on port 0 serves the engine's metric families; a forced stall writes a
   postmortem naming every stalled rid with a consistent page partition;
   then five interleaved runs of each mode on fresh engines give the
   on/off tokens/s ratio and the tick profiler's phase table
   (information);
7. fleet — the multi-model fleet router (``runtime.router.ModelFleet``)
   at full width: qwen3-1.7b x2 and llama3-8b x1 (32 layers, d_model
   4096, GQA group 4, untied 128256-row head), weights from generators
   seeded 0 and 1 on the card, each cast for compute before the next is
   drawn and shared by its replicas; 8 seats, page 16, prefill chunk 128,
   max_seq_len 544.  Run A: bf16 pools, least-loaded selection, a budget
   of 840 pages (no engine can preempt), 24 requests of 64-511 prompt
   tokens and 32 new tokens at temperature 0.9 alternating between the
   models: every request finished in its model's vocabulary, logits
   finite, no preemption, the launch counts equal to the sum over
   engines of layers x graph replays, each rid's stream bit-equal to a
   solo graphed engine's fed the same (rid, prompt, budget), both
   qwen3-1.7b replicas on one tree's storage, the llama3-8b replica's
   graphs bit-equal to eager, the split tickets back at 0; K1 and K2 at
   llama3-8b's shapes (GQA group 4, the tick's 8 seats of 41-543 tokens)
   over bf16 and fp8 pools against their plain versions; llama3-8b's bf16
   tick with the kernels no further from the f32 tick of the same weights
   and pool than 1.5x the plain versions' bf16 tick (per seat and at the
   largest logit; a planted fault, the last page dropped, must fail);
   llama3-8b's kernels against the plain versions in f32 (its weights
   widened), 8 of its prompts teacher-forced as in phase f32.  Run B:
   qwen3-1.7b bf16 and llama3-8b fp8 under a budget of the two floors and
   40 pages, SLO-aware selection and SLO admission, a third of the
   requests premium: every request finished, live bytes within the
   budget after every fleet tick, some engine borrowing, K2 launched.
   Run A again under ``Telemetry(ring=4096)``: the same streams, a
   ``fleet_tick`` event per engine at every heartbeat stride, a valid
   Perfetto export; a forced stall's message and postmortem (every
   engine, the budget block);
   then, as information, a steady fleet step (all 24 seats decoding)
   under torch.profiler, the llama3-8b tick's device busy time against
   its byte bound, and ``python -m repro_torch.launch.serve --fleet``
   with its defaults (reduced configs);
8. f32 — the same model computing in f32 (f32 weights, pool and cache;
   flash prefill on its CUDA-core route): 8 greedy streams teacher-forced
   through the fused tick and through ``prefill`` + ``decode_step``, each
   with the kernels and with the plain versions, whose top-1 must agree
   at every decided position (the plain top-2 gap above twice the largest
   logit difference there) with at least 90% of the positions decided;
   then the paged engine and ``ServingEngine`` on the same 8 requests,
   whose streams must be equal up to their first top-2 gap <= 1e-3;
9. train — the training path, which runs the plain PyTorch versions on
   purpose (no kernel has a backward, in the port or in the reference):
   ``train()`` on qwen3-1.7b at its published width (f32 master weights
   and AdamW state, bf16 compute, remat, batch 8 x seq 1024 from the
   token pipeline, 30 steps), whose losses must be finite and fall by
   the reference's criterion (mean of the last 5 below the mean of the
   first 5 by 0.05) with every kernel launch counter at 0, reporting
   wall time and peak memory; then steady steps through the train cell
   (step time by CUDA events, tokens/s), one of them profiled (device
   busy time, idle share, kernel groups) and its parts timed (forward,
   forward + backward, AdamW); three train steps of the reduced f32
   config on the card and on the CPU from the same params and batches,
   held to the CPU parity tests' tolerances; a checkpoint restart on the
   card (an injected failure at step 6 after the step-4 checkpoint, the
   resumed losses and final params, mu, nu and count against an
   uninterrupted run, and a ``save_async`` whose restored tensors equal
   the saved ones bit for bit);
10. hpc — the fp8 GEMM kernel (K6) against its plain version, held to
   ``fp8_matmul.error_bound`` (f32 sums plus the tensor-core term of sums
   promoted every 128 products), through ``ops.fp8_matmul`` (aligned,
   ragged, bm/bn != 128) and through the per-tensor call at the n = 256,
   nb = 64 LU's first update (M = N = 192, K = 64), at a K the wrapper
   pads to 16, on one-sign operands and at a mid-run HPL trailing-update
   shape (M = N = 32768, K = 1024), timed there with the plain version
   and ``torch._scaled_mm``; planted faults (a scale of the wrong block,
   a dropped k-step, sums never promoted) must fail the same bound;
   HPL fp32 and HPL-MxP fp8 and bf16 (8 refinement iterations) at N =
   65536, NB = 1024 through ``run_hpl``/``run_hplmxp``, with the residual
   criterion (< 16), the falling refinement history and the launch counts
   of K6 checked; the fp8 factor without refinement against the fp32
   factor at n = 256 (> 5x its residual, the reference's test) and,
   logged, at larger n; the fp8 factorization at N = 8192 with the
   kernel and with the plain version (first trailing update and refined
   solutions held); HPCG at 256³ (50 iterations, the true residual
   recomputed) and at 48³ (90 iterations, converged);
11. summary — one JSON line listing the kernels, the card's name and power
    limit, and as the last line ``{"ok": true, "device": {...}}``.

Any failure raises: the script exits non-zero and prints no ``ok`` line.
It never runs on the CPU: without CUDA it stops before any phase.
"""
from __future__ import annotations

import gc
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.nn.attention import SDPBackend, sdpa_kernel  # noqa: E402

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
F32_FLOPS = 67e12              # H100 SXM float32 rate outside tensor cores
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor-core rate
FP8_FLOPS = 1979e12            # H100 SXM dense fp8 tensor-core rate
ARCH = "qwen3-1.7b"
H, KVH, HEAD_DIM, PAGE, D_MODEL = 16, 8, 128, 16, 2048
LLAMA = "llama3-8b"            # the fleet's second model: 32 heads over 8
LLAMA_H = 32
SEAT_LENGTHS = (1, 16, 17, 255, 700, 1024, 1531, 2048)
N_TABLE = 2048 // PAGE
PREFILL_CHUNK = 128
MAX_LEN = 544                  # fixed-slot max_len: prompt <= 511 + 32 new
# dense decode lengths: a fresh prompt, the spread of a serving wave, a
# full slot, and an idle slot parked on the scratch index (max_len + 1)
SLOT_LENGTHS = (1, 64, 65, 200, 333, 511, 544, MAX_LEN + 1)
PREFILL_S = 511                # the widest prompt of the serving runs
ITERS = 20
SDPA_EFF = "sdpa[EFFICIENT_ATTENTION]"    # yardstick names, with backend
SDPA_FLASH = "sdpa[FLASH_ATTENTION]"
# HPC phase: HPL at NB = 1024, the repo's production HPL block
# (launch/dryrun.py), and N = 65536, half its N for one card (the 16 GiB
# matrix, its working copy and the first trailing product fill ~48 GiB)
HPL_N, HPL_NB = 65536, 1024
K6_M = K6_N = 32768            # a mid-run trailing update of that HPL
HPL_CHECK_N = 8192             # whole-path kernel-vs-plain factorization
HPCG_EDGE = 256                # HPCG's customary per-GPU local grid
# the paged engines of the serving phases: 8 seats, pages of 16 tokens,
# room for 16 requests of up to 544 tokens plus 16 pages of headroom
ENGINE_KW = dict(page_size=PAGE, num_pages=16 * 34 + 16, max_seats=8,
                 max_seq_len=512 + 32, prefill_chunk=PREFILL_CHUNK)


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, flush: torch.Tensor, iters: int = ITERS) -> float:
    """Device time of one ``fn()`` in ms, with the 50 MB L2 cache flushed
    before every call (the serving path reads each layer's pool cold):
    the median over ``iters`` calls of the span torch.profiler records
    on the device for each call's ``record_function`` range (from its
    first kernel's start to its last kernel's end)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()

    def timed():
        for _ in range(iters):
            flush.zero_()
            with torch.profiler.record_function(TIMED):
                fn()
    return statistics.median(profiled(timed, TIMED)[1]) / 1e3


def event_ms(fn, flush: torch.Tensor, iters: int) -> float:
    """Time of one ``fn()`` in ms by CUDA events around each call (L2
    flushed before it), the median over ``iters`` calls: for calls of
    milliseconds, whose launch takes microseconds, the events bracket the
    kernels.  ``cuda_ms`` (the profiler) is for the short kernels, where
    events would time the host instead; torch 2.11's profiler misreads
    long ones (it put the fp8 GEMM at 29–31 ms in two runs, faster than
    the card's f32 peak allows, and at 51–52 ms in two others)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


TIMED = "chip_smoke.timed"
PROFILE_TRIES = 3


def profiled(work, key=None):
    """``torch.profiler`` over ``work()`` (CPU and CUDA activity, ending in
    a synchronize).  With ``key``, ``work`` marks each unit with a
    ``record_function(key)`` range, and the device span (µs) of each
    range is returned beside the profile.  torch 2.11's profiler now and
    then loses ranges on the device side: the ones lost are counted in
    the log, and a profile that lost half or more of them (or, without
    ``key``, recorded no device time) is taken again, up to
    PROFILE_TRIES times.

    Raises:
      RuntimeError: no profile in PROFILE_TRIES kept enough device time."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    cpu = torch.autograd.DeviceType.CPU
    for attempt in range(PROFILE_TRIES):
        with torch.profiler.profile(activities=acts) as prof:
            work()
            torch.cuda.synchronize()
        events = prof.events()
        if key is None:
            if any(e.device_type != cpu and e.device_time_total > 0
                   for e in events):
                return prof, []
            ranges, spans = 1, []
        else:
            ranges = sum(1 for e in events
                         if e.name == key and e.device_type == cpu)
            spans = [e.device_time_total for e in events
                     if e.name == key and e.device_type != cpu
                     and e.device_time_total > 0]
            if 2 * len(spans) > ranges:
                if len(spans) < ranges:
                    log("profile", f"torch.profiler lost {ranges - len(spans)}"
                        f" of {ranges} ranges on the device; they are left "
                        "out")
                return prof, spans
        log("profile", f"attempt {attempt + 1}: torch.profiler kept device "
            f"time for {len(spans)} of {ranges} ranges; profiling again")
    raise RuntimeError(f"torch.profiler lost most device time in "
                       f"{PROFILE_TRIES} attempts")


def bound(nbytes: float, flops: float, rate: float = F32_FLOPS):
    """Least time in ms: bytes over the memory rate or operations over
    ``rate``, whichever is larger, and which of the two it is."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / rate
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def sdpa(backend: SDPBackend, *args, **kw):
    """The yardstick: ``F.scaled_dot_product_attention`` pinned to one
    backend, so a backend PyTorch cannot take raises instead of falling
    back to another."""
    with sdpa_kernel(backend):
        return F.scaled_dot_product_attention(*args, **kw)


def check_close(name: str, got: torch.Tensor, want: torch.Tensor,
                atol: float, rtol: float) -> float:
    err = (got.float() - want.float()).abs()
    lim = atol + rtol * want.float().abs()
    if not bool(torch.isfinite(got.float()).all()):
        raise AssertionError(f"{name}: non-finite kernel output")
    if bool((err > lim).any()):
        raise AssertionError(f"{name}: max |kernel - plain| "
                             f"{err.max().item():.3e} beyond atol {atol} + "
                             f"rtol {rtol}·|plain|")
    return err.max().item()


# bf16 outputs: both sides compute in f32 and round once to bf16, so they
# may differ by one bf16 rounding step (2^-8 relative, up to 2^-7 just
# under a power of two) plus f32 summation-order noise near zero
BF16_ATOL, BF16_RTOL = 1e-3, 2.0 ** -7
# f32 outputs: online vs dense softmax, sums in another order
F32_TOL = (2e-5, 1e-4)


def _sms() -> int:
    return torch.cuda.get_device_properties(0).multi_processor_count


def phase_device() -> str:
    line = smi_line()
    log("device", f"nvidia-smi: {line}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("device", f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    log("device", "allow_tf32 matmul="
        f"{torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    return line


DECODE_LIBS = ("paged_decode_attention", "decode_attention")


def phase_build() -> None:
    from repro_torch.kernels import _build, ops
    t0 = time.perf_counter()
    logs = _build.build_all()
    t_nvcc = time.perf_counter() - t0
    for name, text in logs.items():
        if name in DECODE_LIBS:             # _check_decode_build names them
            continue
        for ln in text.splitlines():
            if "registers" in ln or "spill" in ln:
                log("build", f"{name}: {ln.strip()}")
    _check_fp8_build(logs)
    _check_flash_build(logs)
    _check_decode_build(logs)
    t1 = time.perf_counter()
    for d in (2048, HEAD_DIM):
        x = torch.ones((2, d), dtype=torch.bfloat16, device="cuda")
        ops.rmsnorm(x, torch.zeros(d, device="cuda"), impl="kernel")
    torch.cuda.synchronize()
    log("build", f"nvcc {t_nvcc:.1f} s ({len(logs)} sources), "
        f"triton {time.perf_counter() - t1:.1f} s")


def _sass(name: str) -> str:
    """The SASS of the built library of ``csrc/<name>.cu``."""
    from repro_torch.kernels import _build
    path = _build.library(name)._name
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return subprocess.run([cuobjdump, "--dump-sass", path], check=True,
                          capture_output=True, text=True).stdout


def _check_fp8_build(logs: dict) -> None:
    """K6's build: ptxas (``-Xptxas=-v``) must report no spill, and its
    warnings are logged; the library's SASS (``cuobjdump --dump-sass``)
    must hold warpgroup MMAs on e4m3 operands (``QGMMA ... .E4M3.E4M3``;
    HGMMA is the 16-bit form), the fp8 tensor-core path.

    Raises:
      AssertionError: a spill, or no e4m3 warpgroup MMA in the SASS."""
    text = logs["fp8_matmul"]
    for ln in text.splitlines():
        if "warning" in ln.lower():
            log("build", f"fp8_matmul: {ln.strip()}")
    spills = [int(n) for n in re.findall(r"(\d+) bytes spill", text)]
    assert spills and not any(spills), \
        f"fp8_matmul: ptxas reports spills {spills}"
    sass = _sass("fp8_matmul")
    # the warpgroup MMAs: HGMMA for 16-bit operands, QGMMA for fp8
    gmma = [ln.strip() for ln in sass.splitlines()
            if re.search(r"\b[HQ]GMMA\.", ln)]
    e4m3 = [ln for ln in gmma if ".E4M3.E4M3" in ln]
    log("build", f"fp8_matmul SASS: {len(gmma)} warpgroup MMAs, "
        f"{len(e4m3)} on E4M3 operands; first: {e4m3[0] if e4m3 else None}")
    assert e4m3, "fp8_matmul: no warpgroup MMA on E4M3 operands in the SASS"


def _check_flash_build(logs: dict) -> None:
    """K5's build: ptxas must report no spill in any of its kernels, and
    the registers of the tensor-core kernel (``flash_tc_kernel``, one
    instantiation per head dim) are logged; the library's SASS must hold
    bf16 warpgroup MMAs (``HGMMA ... .BF16``), the tensor-core route.

    Raises:
      AssertionError: a spill, or no bf16 warpgroup MMA in the SASS."""
    text = logs["flash_attention"]
    spills = [int(n) for n in re.findall(r"(\d+) bytes spill", text)]
    assert spills and not any(spills), \
        f"flash_attention: ptxas reports spills {spills}"
    entry, regs = "", {}
    for ln in text.splitlines():
        if "Compiling entry function" in ln:
            entry = ln
        elif "registers" in ln and "flash_tc_kernel" in entry:
            d = re.search(r"flash_tc_kernelILi(\d+)E", entry)
            regs[int(d.group(1))] = re.search(r"Used (\d+) registers",
                                              ln).group(1)
    log("build", "flash_attention tensor cores, registers by head dim: "
        + ", ".join(f"d={d}: {r}" for d, r in sorted(regs.items())))
    sass = _sass("flash_attention")
    hgmma = sorted({m for m in re.findall(r"\bHGMMA\.[\w.]+", sass)
                    if m.endswith(".BF16")})
    log("build", f"flash_attention SASS: bf16 warpgroup MMAs {hgmma}")
    assert hgmma, "flash_attention: no bf16 warpgroup MMA in the SASS"


def _ptxas_entries(text: str) -> dict:
    """Each entry function of a ptxas ``-v`` report, by mangled name:
    its registers and its spill bytes (stores, loads)."""
    entries, entry, props = {}, None, None
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            entry = m.group(1)
            entries.setdefault(entry, {"regs": None, "spill": (0, 0)})
            continue
        m = re.search(r"Function properties for (\w+)", ln)
        if m:
            props = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and props in entries:
            entries[props]["spill"] = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and entry is not None:
            entries[entry]["regs"] = int(m.group(1))
    return entries


_MANGLED_TYPES = {"f": "f32", "13__nv_bfloat16": "bf16", "h": "uint8",
                  "a": "int8"}


def _decode_instantiation(name: str):
    """``(q type, storage type, E, layout, MG)`` of a mangled
    ``repro_decode::decode_kernel<QT, KT, E, Addr, MG>``, or None for
    another function.  A storage type equal to bf16 q is mangled as a
    substitution (``S1_``); only bf16 is substituted (f32 is a builtin)."""
    m = re.search(r"decode_kernelI(f|13__nv_bfloat16)"
                  r"(f|13__nv_bfloat16|S\d*_|h|a)Li(\d+)E.*?"
                  r"(PagedAddr|DenseAddr)ELi(\d+)E", name)
    if m is None:
        return None
    q, kv, e, addr, mg = m.groups()
    kv = "bf16" if kv.startswith("S") else _MANGLED_TYPES[kv]
    return _MANGLED_TYPES[q], kv, int(e), addr, int(mg)


def group_arrays(g: int) -> int:
    """MG, the group size the register arrays of group g are sized for."""
    return 1 if g <= 1 else 2 if g <= 2 else 4 if g <= 4 else 8


def serving_decode_instantiations() -> set:
    """The decode-kernel instantiations the serving paths of this script
    run, by library: at qwen3-1.7b's head dim and group, bf16 queries over
    the bf16, fp8 (uint8 bits) and int8 pools and f32 over an f32 pool
    (phase f32) in the paged library, bf16 and f32 caches in the dense;
    at llama3-8b's group of 4 (phase fleet, the same head dim), bf16
    queries over its bf16 and fp8 pools in the paged library."""
    from repro_torch.kernels import decode_attention as da
    e = da.lane_elems(HEAD_DIM)
    mg, mg_llama = group_arrays(H // KVH), group_arrays(LLAMA_H // KVH)
    paged = [("bf16", kv, mg) for kv in ("bf16", "uint8", "int8")]
    paged += [("f32", "f32", mg), ("bf16", "bf16", mg_llama),
              ("bf16", "uint8", mg_llama)]
    dense = [("bf16", "bf16", mg), ("f32", "f32", mg)]
    return ({(lib, (q, kv, e, addr, g))
             for lib, addr, insts in (
                 ("paged_decode_attention", "PagedAddr", paged),
                 ("decode_attention", "DenseAddr", dense))
             for q, kv, g in insts})


def _check_decode_build(logs: dict) -> None:
    """K1/K2's and K4's builds: every instantiation of the shared decode
    kernel is read from ptxas's report by name, and none may spill: the
    phases of this script launch instantiations of every head dim (E),
    group (MG) and storage type, and the wrappers reach all of them.  In
    the SASS of the serving instantiations (``serving_decode_
    instantiations``) the loads are counted by width (a lane reads its
    4 bf16 elements of a K/V row as one 64-bit load).

    Raises:
      AssertionError: an entry that is not a decode kernel, a serving
          instantiation missing from the report, or any that spills."""
    serving = serving_decode_instantiations()
    spills = []
    for lib in DECODE_LIBS:
        found = {}
        for name, ent in _ptxas_entries(logs[lib]).items():
            inst = _decode_instantiation(name)
            assert inst is not None, f"{lib}: unexpected entry {name}"
            found[inst] = dict(ent, name=name)
        spilled = sorted(i for i, ent in found.items() if any(ent["spill"]))
        regs = sorted(ent["regs"] for ent in found.values())
        log("build", f"{lib}: {len(found)} instantiations, {len(spilled)} "
            f"spill; registers {regs[0]}-{regs[-1]}")
        for i in spilled:
            ent = found[i]
            log("build", f"{lib}: spill {ent['spill'][0]}/{ent['spill'][1]} "
                f"bytes (stores/loads) at {ent['regs']} registers: q {i[0]}, "
                f"storage {i[1]}, E={i[2]}, {i[3]}, MG={i[4]}")
            spills.append((lib, i))
        mine = sorted(i for lb, i in serving if lb == lib)
        for i in mine:
            assert i in found, f"{lib}: no instantiation {i} in the report"
        sass = _sass_functions(lib, {found[i]["name"] for i in mine})
        for i in mine:
            ent = found[i]
            loads = Counter(re.findall(r"\bLDG\.[\w.]+", sass[ent["name"]]))
            log("build", f"{lib} serving instantiation q {i[0]}, storage "
                f"{i[1]}, E={i[2]}, MG={i[4]}: {ent['regs']} registers; "
                f"loads {dict(sorted(loads.items()))}")
    assert not spills, f"decode instantiations spill: {spills}"


def _sass_functions(lib: str, names: set) -> dict:
    """The SASS of the named functions of ``csrc/<lib>.cu``'s library."""
    out, cur = {}, None
    for ln in _sass(lib).splitlines():
        m = re.search(r"Function : (\w+)", ln)
        if m:
            cur = m.group(1) if m.group(1) in names else None
            if cur is not None:
                out[cur] = ""
        elif cur is not None:
            out[cur] += ln + "\n"
    missing = names - set(out)
    assert not missing, f"{lib}: no SASS for {sorted(missing)}"
    return out


def _paged_inputs(gen: torch.Generator, seat_lengths=SEAT_LENGTHS):
    """Seats of ``seat_lengths`` tokens (8 at the serving shapes) in
    tables of N_TABLE pages, pages scattered over the pool."""
    need = [-(-n // PAGE) for n in seat_lengths]
    P = 1 + sum(need)
    perm = (torch.randperm(P - 1, generator=gen, device="cuda") + 1).int()
    table = torch.zeros((len(need), N_TABLE), dtype=torch.int32,
                        device="cuda")
    at = 0
    for a, k in enumerate(need):
        table[a, :k] = perm[at:at + k]
        at += k
    lengths = torch.tensor(seat_lengths, dtype=torch.int32, device="cuda")
    q = torch.randn((len(need), 1, H, HEAD_DIM), generator=gen,
                    device="cuda").bfloat16()
    return P, table, lengths, q


def phase_kernels(flush: torch.Tensor) -> dict:
    from repro_torch.core.mixed_precision import quantize_kv_page
    from repro_torch.kernels import ops
    gen = torch.Generator(device="cuda").manual_seed(1)
    P, table, lengths, q = _paged_inputs(gen)
    valid = sum(SEAT_LENGTHS)
    A = len(SEAT_LENGTHS)
    results = {}

    shape = (P, PAGE, KVH, HEAD_DIM)
    pools = {"bf16": (torch.randn(shape, generator=gen, device="cuda")
                      .bfloat16(), torch.randn(shape, generator=gen,
                                               device="cuda").bfloat16(),
                      None, None)}
    for dt in ("fp8", "int8"):
        kq, ks = quantize_kv_page(
            torch.randn(shape, generator=gen, device="cuda"), dt)
        vq, vs = quantize_kv_page(
            torch.randn(shape, generator=gen, device="cuda"), dt)
        pools[dt] = (kq, vq, ks, vs)

    # yardstick: SDPA on the already-gathered cache (gather, dequantize
    # and GQA expansion excluded), every seat padded to 2048 keys
    t = torch.arange(N_TABLE * PAGE, device="cuda")
    mask = (t[None, :] < lengths[:, None].long())[:, None, None, :]
    qs = q.transpose(1, 2)                                 # (A, H, 1, d)

    for dt, (k, v, ks, vs) in pools.items():
        name = ("paged_decode_attention" if ks is None
                else "quantized_paged_decode_attention")

        def run(impl, k=k, v=v, ks=ks, vs=vs):
            return ops.paged_decode_attention(q, k, v, table, lengths,
                                              k_scale=ks, v_scale=vs,
                                              impl=impl)
        got = run("kernel")
        torch.cuda.synchronize()
        want = run("plain")
        err = check_close(f"{name}[{dt}]", got, want, BF16_ATOL, BF16_RTOL)
        ms = cuda_ms(lambda: run("kernel"), flush)
        plain_ms = cuda_ms(lambda: run("plain"), flush, iters=5)

        pt = table.long()
        if ks is None:
            kg, vg = k[pt], v[pt]
        else:
            from repro_torch.core.mixed_precision import dequantize_kv_page
            kg = dequantize_kv_page(k[pt], ks[pt]).bfloat16()
            vg = dequantize_kv_page(v[pt], vs[pt]).bfloat16()
        kg = kg.reshape(A, -1, KVH, HEAD_DIM).transpose(1, 2)
        vg = vg.reshape(A, -1, KVH, HEAD_DIM).transpose(1, 2)
        kg = kg.repeat_interleave(H // KVH, dim=1).contiguous()
        vg = vg.repeat_interleave(H // KVH, dim=1).contiguous()
        lib_ms = cuda_ms(lambda: sdpa(SDPBackend.EFFICIENT_ATTENTION, qs, kg,
                                      vg, attn_mask=mask), flush)

        item = k.element_size()
        nbytes = (2 * valid * KVH * HEAD_DIM * item
                  + (2 * valid * KVH * 4 if ks is not None else 0)
                  + 2 * q.numel() * q.element_size()
                  + table.numel() * 4 + lengths.numel() * 4)
        b_ms, b_by = bound(nbytes, 4.0 * valid * H * HEAD_DIM)
        log("kernels", f"{name}[{dt}] max|err| {err:.3e} kernel {ms:.4f} ms "
            f"plain {plain_ms:.4f} ms {SDPA_EFF} {lib_ms:.4f} ms bound "
            f"{b_ms:.4f} ms ({b_by}, {nbytes / 1e6:.2f} MB)")
        results[f"{name}[{dt}]"] = dict(
            name=name, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
            library=SDPA_EFF)

    # every shape K3 takes on the serving path: ln1/ln2/final at D=2048,
    # q-norm (x H) and k-norm (x KVH) at D=128, over A decode rows or
    # PREFILL_CHUNK prefill rows; the decode shapes of ln and q-norm are
    # timed, the others checked only
    for rows, d, timed in ((A, 2048, True), (A * H, HEAD_DIM, True),
                           (A * KVH, HEAD_DIM, False),
                           (PREFILL_CHUNK, 2048, False),
                           (PREFILL_CHUNK * H, HEAD_DIM, False),
                           (PREFILL_CHUNK * KVH, HEAD_DIM, False)):
        x = torch.randn((rows, d), generator=gen, device="cuda").bfloat16()
        w = 0.1 * torch.randn((d,), generator=gen, device="cuda")
        got = ops.rmsnorm(x, w, impl="kernel")
        torch.cuda.synchronize()
        err = check_close(f"rmsnorm[D={d}, M={rows}]", got,
                          ops.rmsnorm(x, w, impl="plain"),
                          BF16_ATOL, BF16_RTOL)
        if not timed:
            log("kernels", f"rmsnorm[D={d}, M={rows}] max|err| {err:.3e}")
            continue
        w_lib = (1.0 + w).bfloat16()
        ms = cuda_ms(lambda: ops.rmsnorm(x, w, impl="kernel"), flush)
        plain_ms = cuda_ms(lambda: ops.rmsnorm(x, w, impl="plain"), flush)
        lib_ms = cuda_ms(lambda: F.rms_norm(x, (d,), weight=w_lib, eps=1e-6),
                         flush)
        b_ms, b_by = bound(2 * x.numel() * 2 + d * 4, 4.0 * x.numel())
        log("kernels", f"rmsnorm[D={d}, M={rows}] max|err| {err:.3e} "
            f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms F.rms_norm "
            f"{lib_ms:.4f} ms bound {b_ms:.5f} ms ({b_by})")
        results[f"rmsnorm[D={d}]"] = dict(
            name="rmsnorm", max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
            library="F.rms_norm")
    results.update(_norm_kernels(gen, flush))
    _paged_split_edges(gen)
    results.update(_dense_decode_kernel(gen, flush))
    _dense_split_edges(gen)
    results.update(_flash_kernel(gen, flush))
    return results


def _paged_split_edges(gen: torch.Generator) -> None:
    """K1/K2 with every pool type at the edges of the split-K plan of the
    timed shape (8 seats, 8 kv heads, a table of N_TABLE pages): lengths
    chunk - 1, chunk and chunk + 1, seats whose later splits are all empty
    (1, 17), 2·chunk + 1, 3·chunk - 1 and the full table, each against the
    plain version; after the launches every ticket must be back at 0."""
    from repro_torch.core.mixed_precision import quantize_kv_page
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ops
    splits, chunk = da.split_plan(len(SEAT_LENGTHS), KVH, N_TABLE * PAGE,
                                  _sms())
    lens = (chunk - 1, chunk, chunk + 1, 1, 2 * chunk + 1, N_TABLE * PAGE,
            17, 3 * chunk - 1)
    P, table, lengths, q = _paged_inputs(gen, lens)
    shape = (P, PAGE, KVH, HEAD_DIM)
    for dt in ("bf16", "fp8", "int8"):
        k = torch.randn(shape, generator=gen, device="cuda")
        v = torch.randn(shape, generator=gen, device="cuda")
        ks = vs = None
        if dt == "bf16":
            k, v = k.bfloat16(), v.bfloat16()
        else:
            (k, ks), (v, vs) = (quantize_kv_page(k, dt),
                                quantize_kv_page(v, dt))
        got, want = (ops.paged_decode_attention(
            q, k, v, table, lengths, k_scale=ks, v_scale=vs, impl=impl)
            for impl in ("kernel", "plain"))
        torch.cuda.synchronize()
        err = check_close(f"paged split edges[{dt}]", got, want, BF16_ATOL,
                          BF16_RTOL)
        tickets = da._tickets[q.device]
        assert not bool(tickets.any()), \
            f"paged split edges[{dt}]: tickets left at {tickets.nonzero()}"
        log("kernels", f"paged decode split edges [{dt}]: {splits} splits "
            f"of {chunk} tokens, lengths {lens}: max|err| {err:.3e}; "
            "tickets back at 0")


def _dense_decode_kernel(gen: torch.Generator, flush: torch.Tensor) -> dict:
    """K4 at the fixed-slot decode shapes: 8 slots of MAX_LEN + 1 keys,
    lengths SLOT_LENGTHS (the last an idle slot on the scratch index),
    split over the cache width as ``split_plan`` says."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ops
    B, T = len(SLOT_LENGTHS), MAX_LEN + 1
    lengths = torch.tensor(SLOT_LENGTHS, dtype=torch.int32, device="cuda")
    q = torch.randn((B, 1, H, HEAD_DIM), generator=gen,
                    device="cuda").bfloat16()
    k = torch.randn((B, T, KVH, HEAD_DIM), generator=gen,
                    device="cuda").bfloat16()
    v = torch.randn((B, T, KVH, HEAD_DIM), generator=gen,
                    device="cuda").bfloat16()

    def run(impl):
        return ops.decode_attention(q, k, v, lengths, impl=impl)
    got = run("kernel")
    torch.cuda.synchronize()
    err = check_close("decode_attention[bf16]", got, run("plain"),
                      BF16_ATOL, BF16_RTOL)
    ms = cuda_ms(lambda: run("kernel"), flush)
    plain_ms = cuda_ms(lambda: run("plain"), flush, iters=5)
    # yardstick: SDPA on the GQA-expanded cache (expansion excluded)
    kg = k.transpose(1, 2).repeat_interleave(H // KVH, dim=1).contiguous()
    vg = v.transpose(1, 2).repeat_interleave(H // KVH, dim=1).contiguous()
    mask = (torch.arange(T, device="cuda")[None, :]
            < lengths[:, None].long())[:, None, None, :]
    qs = q.transpose(1, 2)
    lib_ms = cuda_ms(lambda: sdpa(SDPBackend.EFFICIENT_ATTENTION, qs, kg, vg,
                                  attn_mask=mask), flush)
    valid = sum(SLOT_LENGTHS)
    nbytes = (2 * valid * KVH * HEAD_DIM * 2 + 2 * q.numel() * 2
              + lengths.numel() * 4)
    b_ms, b_by = bound(nbytes, 4.0 * valid * H * HEAD_DIM)
    splits, chunk = da.split_plan(B, KVH, T, _sms())
    log("kernels", f"decode_attention[bf16] max|err| {err:.3e} kernel "
        f"{ms:.4f} ms plain {plain_ms:.4f} ms {SDPA_EFF} {lib_ms:.4f} ms "
        f"bound {b_ms:.5f} ms ({b_by}, {nbytes / 1e6:.2f} MB; idle slot "
        f"walks {MAX_LEN + 1} of {valid} keys; {splits} splits of {chunk})")
    # the cost of the idle slots' scratch-index walk at a wave's tail: 4
    # short live slots beside 4 idle ones, which walk their whole cache
    # (the reference's mask) or, for comparison only, one key
    tail = []
    for idle_len in (MAX_LEN + 1, 1):
        lens = torch.tensor((97, 120, 131, 142) + (idle_len,) * 4,
                            dtype=torch.int32, device="cuda")
        tail.append(cuda_ms(lambda: ops.decode_attention(
            q, k, v, lens, impl="kernel"), flush))
    log("kernels", f"decode_attention[bf16] wave tail (live 97-142 keys, "
        f"4 idle slots): {tail[0]:.4f} ms with the idle slots walking "
        f"{MAX_LEN + 1} keys, {tail[1]:.4f} ms if they walked 1")
    return {"decode_attention[bf16]": dict(
        name="decode_attention", max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms, library=SDPA_EFF)}


def _dense_split_edges(gen: torch.Generator) -> None:
    """K4 with bf16 and f32 caches at the edges of the split-K plan of
    the fixed-slot shape (8 slots, 8 kv heads, MAX_LEN + 1 keys): lengths
    chunk - 1, chunk and chunk + 1, slots whose later splits are all
    empty (1, 17), 2·chunk + 1, 3·chunk - 1 and an idle slot walking the
    whole cache, each against the plain version at the tolerance of its
    dtype; after the launches every ticket must be back at 0."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ops
    B, T = 8, MAX_LEN + 1
    splits, chunk = da.split_plan(B, KVH, T, _sms())
    lens = (chunk - 1, chunk, chunk + 1, 1, 2 * chunk + 1, T, 17,
            3 * chunk - 1)
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    for dt, tol in ((torch.bfloat16, (BF16_ATOL, BF16_RTOL)),
                    (torch.float32, F32_TOL)):
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dt)
                   for shape in ((B, 1, H, HEAD_DIM), (B, T, KVH, HEAD_DIM),
                                 (B, T, KVH, HEAD_DIM)))
        got, want = (ops.decode_attention(q, k, v, lengths, impl=impl)
                     for impl in ("kernel", "plain"))
        torch.cuda.synchronize()
        err = check_close(f"dense split edges[{dt}]", got, want, *tol)
        tickets = da._tickets[q.device]
        assert not bool(tickets.any()), \
            f"dense split edges[{dt}]: tickets left at {tickets.nonzero()}"
        log("kernels", f"dense decode split edges [{dt}]: {splits} splits of "
            f"{chunk} tokens, lengths {lens}: max|err| {err:.3e}; tickets "
            "back at 0")


def _norm_kernels(gen: torch.Generator, flush: torch.Tensor) -> dict:
    """K3's fused forms against their plain versions, bf16: ``add_rmsnorm``
    at the decode rows (M = 8, D = 2048) and the prefill-chunk rows (M =
    PREFILL_CHUNK), where ``s`` must be bit-equal to torch's own add and
    the norm within the bf16 tolerance; ``rmsnorm_qk`` at the decode
    rows (q 8·H and k 8·KVH rows of D = 128) and the prefill-chunk rows.
    The decode shapes are timed beside K3 on the same rows (for q and k,
    the two K3 launches they replace, each timed alone and summed) with
    their bound; no single PyTorch call computes either, so no library
    time."""
    from repro_torch.kernels import ops
    out = {}
    for rows, timed in ((len(SEAT_LENGTHS), True), (PREFILL_CHUNK, False)):
        x, y = (torch.randn((rows, D_MODEL), generator=gen,
                            device="cuda").bfloat16() for _ in range(2))
        w = 0.1 * torch.randn((D_MODEL,), generator=gen, device="cuda")
        (s, n), (s_p, n_p) = (ops.add_rmsnorm(x, y, w, impl=impl)
                              for impl in ("kernel", "plain"))
        torch.cuda.synchronize()
        same = (s.view(torch.int16) == (x + y).view(torch.int16)).all()
        assert bool(same) and torch.equal(s_p, x + y), \
            f"add_rmsnorm[M={rows}]: s is not bit-equal to x + y"
        err = check_close(f"add_rmsnorm[D={D_MODEL}, M={rows}]", n, n_p,
                          BF16_ATOL, BF16_RTOL)
        if not timed:
            log("kernels", f"add_rmsnorm[D={D_MODEL}, M={rows}] s bit-equal, "
                f"max|err| {err:.3e}")
            continue
        ms = cuda_ms(lambda: ops.add_rmsnorm(x, y, w, impl="kernel"), flush)
        plain_ms = cuda_ms(lambda: ops.add_rmsnorm(x, y, w, impl="plain"),
                           flush)
        k3_ms = cuda_ms(lambda: ops.rmsnorm(x, w, impl="kernel"), flush)
        # read x, y and w, write s and the norm; add, square, sum, scale
        # and weight per element
        b_ms, b_by = bound(4 * x.numel() * 2 + D_MODEL * 4, 5.0 * x.numel())
        log("kernels", f"add_rmsnorm[D={D_MODEL}, M={rows}] s bit-equal, "
            f"max|err| {err:.3e} kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
            f"(K3 alone on the same rows {k3_ms:.4f} ms) bound {b_ms:.5f} ms "
            f"({b_by})")
        out[f"add_rmsnorm[D={D_MODEL}]"] = dict(
            name="add_rmsnorm", max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, library_ms=None, library=None)
    for rows, timed in ((len(SEAT_LENGTHS), True), (PREFILL_CHUNK, False)):
        q = torch.randn((rows, H, HEAD_DIM), generator=gen,
                        device="cuda").bfloat16()
        k = torch.randn((rows, KVH, HEAD_DIM), generator=gen,
                        device="cuda").bfloat16()
        wq, wk = (0.1 * torch.randn((HEAD_DIM,), generator=gen,
                                    device="cuda") for _ in range(2))
        (qn, kn), (qp, kp) = (ops.rmsnorm_qk(q, k, wq, wk, impl=impl)
                              for impl in ("kernel", "plain"))
        torch.cuda.synchronize()
        tag = f"rmsnorm_qk[D={HEAD_DIM}, q {rows * H} + k {rows * KVH} rows]"
        err = max(check_close(tag + " q", qn, qp, BF16_ATOL, BF16_RTOL),
                  check_close(tag + " k", kn, kp, BF16_ATOL, BF16_RTOL))
        if not timed:
            log("kernels", f"{tag} max|err| {err:.3e}")
            continue
        ms = cuda_ms(lambda: ops.rmsnorm_qk(q, k, wq, wk, impl="kernel"),
                     flush)
        plain_ms = cuda_ms(lambda: ops.rmsnorm_qk(q, k, wq, wk,
                                                  impl="plain"), flush)
        k3_ms = (cuda_ms(lambda: ops.rmsnorm(q, wq, impl="kernel"), flush)
                 + cuda_ms(lambda: ops.rmsnorm(k, wk, impl="kernel"), flush))
        elems = q.numel() + k.numel()
        b_ms, b_by = bound(2 * elems * 2 + 2 * HEAD_DIM * 4, 4.0 * elems)
        log("kernels", f"{tag} max|err| {err:.3e} kernel {ms:.4f} ms plain "
            f"{plain_ms:.4f} ms (K3 on q and K3 on k, the sum of the two "
            f"kernels' times, {k3_ms:.4f} ms) bound {b_ms:.5f} ms ({b_by})")
        out[f"rmsnorm_qk[D={HEAD_DIM}]"] = dict(
            name="rmsnorm_qk", max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, library_ms=None, library=None)
    return out


def _flash_kernel(gen: torch.Generator, flush: torch.Tensor) -> dict:
    """K5 at the prefill shapes: one causal prompt of PREFILL_S tokens
    timed; 64 and 37 tokens checked."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    assert fa.route(torch.bfloat16, HEAD_DIM) == "tensor cores", \
        "the prefill shape does not take the tensor-core route"
    out = {}
    for S in (PREFILL_S, 64, 37):
        q = torch.randn((1, S, H, HEAD_DIM), generator=gen,
                        device="cuda").bfloat16()
        k = torch.randn((1, S, KVH, HEAD_DIM), generator=gen,
                        device="cuda").bfloat16()
        v = torch.randn((1, S, KVH, HEAD_DIM), generator=gen,
                        device="cuda").bfloat16()

        def run(impl, q=q, k=k, v=v):
            return ops.flash_attention(q, k, v, causal=True, impl=impl)
        got = run("kernel")
        torch.cuda.synchronize()
        err = check_close(f"flash_attention[causal, S={S}]", got,
                          run("plain"), BF16_ATOL, BF16_RTOL)
        if S != PREFILL_S:
            log("kernels", f"flash_attention[causal, S={S}] max|err| "
                f"{err:.3e}")
            continue
        ms = cuda_ms(lambda: run("kernel"), flush)
        plain_ms = cuda_ms(lambda: run("plain"), flush, iters=5)
        qs = q.transpose(1, 2).contiguous()
        kg = k.transpose(1, 2).repeat_interleave(H // KVH, dim=1).contiguous()
        vg = v.transpose(1, 2).repeat_interleave(H // KVH, dim=1).contiguous()
        lib_ms = cuda_ms(lambda: sdpa(SDPBackend.FLASH_ATTENTION, qs, kg, vg,
                                      is_causal=True), flush)
        nbytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())
        kept = S * (S + 1) // 2
        b_ms, b_by = bound(nbytes, 4.0 * HEAD_DIM * H * kept, BF16_FLOPS)
        log("kernels", f"flash_attention[causal, S={S}] max|err| {err:.3e} "
            f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms {SDPA_FLASH} "
            f"{lib_ms:.4f} ms bound {b_ms:.5f} ms ({b_by}, "
            f"{nbytes / 1e6:.2f} MB, {4.0 * HEAD_DIM * H * kept / 1e9:.2f} "
            "GFLOP at the bf16 tensor-core rate)")
        out["flash_attention[causal]"] = dict(
            name="flash_attention", max_abs_err=err, ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=lib_ms, library=SDPA_FLASH)
    return out


def phase_variants() -> None:
    """The kernels against their plain versions off the main path's
    shapes: f32 queries and pools, GQA groups 1 and 4 (llama3-8b),
    smaller head dims (the reduced configs), f32 RMSNorm."""
    from repro_torch.core.mixed_precision import quantize_kv_page
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    gen = torch.Generator(device="cuda").manual_seed(3)
    cases = [  # (H, KVH, d, q dtype, pool)
        (16, 8, 128, torch.float32, "f32"), (16, 8, 128, torch.bfloat16, "f32"),
        (32, 8, 128, torch.bfloat16, "bf16"), (8, 8, 64, torch.float32, "fp8"),
        (4, 4, 16, torch.float32, "int8"), (4, 2, 16, torch.float32, "bf16")]
    lengths = torch.tensor([1, 9, 64, 200], dtype=torch.int32, device="cuda")
    n = 16
    table = (torch.randperm(4 * n, generator=gen, device="cuda") + 1).int()
    table = table.reshape(4, n)
    for H_, KVH_, d, qdt, pool in cases:
        q = torch.randn((4, 1, H_, d), generator=gen, device="cuda").to(qdt)
        shape = (4 * n + 1, PAGE, KVH_, d)
        k = torch.randn(shape, generator=gen, device="cuda")
        v = torch.randn(shape, generator=gen, device="cuda")
        ks = vs = None
        if pool in ("fp8", "int8"):
            (k, ks), (v, vs) = (quantize_kv_page(k, pool),
                                quantize_kv_page(v, pool))
        elif pool == "bf16":
            k, v = k.bfloat16(), v.bfloat16()
        got, want = (ops.paged_decode_attention(
            q, k, v, table, lengths, k_scale=ks, v_scale=vs, impl=impl)
            for impl in ("kernel", "plain"))
        tol = F32_TOL if qdt == torch.float32 else (BF16_ATOL, BF16_RTOL)
        err = check_close(f"paged[H={H_},KVH={KVH_},d={d},{qdt},{pool}]",
                          got, want, *tol)
        log("variants", f"paged decode H={H_} KVH={KVH_} d={d} q={qdt} "
            f"pool={pool}: max|err| {err:.3e}")
    for d in (64, 2048):
        x = torch.randn((5, d), generator=gen, device="cuda")
        w = torch.randn((d,), generator=gen, device="cuda")
        err = check_close(f"rmsnorm[f32,D={d}]",
                          ops.rmsnorm(x, w, impl="kernel"),
                          ops.rmsnorm(x, w, impl="plain"), *F32_TOL)
        log("variants", f"rmsnorm f32 D={d}: max|err| {err:.3e}")
    dense = [  # (B, T, H, KVH, d, q dtype, cache dtype)
        (4, 37, 4, 2, 16, torch.float32, torch.float32),
        (3, 160, 8, 2, 64, torch.float32, torch.float32),
        (3, 96, 4, 1, 32, torch.bfloat16, torch.bfloat16),
        (4, 255, 32, 8, 128, torch.bfloat16, torch.bfloat16),
        (2, 545, 16, 8, 128, torch.float32, torch.bfloat16),
        (2, 100, 8, 8, 256, torch.float32, torch.float32)]
    for B, T, H_, KVH_, d, qdt, kdt in dense:
        q = torch.randn((B, 1, H_, d), generator=gen, device="cuda").to(qdt)
        k = torch.randn((B, T, KVH_, d), generator=gen, device="cuda").to(kdt)
        v = torch.randn((B, T, KVH_, d), generator=gen, device="cuda").to(kdt)
        lengths = torch.randint(1, T + 1, (B,), generator=gen, device="cuda",
                                dtype=torch.int32)
        got, want = (ops.decode_attention(q, k, v, lengths, impl=impl)
                     for impl in ("kernel", "plain"))
        tol = F32_TOL if qdt == torch.float32 else (BF16_ATOL, BF16_RTOL)
        err = check_close(f"dense[B={B},T={T},H={H_},KVH={KVH_},d={d},"
                          f"{qdt},{kdt}]", got, want, *tol)
        log("variants", f"dense decode T={T} H={H_} KVH={KVH_} d={d} "
            f"q={qdt} cache={kdt}: max|err| {err:.3e}")
    flash = [  # (B, Sq, Skv, H, KVH, d, dtype, causal, window)
        (2, 100, 100, 16, 8, 128, torch.float32, True, None),
        (1, 511, 511, 16, 8, 128, torch.bfloat16, True, 128),
        (2, 77, 77, 8, 2, 64, torch.float32, True, 32),
        (2, 64, 64, 4, 4, 32, torch.float32, False, None),
        (2, 96, 200, 4, 1, 32, torch.bfloat16, False, None),
        (1, 37, 37, 4, 2, 16, torch.float32, True, None),
        (1, 300, 300, 4, 4, 256, torch.bfloat16, True, None)]
    for B, Sq, Skv, H_, KVH_, d, dt, causal, window in flash:
        q = torch.randn((B, Sq, H_, d), generator=gen, device="cuda").to(dt)
        k = torch.randn((B, Skv, KVH_, d), generator=gen, device="cuda").to(dt)
        v = torch.randn((B, Skv, KVH_, d), generator=gen, device="cuda").to(dt)
        got, want = (ops.flash_attention(q, k, v, causal=causal,
                                         window=window, impl=impl)
                     for impl in ("kernel", "plain"))
        tol = F32_TOL if dt == torch.float32 else (BF16_ATOL, BF16_RTOL)
        err = check_close(f"flash[B={B},Sq={Sq},Skv={Skv},H={H_},"
                          f"KVH={KVH_},d={d},{dt},causal={causal},"
                          f"window={window}]", got, want, *tol)
        log("variants", f"flash Sq={Sq} Skv={Skv} H={H_} KVH={KVH_} d={d} "
            f"{dt} causal={causal} window={window} "
            f"({fa.route(dt, d)}): max|err| {err:.3e}")
    torch.cuda.synchronize()


def norm_launches(cfg, steps: int) -> dict:
    """The norm kernels' launches over ``steps`` model steps: per step
    layer 0's ln1 alone (K3), per layer the attention add fused into ln2
    and the MLP add into the next ln1 or the final norm (``add_rmsnorm``),
    and, in a model with qk-norm, the q- and k-norm in one launch
    (``rmsnorm_qk``)."""
    L = cfg.num_layers
    out = {f"rmsnorm[D={cfg.d_model}]": steps,
           f"add_rmsnorm[D={cfg.d_model}]": 2 * L * steps}
    if cfg.qk_norm:
        out[f"rmsnorm_qk[D={cfg.head_dim}]"] = L * steps
    return out


def _check_run(tag: str, r: dict, cfg, counts: dict,
               phase: str = "serve") -> None:
    """Checks one serving run with a ``tag`` pool against the kernel
    launches ``counts`` read just after it."""
    eng = r["engine"]
    kernel = ("paged_decode_attention" if tag == "bf16"
              else "quantized_paged_decode_attention") + f"[{tag}]"
    done = r["finished"]
    assert len(done) == 16, f"{tag}: {len(done)} of 16 requests finished"
    for req in done:
        assert len(req.generated) == req.max_new_tokens == 32, (tag, req.rid)
        assert all(0 <= t < cfg.vocab_size for t in req.generated), \
            f"{tag}: rid {req.rid} emitted a token outside the vocabulary"
    assert bool(eng.policy.logits_finite), f"{tag}: a logit was not finite"
    ticks = eng.policy.decode_ticks
    chunks = sum(1 for _, ev, _ in eng.trace if ev == "prefill_chunk")
    # the attention kernel of the pool once per layer per decode tick;
    # per model step (decode tick or prefill chunk) the norms
    L, steps = cfg.num_layers, ticks + chunks
    want = {kernel: ticks * L, **norm_launches(cfg, steps)}
    assert counts == want, \
        f"{tag}: launches {counts}, expected {want} for {ticks} decode " \
        f"ticks and {chunks} prefill chunks"
    m = r["metrics"]
    log(phase, f"{tag}: {m['completed']:.0f} requests "
        f"{m['generated_tokens']:.0f} tokens, {ticks} decode ticks, "
        f"{chunks} prefill chunks, {m['tokens_per_s']:.1f} tokens/s, "
        f"mean TTFT {m['ttft_avg_s'] * 1e3:.1f} ms, wall "
        f"{m['wall_s']:.2f} s; launches {json.dumps(dict(counts))}")


def _tick_state(eng):
    """A decode state of every seat of ``eng`` at spread positions, on
    pages of its pool (their contents are what serving left there)."""
    pol = eng.policy
    A = pol.max_seats
    gen = torch.Generator(device="cuda").manual_seed(2)
    pages = (torch.randperm(pol.bm.capacity, generator=gen,
                            device="cuda")[:A * pol.n_tables] + 1).int()
    return dict(
        last=torch.randint(0, eng.cfg.vocab_size, (A,), generator=gen,
                           device="cuda", dtype=torch.int32),
        pos=torch.linspace(40, pol.n_tables * PAGE - 2, A).int().cuda(),
        table=pages.reshape(A, pol.n_tables),
        nv=torch.ones(A, dtype=torch.int32, device="cuda"),
        temp=torch.zeros(A, device="cuda"),
        top_k=torch.zeros(A, dtype=torch.int32, device="cuda"),
        top_p=torch.ones(A, device="cuda"),
        seed=torch.zeros(A, dtype=torch.int64, device="cuda"),
        rid=torch.arange(A, dtype=torch.int64, device="cuda"),
        step=torch.zeros(A, dtype=torch.int64, device="cuda"))


def _tick(eng, cache, state, impl, params=None, cfg=None):
    """One fused tick of ``eng``'s model (or of ``params``/``cfg``) from
    a copy of ``state`` over ``cache``; returns (tokens, logits)."""
    from repro_torch.models import model as M
    s = {k: t.clone() for k, t in state.items()}
    return M.fused_decode_tick(
        eng.policy.params if params is None else params,
        eng.cfg if cfg is None else cfg, cache, s["last"], s["pos"],
        s["table"], s["nv"], s["temp"], s["top_k"], s["top_p"], s["seed"],
        s["rid"], s["step"], impl=impl)


def _clone(cache):
    return {p: {k: t.clone() for k, t in ent.items()}
            for p, ent in cache.items()}


def _check_logits(phase: str, what: str, lk: torch.Tensor,
                  lp: torch.Tensor) -> float:
    """Holds one model step's (rows, V) logits with the kernels ``lk``
    against the plain versions' ``lp``; returns max |difference|."""
    assert bool(torch.isfinite(lk).all()) and bool(torch.isfinite(lp).all())
    diff = (lk - lp).abs().max().item()
    scale = lp.abs().max().item()
    # bf16 rounding differences of the kernels compound over 28 layers:
    # allow 5% of the largest logit
    assert diff <= 0.05 * scale + 1e-3, \
        f"{what}: logits kernel vs plain differ by {diff:.3e} (largest " \
        f"logit {scale:.3e})"
    same = int((lk.argmax(-1) == lp.argmax(-1)).sum())
    log(phase, f"{what} kernel vs plain: max|Δlogit| {diff:.3e} (largest "
        f"|logit| {scale:.3e}), greedy tokens equal {same}/{len(lk)}")
    return diff


SERVING_GROUPS = (("norm kernels (K3 and its fused forms)",
                   lambda key: "rmsnorm" in key),
                  ("decode attention (K1/K2/K4)",
                   lambda key: "decode_kernel" in key))


def _profile_steady(phase: str, what: str, step, steps: int = 5,
                    groups=SERVING_GROUPS, top: int = 6) -> tuple:
    """Wall time of a steady model ``step()`` (which ends by bringing its
    tokens to the host, as the engine does), its device busy time (the
    kernels' time under torch.profiler), the kernels that take it, and
    the time of each of ``groups`` (label, pick(kernel name)).
    The idle share compares the busy time with the wall time measured
    without the profiler, whose host overhead it would otherwise count.
    Returns (wall, busy) in ms per step."""
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    wall = (time.perf_counter() - t0) / steps * 1e3

    def work():
        for _ in range(steps):
            step()
    kernels = [a for a in profiled(work)[0].key_averages()
               if a.device_type == torch.autograd.DeviceType.CUDA
               and a.self_device_time_total > 0]
    busy = sum(a.self_device_time_total for a in kernels) / steps / 1e3
    kernels.sort(key=lambda a: a.self_device_time_total, reverse=True)
    log(phase, f"{what}: wall {wall:.2f} ms, device busy {busy:.3f} ms "
        f"({sum(a.count for a in kernels) // steps} kernels), idle share "
        f"{1 - busy / wall:.3f}")
    for a in kernels[:top]:
        log(phase, f"{what}:   {a.self_device_time_total / steps / 1e3:.4f} "
            f"ms x{a.count // steps} {a.key[:110]}")
    for label, pick in groups:
        sel = [a for a in kernels if pick(a.key)]
        log(phase, f"{what}: {label} "
            f"{sum(a.self_device_time_total for a in sel) / steps / 1e3:.4f} "
            f"ms x{sum(a.count for a in sel) // steps}")
    return wall, busy


def _tick_kernel_vs_plain(tag: str, eng) -> float:
    """One fused tick on one state, with the kernels and with the plain
    versions; returns max |logits difference|."""
    state = _tick_state(eng)
    out = {}
    for impl in ("kernel", "plain"):
        out[impl] = _tick(eng, _clone(eng.policy.cache), state, impl)[1]
        torch.cuda.synchronize()
    return _check_logits("serve", f"{tag}: fused tick", out["kernel"],
                         out["plain"])


def _profile_tick(tag: str, eng) -> None:
    """The steady fused tick (8 seats, kernels), run eagerly, under
    ``_profile_steady``."""
    state = _tick_state(eng)
    cache = _clone(eng.policy.cache)
    _profile_steady("serve", f"{tag}: steady fused tick, eager",
                    lambda: _tick(eng, cache, state, "kernel")[0].cpu())


def _profile_graph_tick(tag: str, eng, phase: str = "serve") -> tuple:
    """The engine's captured fused tick replayed from the state of
    ``_profile_tick`` under ``_profile_steady``; ``pos`` and ``step`` are
    put back before each replay (two copies of 32 and 64 bytes among the
    kernels counted), so no seat runs past its table.  Returns (wall,
    busy) in ms per tick."""
    pol = eng.policy
    state = _tick_state(eng)
    for key, t in state.items():
        pol._dev[key].copy_(t)

    def step():
        pol._dev["pos"].copy_(state["pos"])
        pol._dev["step"].copy_(state["step"])
        return pol._tick_fn()[0].cpu()
    return _profile_steady(phase, f"{tag}: steady fused tick, graph replay",
                           step)


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().reshape(-1).view(torch.uint8),
        b.contiguous().reshape(-1).view(torch.uint8))


def _assert_bits(what: str, pairs: dict) -> None:
    """Every ``name: (replayed, eager)`` pair must be bit-equal."""
    torch.cuda.synchronize()
    bad = [name for name, (got, want) in pairs.items()
           if not _bits_equal(got, want)]
    assert not bad, f"{what}: graph replay and eager run differ in {bad}"


def _pools(cache, skip_scratch: bool = False) -> dict:
    """Every pool tensor of a paged cache by name; ``skip_scratch`` drops
    page 0, which takes the padding's writes in no fixed order."""
    return {f"{p}.{k}": t[:, 1:] if skip_scratch else t
            for p, ent in cache.items() for k, t in ent.items()}


def _graph_vs_eager(tag: str, eng, phase: str = "serve") -> None:
    """The paged engine's two graphs replayed against the functions they
    captured, run eagerly on the same inputs and a copy of the same pool:
    the fused tick (8 seats at spread lengths, greedy, temperature,
    top-k and top-p) in its tokens, logits, every pool byte and the
    advanced ``last``, ``pos`` and ``step``; the prefill chunk (77 of
    128 tokens from position 200) in its logits and every pool byte
    outside the scratch page.  All must be bit-equal."""
    from repro_torch.models import model as M
    pol, cfg = eng.policy, eng.cfg
    state = _tick_state(eng)
    state["temp"][1::2] = 0.8
    state["top_k"][1::4] = 50
    state["top_p"][3::4] = 0.9
    state["seed"][:] = 7
    eager = {k: t.clone() for k, t in state.items()}
    cache = _clone(pol.cache)
    toks, logits = M.fused_decode_tick(
        pol.params, cfg, cache, eager["last"], eager["pos"], eager["table"],
        eager["nv"], eager["temp"], eager["top_k"], eager["top_p"],
        eager["seed"], eager["rid"], eager["step"], impl=pol.impl)
    for key, t in state.items():
        pol._dev[key].copy_(t)
    g_toks, g_logits = pol._tick_fn()
    pairs = {"tokens": (g_toks, toks), "logits": (g_logits, logits),
             **{key: (pol._dev[key], eager[key])
                for key in ("last", "pos", "step")}}
    got_pool, want_pool = _pools(pol.cache), _pools(cache)
    pairs.update({k: (got_pool[k], want_pool[k]) for k in got_pool})
    _assert_bits(f"{tag}: fused tick", pairs)
    stochastic = int((state["temp"] > 0).sum())
    log(phase, f"{tag}: fused tick graph replay == eager, bit for bit "
        f"(tokens, logits, {len(got_pool)} pool tensors, last/pos/step; "
        f"{stochastic} of {len(toks)} seats sampling)")

    gen = torch.Generator(device="cuda").manual_seed(5)
    C, c, start = pol.prefill_chunk, 77, 200
    tok = torch.zeros((1, C), dtype=torch.int32, device="cuda")
    tok[0, :c] = torch.randint(0, cfg.vocab_size, (c,), generator=gen,
                               device="cuda", dtype=torch.int32)
    meta = torch.tensor([start, c], dtype=torch.int32, device="cuda")
    row = state["table"][:1].clone()
    cache = _clone(pol.cache)
    logits, _ = M.paged_decode_step(pol.params, cfg, cache, tok, meta[:1],
                                    row, meta[1:], impl=pol.impl)
    buf = pol._prefill.dev
    buf["tokens"].copy_(tok)
    buf["meta"].copy_(meta)
    buf["row"].copy_(row)
    g_logits = pol._prefill_fn()
    got_pool = _pools(pol.cache, skip_scratch=True)
    want_pool = _pools(cache, skip_scratch=True)
    pairs = {"logits": (g_logits, logits),
             **{k: (got_pool[k], want_pool[k]) for k in got_pool}}
    _assert_bits(f"{tag}: prefill chunk", pairs)
    log(phase, f"{tag}: prefill chunk graph replay == eager, bit for bit "
        f"({c} of {C} tokens from position {start}: logits, "
        f"{len(got_pool)} pool tensors outside the scratch page)")


def _check_tickets(what: str, tickets) -> None:
    """The decode kernels' split tickets must all be back at 0."""
    for buf in tickets:
        assert not bool(buf.any()), \
            f"{what}: tickets left at {buf.nonzero().flatten().tolist()}"


def _eager_engine(tag: str, r: dict, cfg) -> None:
    """The paged engine with ``fused=False`` (eager model step, host-side
    sampling, no graph) over the requests of the graphed run ``r``, on
    the same weights: the greedy streams and the traces must be equal."""
    from repro_torch.runtime.serving import PagedServingEngine
    eng = PagedServingEngine(
        cfg, r["engine"].params, kv_dtype=None if tag == "bf16" else tag,
        fused=False, device="cuda", **ENGINE_KW)
    for q in sorted(r["finished"], key=lambda q: q.rid):
        eng.submit(q.prompt, max_new_tokens=q.max_new_tokens)
    eager = {q.rid: q.generated for q in eng.run()}
    graphed = {q.rid: q.generated for q in r["finished"]}
    diff = [rid for rid in graphed if eager.get(rid) != graphed[rid]]
    assert not diff and len(eager) == len(graphed), \
        f"{tag}: fused=True and fused=False streams differ for rids {diff}"
    assert eng.trace == r["engine"].trace, f"{tag}: traces differ"
    m = eng.metrics.snapshot()
    log("serve", f"{tag}: fused=False engine (eager, host sampling) over "
        f"the same 16 requests: streams and trace equal to the graphed "
        f"run's; {eng.policy.decode_ticks} decode ticks, "
        f"{m['tokens_per_s']:.1f} tokens/s, mean TTFT "
        f"{m['ttft_avg_s'] * 1e3:.1f} ms, wall {m['wall_s']:.2f} s "
        f"(graphed: {r['metrics']['tokens_per_s']:.1f} tokens/s, wall "
        f"{r['metrics']['wall_s']:.2f} s)")


def phase_serve():
    """Serves the same 16 requests (prompts of 64-511 tokens, 32 new
    tokens each) with a bf16, an fp8 and an int8 pool; returns the runs
    and the kernel launches of each run, read just after it, by pool."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve_paged
    cfg = get_config(ARCH)
    kw = dict(reduced=False, device="cuda", requests=16, gen=32, min_gen=32,
              min_prompt_len=64, seed=0, **ENGINE_KW)
    runs, counts = {}, {}
    for tag in ("bf16", "fp8", "int8"):
        ops.reset_launches()                   # the main path starts here
        runs[tag] = serve_paged(ARCH, kv_dtype=None if tag == "bf16"
                                else tag, **kw)
        counts[tag] = dict(ops.launches)       # ... and ends here
        _check_run(tag, runs[tag], cfg, counts[tag])
        _eager_engine(tag, runs[tag], cfg)
        gc.collect()
        torch.cuda.empty_cache()
        _graph_vs_eager(tag, runs[tag]["engine"])
        _check_tickets(f"{tag}: after the graphed runs",
                       [runs[tag]["engine"].policy._tickets,
                        *da._tickets.values()])
    for tag, r in runs.items():
        _tick_kernel_vs_plain(f"{tag} pool", r["engine"])
        if tag != "int8":
            _profile_tick(f"{tag} pool", r["engine"])
            _profile_graph_tick(f"{tag} pool", r["engine"])
    return runs, counts


def _decode_state(eng):
    """Inputs of one fixed-slot decode step: a token per slot and write
    positions spread from 40 to the scratch index (an idle slot)."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    return (torch.randint(0, eng.cfg.vocab_size, (eng.B, 1), generator=gen,
                          device="cuda", dtype=torch.int32),
            torch.linspace(40, eng.max_len, eng.B).int().cuda())


def _decode_kernel_vs_plain(eng) -> float:
    """One decode step on the engine's cache with the kernels and with
    the plain versions; returns max |logits difference|."""
    from repro_torch.models import model as M
    tok, pos = _decode_state(eng)
    out = {}
    for impl in ("kernel", "plain"):
        logits, _ = M.decode_step(eng.params, eng.cfg, _clone(eng.cache),
                                  tok, pos, impl=impl)
        torch.cuda.synchronize()
        out[impl] = logits[:, -1]
    return _check_logits("serve-fixed", "decode step", out["kernel"],
                         out["plain"])


def _profile_decode_step(eng) -> None:
    """The steady fixed-slot decode step (8 slots, kernels, greedy tokens
    to the host) under ``_profile_steady``."""
    from repro_torch.models import model as M
    tok, pos = _decode_state(eng)
    cache = _clone(eng.cache)

    def step():
        logits, _ = M.decode_step(eng.params, eng.cfg, cache, tok, pos)
        return torch.argmax(logits[:, -1], dim=-1).cpu()
    _profile_steady("serve-fixed", "steady decode step, eager", step)


def _fixed_graph_vs_eager(eng) -> None:
    """The fixed-slot engine's captured decode step replayed against
    ``M.decode_step`` run eagerly on the inputs of
    ``_decode_kernel_vs_plain`` and a copy of the same cache: logits and
    every cache byte must be bit-equal."""
    from repro_torch.models import model as M
    pol = eng.policy
    tok, pos = _decode_state(eng)
    cache = _clone(pol.cache)
    logits, _ = M.decode_step(pol.params, eng.cfg, cache, tok, pos)
    pol._feed.dev["tokens"].copy_(tok[:, 0])
    pol._feed.dev["pos"].copy_(pos)
    got = pol._decode_fn()
    pairs = {"logits": (got, logits[:, -1])}
    pairs.update({f"{p}.{k}": (pol.cache[p][k], cache[p][k])
                  for p in cache for k in cache[p]})
    _assert_bits("fixed-slot decode step", pairs)
    log("serve-fixed", f"decode step graph replay == eager, bit for bit "
        f"(logits, {len(pairs) - 1} cache tensors)")


def _profile_graph_decode_step(eng) -> None:
    """The fixed-slot engine's captured decode step replayed on the inputs
    of ``_profile_decode_step`` under ``_profile_steady``."""
    pol = eng.policy
    tok, pos = _decode_state(eng)
    pol._feed.dev["tokens"].copy_(tok[:, 0])
    pol._feed.dev["pos"].copy_(pos)
    _profile_steady("serve-fixed", "steady decode step, graph replay",
                    lambda: torch.argmax(pol._decode_fn(), dim=-1).cpu())


def phase_serve_fixed(paged: dict) -> dict:
    """The fixed-slot path at full width: the static batch of ``serve``,
    then a ``ServingEngine`` over the requests of the bf16 paged run
    ``paged`` (same weights, prompts and budgets).  Returns the kernel
    launches of the engine run, read just after it."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve
    from repro_torch.runtime.serving import ServingEngine
    cfg = get_config(ARCH)
    r = serve(ARCH, batch=4, prompt_len=128, gen=16, reduced=False,
              device="cuda")
    g = r["generated"]
    assert g.shape == (4, 16), g.shape
    assert ((g >= 0) & (g < cfg.vocab_size)).all(), \
        "serve: a token outside the vocabulary"
    log("serve-fixed", f"[serve] prefill={r['prefill_s'] * 1e3:.0f}ms "
        f"decode={r['decode_s'] * 1e3:.0f}ms "
        f"throughput={r['tokens_per_s']:.1f} tok/s (batch 4, prompt 128, "
        "16 new tokens)")

    reqs = sorted(paged["finished"], key=lambda q: q.rid)
    eng = ServingEngine(cfg, paged["engine"].params, slots=8,
                        max_len=MAX_LEN, device="cuda")
    for q in reqs:
        eng.submit(q.prompt, max_new_tokens=q.max_new_tokens)
    ops.reset_launches()                       # the main path starts here
    done = eng.run()
    counts = dict(ops.launches)                # ... and ends here
    assert len(done) == 16, f"fixed-slot: {len(done)} of 16 finished"
    for q in done:
        assert len(q.generated) == q.max_new_tokens == 32, q.rid
        assert all(0 <= t < cfg.vocab_size for t in q.generated), \
            f"fixed-slot: rid {q.rid} emitted a token outside the vocabulary"
    assert bool(eng.policy.logits_finite), "fixed-slot: a logit was not finite"
    ticks = eng.policy.decode_ticks
    prefills = sum(1 for _, ev, _ in eng.trace if ev == "admit")
    # per decode step the dense decode kernel once per layer; per prefill
    # the flash kernel once per layer; per model call the norms; no other
    # kernel
    L = cfg.num_layers
    want = {"decode_attention[bf16]": ticks * L,
            "flash_attention[causal]": prefills * L,
            **norm_launches(cfg, ticks + prefills)}
    assert counts == want, \
        f"fixed-slot: launches {counts}, expected {want} for {ticks} " \
        f"decode steps and {prefills} prefills"
    m = eng.metrics.snapshot()
    log("serve-fixed", f"engine: {m['completed']:.0f} requests "
        f"{m['generated_tokens']:.0f} tokens, {ticks} decode steps, "
        f"{prefills} prefills, {m['tokens_per_s']:.1f} tokens/s, mean TTFT "
        f"{m['ttft_avg_s'] * 1e3:.1f} ms, wall {m['wall_s']:.2f} s; "
        f"launches {json.dumps(counts)}")
    _decode_kernel_vs_plain(eng)
    _fixed_graph_vs_eager(eng)
    _check_tickets("fixed-slot: after the graphed run",
                   [eng.policy._tickets, *da._tickets.values()])
    _profile_decode_step(eng)
    _profile_graph_decode_step(eng)
    # information, not a gate: whole-prompt and chunked prefill round
    # bf16 differently, so greedy streams part at near-ties
    paged_gen = {q.rid: q.generated for q in reqs}
    equal = sum(a == b for q in done
                for a, b in zip(q.generated, paged_gen[q.rid]))
    lead = [next((i for i, (a, b) in enumerate(
        zip(q.generated, paged_gen[q.rid])) if a != b), 32) for q in done]
    log("serve-fixed", f"greedy tokens shared with the bf16 paged engine: "
        f"{equal}/512 position-wise, {sum(x == 32 for x in lead)}/16 "
        f"streams identical, first divergence at mean token "
        f"{sum(lead) / 16:.1f}")
    return counts


# ---------------------------------------------------------------------------
# phase telemetry
# ---------------------------------------------------------------------------

TEL_MODES = ("off", "on", "profiled")
TEL_REPS = 5                   # interleaved engine runs per mode and pool
STEADY_TICKS = 5               # ticks in each profiled / sync-counted window
TEL_DIR = ROOT / "build" / "telemetry"     # the trace export, the postmortem


def _telemetry(mode: str):
    from repro_torch.runtime.telemetry import Telemetry
    return {"off": None, "on": Telemetry(ring=4096),
            "profiled": Telemetry(profile=True)}[mode]


def _tel_engine(cfg, params, tag: str, mode: str, requests):
    """A graphed paged engine with the phase-4 configuration and a ``tag``
    pool, ``mode`` telemetry, and ``requests`` submitted."""
    from repro_torch.runtime.serving import PagedServingEngine
    eng = PagedServingEngine(cfg, params, kv_dtype=None if tag == "bf16"
                             else tag, telemetry=_telemetry(mode),
                             device="cuda", **ENGINE_KW)
    for prompt, n in requests:
        eng.submit(prompt, max_new_tokens=n)
    return eng


def _to_steady(eng) -> None:
    """Step ``eng`` until its next tick admits and prefills nothing: every
    request is seated and decoding."""
    while eng.queue or any(r.prefill_pos < len(r.prefill_src)
                           for r in eng.seats.values()):
        eng.step()


def _window_kernels(eng) -> tuple:
    """(kernels, memory copies, ``fused_decode_tick`` ranges) of
    STEADY_TICKS engine ticks under torch.profiler.  The profiler lists
    each range's span on the device (a user annotation) among the device
    events; it is not a kernel and is not counted as one."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(STEADY_TICKS):
            assert eng.seats, "the steady window outlived the requests"
            eng.step()
        torch.cuda.synchronize()
    dev = [a for a in prof.key_averages()
           if a.device_type == torch.autograd.DeviceType.CUDA
           and a.self_device_time_total > 0]
    copies = sum(a.count for a in dev if a.key.startswith(("Memcpy",
                                                           "Memset")))
    kernels = sum(a.count for a in dev
                  if a.key != "fused_decode_tick") - copies
    ranges = sum(1 for e in prof.events() if e.name == "fused_decode_tick"
                 and e.device_type == torch.autograd.DeviceType.CPU)
    return kernels, copies, ranges


def _window_syncs(eng) -> Counter:
    """Synchronizing CUDA calls made by STEADY_TICKS engine ticks, counted
    under ``torch.cuda.set_sync_debug_mode("warn")`` by the file and line
    that made them.  Only calls inside the ticks count: the first switch
    into the mode makes one of its own."""
    import traceback
    import warnings
    seen = Counter()
    inside = False

    def record(message, category, filename, lineno, file=None, line=None):
        if inside and "synchroniz" in str(message):
            f = [f for f in traceback.extract_stack()[:-1]
                 if Path(f.filename).name != "warnings.py"][-1]
            seen[f"{Path(f.filename).name}:{f.lineno}"] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(STEADY_TICKS):
                assert eng.seats, "the steady window outlived the requests"
                inside = True
                eng.step()
                inside = False
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return seen


def _tel_identity(cfg, params, tag: str, requests, want) -> dict:
    """The 16 requests through graphed engines with telemetry off, on and
    profiling: tokens and flat traces equal to each other and to phase
    4's run ``want`` (streams, trace), launch counts as phase 4's, and in
    a steady window the same kernels, copies and synchronizing calls per
    tick, with the ``fused_decode_tick`` ranges only when profiling.
    Returns the telemetry-on engine."""
    from repro_torch.kernels import ops
    windows = {}
    for mode in TEL_MODES:
        ops.reset_launches()                   # the main path starts here
        eng = _tel_engine(cfg, params, tag, mode, requests)
        _to_steady(eng)
        # no collection of an earlier engine's graphs inside a window
        gc.collect()
        syncs = _window_syncs(eng)
        gc.collect()
        kernels, copies, ranges = _window_kernels(eng)
        done = eng.run()
        counts = dict(ops.launches)            # ... and ends here
        _check_run(tag, {"engine": eng, "finished": done,
                         "metrics": eng.metrics.snapshot()}, cfg, counts,
                   phase="telemetry")
        streams = {q.rid: q.generated for q in done}
        assert streams == want[0], f"{tag}/{mode}: streams differ from " \
            "phase 4's run"
        assert eng.trace == want[1], f"{tag}/{mode}: trace differs from " \
            "phase 4's run"
        windows[mode] = (kernels, copies, syncs, ranges)
        if mode == "on":
            on = eng
        log("telemetry", f"{tag}/{mode}: streams and flat trace equal to "
            f"phase 4's; steady window of {STEADY_TICKS} ticks: "
            f"{kernels / STEADY_TICKS:.1f} kernels, "
            f"{copies / STEADY_TICKS:.1f} copies, "
            f"{sum(syncs.values()) / STEADY_TICKS:.1f} synchronizing calls "
            f"per tick ({json.dumps(dict(syncs))}), {ranges} "
            "fused_decode_tick ranges")
    off = windows["off"]
    for mode in ("on", "profiled"):
        assert windows[mode][:3] == off[:3], \
            f"{tag}: {mode} (kernels, copies, syncs) {windows[mode][:3]} " \
            f"!= off {off[:3]} over {STEADY_TICKS} ticks"
    assert sum(off[2].values()) >= STEADY_TICKS, \
        f"{tag}: {dict(off[2])} synchronizing calls counted over " \
        f"{STEADY_TICKS} ticks; the token pull alone is one per tick"
    assert (windows["off"][3], windows["on"][3]) == (0, 0)
    assert windows["profiled"][3] == STEADY_TICKS, \
        f"{tag}: {windows['profiled'][3]} fused_decode_tick ranges in " \
        f"{STEADY_TICKS} profiled ticks"
    return on


def _tel_export(tag: str, eng) -> None:
    """The recorder of the telemetry-on engine: its events project onto
    the flat trace, and its Perfetto export validates and holds a
    prefill and a decode span for every request."""
    from repro_torch.runtime.telemetry import (build_spans,
                                               validate_chrome_trace,
                                               write_perfetto)
    tel = eng.telemetry
    events = tel.events()
    assert tel.recorder.dropped == 0, f"{tag}: the ring dropped events"
    assert [(e.tick, e.kind, e.rid) for e in events
            if e.kind != "submit"] == eng.trace, \
        f"{tag}: recorder events do not project onto the flat trace"
    path = TEL_DIR / f"trace_{tag}.json"
    write_perfetto(str(path), events)
    doc = json.loads(path.read_text())
    errors = validate_chrome_trace(doc)
    assert errors == [], f"{tag}: Perfetto export invalid: {errors[:5]}"
    spans = build_spans(events)["spans"]
    for name in ("prefill", "decode"):
        rids = {s["rid"] for s in spans if s["name"] == name}
        assert rids == set(range(16)), f"{tag}: {name} spans for {rids}"
    log("telemetry", f"{tag}: {len(events)} events, none dropped; Perfetto "
        f"export {path.relative_to(ROOT)} valid ({len(doc['traceEvents'])} "
        f"trace events, {len(spans)} spans)")


def _tel_metrics_server(eng) -> None:
    """A ``MetricsServer`` on port 0 over the engine's metrics serves
    every family of the exposition."""
    import urllib.request
    from repro_torch.runtime.telemetry import MetricsServer, prometheus_text
    srv = MetricsServer(lambda: prometheus_text({ARCH: eng.metrics}), port=0)
    try:
        with urllib.request.urlopen(srv.url, timeout=10) as resp:
            text = resp.read().decode()
    finally:
        srv.close()
    assert text == prometheus_text({ARCH: eng.metrics})
    families = [ln.split()[2] for ln in text.splitlines()
                if ln.startswith("# TYPE ")]
    for fam in ("repro_requests_completed_total", "repro_tokens_decode_total",
                "repro_ticks_total", "repro_pages_in_use",
                "repro_ttft_seconds", "repro_tbt_seconds"):
        assert fam in families, f"metrics server: no {fam}"
    assert f'repro_requests_completed_total{{engine="{ARCH}"}} 16' in text
    log("telemetry", f"metrics server on port {srv.port}: {len(families)} "
        f"families, {len(text.splitlines())} lines, equal to "
        "prometheus_text")


def _tel_stall(cfg, params, requests) -> None:
    """A forced stall (3 ticks for 16 requests) raises and writes a
    postmortem that names every stalled rid and holds a consistent
    ``BlockManager`` partition."""
    from repro_torch.runtime.serving import (PagedServingEngine,
                                             SchedulerStallError)
    from repro_torch.runtime.telemetry import Telemetry
    path = TEL_DIR / "postmortem.json"
    eng = PagedServingEngine(cfg, params, device="cuda", telemetry=Telemetry(
        ring=4096, postmortem_path=str(path)), **ENGINE_KW)
    for prompt, n in requests:
        eng.submit(prompt, max_new_tokens=n)
    try:
        eng.run(max_ticks=3)
    except SchedulerStallError:
        pass
    else:
        raise AssertionError("run(max_ticks=3) did not stall")
    pm = json.loads(path.read_text())
    pending = sorted(q.rid for q in [*eng.queue, *eng.seats.values()])
    state = pm["engines"]["engine"]
    named = sorted({r["rid"] for r in state["queue"]}
                   | {r["rid"] for r in state["seats"].values()})
    assert named == pending and pending, (named, pending)
    for rid in pending:
        assert f"{rid}(standard)" in pm["reason"], rid
    bm = state["block_manager"]
    assert bm["partition_ok"] is True, "postmortem: pages not partitioned"
    assert len(bm["free"]) + len(bm["reclaimable"]) + \
        len(bm["live_refcounts"]) == bm["capacity"]
    log("telemetry", f"forced stall: postmortem {path.relative_to(ROOT)} "
        f"names the {len(pending)} stalled rids ({len(state['seats'])} "
        f"seated, {len(state['queue'])} queued), {bm['in_use']} pages in "
        f"use, partition consistent, "
        f"{pm['flight_recorder']['total']} events recorded")


def _tel_reps(cfg, params, tag: str, requests) -> None:
    """TEL_REPS interleaved runs of each mode on fresh engines: tokens/s
    with telemetry on over off (information, not a gate) and the tick
    profiler's phase table, summed over the profiled runs."""
    from repro_torch.runtime.telemetry import TickProfiler
    tps = {mode: [] for mode in TEL_MODES}
    prof = TickProfiler()
    for rep in range(TEL_REPS):
        for mode in TEL_MODES if rep % 2 == 0 else TEL_MODES[::-1]:
            eng = _tel_engine(cfg, params, tag, mode, requests)
            done = eng.run()
            assert len(done) == 16
            tps[mode].append(eng.metrics.snapshot()["tokens_per_s"])
            if mode == "profiled":
                p = eng.telemetry.profiler
                for phase, t in p.totals.items():
                    prof.totals[phase] = prof.totals.get(phase, 0.0) + t
                    prof.calls[phase] = prof.calls.get(phase, 0) + \
                        p.calls[phase]
                prof.ticks += p.ticks
            del eng, done
            gc.collect()
    med = {mode: statistics.median(v) for mode, v in tps.items()}
    pair = statistics.median(on / off for on, off in zip(tps["on"],
                                                         tps["off"]))
    log("telemetry", f"{tag}: tokens/s over {TEL_REPS} interleaved runs "
        + "; ".join(f"{mode} {', '.join(f'{x:.1f}' for x in v)}"
                    for mode, v in tps.items()))
    log("telemetry", f"{tag}: on/off tokens/s ratio {med['on'] / med['off']:.4f}"
        f" (medians; median of paired ratios {pair:.4f}), profiled/off "
        f"{med['profiled'] / med['off']:.4f} (information, not a gate)")
    snap = prof.snapshot()
    decode_ticks = snap["phases"]["decode/dispatch"]["calls"]
    log("telemetry", f"{tag}: tick-phase profile over {snap['ticks']} ticks "
        f"({decode_ticks} fused decode ticks) of {TEL_REPS} runs:")
    for phase, ph in snap["phases"].items():
        log("telemetry", f"{tag}:   {phase:<16} {ph['total_s'] * 1e3:9.2f} ms"
            f" total {ph['total_s'] * 1e3 / ph['calls']:7.3f} ms per call "
            f"x{ph['calls']:<5} {ph['share'] * 100:5.1f}%")


def phase_telemetry(params, requests, want: dict) -> None:
    """The telemetry plane on the graphed paged engine at full width, with
    a bf16 and an fp8 pool: ``params`` and ``requests`` (prompt, budget)
    are phase 4's, ``want`` its streams and traces by pool."""
    from repro_torch.configs import get_config
    cfg = get_config(ARCH)
    TEL_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    for tag in ("bf16", "fp8"):
        on = _tel_identity(cfg, params, tag, requests, want[tag])
        _tel_export(tag, on)
        if tag == "bf16":
            _tel_metrics_server(on)
        del on
        gc.collect()
        torch.cuda.empty_cache()
    _tel_stall(cfg, params, requests)
    gc.collect()
    t1 = time.perf_counter()
    for tag in ("bf16", "fp8"):
        _tel_reps(cfg, params, tag, requests)
    torch.cuda.empty_cache()
    log("telemetry", f"phase times: checks {t1 - t0:.1f} s, interleaved runs "
        f"{time.perf_counter() - t1:.1f} s")


# ---------------------------------------------------------------------------
# phase fleet
# ---------------------------------------------------------------------------

# the fleet's engines take the paged engines' knobs; the pools come from
# the fleet's budget.  Run A's budget holds 3 engines x 8 seats x 34 pages
# (no engine can preempt); Run B's the two floors and 40 pages more
FLEET_KW = {k: v for k, v in ENGINE_KW.items() if k != "num_pages"}
FLEET_A = ((ARCH, 2, None), (LLAMA, 1, None))
FLEET_B = ((ARCH, 1, None), (LLAMA, 1, "fp8"))
FLEET_PAGES_A = 840
FLEET_SURPLUS_B = 40
FLEET_REQUESTS = 24
FLEET_DIR = ROOT / "build" / "fleet"      # the trace export, the postmortem


def _fleet_weights() -> dict:
    """qwen3-1.7b and llama3-8b at full width, model ``i`` from a
    ``torch.Generator`` seeded with ``i`` on the card (``serve_fleet``'s
    seeding at seed 0, so qwen3-1.7b has phase 4's weights), each drawn
    in f32 and cast for compute before the next is drawn: no f32 tree
    outlives its turn.  Returns arch -> (cfg, the cast tree)."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models.convert import cast_for_compute
    out = {}
    for i, arch in enumerate((ARCH, LLAMA)):
        cfg = get_config(arch)
        gen = torch.Generator(device="cuda").manual_seed(i)
        out[arch] = (cfg, cast_for_compute(
            M.init_params(M.param_specs(cfg), gen, device="cuda"),
            M.compute_dtype(cfg)))
        gc.collect()
    return out


def _tree_bytes(tree) -> int:
    from repro_torch.tree import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def _fleet_requests(weights) -> list:
    """FLEET_REQUESTS requests alternating between the two models:
    prompts of 64-511 tokens, exactly 32 new tokens each."""
    rng = np.random.default_rng(7)
    out = []
    for i in range(FLEET_REQUESTS):
        arch = (ARCH, LLAMA)[i % 2]
        vocab = weights[arch][0].vocab_size
        out.append((arch, rng.integers(0, vocab, int(rng.integers(
            64, 512))).astype(np.int32), 32))
    return out


def _fleet(weights, spec, total_pages: int, **kw):
    """A ``ModelFleet`` on the card of ``spec`` (arch, replicas, kv dtype)
    over the cast trees of ``weights``, with the paged engines' knobs."""
    from repro_torch.runtime.router import FleetModel, ModelFleet
    return ModelFleet([FleetModel(arch, *weights[arch], replicas=n,
                                  kv_dtype=dt) for arch, n, dt in spec],
                      total_pages=total_pages, device="cuda", **FLEET_KW,
                      **kw)


def _fleet_submit(fleet, requests, sampling, premium_every: int = 0):
    for i, (arch, prompt, n) in enumerate(requests):
        prem = premium_every and i % premium_every == 0
        fleet.submit(model=arch, prompt=prompt, max_new_tokens=n,
                     sampling=sampling,
                     priority="premium" if prem else "standard")


def _fleet_tickets(fleet) -> list:
    from repro_torch.kernels import decode_attention as da
    return [eng.policy._tickets for _, _, eng in fleet._engines()] + \
        list(da._tickets.values())


def _fleet_launches(fleet) -> dict:
    """The launches a fleet run must have made, summed over its engines:
    each engine's attention kernel (by its pool) once per layer per
    replay of its tick graph, and per replay of either graph (a decode
    tick or a prefill chunk) its model's norms."""
    want = Counter()
    for _, _, eng in fleet._engines():
        cfg, ticks = eng.cfg, eng.policy.decode_ticks
        chunks = sum(1 for _, ev, _ in eng.trace if ev == "prefill_chunk")
        kv = eng.kv_dtype
        want["paged_decode_attention[bf16]" if kv == "bf16"
             else f"quantized_paged_decode_attention[{kv}]"] += \
            ticks * cfg.num_layers
        want.update(norm_launches(cfg, ticks + chunks))
    return dict(want)


def _check_fleet_run(tag: str, fleet, requests, counts: dict) -> dict:
    """Every request finished on a replica of its model with its budget
    of tokens, all in its model's vocabulary; every engine's logits
    finite; the launches ``counts`` read just after the run equal the
    sum over engines of its graph replays' (``_fleet_launches``); the
    split tickets back at 0.  Returns rid -> generated."""
    done = fleet.finished()
    assert sorted(done) == list(range(len(requests))), \
        f"{tag}: {len(done)} of {len(requests)} requests finished"
    for rid, (arch, _, n) in enumerate(requests):
        assert fleet.route(rid)[0] == arch, (tag, rid)
        gen = done[rid].generated
        vocab = fleet.group(arch).cfg.vocab_size
        assert len(gen) == n, (tag, rid, len(gen))
        assert all(0 <= t < vocab for t in gen), \
            f"{tag}: rid {rid} emitted a token outside {arch}'s vocabulary"
    for name, i, eng in fleet._engines():
        assert bool(eng.policy.logits_finite), \
            f"{tag}: {name}/{i}: a logit was not finite"
    want = _fleet_launches(fleet)
    assert counts == want, f"{tag}: launches {counts}, expected {want}"
    _check_tickets(f"{tag}: after the run", _fleet_tickets(fleet))
    for name, i, eng in fleet._engines():
        m = eng.metrics.snapshot()
        log("fleet", f"{tag}: {name}/{i} ({eng.kv_dtype} pool, "
            f"{eng.bm.capacity} pages): {m['completed']:.0f} requests, "
            f"{eng.policy.decode_ticks} decode ticks, "
            f"{m['preemptions']:.0f} preemptions, peak "
            f"{m['peak_pages_in_use']:.0f} pages")
    log("fleet", f"{tag}: {fleet._tick} fleet ticks; launches "
        f"{json.dumps(counts)} equal the sum over engines of their graph "
        "replays; split tickets back at 0")
    return {rid: q.generated for rid, q in done.items()}


def _report_fleet(tag: str, fleet) -> None:
    """Fleet and per-model tokens/s and mean TTFT (information)."""
    m = fleet.metrics_snapshot()
    f = m["fleet"]
    log("fleet", f"{tag}: fleet {f['generated_tokens']:.0f} tokens, "
        f"{f['tokens_per_s']:.1f} tokens/s, mean TTFT "
        f"{f['ttft_avg_s'] * 1e3:.1f} ms, wall {f['wall_s']:.2f} s")
    for name, mm in m["models"].items():
        log("fleet", f"{tag}:   {name} x{len(mm['replicas'])}: "
            f"{mm['tokens_per_s']:.1f} tokens/s, mean TTFT "
            f"{mm['ttft_avg_s'] * 1e3:.1f} ms, preemptions "
            f"{mm['preemptions']:.0f}")


def _fleet_identity(weights, requests, sampling) -> dict:
    """Run A: the fleet of FLEET_A with bf16 pools and a budget in which
    no engine preempts, ``requests`` sampled at temperature 0.9: the
    checks of ``_check_fleet_run``, no preemption, both qwen3-1.7b
    replicas on the storage of the one cast tree, the llama3-8b replica's
    graphs against its functions run eagerly (bit for bit), K1/K2 at its
    shapes (``_llama_attention``) and its tick with the kernels against
    the plain versions and the f32 tick (``_tick_vs_f32``).  Returns the
    streams."""
    from repro_torch.kernels import ops
    from repro_torch.tree import tree_leaves
    fleet = _fleet(weights, FLEET_A, FLEET_PAGES_A)
    pools = sum(_tree_bytes(eng.cache) for _, _, eng in fleet._engines())
    held = sum(_tree_bytes(w[1]) for w in weights.values())
    alloc = torch.cuda.memory_allocated()
    # an f32 copy of either model's matmul weights would be >= 6.8 GB
    assert alloc < held + pools + 4 * 2 ** 30, \
        f"run A: {alloc / 2 ** 30:.2f} GiB allocated for " \
        f"{(held + pools) / 2 ** 30:.2f} GiB of weights and pools"
    log("fleet", f"run A built: weights {held / 2 ** 30:.2f} GiB, pools "
        f"{pools / 2 ** 30:.2f} GiB, {alloc / 2 ** 30:.2f} GiB allocated "
        "(no f32 copy of a weight is alive)")
    ops.reset_launches()                       # the main path starts here
    _fleet_submit(fleet, requests, sampling)
    fleet.run()
    counts = dict(ops.launches)                # ... and ends here
    streams = _check_fleet_run("run A", fleet, requests, counts)
    for name, i, eng in fleet._engines():
        assert eng.metrics.preemptions == 0, \
            f"run A: {name}/{i} preempted; the budget was sized for none"
    for arch in (ARCH, LLAMA):
        want = [t.data_ptr() for t in tree_leaves(weights[arch][1])]
        for i, eng in enumerate(fleet.group(arch).engines):
            got = [t.data_ptr() for t in tree_leaves(eng.params)]
            assert got == want, f"run A: {arch}/{i} holds its own weights"
    log("fleet", f"run A: both {ARCH} replicas and the {LLAMA} replica "
        "hold the storage of their model's one cast tree (data_ptr of "
        "every leaf)")
    _report_fleet("run A", fleet)
    llama = fleet.group(LLAMA).engines[0]
    _graph_vs_eager(f"{LLAMA}/0", llama, phase="fleet")
    _llama_attention(llama)
    _tick_vs_f32(f"{LLAMA}/0", llama)
    _check_tickets("run A: after the llama3-8b checks", _fleet_tickets(fleet))
    return streams


def _llama_attention(eng) -> None:
    """K1 and K2 against their plain versions at the shapes the fleet
    gives them on llama3-8b: bf16 queries of 32 heads over 8 kv heads
    (GQA group 4), head dim 128, the 8 seats of ``_tick_state(eng)``
    (lengths 41-543 over tables of 34 pages of ``eng``'s pool) over a
    bf16 pool and an fp8 one, within BF16_ATOL/RTOL."""
    from repro_torch.core.mixed_precision import quantize_kv_page
    from repro_torch.kernels import ops
    state = _tick_state(eng)
    lengths = state["pos"] + 1
    gen = torch.Generator(device="cuda").manual_seed(4)
    q = torch.randn((len(lengths), 1, LLAMA_H, HEAD_DIM), generator=gen,
                    device="cuda").bfloat16()
    shape = (eng.policy.bm.capacity + 1, PAGE, KVH, HEAD_DIM)
    k, v = (torch.randn(shape, generator=gen, device="cuda")
            for _ in range(2))
    (kq, ks), (vq, vs) = quantize_kv_page(k, "fp8"), quantize_kv_page(v, "fp8")
    for pool, (kp, vp, ksc, vsc) in (
            ("bf16", (k.bfloat16(), v.bfloat16(), None, None)),
            ("fp8", (kq, vq, ks, vs))):
        got, want = (ops.paged_decode_attention(
            q, kp, vp, state["table"], lengths, k_scale=ksc, v_scale=vsc,
            impl=impl) for impl in ("kernel", "plain"))
        err = check_close(f"{LLAMA} paged decode[{pool}]", got, want,
                          BF16_ATOL, BF16_RTOL)
        log("fleet", f"{LLAMA} paged decode H={LLAMA_H} KVH={KVH} "
            f"d={HEAD_DIM} q=bf16 pool={pool}, lengths "
            f"{lengths.tolist()}: max|err| {err:.3e}")


# the bf16 tick with the kernels may lie no further from the f32 tick of
# the same weights and pool than the plain versions' bf16 tick lies, up to
# this factor, in every seat's RMS over its logits and in the largest
# difference
TICK_F32_RATIO = 1.5


def _tick_vs_f32(tag: str, eng) -> None:
    """The fused tick with the kernels against the plain versions, where
    bf16 roundings compounded over many layers leave both some way from
    the exact tick: each bf16 tick is held to the f32 tick (plain
    versions) of the same weights and pool widened, and the kernels' may
    be no further from it than TICK_F32_RATIO times the plain versions'.
    A planted fault (the kernels' attention missing every seat's last
    page) must fail the same test."""
    import dataclasses
    from repro_torch.kernels import ops
    from repro_torch.tree import tree_map
    state = _tick_state(eng)
    pool = eng.policy.cache

    def bf16(impl):
        return _tick(eng, _clone(pool), state, impl)[1]
    wide = tree_map(lambda t: t.float(), eng.params)
    lf = _tick(eng, {p: {k: t.float() for k, t in ent.items()}
                     for p, ent in pool.items()}, state, "plain", wide,
               dataclasses.replace(eng.cfg, compute_dtype="float32"))[1]
    del wide
    gc.collect()

    def ratios(lk, lp):
        assert bool(torch.isfinite(lk).all()), f"{tag}: non-finite logits"
        ek, ep = (lk - lf).abs(), (lp - lf).abs()
        rows = (ek.square().mean(-1).sqrt() / ep.square().mean(-1).sqrt())
        return rows, ek.max().item() / ep.max().item(), ek, ep
    lp = bf16("plain")
    lk = bf16("kernel")
    rows, peak, ek, ep = ratios(lk, lp)
    attention = ops.paged_decode_attention

    def dropped_page(q, k, v, table, lengths, **kw):
        if kw.get("impl") == "plain":
            return attention(q, k, v, table, lengths, **kw)
        return attention(q, k, v, table, torch.clamp(lengths - PAGE, min=1),
                         **kw)
    ops.paged_decode_attention = dropped_page
    try:
        bad_rows, bad_peak, _, _ = ratios(bf16("kernel"), lp)
    finally:
        ops.paged_decode_attention = attention
    scale = lf.abs().max().item()
    log("fleet", f"{tag}: bf16 fused tick against the f32 tick (largest "
        f"|logit| {scale:.3e}): kernels max|Δ| {ek.max().item():.3e}, "
        f"plain max|Δ| {ep.max().item():.3e} (ratio {peak:.3f}); per seat "
        f"RMS ratio kernels/plain {[round(r, 3) for r in rows.tolist()]}; "
        f"kernels vs plain max|Δ| {(lk - lp).abs().max().item():.3e}; "
        f"greedy tokens equal to the f32 tick's: kernels "
        f"{int((lk.argmax(-1) == lf.argmax(-1)).sum())}/{len(lf)}, plain "
        f"{int((lp.argmax(-1) == lf.argmax(-1)).sum())}/{len(lf)}")
    log("fleet", f"{tag}: planted fault [last page dropped]: per seat RMS "
        f"ratio {[round(r, 3) for r in bad_rows.tolist()]}, max ratio "
        f"{bad_peak:.3f}")
    assert rows.max().item() <= TICK_F32_RATIO and peak <= TICK_F32_RATIO, \
        f"{tag}: the kernels' bf16 tick lies further from the f32 tick " \
        f"than {TICK_F32_RATIO}x the plain versions' (per seat " \
        f"{rows.tolist()}, largest {peak:.3f})"
    assert bad_rows.max().item() > TICK_F32_RATIO or \
        bad_peak > TICK_F32_RATIO, \
        f"{tag}: a planted fault passes the f32 tick test"


def _fleet_llama_f32(weights, requests) -> None:
    """llama3-8b's kernels (K1 at GQA group 4, K3 and its fused forms at
    D = 4096) against the plain versions where the comparison is fair:
    in f32 (the cast weights widened, f32 pools), 8 of Run A's llama3-8b
    prompts teacher-forced through prefill chunks and 31 fused ticks,
    phase f32's method: every decided position's top-1 equal and at
    least F32_MIN_DECIDED of the positions decided."""
    import dataclasses
    from repro_torch.tree import tree_map
    cfg, params = weights[LLAMA]
    wide = tree_map(lambda t: t.float(), params)
    prompts = [p for arch, p, _ in requests if arch == LLAMA][:8]
    _f32_paged_teacher_forced(
        dataclasses.replace(cfg, compute_dtype="float32"), wide, prompts,
        what=f"{LLAMA} fused tick (paged, f32 pool)", phase="fleet")


def _fleet_solo(weights, requests, streams, sampling) -> None:
    """Each model's requests of Run A on a solo graphed engine, submitted
    with the fleet's rids: the streams must equal the fleet's bit for
    bit, with no preemption."""
    from repro_torch.runtime.serving import PagedServingEngine
    for arch in (ARCH, LLAMA):
        cfg, params = weights[arch]
        eng = PagedServingEngine(cfg, params, device="cuda", **ENGINE_KW)
        mine = [(rid, p, n) for rid, (a, p, n) in enumerate(requests)
                if a == arch]
        for rid, p, n in mine:
            eng.submit(p, max_new_tokens=n, sampling=sampling, rid=rid)
        solo = {q.rid: q.generated for q in eng.run()}
        assert eng.metrics.preemptions == 0, f"solo {arch} preempted"
        diff = [rid for rid, _, _ in mine if solo[rid] != streams[rid]]
        assert not diff, f"{arch}: fleet and solo streams differ for {diff}"
        _check_tickets(f"solo {arch}", [eng.policy._tickets])
        log("fleet", f"solo {arch} engine over its {len(mine)} requests "
            "with the fleet's rids: streams equal to run A's, bit for bit")
        del eng
        gc.collect()


def _fleet_budget(weights, requests) -> None:
    """Run B: qwen3-1.7b with a bf16 pool and llama3-8b with an fp8 pool
    under a budget of the two floors and FLEET_SURPLUS_B pages, SLO-aware
    selection and SLO admission, a third of the requests premium: every
    request finishes, the live bytes across engines stay within the
    budget after every fleet step, some engine borrows beyond its floor,
    and K2 carries the fp8 replica."""
    from repro_torch.kernels import ops
    floors = 2 * -(-ENGINE_KW["max_seq_len"] // PAGE)
    fleet = _fleet(weights, FLEET_B, floors + FLEET_SURPLUS_B,
                   selection="slo-aware", admission="slo")
    budget = fleet.budget
    ops.reset_launches()                       # the main path starts here
    _fleet_submit(fleet, requests, None, premium_every=3)
    borrowed, live_max = Counter(), 0
    while fleet.pending():
        fleet.step()
        u = budget.usage()
        live = sum(e["bytes_in_use"] for e in u["engines"].values())
        assert live <= budget.total_bytes, \
            f"run B: {live} live bytes > budget {budget.total_bytes} at " \
            f"fleet tick {fleet._tick}"
        live_max = max(live_max, live)
        for key, e in u["engines"].items():
            borrowed[key] = max(borrowed[key], e["borrowed"])
        assert fleet._tick < 20_000, "run B: the fleet does not finish"
    counts = dict(ops.launches)                # ... and ends here
    _check_fleet_run("run B", fleet, requests, counts)
    assert any(borrowed.values()), "run B: no engine borrowed"
    assert counts.get("quantized_paged_decode_attention[fp8]", 0) > 0
    log("fleet", f"run B: budget {budget.total} pages of "
        f"{budget.page_bytes} bytes ({budget.total_bytes / 2 ** 20:.1f} MiB)"
        f"; live bytes at most {live_max / 2 ** 20:.1f} MiB across the "
        f"engines after every fleet tick; most pages borrowed beyond the "
        f"floor {json.dumps(dict(borrowed))}")
    _report_fleet("run B", fleet)


def _fleet_telemetry(weights, requests, streams, sampling) -> None:
    """Run A again under ``Telemetry(ring=4096)``: the same streams, one
    ``fleet_tick`` event per engine at every ``heartbeat_every`` stride,
    a valid Perfetto export; then a forced stall (``run(max_ticks=2)`` on
    a fresh fleet) whose message names every pending request as
    ``model/replica:rid(priority)`` and whose postmortem names every
    engine and holds the budget block."""
    from repro_torch.runtime.serving import SchedulerStallError
    from repro_torch.runtime.telemetry import (Telemetry, build_spans,
                                               validate_chrome_trace,
                                               write_perfetto)
    tel = Telemetry(ring=4096)
    fleet = _fleet(weights, FLEET_A, FLEET_PAGES_A, telemetry=tel)
    _fleet_submit(fleet, requests, sampling)
    done = fleet.run()
    assert {rid: q.generated for rid, q in done.items()} == streams, \
        "telemetry: streams differ from run A's"
    every = tel.heartbeat_every
    assert fleet._tick >= every, f"telemetry: {fleet._tick} fleet ticks"
    engines = [f"{n}/{i}" for n, i, _ in fleet._engines()]
    beats = Counter((e.tick, e.engine) for e in tel.events()
                    if e.kind == "fleet_tick")
    want = {(t, name): 1 for t in range(every, fleet._tick + 1, every)
            for name in engines}
    assert dict(beats) == want, f"telemetry: heartbeats {dict(beats)}"
    assert tel.recorder.dropped == 0, "telemetry: the ring dropped events"
    path = FLEET_DIR / "trace_fleet.json"
    write_perfetto(str(path), tel.events())
    doc = json.loads(path.read_text())
    errors = validate_chrome_trace(doc)
    assert errors == [], f"telemetry: Perfetto export invalid: {errors[:5]}"
    spans = build_spans(tel.events())["spans"]
    log("fleet", f"telemetry: streams equal to run A's; {len(want)} "
        f"fleet_tick events, one per engine every {every} of "
        f"{fleet._tick} ticks; Perfetto export {path.relative_to(ROOT)} "
        f"valid ({len(doc['traceEvents'])} trace events, {len(spans)} "
        "spans)")
    del fleet, done
    gc.collect()
    path = FLEET_DIR / "postmortem.json"
    fleet = _fleet(weights, FLEET_A, FLEET_PAGES_A, telemetry=Telemetry(
        ring=4096, postmortem_path=str(path)))
    _fleet_submit(fleet, requests, sampling)
    try:
        fleet.run(max_ticks=2)
    except SchedulerStallError as e:
        msg = str(e)
    else:
        raise AssertionError("fleet run(max_ticks=2) did not stall")
    pm = json.loads(path.read_text())
    assert set(pm["engines"]) == set(engines), sorted(pm["engines"])
    assert pm["budget"]["total_pages"] == FLEET_PAGES_A
    assert set(pm["budget"]["engines"]) == \
        {str((n, i)) for n, i, _ in fleet._engines()}
    pending = 0
    for name, i, eng in fleet._engines():
        for q in [*eng.queue, *eng.seats.values()]:
            assert f"{name}/{i}:{q.rid}({q.priority})" in msg, q.rid
            pending += 1
    assert pending and pm["reason"] == "SchedulerStallError: " + msg
    log("fleet", f"forced stall: the message names the {pending} pending "
        f"requests by model/replica:rid(priority); postmortem "
        f"{path.relative_to(ROOT)} names the engines {engines} and holds "
        "the budget block")


def _fleet_steady(weights) -> None:
    """A fleet of FLEET_A with every engine's 8 seats decoding (prompts of
    128 tokens, 64 new tokens): one fleet step (three engine ticks, each
    ending in its token pull) under ``_profile_steady``, then the
    llama3-8b replica's tick replayed alone, its device busy time against
    the least time its bytes take (information)."""
    from repro_torch.tree import tree_flatten_with_paths
    fleet = _fleet(weights, FLEET_A, FLEET_PAGES_A)
    rng = np.random.default_rng(8)
    for arch, n in ((ARCH, 16), (LLAMA, 8)):
        for _ in range(n):
            fleet.submit(model=arch, prompt=rng.integers(
                0, weights[arch][0].vocab_size, 128).astype(np.int32),
                max_new_tokens=64)
    while any(eng.queue or any(r.prefill_pos < len(r.prefill_src)
                               for r in eng.seats.values())
              for _, _, eng in fleet._engines()):
        fleet.step()
    assert all(len(eng.seats) == 8 for _, _, eng in fleet._engines())
    _profile_steady("fleet", "steady fleet step (3 engines, 24 seats)",
                    fleet.step)
    eng = fleet.group(LLAMA).engines[0]
    cfg, params = eng.cfg, eng.params
    state = _tick_state(eng)
    # bytes one tick must move: every weight once but the embedding's
    # 8 rows, the K and V of every seat's positions, and the logits
    weights_read = sum(t.numel() * t.element_size() for p, t in
                       tree_flatten_with_paths(params) if p != "embed")
    row = params["embed"][0]
    weights_read += 8 * row.numel() * row.element_size()
    kv = 2 * cfg.num_layers * KVH * HEAD_DIM * 2 * \
        int((state["pos"] + 1).sum())
    nbytes = weights_read + kv + 8 * cfg.vocab_size * 4
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    _, busy = _profile_graph_tick(f"{LLAMA}/0", eng, phase="fleet")
    log("fleet", f"{LLAMA}/0 tick: device busy {busy:.3f} ms against the "
        f"byte bound {bound_ms:.3f} ms ({nbytes / 1e9:.2f} GB at "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s): {busy / bound_ms:.2f}x "
        "(information)")
    _check_tickets("steady fleet", _fleet_tickets(fleet))


def _fleet_cli() -> None:
    """``python -m repro_torch.launch.serve --fleet`` with the reference's
    defaults (reduced configs, ``qwen3-1.7b:2,llama3-8b``) on the card."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                          "--fleet"], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, f"serve --fleet: rc {out.returncode}\n" \
        f"{out.stderr[-3000:]}"
    lines = [ln for ln in out.stdout.splitlines()
             if ln.startswith("[serve.fleet]")]
    assert lines and "device=cuda" in lines[0] and "8 requests" in lines[0], \
        out.stdout[-2000:]
    for ln in lines:
        log("fleet", f"cli: {ln}")


def phase_fleet() -> None:
    """The multi-model fleet on the card: qwen3-1.7b x2 and llama3-8b x1
    at full width behind one ``ModelFleet``."""
    from repro_torch.runtime.sampler import SamplingParams
    FLEET_DIR.mkdir(parents=True, exist_ok=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    weights = _fleet_weights()
    log("fleet", f"weights: {ARCH} "
        f"{_tree_bytes(weights[ARCH][1]) / 2 ** 30:.2f} GiB, {LLAMA} "
        f"{_tree_bytes(weights[LLAMA][1]) / 2 ** 30:.2f} GiB cast for "
        f"compute; {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB "
        "allocated, peak while drawing "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    requests = _fleet_requests(weights)
    sampling = SamplingParams(temperature=0.9, seed=11)
    streams = _fleet_identity(weights, requests, sampling)
    gc.collect()
    _fleet_solo(weights, requests, streams, sampling)
    _fleet_llama_f32(weights, requests)
    gc.collect()
    t1 = time.perf_counter()
    _fleet_budget(weights, requests)
    gc.collect()
    _fleet_telemetry(weights, requests, streams, sampling)
    gc.collect()
    t2 = time.perf_counter()
    _fleet_steady(weights)
    gc.collect()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del weights
    gc.collect()
    torch.cuda.empty_cache()
    t3 = time.perf_counter()
    _fleet_cli()
    log("fleet", f"phase times: run A and solo {t1 - t0:.1f} s, run B and "
        f"telemetry {t2 - t1:.1f} s, steady profile {t3 - t2:.1f} s, cli "
        f"{time.perf_counter() - t3:.1f} s; peak "
        f"{peak:.2f} GiB allocated (max_memory_allocated)")


# phase f32: a position is decided when the plain version's top-2 gap
# exceeds twice the largest |kernel - plain| logit difference there (the
# workload-7 method of docs/benchmarks.md): there the two must pick the
# same token.  In f32 the differences are summation order, ~1e-5 against
# top-2 gaps of ~1e-2 at random weights, so nearly every position is
# decided; a wrong split merge (differences of ~1e-1) would leave few.
F32_MIN_DECIDED = 0.9
F32_GAP = 1e-3          # engines: streams must agree up to a gap this small
F32_GEN = 32


def _hold_decided(stats: dict, lk: torch.Tensor, lp: torch.Tensor) -> None:
    """Adds one model step's (rows, V) logits with the kernels ``lk`` and
    the plain versions ``lp`` to ``stats``: rows, decided rows, decided
    rows whose top-1 agree, the largest |Δlogit|."""
    assert bool(torch.isfinite(lk).all()) and bool(torch.isfinite(lp).all())
    delta = (lk - lp).abs().amax(dim=-1)
    top = lp.topk(2, dim=-1)
    decided = top.values[:, 0] - top.values[:, 1] > 2 * delta
    agree = lk.argmax(dim=-1) == top.indices[:, 0]
    stats["rows"] += len(lp)
    stats["decided"] += int(decided.sum())
    stats["agree"] += int((decided & agree).sum())
    stats["max_delta"] = max(stats["max_delta"], delta.max().item())


def _report_decided(what: str, stats: dict, phase: str = "f32") -> None:
    """Every decided position must agree, and at least F32_MIN_DECIDED of
    the positions must be decided."""
    frac = stats["decided"] / stats["rows"]
    log(phase, f"{what} kernel vs plain, teacher-forced: top-1 equal at "
        f"{stats['agree']}/{stats['decided']} decided positions; decided "
        f"{stats['decided']}/{stats['rows']} = {frac:.4f}; max|Δlogit| "
        f"{stats['max_delta']:.3e}")
    assert stats["agree"] == stats["decided"], \
        f"{what}: top-1 differs at {stats['decided'] - stats['agree']} " \
        "decided positions"
    assert frac >= F32_MIN_DECIDED, \
        f"{what}: only {frac:.3f} of the positions are decided"


def _new_stats() -> dict:
    return {"rows": 0, "decided": 0, "agree": 0, "max_delta": 0.0}


def _f32_paged_teacher_forced(cfg, params, prompts,
                              what: str = "fused tick (paged, f32 pool)",
                              phase: str = "f32") -> None:
    """The fused tick with the kernels and with the plain versions on one
    greedy stream per seat: each prompt prefilled in chunks of
    PREFILL_CHUNK (``paged_decode_step``, as the engine does), then
    F32_GEN - 1 fused ticks over 8 seats, every input token the plain
    version's top-1 (teacher forcing), each on its own f32 pool."""
    from repro_torch.models import model as M
    A = len(prompts)
    n_tables = -(-MAX_LEN // PAGE)
    table = (torch.arange(A * n_tables, dtype=torch.int32, device="cuda")
             + 1).reshape(A, n_tables)
    impls = ("plain", "kernel")
    caches = {impl: M.init_paged_cache(cfg, 1 + A * n_tables, PAGE,
                                       device="cuda") for impl in impls}
    stats = _new_stats()
    first = {impl: [] for impl in impls}
    for a, prompt in enumerate(prompts):
        for impl in impls:
            for start in range(0, len(prompt), PREFILL_CHUNK):
                c = len(prompt[start:start + PREFILL_CHUNK])
                tok = torch.zeros((1, PREFILL_CHUNK), dtype=torch.int32)
                tok[0, :c] = torch.from_numpy(prompt[start:start + c])
                meta = torch.tensor([start, c], dtype=torch.int32)
                logits, _ = M.paged_decode_step(
                    params, cfg, caches[impl], tok.cuda(), meta[:1].cuda(),
                    table[a:a + 1], meta[1:].cuda(), impl=impl)
            first[impl].append(logits[0, c - 1])
    lp = torch.stack(first["plain"])
    _hold_decided(stats, torch.stack(first["kernel"]), lp)
    teacher = lp.argmax(dim=-1).int()
    lens = torch.tensor([len(p) for p in prompts], dtype=torch.int32,
                        device="cuda")
    state = {impl: dict(
        last=teacher.clone(), pos=lens.clone(),
        nv=torch.ones(A, dtype=torch.int32, device="cuda"),
        temp=torch.zeros(A, device="cuda"),
        top_k=torch.zeros(A, dtype=torch.int32, device="cuda"),
        top_p=torch.ones(A, device="cuda"),
        seed=torch.zeros(A, dtype=torch.int64, device="cuda"),
        rid=torch.arange(A, dtype=torch.int64, device="cuda"),
        step=torch.ones(A, dtype=torch.int64, device="cuda"))
        for impl in impls}
    for _ in range(F32_GEN - 1):
        out = {}
        for impl in impls:
            st = state[impl]
            st["last"].copy_(teacher)
            out[impl] = M.fused_decode_tick(
                params, cfg, caches[impl], st["last"], st["pos"], table,
                st["nv"], st["temp"], st["top_k"], st["top_p"], st["seed"],
                st["rid"], st["step"], impl=impl)[1]
        _hold_decided(stats, out["kernel"], out["plain"])
        teacher = out["plain"].argmax(dim=-1).int()
    _report_decided(what, stats, phase)


def _f32_fixed_teacher_forced(cfg, params, prompts) -> None:
    """``prefill`` and ``decode_step`` with the kernels and with the plain
    versions on the same streams as ``_f32_paged_teacher_forced``: each
    prompt prefilled whole into its slot of an f32 cache of MAX_LEN + 1,
    then F32_GEN - 1 decode steps over the 8 slots, teacher-forced."""
    from repro_torch.models import model as M
    A = len(prompts)
    impls = ("plain", "kernel")
    caches = {impl: M.init_cache(cfg, A, MAX_LEN + 1, device="cuda")
              for impl in impls}
    opts = M.RunOptions(q_chunk=min(MAX_LEN, 512))
    stats = _new_stats()
    first = {impl: [] for impl in impls}
    for a, prompt in enumerate(prompts):
        tokens = torch.from_numpy(prompt)[None].cuda()
        for impl in impls:
            logits, rows = M.prefill(params, cfg, {"tokens": tokens}, opts,
                                     impl=impl)
            for pos, ent in caches[impl].items():
                for key, full in ent.items():
                    full[:, a, :len(prompt)] = rows[pos][key][:, 0]
            first[impl].append(logits[0, -1])
    lp = torch.stack(first["plain"])
    _hold_decided(stats, torch.stack(first["kernel"]), lp)
    teacher = lp.argmax(dim=-1).int()
    pos = torch.tensor([len(p) for p in prompts], dtype=torch.int32,
                       device="cuda")
    for _ in range(F32_GEN - 1):
        out = {impl: M.decode_step(params, cfg, caches[impl], teacher[:, None],
                                   pos, impl=impl)[0][:, -1]
               for impl in impls}
        _hold_decided(stats, out["kernel"], out["plain"])
        teacher = out["plain"].argmax(dim=-1).int()
        pos = pos + 1
    _report_decided("prefill + decode step (fixed-slot, f32 cache)", stats)


def _f32_engines(cfg, params, prompts) -> dict:
    """The paged engine and ``ServingEngine`` (the reference's equivalence
    oracle) on the same greedy requests, f32 pool and cache.  Each stream
    must equal the other engine's up to its first position where the
    top-2 gap is at most F32_GAP; the gaps come from a whole-sequence
    re-score of the paged stream (``backbone`` over prompt + stream, the
    logits of every generated position), which is the same context as
    either engine's up to the streams' first difference.  Returns the
    kernel launches of each engine's run."""
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.runtime.serving import PagedServingEngine, ServingEngine
    streams, counts = {}, {}
    for name in ("paged", "fixed"):
        eng = (PagedServingEngine(cfg, params, page_size=PAGE,
                                  num_pages=16 * 34 + 16, max_seats=8,
                                  max_seq_len=MAX_LEN,
                                  prefill_chunk=PREFILL_CHUNK, device="cuda")
               if name == "paged" else
               ServingEngine(cfg, params, slots=8, max_len=MAX_LEN,
                             device="cuda"))
        rids = [eng.submit(p, max_new_tokens=F32_GEN) for p in prompts]
        ops.reset_launches()                   # the main path starts here
        done = {q.rid: q.generated for q in eng.run()}
        counts[name] = dict(ops.launches)      # ... and ends here
        assert sorted(done) == rids and bool(eng.policy.logits_finite), \
            f"f32 {name} engine: finished {sorted(done)}"
        streams[name] = [done[r] for r in rids]
        log("f32", f"{name} engine: {len(done)} requests, launches "
            f"{json.dumps(counts[name])}")
        del eng
    for name, key in (("paged", "paged_decode_attention[f32]"),
                      ("fixed", "decode_attention[f32]"),
                      ("fixed", "flash_attention[causal]")):
        assert counts[name].get(key, 0) > 0, f"f32 {name}: {key} never ran"
    out_w = M._output_weight(params, cfg)
    opts = M.RunOptions(q_chunk=512)
    compared, equal_streams = 0, 0
    for a, prompt in enumerate(prompts):
        gp, gf = streams["paged"][a], streams["fixed"][a]
        seq = torch.from_numpy(np.concatenate(
            [prompt, np.asarray(gp[:-1], np.int32)]))[None].cuda()
        h, _ = M.backbone(params, cfg, M._embed_inputs(
            params, cfg, {"tokens": seq}), opts)
        top = (h[0, len(prompt) - 1:] @ out_w).topk(2, dim=-1).values
        gaps = (top[:, 0] - top[:, 1]).tolist()
        undecided = next((i for i, g in enumerate(gaps) if g <= F32_GAP),
                         len(gp))
        first_diff = next((i for i, (x, y) in enumerate(zip(gp, gf))
                           if x != y), len(gp))
        assert first_diff >= undecided, \
            f"f32 request {a}: the engines part at token {first_diff}, " \
            f"before the first gap <= {F32_GAP} (token {undecided}; gaps " \
            f"{[f'{g:.2e}' for g in gaps[:first_diff + 1]]})"
        compared += undecided
        equal_streams += first_diff == len(gp)
    log("f32", f"paged engine vs ServingEngine: {compared}/"
        f"{len(prompts) * F32_GEN} tokens compared (each stream up to its "
        f"first top-2 gap <= {F32_GAP}), all equal; {equal_streams}/"
        f"{len(prompts)} streams identical throughout")
    return counts


def phase_f32(prompts) -> dict:
    """qwen3-1.7b at its published width computing in f32 (f32 weights
    from the seed of the bf16 runs, f32 pool and cache; K5 on its CUDA-
    core route, K1 on an f32 pool, K4 on an f32 cache) over ``prompts``
    (the first 8 requests of the paged runs): kernels against plain
    versions teacher-forced on both paths, then the paged engine against
    ``ServingEngine``.  Returns the engines' launch counts."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    cfg = dataclasses.replace(get_config(ARCH), compute_dtype="float32")
    params = M.init_params(M.param_specs(cfg), torch.Generator(
        device="cuda").manual_seed(0), device="cuda")
    t0 = time.perf_counter()
    _f32_paged_teacher_forced(cfg, params, prompts)
    _f32_fixed_teacher_forced(cfg, params, prompts)
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    counts = _f32_engines(cfg, params, prompts)
    log("f32", f"phase times: teacher-forced {t1 - t0:.1f} s, engines "
        f"{time.perf_counter() - t1:.1f} s")
    return counts


# full-width training: 30 steps, as the reference's system test
# (tests/test_system.py), at train()'s default peak lr of 1e-3, the
# reference's; 12 steps leave the loss at its uniform level (ln V = 11.93)
# or above it
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 30, 8, 1024, 1e-3
# the CPU parity tests' tolerances for three f32 train steps
# (tests/test_torch_train.py): losses rtol 1e-5, grad norms rtol 1e-3, lr
# rtol 1e-6, params within 5e-5 and the update (p_3 - p_0) within 1e-3
# of its norm
TRAIN_F32_TOL = {"loss": 1e-5, "grad_norm": 1e-3, "lr": 1e-6,
                 "param": 5e-5, "update": 1e-3}
# a resumed run against an uninterrupted one (bf16 compute): losses
# within 1e-3, and the final params, AdamW moments mu and nu each within
# 1e-3 of their norm (the params: of their update p_8 - p_0), count equal.
# A restore that dropped the moments or reset count misses these by
# orders of magnitude; the card read 0 for the losses (PERF.md §6)
RESUME_LOSS_ATOL, RESUME_STATE_RTOL = 1e-3, 1e-3


def _train_full_width() -> None:
    """``train()`` on qwen3-1.7b at its published width: losses finite
    and falling by the reference's criterion, no kernel launched, wall
    time and peak memory."""
    from repro_torch.kernels import ops
    from repro_torch.launch.train import train
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    losses = train(ARCH, steps=TRAIN_STEPS, batch=TRAIN_BATCH,
                   seq=TRAIN_SEQ, reduced=False, log_every=10,
                   lr_peak=TRAIN_LR, device="cuda")
    wall = time.perf_counter() - t0
    launched = {k: n for k, n in ops.launches.items() if n}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log("train", "losses " + " ".join(f"{x:.4f}" for x in losses))
    if launched:
        raise AssertionError(f"kernels launched by the train step: "
                             f"{launched}")
    if not all(np.isfinite(losses)) or len(losses) != TRAIN_STEPS:
        raise AssertionError(f"losses {losses}")
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    if not last < first - 0.05:
        raise AssertionError(f"loss did not fall: mean of the first 5 "
                             f"{first:.4f}, of the last 5 {last:.4f}")
    log("train", f"qwen3-1.7b full width (f32 master weights + AdamW, "
        f"bf16 compute, remat) through train(), batch {TRAIN_BATCH} x seq "
        f"{TRAIN_SEQ}, {TRAIN_STEPS} steps in {wall:.1f} s, peak lr "
        f"{TRAIN_LR}: loss {first:.4f} -> {last:.4f} (means of the first "
        f"and last 5); peak {peak:.2f} GiB allocated; kernel launches 0")


def _kernel_kind(key: str) -> str:
    """The group of a kernel of the train step, by its name."""
    key = key.lower()
    for kind, marks in (("matmul", ("gemm", "xmma", "cutlass", "cublas",
                                    "nvjet")),
                        ("softmax", ("softmax",)),
                        ("reduction", ("reduce",)),
                        ("index, gather, scatter", ("index", "gather",
                                                    "scatter")),
                        ("copy, fill", ("copy", "memcpy", "memset", "fill",
                                        "cat"))):
        if any(m in key for m in marks):
            return kind
    return "elementwise, other"


TRAIN_GROUPS = tuple(
    (kind, lambda key, kind=kind: _kernel_kind(key) == kind)
    for kind in ("matmul", "softmax", "reduction", "index, gather, scatter",
                 "copy, fill", "elementwise, other"))


def _profile_train_step() -> None:
    """Steady full-width train steps through ``build_cell(...).fn``: step
    time by CUDA events, tokens/s, then one step profiled (wall, device
    busy time, idle share, top kernels, the time of each kernel group)
    and the forward / forward + backward / AdamW parts."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch.steps import build_cell, value_and_grad
    from repro_torch.launch.train import make_train_state
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import adamw_update
    cfg = get_config(ARCH)
    params, opt = make_train_state(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    opts = M.RunOptions(q_chunk=min(TRAIN_SEQ, 512),
                        xent_chunk=min(TRAIN_SEQ, 512))
    cell = build_cell(
        cfg, ShapeConfig("custom", TRAIN_SEQ, TRAIN_BATCH, "train"), opts,
        lr_peak=TRAIN_LR, total_steps=10 * TRAIN_STEPS)
    batch = TokenPipeline(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH,
                          device="cuda").get_batch(0)

    def events(fn, iters: int = 3) -> float:
        """Median ms of ``fn()`` by CUDA events, after one warm-up."""
        fn()
        times = []
        for _ in range(iters):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)
    steady = events(lambda: cell.fn(params, opt, batch), iters=5)
    n_params = M.count_params(M.param_specs(cfg))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    log("train", f"steady train step (full width, {n_params / 1e9:.3f} B "
        f"params, batch {TRAIN_BATCH} x seq {TRAIN_SEQ}): {steady:.1f} ms "
        f"(CUDA events, median of 5 after one warm-up), "
        f"{tokens / steady * 1e3:.0f} tokens/s; information: "
        f"6·N·tokens/time = {6 * n_params * tokens / steady / 1e9:.1f} "
        f"TFLOP/s, {6 * n_params * tokens / steady * 1e3 / BF16_FLOPS:.3f} "
        "of the bf16 peak")

    def step():
        cell.fn(params, opt, batch)
        torch.cuda.synchronize()
    _profile_steady("train", "steady train step (full width)", step,
                    steps=2, groups=TRAIN_GROUPS, top=12)
    with torch.no_grad():
        fwd = events(lambda: M.lm_loss(params, cfg, batch, opts))
    fwd_bwd = events(lambda: value_and_grad(params, cfg, batch, opts))
    _, grads = value_and_grad(params, cfg, batch, opts)
    lr = torch.tensor(TRAIN_LR, device="cuda")
    adam = events(lambda: adamw_update(grads, opt, params, lr))
    log("train", f"steady train step parts (CUDA events, median of 3): "
        f"forward {fwd:.1f} ms (no grad), forward + backward with remat "
        f"{fwd_bwd:.1f} ms, AdamW {adam:.1f} ms")


def _train_card_vs_cpu() -> None:
    """Three train steps of the reduced f32 qwen3-1.7b on the card and on
    the CPU from the same params and batches."""
    from repro_torch.configs import ShapeConfig, get_config, reduced_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch.steps import build_cell
    from repro_torch.launch.train import make_train_state
    from repro_torch.models import model as M
    from repro_torch.tree import tree_leaves, tree_map
    cfg = reduced_config(get_config(ARCH), compute_dtype="float32")
    batch, seq = 8, 64
    cell = build_cell(cfg, ShapeConfig("custom", seq, batch, "train"),
                      M.RunOptions(q_chunk=seq, xent_chunk=seq),
                      lr_peak=3e-3, total_steps=300)
    p0, _ = make_train_state(cfg, torch.Generator().manual_seed(0), "cpu")
    runs = {}
    for dev in ("cpu", "cuda"):
        params, opt = make_train_state(cfg, torch.Generator().manual_seed(0),
                                       "cpu")
        params = tree_map(lambda t: t.to(dev), params)
        opt = tree_map(lambda t: t.to(dev), opt)
        pipe = TokenPipeline(cfg.vocab_size, seq, batch, device=dev)
        metrics = []
        for step in range(3):
            params, opt, m = cell.fn(params, opt, pipe.get_batch(step))
            metrics.append({k: float(m[k]) for k in
                            ("loss", "grad_norm", "lr")})
        runs[dev] = (metrics, [t.cpu() for t in tree_leaves(params)])
    (mc, pc), (mg, pg) = runs["cpu"], runs["cuda"]
    tol = TRAIN_F32_TOL
    for step, (a, b) in enumerate(zip(mc, mg)):
        for key in ("loss", "grad_norm", "lr"):
            if abs(a[key] - b[key]) > tol[key] * abs(a[key]):
                raise AssertionError(f"step {step} {key}: cpu {a[key]} "
                                     f"cuda {b[key]}")
    worst_p = worst_u = 0.0
    for c, g, start in zip(pc, pg, tree_leaves(p0)):
        worst_p = max(worst_p, float((c - g).abs().max()))
        worst_u = max(worst_u, float(torch.linalg.vector_norm(c - g)
                                     / torch.linalg.vector_norm(c - start)))
    if worst_p > tol["param"] or worst_u > tol["update"]:
        raise AssertionError(f"params after 3 steps: max |cpu - cuda| "
                             f"{worst_p:.3e}, update error {worst_u:.3e}")
    gn_err = max(abs(a["grad_norm"] - b["grad_norm"]) / a["grad_norm"]
                 for a, b in zip(mc, mg))
    log("train", "reduced f32 qwen3-1.7b, 3 steps, card vs CPU: losses "
        + ", ".join(f"{a['loss']:.6f}/{b['loss']:.6f}" for a, b in
                    zip(mc, mg))
        + f"; grad norms within {gn_err:.2e} relative; params max |Δ| "
        f"{worst_p:.2e}, update "
        f"error {worst_u:.2e} (limits {tol})")


def _train_restart(device: str = "cuda") -> None:
    """Checkpoint and restart at the reduced config: an injected failure,
    a resumed run against an uninterrupted one (losses, and the final
    params and AdamW state), and a ``save_async`` whose restored tensors
    must equal the saved ones bit for bit."""
    import tempfile
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.launch.train import make_train_state, train
    from repro_torch.tree import tree_flatten_with_paths, tree_leaves
    kw = dict(steps=8, batch=8, seq=64, lr_peak=3e-3, log_every=100,
              device=device)
    cfg = reduced_config(get_config(ARCH))
    with tempfile.TemporaryDirectory() as root:
        full_ck = str(Path(root) / "full")
        full = train(ARCH, ckpt_dir=full_ck, ckpt_every=100, **kw)
        ck = str(Path(root) / "ck")
        try:
            train(ARCH, ckpt_dir=ck, ckpt_every=4, fail_at_step=6, **kw)
        except RuntimeError as e:
            if "injected failure at step 6" not in str(e):
                raise
        else:
            raise AssertionError("fail_at_step=6 did not raise")
        if CheckpointManager(ck).steps() != [4]:
            raise AssertionError(f"checkpoints after the failure: "
                                 f"{CheckpointManager(ck).steps()}")
        resumed = train(ARCH, ckpt_dir=ck, ckpt_every=100, **kw)
        err = max(abs(a - b) for a, b in zip(resumed, full[4:]))
        if len(resumed) != 4 or err > RESUME_LOSS_ATOL:
            raise AssertionError(f"resumed losses {resumed} against "
                                 f"{full[4:]}")
        p0, o0 = make_train_state(
            cfg, torch.Generator(device=device).manual_seed(0), device)
        like = {"params": p0, "opt": o0}
        ends = []
        for where in (full_ck, ck):
            mgr = CheckpointManager(where)
            ends.append(mgr.restore(like, 8)[1])
            mgr.close()
        want, got = ends

        def rel(got_t, want_t, base_t=None) -> float:
            """||got - want|| / ||want - base|| over the leaves (``base``
            0 when None)."""
            g, w = tree_leaves(got_t), tree_leaves(want_t)
            b = tree_leaves(base_t) if base_t is not None else [0] * len(w)
            num = sum(float((x - y).double().square().sum())
                      for x, y in zip(g, w))
            den = sum(float((y - z).double().square().sum())
                      for y, z in zip(w, b))
            return (num / den) ** 0.5
        state_err = {"params": rel(got["params"], want["params"], p0),
                     "mu": rel(got["opt"]["mu"], want["opt"]["mu"]),
                     "nu": rel(got["opt"]["nu"], want["opt"]["nu"])}
        counts = {int(got["opt"]["count"]), int(want["opt"]["count"])}
        if counts != {8} or max(state_err.values()) > RESUME_STATE_RTOL:
            raise AssertionError(f"resumed state against the uninterrupted "
                                 f"run: {state_err}, counts {counts}")
        params, opt = make_train_state(
            cfg, torch.Generator(device=device).manual_seed(1), device)
        opt["mu"]["embed"].normal_()
        opt["count"].fill_(4)
        tree = {"params": params, "opt": opt,
                "bf16": {"embed": params["embed"].to(torch.bfloat16)}}
        saved = {name: t.clone() for name, t in tree_flatten_with_paths(tree)}
        mgr = CheckpointManager(str(Path(root) / "bits"), stripes=4)
        fut = mgr.save_async(4, tree)
        for _, t in tree_flatten_with_paths(tree):
            t.add_(1)                        # the save copied them already
        fut.result()
        step, got = mgr.restore(tree)
        mgr.close()
        bad = [name for name, t in tree_flatten_with_paths(got)
               if t.device.type != torch.device(device).type
               or not _bits_equal(t, saved[name])]
        if step != 4 or bad:
            raise AssertionError(f"restored step {step}, leaves not "
                                 f"bit-equal: {bad}")
    log("train", f"restart on {device} (reduced qwen3-1.7b, bf16 compute): "
        f"fail_at_step=6 raised with step_4 committed; resumed steps 4-7 "
        f"against the uninterrupted run: max |Δloss| {err:.2e} (limit "
        f"{RESUME_LOSS_ATOL}), final state relative error "
        + ", ".join(f"{k} {v:.2e}" for k, v in state_err.items())
        + f" (limit {RESUME_STATE_RTOL}), count 8 on both; save_async then "
        "in-place writes: "
        f"{len(saved)} leaves restored bit-equal (f32, int32, bf16)")


def phase_train() -> None:
    """Training on the card: full width through ``train()``, the reduced
    f32 step against the CPU, and a checkpoint restart."""
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    _train_full_width()
    gc.collect()
    torch.cuda.empty_cache()
    _profile_train_step()
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    _train_card_vs_cpu()
    _train_restart()
    gc.collect()
    torch.cuda.empty_cache()
    log("train", f"phase times: full width {t1 - t0:.1f} s, reduced checks "
        f"{time.perf_counter() - t1:.1f} s; phase peak "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB allocated")


def check_fp8(name: str, got: torch.Tensor, want: torch.Tensor, a_q, b_q,
              sa_rows: torch.Tensor, sb_cols: torch.Tensor,
              faults: dict | None = None) -> float:
    """Holds the fp8 GEMM kernel ``got`` against its plain version
    ``want`` on the same e4m3 operands, to ``fp8_matmul.error_bound``:
    the f32 summation bound ``2·γ_K·(|a_q|·|b_q|)·(sa·sb) +
    2^-23·|plain|`` plus the tensor-core term ``2^-9·(|a_q|·|b_q|)·(sa·sb)``
    of sums promoted into f32 every 128 products.  ``sa_rows`` (M,) and
    ``sb_cols`` (N,) are each row's and column's scale.  Logs the largest
    ``|Δ| / ((|a_q|·|b_q|)·sa·sb)`` and whether the f32 bound alone (that
    of a kernel summing in f32) held as well.

    ``faults`` maps a planted fault's name to ``(make, must_fail)``:
    ``make()`` returns a wrong result for the same product, which is held
    to the same limit and its ratio logged; where ``must_fail``, the
    limit must reject it.  Returns the kernel's ratio."""
    from repro_torch.kernels import fp8_matmul as fm
    k = a_q.shape[1]
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite kernel output")
    mag = fm.magnitude(a_q, b_q, sa_rows, sb_cols)
    lim = fm.error_bound(mag, want, k)

    def held(res):
        err = (res - want).abs()
        ratio = torch.where(mag > 0, err / mag, 0.0).max().item()
        return err, ratio, bool((err <= lim).all())
    err, ratio, ok = held(got)
    if not ok:
        raise AssertionError(
            f"{name}: max |kernel - plain| {err.max().item():.3e} beyond "
            f"the tensor-core bound (largest |Δ|/mag {ratio:.3e}, limit "
            f"2·γ_K + {fm.TC_LIMIT:.3e})")
    f32_ok = bool((err <= fm.error_bound(mag, want, k,
                                         tensor_core=False)).all())
    log("hpc", f"{name}: max|err| {err.max().item():.3e}, largest "
        f"|Δ|/((|a||b|)·s) {ratio:.3e} within the tensor-core bound "
        f"(2·γ_K + 2^-9, K={k}); within the f32 summation bound alone: "
        f"{f32_ok}")
    del err
    for fault, (make, must_fail) in (faults or {}).items():
        _, r, passed = held(make())
        log("hpc", f"{name}: planted fault [{fault}]: largest |Δ|/mag "
            f"{r:.3e}, {'passes' if passed else 'fails'} the bound")
        assert not (must_fail and passed), \
            f"{name}: the bound passes the planted fault [{fault}]"
    return ratio


def _dropped_kstep(a_q: torch.Tensor) -> torch.Tensor:
    """a_q with its second wgmma k-step (columns 32–63) zeroed: the result
    of a kernel that skips one k-step of its first chunk."""
    bad = a_q.clone()
    bad[:, 32:64] = 0
    return bad


def _no_promotion(a_q, b_q, sa, sb):
    """``torch._scaled_mm`` with fast accumulation: Hopper's fp8 tensor-core
    sums kept across all of K, never promoted (b_q column-major)."""
    return lambda: torch._scaled_mm(a_q, b_q, scale_a=sa, scale_b=sb,
                                    out_dtype=torch.float32,
                                    use_fast_accum=True)


def _fp8_kernel(gen: torch.Generator, flush: torch.Tensor) -> dict:
    """K6 against its plain version: the per-block wrapper at aligned and
    ragged shapes and at bm/bn != 128; the per-tensor (broadcast-scale)
    call at the n = 256, nb = 64 LU's first trailing update, at a K the
    wrapper pads (b column-major, as the LU's row panel is), on operands
    of one sign (every product positive, so no truncation cancels
    another: the shape that shows promotion), and at a mid-run HPL
    trailing-update shape, M = N = 32768, K = NB, timed (``event_ms``)
    with the plain version and the ``torch._scaled_mm`` yardstick.  At
    each shape planted faults are held to the same bound and must fail
    it: a dropped k-step everywhere, a scale of the wrong block where
    there are blocks, and sums never promoted on the one-sign operands
    (logged on signed operands, where promotion changes little)."""
    from repro_torch.core.mixed_precision import quantize_fp8
    from repro_torch.kernels import ops
    ratios = []
    for m, k, n, (bm, bn, bk) in ((512, 1024, 384, (128, 128, 128)),
                                  (1000, 700, 300, (128, 128, 128)),
                                  (320, 512, 448, (64, 256, 64))):
        a = torch.randn((m, k), generator=gen, device="cuda")
        b = torch.randn((k, n), generator=gen, device="cuda")
        a_q, b_q, sa, sb = ops.quantize_blocks(a, b, bm=bm, bn=bn, bk=bk)
        got = ops.fp8_matmul(a, b, bm=bm, bn=bn, bk=bk, impl="kernel")
        torch.cuda.synchronize()
        want = ops.fp8_matmul(a, b, bm=bm, bn=bn, bk=bk, impl="plain")

        def bad(aq, sa_, sb_, b_q=b_q, bm=bm, bn=bn, bk=bk, m=m, n=n):
            return lambda: ops.scaled_fp8_matmul(
                aq, b_q, sa_, sb_, bm=bm, bn=bn, bk=bk,
                impl="kernel")[:m, :n]
        ratios.append(check_fp8(
            f"fp8_matmul[M={m},K={k},N={n},bm={bm},bn={bn},bk={bk}]", got,
            want, a_q[:m], b_q[:, :n], sa.repeat_interleave(bm)[:m],
            sb.repeat_interleave(bn)[:n], faults={
                "a scale of the wrong block": (bad(a_q, sa.roll(1), sb),
                                               True),
                "b scale of the wrong block": (bad(a_q, sa, sb.roll(1)),
                                               True),
                "dropped k-step": (bad(_dropped_kstep(a_q), sa, sb), True)}))
    # K = 200 reaches the kernel padded to 208 (TMA's 16-byte rows); the
    # one-sign operands come last
    for m, k, n, draw in ((192, 64, 192, torch.randn),
                          (384, 200, 320, torch.randn),
                          (512, 1024, 512, torch.rand)):
        a_q, sa = quantize_fp8(draw((m, k), generator=gen, device="cuda"))
        b_q, sb = quantize_fp8(draw((n, k), generator=gen,
                                    device="cuda").t())
        assert b_q.t().is_contiguous(), "b_q is not column-major"

        def run(aq, impl="kernel", b_q=b_q, sa=sa, sb=sb, m=m, n=n, k=k):
            return ops.scaled_fp8_matmul(aq, b_q, sa.reshape(1),
                                         sb.reshape(1), bm=m, bn=n, bk=k,
                                         impl=impl)
        faults = {"dropped k-step":
                  (lambda run=run, a_q=a_q: run(_dropped_kstep(a_q)), True)}
        if k % 16 == 0:                        # _scaled_mm's contract
            faults["no promotion"] = (_no_promotion(a_q, b_q, sa, sb),
                                      draw is torch.rand)
        sign = "one-sign operands" if draw is torch.rand else "b column-major"
        ratios.append(check_fp8(
            f"fp8_matmul[per-tensor, M={m},K={k},N={n},{sign}]", run(a_q),
            run(a_q, "plain"), a_q, b_q, sa.expand(m), sb.expand(n),
            faults=faults))

    M, N, K = K6_M, K6_N, HPL_NB
    a = torch.randn((M, K), generator=gen, device="cuda")
    b = torch.randn((K, N), generator=gen, device="cuda")
    a_q, sa = quantize_fp8(a)
    b_q, sb = quantize_fp8(b)
    del a, b

    def run(impl):
        return ops.scaled_fp8_matmul(a_q, b_q, sa.reshape(1), sb.reshape(1),
                                     bm=M, bn=N, bk=K, impl=impl)
    got = run("kernel")
    torch.cuda.synchronize()
    want = run("plain")
    err = (got - want).abs().max().item()
    b_cm = b_q.t().contiguous().t()            # column-major, as cuBLASLt takes
    ratios.append(check_fp8(
        f"fp8_matmul[per-tensor, M={M},K={K},N={N}]", got, want, a_q, b_q,
        sa.expand(M), sb.expand(N), faults={
            "dropped k-step": (lambda: ops.scaled_fp8_matmul(
                _dropped_kstep(a_q), b_q, sa.reshape(1), sb.reshape(1),
                bm=M, bn=N, bk=K, impl="kernel"), True),
            "no promotion": (_no_promotion(a_q, b_cm, sa, sb), False)}))
    del got, want
    log("hpc", f"fp8_matmul: largest |Δ|/((|a||b|)·s) over the checks "
        f"{max(ratios):.3e} (one-sign operands {ratios[-2]:.3e}, signed "
        f"{max(ratios[:-2] + ratios[-1:]):.3e}); limit 2^-9 = "
        f"{2.0 ** -9:.3e} plus 2·γ_K")
    ms = event_ms(lambda: run("kernel"), flush, iters=5)
    plain_ms = event_ms(lambda: run("plain"), flush, iters=3)
    library = "torch._scaled_mm[out f32]"
    try:
        lib_ms = event_ms(lambda: torch._scaled_mm(
            a_q, b_cm, scale_a=sa, scale_b=sb, out_dtype=torch.float32),
            flush, iters=5)
    except RuntimeError as e:                  # the yardstick only
        log("hpc", f"_scaled_mm refused an f32 output ({e}); timing it with "
            "a bf16 output")
        library = "torch._scaled_mm[out bf16]"
        lib_ms = event_ms(lambda: torch._scaled_mm(
            a_q, b_cm, scale_a=sa, scale_b=sb, out_dtype=torch.bfloat16),
            flush, iters=5)
    nbytes = M * K + K * N + 4 * M * N + 8
    flops = 2.0 * M * N * K
    # a reading above the fp8 tensor-core peak is a misread timer
    assert flops / (ms * 1e-3) <= FP8_FLOPS, \
        f"fp8_matmul timed at {ms:.3f} ms, above the fp8 tensor-core peak"
    b_ms, b_by = bound(nbytes, flops, FP8_FLOPS)
    log("hpc", f"fp8_matmul[e4m3] M=N={M} K={K}: kernel {ms:.3f} ms "
        f"({flops / ms / 1e9:.1f} TFLOP/s) plain {plain_ms:.3f} ms "
        f"{library} {lib_ms:.3f} ms bound {b_ms:.4f} ms ({b_by}, "
        f"{nbytes / 1e9:.2f} GB; operations at the fp8 tensor-core rate "
        f"{flops / FP8_FLOPS * 1e3:.4f} ms)")
    return {"fp8_matmul[e4m3]": dict(
        name="fp8_matmul", max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms, library=library)}


def _hpl_runs() -> tuple:
    """HPL (fp32) and HPL-MxP (fp8, bf16) at HPL_N, HPL_NB through the
    entry points ``run_hpl``/``run_hplmxp``, each with the kernel launch
    counts set to 0 just before it and read just after it."""
    from repro_torch.core.hpl import run_hpl
    from repro_torch.core.hplmxp import run_hplmxp
    from repro_torch.kernels import ops
    n, nb = HPL_N, HPL_NB
    counts = {}
    ops.reset_launches()                       # the main path starts here
    hpl = run_hpl(n, nb, device="cuda")
    counts["fp32"] = dict(ops.launches)        # ... and ends here
    assert hpl["passed"] and hpl["residual"] < 16, f"HPL fp32: {hpl}"
    assert counts["fp32"] == {}, f"HPL fp32 launched {counts['fp32']}"
    log("hpc", f"HPL fp32 N={n} NB={nb}: {hpl['time_s']:.2f} s "
        f"{hpl['gflops']:.1f} GFLOP/s residual {hpl['residual']:.3e}")
    runs = {"fp32": hpl}
    for prec in ("fp8", "bf16"):
        ops.reset_launches()                   # the main path starts here
        r = run_hplmxp(n, nb, lowprec=prec, ir_iters=8, device="cuda")
        counts[prec] = dict(ops.launches)      # ... and ends here
        hist = r["ir_history"]
        assert r["passed"] and r["residual"] < 16, f"HPL-MxP {prec}: {r}"
        assert hist[-1] < hist[0], f"HPL-MxP {prec}: IR history {hist}"
        # one trailing update per block step but the last, in the timed
        # factorization and in the warm-up at 2·NB
        want = ({"fp8_matmul[e4m3]": n // nb - 1 + 1} if prec == "fp8"
                else {})
        assert counts[prec] == want, \
            f"HPL-MxP {prec}: launches {counts[prec]}, expected {want}"
        log("hpc", f"HPL-MxP {prec} N={n} NB={nb}: LU {r['lu_time_s']:.2f} s "
            f"({r['gflops_lu_only']:.1f} GFLOP/s LU only), IR "
            f"{r['ir_time_s']:.3f} s, {r['gflops']:.1f} GFLOP/s; residual "
            f"{r['residual']:.3e} after IR, {r['residual_no_ir']:.3e} "
            f"without; IR history {[f'{h:.1e}' for h in hist]}; launches "
            f"{json.dumps(counts[prec])}")
        runs[prec] = r
    # information: the test matrix's 0.3·N diagonal shift shrinks the
    # trailing updates, and the fp8 error in them, as N grows;
    # _fp8_lu_alone holds the reference's criterion at its own size
    log("hpc", f"fp8 factor without IR at N={n}: residual "
        f"{runs['fp8']['residual_no_ir'] / hpl['residual']:.2f}x the fp32 "
        "factor's")
    return runs, counts


def _fp8_lu_alone() -> None:
    """The reference's ``test_hplmxp_fp8_lu_alone_is_inaccurate`` on the
    card: at n = 256, nb = 64 the fp8 factor solved without refinement
    must leave more than 5x the fp32 factor's scaled residual.  Larger n
    are logged: the test matrix's 0.3·n diagonal shift shrinks the
    trailing updates, and with them the fp8 error, as 1/n."""
    from repro_torch.core.hpl import (blocked_lu, hpl_residual, lu_solve,
                                      make_test_matrix)
    for n, nb in ((256, 64), (1024, 128), (4096, 512), (16384, 1024)):
        a, b = make_test_matrix(n, device="cuda")
        r = {m: float(hpl_residual(a, lu_solve(blocked_lu(
            a, nb=nb, matmul=m), b), b)) for m in ("fp8", "fp32")}
        ratio = r["fp8"] / r["fp32"]
        log("hpc", f"fp8 LU without IR, n={n} nb={nb}: residual "
            f"{r['fp8']:.3e} = {ratio:.1f}x the fp32 factor's "
            f"{r['fp32']:.3e}" + (" (must exceed 5x)" if n == 256 else ""))
        if n == 256:
            assert ratio > 5, f"fp8 LU without IR only {ratio:.2f}x fp32's"


def _hpl_kernel_vs_plain() -> None:
    """``blocked_lu(matmul="fp8")`` at HPL_CHECK_N with the kernel and with
    the plain version.  Both factor the first panel identically, so the
    first trailing update multiplies identical quantized operands: it is
    held to ``check_fp8``'s bound, with a dropped k-step planted.  Later
    panels can flip an e4m3
    rounding, so the refined solutions (8 iterations) are held instead:
    within 1e-4 of |x|∞, the f32 accuracy IR reaches on this matrix."""
    from repro_torch.core.hpl import blocked_lu, lu_solve, make_test_matrix
    from repro_torch.core.mixed_precision import (iterative_refinement,
                                                  quantize_fp8)
    from repro_torch.kernels import ops
    n, nb = HPL_CHECK_N, HPL_NB
    a, b = make_test_matrix(n, device="cuda")
    lu = {impl: blocked_lu(a, nb=nb, matmul="fp8", impl=impl)
          for impl in ("kernel", "plain")}
    l_col, u_row = lu["kernel"][nb:, :nb], lu["kernel"][:nb, nb:]
    assert torch.equal(l_col, lu["plain"][nb:, :nb]) and \
        torch.equal(u_row, lu["plain"][:nb, nb:]), "first panels differ"
    qa, sa = quantize_fp8(l_col)
    qb, sb = quantize_fp8(u_row)
    # the real path's row panel, as blocked_lu makes it: a triangular
    # solve's result, whose e4m3 copy the kernel reads without a transpose
    # when it is column-major
    u_solve = torch.linalg.solve_triangular(
        lu["kernel"][:nb, :nb], a[:nb, nb:], upper=False, unitriangular=True)
    log("hpc", f"row panel from solve_triangular: strides "
        f"{u_solve.stride()}, its e4m3 copy column-major (no transpose "
        f"copy): {quantize_fp8(u_solve)[0].t().is_contiguous()}")
    del u_solve
    first = {impl: ops.scaled_fp8_matmul(qa, qb, sa.reshape(1),
                                         sb.reshape(1), bm=n - nb, bn=n - nb,
                                         bk=nb, impl=impl)
             for impl in ("kernel", "plain")}
    check_fp8(f"first trailing update N={n}", first["kernel"],
              first["plain"], qa, qb, sa.expand(n - nb), sb.expand(n - nb),
              faults={"dropped k-step": (lambda: ops.scaled_fp8_matmul(
                  _dropped_kstep(qa), qb, sa.reshape(1), sb.reshape(1),
                  bm=n - nb, bn=n - nb, bk=nb, impl="kernel"), True)})
    x = {}
    for impl, f in lu.items():
        x[impl], _ = iterative_refinement(lambda v: a @ v,
                                          lambda r, f=f: lu_solve(f, r), b,
                                          iters=8)
    dx = (x["kernel"] - x["plain"]).abs().max().item()
    scale = x["plain"].abs().max().item()
    dlu = (lu["kernel"] - lu["plain"]).abs().max().item()
    assert dx <= 1e-4 * scale, \
        f"IR solutions kernel vs plain differ by {dx:.3e} (|x| {scale:.3e})"
    log("hpc", f"blocked_lu fp8 N={n}: factors kernel vs plain max|Δ| "
        f"{dlu:.3e}; IR solutions max|Δ| {dx:.3e} (|x|∞ {scale:.3e}, "
        "limit 1e-4·|x|∞)")


def _hpcg_runs() -> None:
    """HPCG at 256³ (50 iterations, the reference default) with the true
    residual recomputed against the recurrence's, then the 48³,
    90-iteration case of ``benchmarks/run.py``, which must converge."""
    from repro_torch.core.hpcg import run_hpcg
    e = HPCG_EDGE
    r = run_hpcg(e, e, e, max_iters=50, device="cuda")
    ratio = r["true_rel_residual"] / r["rel_residual"]
    # in f32 the recurrence drifts from the true residual by ~eps·|A||x|,
    # far below a residual that 50 iterations leave at this size
    assert 1 / 1.5 < ratio < 1.5, f"HPCG {e}³: true/recurrence {ratio}"
    log("hpc", f"HPCG {e}³ 50 iterations: {r['time_s'] * 1e3:.1f} ms "
        f"{r['gflops']:.1f} GFLOP/s {r['bandwidth_gbs']:.1f} GB/s (nominal "
        f"bytes), relative residual {r['rel_residual']:.3e}, true "
        f"{r['true_rel_residual']:.3e} (ratio {ratio:.4f}, limit 1.5x)")
    r = run_hpcg(48, 48, 48, max_iters=90, device="cuda")
    assert r["converged"], f"HPCG 48³: {r}"
    log("hpc", f"HPCG 48³ 90 iterations: {r['time_s'] * 1e3:.1f} ms "
        f"{r['gflops']:.2f} GFLOP/s, relative residual "
        f"{r['rel_residual']:.3e} (converged < 1e-4)")


def phase_hpc() -> tuple:
    """The HPC path: K6 against its plain version and timed; HPL fp32 and
    HPL-MxP fp8/bf16 at full size; the fp8 factorization with the kernel
    against the plain version; HPCG.  Returns K6's results and the
    launch counts of each HPL run."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    t0 = time.perf_counter()
    results = _fp8_kernel(gen, flush)
    del flush
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    runs, counts = _hpl_runs()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    t2 = time.perf_counter()
    _fp8_lu_alone()
    _hpl_kernel_vs_plain()
    _hpcg_runs()
    log("hpc", f"phase times: K6 checks {t1 - t0:.1f} s, HPL runs "
        f"{t2 - t1:.1f} s (peak {peak:.1f} GiB allocated), the rest "
        f"{time.perf_counter() - t2:.1f} s")
    return results, counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs the "
              "card", file=sys.stderr)
        return 2
    smi = phase_device()
    phase_build()
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    results = phase_kernels(flush)
    del flush
    phase_variants()
    runs, counts = phase_serve()
    counts["fixed"] = phase_serve_fixed(runs["bf16"])
    reqs = sorted(runs["bf16"]["finished"], key=lambda q: q.rid)
    prompts = [q.prompt for q in reqs[:8]]
    requests = [(q.prompt, q.max_new_tokens) for q in reqs]
    want = {tag: ({q.rid: q.generated for q in runs[tag]["finished"]},
                  runs[tag]["engine"].trace) for tag in ("bf16", "fp8")}
    params = runs["bf16"]["engine"].params
    del runs, reqs                             # free the serving state
    gc.collect()
    torch.cuda.empty_cache()
    phase_telemetry(params, requests, want)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    # the engines' pools, weights and graphs (with their private memory)
    # go with them
    log("serve", f"serving state freed: "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated, "
        f"{torch.cuda.memory_reserved() / 2 ** 30:.2f} GiB reserved")
    phase_fleet()
    gc.collect()
    torch.cuda.empty_cache()
    log("fleet", f"fleet state freed: "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated")
    phase_f32(prompts)
    gc.collect()
    torch.cuda.empty_cache()
    phase_train()
    hpc_results, hpc_counts = phase_hpc()
    results.update(hpc_results)
    counts["hplmxp_fp8"] = hpc_counts["fp8"]
    source = "src/repro_torch/kernels/"
    meta = {
        "paged_decode_attention": (
            "cuda", source + "csrc/paged_decode_attention.cu",
            "src/repro/kernels/decode_attention.py:159"),
        "quantized_paged_decode_attention": (
            "cuda", source + "csrc/paged_decode_attention.cu",
            "src/repro/kernels/decode_attention.py:254"),
        "rmsnorm": ("triton", source + "rmsnorm.py",
                    "src/repro/kernels/rmsnorm.py:25"),
        "add_rmsnorm": ("triton", source + "rmsnorm.py",
                        "src/repro/kernels/rmsnorm.py:25"),
        "rmsnorm_qk": ("triton", source + "rmsnorm.py",
                       "src/repro/kernels/rmsnorm.py:25"),
        "decode_attention": ("cuda", source + "csrc/decode_attention.cu",
                             "src/repro/kernels/decode_attention.py:63"),
        "flash_attention": ("cuda", source + "csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:79"),
        "fp8_matmul": ("cuda", source + "csrc/fp8_matmul.cu",
                       "src/repro/kernels/fp8_matmul.py:42"),
    }
    kernels = []
    # each row's launches come from the serving run that drove it: the
    # paged attention kernels from the run with their pool type, the norm
    # kernels (which every run drives) from the bf16 paged run, the dense
    # decode and flash kernels from the fixed-slot engine run
    for key, run in (("paged_decode_attention[bf16]", "bf16"),
                     ("quantized_paged_decode_attention[fp8]", "fp8"),
                     ("quantized_paged_decode_attention[int8]", "int8"),
                     ("rmsnorm[D=2048]", "bf16"),
                     ("add_rmsnorm[D=2048]", "bf16"),
                     ("rmsnorm_qk[D=128]", "bf16"),
                     ("decode_attention[bf16]", "fixed"),
                     ("flash_attention[causal]", "fixed"),
                     ("fp8_matmul[e4m3]", "hplmxp_fp8")):
        r = results[key]
        route, src, replaces = meta[r["name"]]
        n = counts[run].get(key, 0)
        if n <= 0:
            raise AssertionError(f"{key} never launched on the path")
        kernels.append({"name": key, "route": route, "source": src,
                        "replaces": replaces, "launches": n,
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"],
                        "library": r["library"]})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
