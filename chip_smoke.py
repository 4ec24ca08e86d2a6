#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA H100.

  python3 chip_smoke.py

Phases, each printed as it runs:

1. device — the card's name and power limit (nvidia-smi), torch and CUDA
   versions; TF32 is switched off for float32 matmuls and convolutions;
2. build — the CUDA kernels compile from ``src/repro_torch/kernels/csrc``
   with nvcc, and the Triton kernel compiles at its first launch;
3. kernels — every kernel of the serving paths against its plain PyTorch
   version at the serving shapes of qwen3-1.7b (H=16, KVH=8, d=128;
   paged decode: page 16, 8 seats with lengths from 1 to 2048; dense
   decode: 8 slots of 545 keys, lengths 1 to 545; flash prefill: one
   causal prompt of 511 tokens; RMSNorm at D=2048 and D=128), with its
   time, the plain version's time, one PyTorch library call's time as a
   yardstick (``F.scaled_dot_product_attention`` pinned to one backend,
   ``F.rms_norm``), and the least time the card could take; untimed,
   RMSNorm at the k-norm and prefill-chunk shapes and flash prefill at 64
   and 37 tokens; then the same checks off those shapes (f32 queries,
   pools and caches, GQA groups 1 and 4, head dims 16 to 256, odd cache
   lengths, sliding-window and non-causal flash, f32 RMSNorm);
4. serve — ``serve_paged`` at the full width of qwen3-1.7b (28 layers,
   d_model 2048, vocab 151936, bf16 compute, weights from a seeded
   torch.Generator), 16 requests with prompts of 64-511 tokens and 32
   new tokens each, served with a bf16, an fp8 and an int8 KV pool;
   checks for each run that every request finished, every token is in
   the vocabulary, no logit was NaN, and that the kernels carried the
   path (launch counts, set to 0 before the run and read after it);
   then one fused tick on the same state with the kernels and with the
   plain versions, whose logits must agree, and the steady tick's wall
   time, device busy time and top kernels (torch.profiler; bf16 and fp8
   pools);
5. serve-fixed — the fixed-slot path at the same width: ``serve`` (the
   static batch behind ``--engine batch``: 4 prompts of 128 tokens, 16
   new tokens each), then a ``ServingEngine`` (8 slots, max_len 544) over
   the same 16 requests as the paged runs, with the same checks and the
   launch counts of the dense decode and flash kernels; one decode step
   with the kernels and with the plain versions, whose logits must agree;
   the steady decode step's wall time, device busy time and idle share;
   and, as information, how many greedy tokens the fixed-slot and bf16
   paged engines share;
6. summary — one JSON line listing the kernels, the card's name and power
   limit, and as the last line ``{"ok": true, "device": {...}}``.

Any failure raises: the script exits non-zero and prints no ``ok`` line.
It never runs on the CPU: without CUDA it stops before any phase.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.nn.attention import SDPBackend, sdpa_kernel  # noqa: E402

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
F32_FLOPS = 67e12              # H100 SXM float32 rate outside tensor cores
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor-core rate
ARCH = "qwen3-1.7b"
H, KVH, HEAD_DIM, PAGE = 16, 8, 128, 16
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


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, flush: torch.Tensor, iters: int = ITERS) -> float:
    """Mean device time of one ``fn()`` in ms, with the 50 MB L2 cache
    flushed before every call (the serving path reads each layer's pool
    cold): the device time torch.profiler gives the kernels ``fn``
    launched.  Raises if the profiler saw no device time."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            flush.zero_()
            with torch.profiler.record_function("chip_smoke.timed"):
                fn()
        torch.cuda.synchronize()
    us = sum(a.device_time_total for a in prof.key_averages()
             if a.key == "chip_smoke.timed")
    if us <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    return us / 1e3 / iters


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


def phase_build() -> None:
    from repro_torch.kernels import _build, ops
    t0 = time.perf_counter()
    logs = _build.build_all()
    t_nvcc = time.perf_counter() - t0
    for name, text in logs.items():
        for ln in text.splitlines():
            if "registers" in ln or "spill" in ln:
                log("build", f"{name}: {ln.strip()}")
    t1 = time.perf_counter()
    for d in (2048, HEAD_DIM):
        x = torch.ones((2, d), dtype=torch.bfloat16, device="cuda")
        ops.rmsnorm(x, torch.zeros(d, device="cuda"), impl="kernel")
    torch.cuda.synchronize()
    log("build", f"nvcc {t_nvcc:.1f} s ({len(logs)} sources built), "
        f"triton {time.perf_counter() - t1:.1f} s")


def _paged_inputs(gen: torch.Generator):
    """8 seats at the serving shapes, pages scattered over the pool."""
    need = [-(-n // PAGE) for n in SEAT_LENGTHS]
    P = 1 + sum(need)
    perm = (torch.randperm(P - 1, generator=gen, device="cuda") + 1).int()
    table = torch.zeros((len(need), N_TABLE), dtype=torch.int32,
                        device="cuda")
    at = 0
    for a, k in enumerate(need):
        table[a, :k] = perm[at:at + k]
        at += k
    lengths = torch.tensor(SEAT_LENGTHS, dtype=torch.int32, device="cuda")
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
    results.update(_dense_decode_kernel(gen, flush))
    results.update(_flash_kernel(gen, flush))
    return results


def _dense_decode_kernel(gen: torch.Generator, flush: torch.Tensor) -> dict:
    """K4 at the fixed-slot decode shapes: 8 slots of MAX_LEN + 1 keys,
    lengths SLOT_LENGTHS (the last an idle slot on the scratch index)."""
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
    log("kernels", f"decode_attention[bf16] max|err| {err:.3e} kernel "
        f"{ms:.4f} ms plain {plain_ms:.4f} ms {SDPA_EFF} {lib_ms:.4f} ms "
        f"bound {b_ms:.5f} ms ({b_by}, {nbytes / 1e6:.2f} MB; idle slot "
        f"walks {MAX_LEN + 1} of {valid} keys)")
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


def _flash_kernel(gen: torch.Generator, flush: torch.Tensor) -> dict:
    """K5 at the prefill shapes: one causal prompt of PREFILL_S tokens
    timed; 64 and 37 tokens checked."""
    from repro_torch.kernels import ops
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
    from repro_torch.kernels import ops
    gen = torch.Generator(device="cuda").manual_seed(3)
    # f32 outputs: online vs dense softmax, sums in another order
    f32_tol = (2e-5, 1e-4)
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
        tol = f32_tol if qdt == torch.float32 else (BF16_ATOL, BF16_RTOL)
        err = check_close(f"paged[H={H_},KVH={KVH_},d={d},{qdt},{pool}]",
                          got, want, *tol)
        log("variants", f"paged decode H={H_} KVH={KVH_} d={d} q={qdt} "
            f"pool={pool}: max|err| {err:.3e}")
    for d in (64, 2048):
        x = torch.randn((5, d), generator=gen, device="cuda")
        w = torch.randn((d,), generator=gen, device="cuda")
        err = check_close(f"rmsnorm[f32,D={d}]",
                          ops.rmsnorm(x, w, impl="kernel"),
                          ops.rmsnorm(x, w, impl="plain"), *f32_tol)
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
        tol = f32_tol if qdt == torch.float32 else (BF16_ATOL, BF16_RTOL)
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
        tol = f32_tol if dt == torch.float32 else (BF16_ATOL, BF16_RTOL)
        err = check_close(f"flash[B={B},Sq={Sq},Skv={Skv},H={H_},"
                          f"KVH={KVH_},d={d},{dt},causal={causal},"
                          f"window={window}]", got, want, *tol)
        log("variants", f"flash Sq={Sq} Skv={Skv} H={H_} KVH={KVH_} d={d} "
            f"{dt} causal={causal} window={window}: max|err| {err:.3e}")
    torch.cuda.synchronize()


def _check_run(tag: str, r: dict, cfg, counts: dict) -> None:
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
    # the attention kernel of the pool once per layer per decode tick; per
    # model step (decode tick or prefill chunk) ln1 and ln2 per layer plus
    # the final norm at D=2048, q-norm and k-norm per layer at D=128; no
    # other kernel
    L, steps = cfg.num_layers, ticks + chunks
    want = {kernel: ticks * L,
            f"rmsnorm[D={cfg.d_model}]": (2 * L + 1) * steps,
            f"rmsnorm[D={cfg.head_dim}]": 2 * L * steps}
    assert counts == want, \
        f"{tag}: launches {counts}, expected {want} for {ticks} decode " \
        f"ticks and {chunks} prefill chunks"
    m = r["metrics"]
    log("serve", f"{tag}: {m['completed']:.0f} requests "
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


def _tick(eng, cache, state, impl):
    from repro_torch.models import model as M
    s = {k: t.clone() for k, t in state.items()}
    return M.fused_decode_tick(
        eng.policy.params, eng.cfg, cache, s["last"], s["pos"], s["table"],
        s["nv"], s["temp"], s["top_k"], s["top_p"], s["seed"], s["rid"],
        s["step"], impl=impl)


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


def _profile_steady(phase: str, what: str, step, steps: int = 5) -> None:
    """Wall time of a steady model ``step()`` (which ends by bringing its
    tokens to the host, as the engine does), its device busy time (the
    kernels' time under torch.profiler) and the kernels that take it.
    The idle share compares the busy time with the wall time measured
    without the profiler, whose host overhead it would otherwise count."""
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    wall = (time.perf_counter() - t0) / steps * 1e3
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(steps):
            step()
    kernels = [a for a in prof.key_averages()
               if a.device_type == torch.autograd.DeviceType.CUDA
               and a.self_device_time_total > 0]
    busy = sum(a.self_device_time_total for a in kernels) / steps / 1e3
    if busy <= 0:
        raise RuntimeError(f"{what}: torch.profiler recorded no device time")
    kernels.sort(key=lambda a: a.self_device_time_total, reverse=True)
    log(phase, f"{what}: wall {wall:.2f} ms, device busy {busy:.3f} ms "
        f"({sum(a.count for a in kernels) // steps} kernels), idle share "
        f"{1 - busy / wall:.3f}")
    for a in kernels[:6]:
        log(phase, f"{what}:   {a.self_device_time_total / steps / 1e3:.4f} "
            f"ms x{a.count // steps} {a.key[:80]}")


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
    """The steady fused tick (8 seats, kernels) under ``_profile_steady``."""
    state = _tick_state(eng)
    cache = _clone(eng.policy.cache)
    _profile_steady("serve", f"{tag}: steady fused tick",
                    lambda: _tick(eng, cache, state, "kernel")[0].cpu())


def phase_serve():
    """Serves the same 16 requests (prompts of 64-511 tokens, 32 new
    tokens each) with a bf16, an fp8 and an int8 pool; returns the runs
    and the kernel launches of each run, read just after it, by pool."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve_paged
    cfg = get_config(ARCH)
    kw = dict(reduced=False, device="cuda", requests=16, gen=32, min_gen=32,
              min_prompt_len=64, max_seq_len=512 + 32, page_size=PAGE,
              num_pages=16 * 34 + 16, max_seats=8,
              prefill_chunk=PREFILL_CHUNK, seed=0)
    runs, counts = {}, {}
    for tag in ("bf16", "fp8", "int8"):
        ops.reset_launches()                   # the main path starts here
        runs[tag] = serve_paged(ARCH, kv_dtype=None if tag == "bf16"
                                else tag, **kw)
        counts[tag] = dict(ops.launches)       # ... and ends here
        _check_run(tag, runs[tag], cfg, counts[tag])
    for tag, r in runs.items():
        _tick_kernel_vs_plain(f"{tag} pool", r["engine"])
        if tag != "int8":
            _profile_tick(f"{tag} pool", r["engine"])
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
    _profile_steady("serve-fixed", "steady decode step", step)


def phase_serve_fixed(paged: dict) -> dict:
    """The fixed-slot path at full width: the static batch of ``serve``,
    then a ``ServingEngine`` over the requests of the bf16 paged run
    ``paged`` (same weights, prompts and budgets).  Returns the kernel
    launches of the engine run, read just after it."""
    from repro_torch.configs import get_config
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
    # the flash kernel once per layer; per model call ln1 and ln2 per
    # layer plus the final norm at D=2048, q- and k-norm per layer at
    # D=128; no other kernel
    L = cfg.num_layers
    want = {"decode_attention[bf16]": ticks * L,
            "flash_attention[causal]": prefills * L,
            f"rmsnorm[D={cfg.d_model}]": (2 * L + 1) * (ticks + prefills),
            f"rmsnorm[D={cfg.head_dim}]": 2 * L * (ticks + prefills)}
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
    _profile_decode_step(eng)
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
        "decode_attention": ("cuda", source + "csrc/decode_attention.cu",
                             "src/repro/kernels/decode_attention.py:63"),
        "flash_attention": ("cuda", source + "csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:79"),
    }
    kernels = []
    # each row's launches come from the serving run that drove it: the
    # paged attention kernels from the run with their pool type, RMSNorm
    # (which every run drives) from the bf16 paged run, the dense decode
    # and flash kernels from the fixed-slot engine run
    for key, run in (("paged_decode_attention[bf16]", "bf16"),
                     ("quantized_paged_decode_attention[fp8]", "fp8"),
                     ("quantized_paged_decode_attention[int8]", "int8"),
                     ("rmsnorm[D=2048]", "bf16"), ("rmsnorm[D=128]", "bf16"),
                     ("decode_attention[bf16]", "fixed"),
                     ("flash_attention[causal]", "fixed")):
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
