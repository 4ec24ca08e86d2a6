#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA H100.

  python3 chip_smoke.py

Phases, each printed as it runs:

1. device — the card's name and power limit (nvidia-smi), torch and CUDA
   versions; TF32 is switched off for float32 matmuls and convolutions;
2. build — the CUDA kernels compile from ``src/repro_torch/kernels/csrc``
   with nvcc, and the Triton kernel compiles at its first launch;
3. kernels — every kernel of the serving path against its plain PyTorch
   version at the serving shapes of qwen3-1.7b (H=16, KVH=8, d=128,
   page 16, 8 seats with lengths from 1 to 2048; RMSNorm at D=2048 and
   D=128), with its time, the plain version's time, one PyTorch library
   call's time as a yardstick, and the least time the card could take;
   untimed, RMSNorm at the k-norm and prefill-chunk shapes; then the same
   checks off those shapes (f32 queries and
   pools, GQA groups 1 and 4, head dims 16 and 64, f32 RMSNorm);
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
5. summary — one JSON line listing the kernels, the card's name and power
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

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
F32_FLOPS = 67e12              # H100 SXM float32 rate outside tensor cores
ARCH = "qwen3-1.7b"
H, KVH, HEAD_DIM, PAGE = 16, 8, 128, 16
SEAT_LENGTHS = (1, 16, 17, 255, 700, 1024, 1531, 2048)
N_TABLE = 2048 // PAGE
PREFILL_CHUNK = 128
ITERS = 20


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


def bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


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
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qs, kg, vg, attn_mask=mask), flush)

        item = k.element_size()
        nbytes = (2 * valid * KVH * HEAD_DIM * item
                  + (2 * valid * KVH * 4 if ks is not None else 0)
                  + 2 * q.numel() * q.element_size()
                  + table.numel() * 4 + lengths.numel() * 4)
        b_ms, b_by = bound(nbytes, 4.0 * valid * H * HEAD_DIM)
        log("kernels", f"{name}[{dt}] max|err| {err:.3e} kernel {ms:.4f} ms "
            f"plain {plain_ms:.4f} ms sdpa {lib_ms:.4f} ms bound "
            f"{b_ms:.4f} ms ({b_by}, {nbytes / 1e6:.2f} MB)")
        results[f"{name}[{dt}]"] = dict(
            name=name, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)

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
            bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
    return results


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


def _tick_kernel_vs_plain(tag: str, eng) -> float:
    """One fused tick on one state, with the kernels and with the plain
    versions; returns max |logits difference|."""
    state = _tick_state(eng)
    out = {}
    for impl in ("kernel", "plain"):
        cache = {p: {k: t.clone() for k, t in ent.items()}
                 for p, ent in eng.policy.cache.items()}
        toks, logits = _tick(eng, cache, state, impl)
        torch.cuda.synchronize()
        out[impl] = (toks.clone(), logits.clone())
        del cache
    (tk, lk), (tp, lp) = out["kernel"], out["plain"]
    assert bool(torch.isfinite(lk).all()) and bool(torch.isfinite(lp).all())
    diff = (lk - lp).abs().max().item()
    scale = lp.abs().max().item()
    # bf16 rounding differences of the kernels compound over 28 layers:
    # allow 5% of the largest logit
    assert diff <= 0.05 * scale + 1e-3, \
        f"{tag}: fused tick logits kernel vs plain differ by {diff:.3e} " \
        f"(largest logit {scale:.3e})"
    log("serve", f"{tag}: fused tick kernel vs plain: max|Δlogit| "
        f"{diff:.3e} (largest |logit| {scale:.3e}), greedy tokens equal "
        f"{int((tk == tp).sum())}/{len(tk)}")
    return diff


def _profile_tick(tag: str, eng, ticks: int = 5) -> None:
    """Wall time of the steady fused tick (8 seats, kernels), its device
    busy time (the kernels' time under torch.profiler) and the kernels
    that take it.  The idle share compares the busy time with the wall
    time measured without the profiler, whose host overhead it would
    otherwise count."""
    state = _tick_state(eng)
    cache = {p: {k: t.clone() for k, t in ent.items()}
             for p, ent in eng.policy.cache.items()}
    for _ in range(2):
        _tick(eng, cache, state, "kernel")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ticks):
        _tick(eng, cache, state, "kernel")[0].cpu()
    wall = (time.perf_counter() - t0) / ticks * 1e3
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(ticks):
            _tick(eng, cache, state, "kernel")[0].cpu()
    kernels = [a for a in prof.key_averages()
               if a.device_type == torch.autograd.DeviceType.CUDA
               and a.self_device_time_total > 0]
    busy = sum(a.self_device_time_total for a in kernels) / ticks / 1e3
    if busy <= 0:
        raise RuntimeError(f"{tag}: torch.profiler recorded no device time")
    kernels.sort(key=lambda a: a.self_device_time_total, reverse=True)
    log("serve", f"{tag}: steady fused tick: wall {wall:.2f} ms, device "
        f"busy {busy:.3f} ms ({sum(a.count for a in kernels) // ticks} "
        f"kernels), idle share {1 - busy / wall:.3f}")
    for a in kernels[:6]:
        log("serve", f"{tag}:   "
            f"{a.self_device_time_total / ticks / 1e3:.4f} ms/tick "
            f"x{a.count // ticks} {a.key[:80]}")


def phase_serve() -> dict:
    """Serves the same 16 requests (prompts of 64-511 tokens, 32 new
    tokens each) with a bf16, an fp8 and an int8 pool; returns the kernel
    launches of each run, read just after it, by pool."""
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
    counts = phase_serve()
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
    }
    kernels = []
    # each row's launches come from the serving run that drove it: the
    # attention kernels from the run with their pool type, RMSNorm (which
    # every run drives) from the bf16 run
    for key, run in (("paged_decode_attention[bf16]", "bf16"),
                     ("quantized_paged_decode_attention[fp8]", "fp8"),
                     ("quantized_paged_decode_attention[int8]", "int8"),
                     ("rmsnorm[D=2048]", "bf16"), ("rmsnorm[D=128]", "bf16")):
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
                        "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
