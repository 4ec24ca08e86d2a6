"""Serving entry points of the port (counterpart of ``repro.launch.serve``):

- ``serve`` (``--engine batch``, the default, as in the JAX CLI): one
  static batch of prompts through ``models.model.prefill`` and then
  ``decode_step`` token by token — the fixed-slot path, with the flash
  prefill and dense decode kernels on the card;
- ``serve_paged`` (``--engine paged``): a mixed-length request stream
  through ``runtime.serving.PagedServingEngine``, reporting its metrics
  (TTFT, tokens/s, page utilization, prefix-hit rate).

Weights are drawn from a ``torch.Generator`` seeded with ``--seed`` on the
device, prompts from ``numpy.random.default_rng(seed)``.  Both run on the
card unless ``device="cpu"`` (``--device cpu``) is given.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
      --batch 4 --prompt-len 128 --gen 16
  PYTHONPATH=src python -m repro_torch.launch.serve --engine paged \\
      --arch qwen3-1.7b --requests 8 --gen 16 --temperature 0.8 --top-p 0.95
  PYTHONPATH=src python -m repro_torch.launch.serve --engine paged \\
      --device cpu --kv-dtype fp8 --requests 6 --gen 10
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs import get_config, reduced_config, resolve_arch
from repro_torch.core.mixed_precision import KV_DTYPES
from repro_torch.models import model as M
from repro_torch.models.convert import cast_for_compute
from repro_torch.runtime.sampler import Sampler, SamplingParams
from repro_torch.runtime.serving import PagedServingEngine, resolve_device


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(arch: str, *, batch: int = 4, prompt_len: int = 32, gen: int = 16,
          reduced: bool = True, seed: int = 0,
          sampling: Optional[SamplingParams] = None, device=None):
    """Static-batch generation: prefill ``batch`` random prompts of
    ``prompt_len`` tokens, then ``gen - 1`` decode steps (the first token
    comes from the prefill logits).  Greedy unless ``sampling`` says
    otherwise; stochastic rows go through the host ``Sampler`` with
    ``rid`` = the batch row and ``step`` = the token index.

    Returns ``{"generated": (batch, gen) int32 numpy array, "prefill_s",
    "decode_s", "tokens_per_s"}``; the times end in a device synchronize.

    Raises:
      ValueError: ``batch``, ``prompt_len`` or ``gen`` below 1."""
    if min(batch, prompt_len, gen) < 1:
        raise ValueError(f"--batch {batch}, --prompt-len {prompt_len} and "
                         f"--gen {gen} must all be >= 1")
    dev = resolve_device(device)
    cfg = get_config(arch)
    if reduced:
        cfg = reduced_config(cfg)
    opts = M.RunOptions(q_chunk=min(prompt_len, 512))
    gen_t = torch.Generator(device=dev).manual_seed(seed)
    params = cast_for_compute(
        M.init_params(M.param_specs(cfg), gen_t, device=dev),
        M.compute_dtype(cfg))
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (batch, prompt_len)).astype(np.int32)).to(dev)
    sampler = Sampler()

    def pick(last: torch.Tensor, step: int) -> torch.Tensor:
        """(B, V) logits -> (B, 1) int32 tokens on the device."""
        if sampling is None or sampling.greedy:
            return torch.argmax(last, dim=-1).to(torch.int32)[:, None]
        rows = last.float().cpu().numpy()
        toks = [sampler.sample(rows[b], sampling, rid=b, step=step)
                for b in range(batch)]
        return torch.tensor(toks, dtype=torch.int32, device=dev)[:, None]

    t0 = time.perf_counter()
    logits, cache = M.prefill(params, cfg, {"tokens": tokens}, opts)
    # grow the cache along the sequence axis to hold the generation
    cache = {pos: {k: torch.cat([c, c.new_zeros(c.shape[:2] + (gen,)
                                                + c.shape[3:])], dim=2)
                   for k, c in ent.items()}
             for pos, ent in cache.items()}
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    tok = pick(logits[:, -1], 0)
    out = [tok]
    t0 = time.perf_counter()
    for i in range(gen - 1):
        pos = torch.full((batch,), prompt_len + i, dtype=torch.int32,
                         device=dev)
        logits, cache = M.decode_step(params, cfg, cache, tok, pos)
        tok = pick(logits[:, -1], i + 1)
        out.append(tok)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    return {"generated": torch.cat(out, dim=1).cpu().numpy(),
            "prefill_s": t_prefill, "decode_s": t_decode,
            "tokens_per_s": batch * (gen - 1) / max(t_decode, 1e-9)}


def serve_paged(arch: str, *, requests: int = 8, gen: int = 16,
                page_size: int = 16, num_pages: int = 128,
                max_seats: int = 8, prefill_chunk: int = 32,
                reduced: bool = True, seed: int = 0,
                eos_id: Optional[int] = None,
                sampling: Optional[SamplingParams] = None,
                prefix_cache: bool = True,
                max_seq_len: Optional[int] = None,
                prompt_len: Optional[int] = None,
                min_prompt_len: int = 1, min_gen: int = 2,
                lazy_pages: bool = True, watermark: float = 0.05,
                priority: str = "standard",
                deadline_ms: Optional[float] = None,
                tbt_deadline_ms: Optional[float] = None,
                admission: str = "fcfs", aging_ticks: int = 64,
                kv_dtype: Optional[str] = None,
                class_precision: Optional[Dict[str, str]] = None,
                device=None):
    """Drive the paged engine over a request stream.

    ``max_seq_len`` bounds prompt + generation per request and defaults
    to ``(prompt_len or 3 * page_size) + gen``.  ``prompt_len`` fixes
    every prompt's length; when None, lengths are drawn from
    ``[min_prompt_len, max_seq_len - gen)``.  Generation budgets are drawn
    from ``[min_gen, gen]`` (``min_gen=gen`` fixes them).  Prompt tokens
    and generation budgets
    come from ``numpy.random.default_rng(seed)``, the weights from a
    ``torch.Generator`` seeded with ``seed`` on ``device``.  ``device``
    defaults to CUDA and raises when CUDA is absent.

    Returns ``{"finished": [Request], "metrics": snapshot, "engine":
    PagedServingEngine}``.

    Raises:
      ValueError: infeasible flag combinations, named."""
    if max_seq_len is None:
        max_seq_len = (prompt_len if prompt_len else 3 * page_size) + gen
    if prompt_len is not None and prompt_len + gen > max_seq_len:
        raise ValueError(
            f"--prompt-len {prompt_len} + --gen {gen} exceeds "
            f"--max-seq-len {max_seq_len}")
    if prompt_len is None and max_seq_len - gen <= max(min_prompt_len, 1):
        raise ValueError(
            f"--max-seq-len {max_seq_len} leaves no room for prompts of "
            f"min_prompt_len {min_prompt_len} after --gen {gen}; raise it "
            "or pass --prompt-len")
    if not 1 <= min_gen <= gen:
        raise ValueError(f"min_gen {min_gen} must lie in [1, --gen {gen}]")
    dev = resolve_device(device)
    cfg = get_config(arch)
    if reduced:
        cfg = reduced_config(cfg)
    gen_t = torch.Generator(device=dev).manual_seed(seed)
    eng = PagedServingEngine(
        cfg, M.init_params(M.param_specs(cfg), gen_t, device=dev),
        page_size=page_size, num_pages=num_pages, max_seats=max_seats,
        max_seq_len=max_seq_len, prefill_chunk=prefill_chunk,
        prefix_cache=prefix_cache, lazy_pages=lazy_pages,
        watermark=watermark, admission=admission, aging_ticks=aging_ticks,
        kv_dtype=kv_dtype, class_precision=class_precision, device=dev)
    rng = np.random.default_rng(seed)
    for _ in range(requests):
        plen = (prompt_len if prompt_len
                else int(rng.integers(min_prompt_len, max_seq_len - gen)))
        eng.submit(rng.integers(0, cfg.vocab_size, plen).astype(np.int32),
                   max_new_tokens=int(rng.integers(min_gen, gen + 1)),
                   eos_id=eos_id, sampling=sampling,
                   priority=priority, deadline_ms=deadline_ms,
                   tbt_deadline_ms=tbt_deadline_ms)
    done = eng.run()
    return {"finished": done, "metrics": eng.metrics.snapshot(),
            "engine": eng}


def parse_class_precision(spec: str) -> Dict[str, str]:
    """Parse a ``--class-precision`` map: comma-separated ``class=dtype``
    entries, e.g. ``premium=bf16,standard=fp8``.

    Raises:
      ValueError: malformed entry or an unknown dtype name."""
    out: Dict[str, str] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        cls, sep, dt = part.partition("=")
        cls, dt = cls.strip(), dt.strip()
        if not sep or not cls or not dt:
            raise ValueError(
                f"bad --class-precision entry {part!r}; expected "
                "class=dtype, e.g. premium=bf16,standard=fp8")
        if dt not in KV_DTYPES:
            raise ValueError(
                f"unknown kv dtype {dt!r} in --class-precision entry "
                f"{part!r}; expected one of {', '.join(KV_DTYPES)}")
        out[cls] = dt
    return out


def model_name(name: str) -> str:
    """argparse ``type=`` resolver for ``--model``/``--arch``."""
    try:
        return resolve_arch(name)
    except KeyError as e:
        raise argparse.ArgumentTypeError(e.args[0]) from None


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Serve on the port: a static batch (fixed-slot path) "
                    "or a request stream on the paged engine.")
    ap.add_argument("--engine", choices=("batch", "paged"), default="batch",
                    help="batch: one static batch, prefill then decode "
                         "(default); paged: the paged continuous-batching "
                         "engine over --requests")
    ap.add_argument("--model", "--arch", dest="arch", type=model_name,
                    default="qwen3-1.7b",
                    help="registry model name (default qwen3-1.7b)")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu runs the plain "
                         "versions)")
    ap.add_argument("--batch", type=int, default=4,
                    help="static batch size (--engine batch)")
    ap.add_argument("--prompt-len", type=int, default=None,
                    help="fixed prompt length (batch default 32; the "
                         "paged engine samples lengths when unset)")
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--num-pages", type=int, default=128)
    ap.add_argument("--max-seq-len", type=int, default=None,
                    help="per-request prompt+generation bound (default "
                         "(prompt_len or 3*page_size) + gen)")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="disable prefix-cache page sharing")
    ap.add_argument("--lazy-pages", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="allocate KV pages on demand during decode and "
                         "preempt under pressure")
    ap.add_argument("--watermark", type=float, default=0.05,
                    help="lazy admission gate: free-page headroom as a "
                         "fraction of pool capacity")
    ap.add_argument("--eos-id", type=int, default=None,
                    help="stop a request early on this token id")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy argmax (default)")
    ap.add_argument("--top-k", type=int, default=0, help="0 = off")
    ap.add_argument("--top-p", type=float, default=1.0, help="1.0 = off")
    ap.add_argument("--seed", type=int, default=0,
                    help="base seed for weights, prompts and sampling")
    ap.add_argument("--priority", choices=("premium", "standard", "batch"),
                    default="standard",
                    help="SLO class applied to every submitted request")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="TTFT deadline per request in ms")
    ap.add_argument("--tbt-deadline-ms", type=float, default=None,
                    help="per-decode-token deadline in ms")
    ap.add_argument("--admission", choices=("fcfs", "slo"), default="fcfs",
                    help="queue policy: fcfs or slo (priority + EDF + aging)")
    ap.add_argument("--aging-ticks", type=int, default=64,
                    help="slo anti-starvation bound in ticks")
    ap.add_argument("--kv-dtype", choices=KV_DTYPES, default=None,
                    help="KV pool storage precision (default: the compute "
                         "dtype); fp8/int8 quantize pages with per-token "
                         "scales")
    ap.add_argument("--class-precision", default=None,
                    help="SLO class -> minimum KV precision map, e.g. "
                         "premium=bf16,standard=fp8")
    return ap


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    try:
        class_precision = (parse_class_precision(args.class_precision)
                           if args.class_precision else None)
        sampling = SamplingParams(temperature=args.temperature,
                                  top_k=args.top_k, top_p=args.top_p,
                                  seed=args.seed)
        if args.engine == "batch":
            r = serve(args.arch, batch=args.batch,
                      prompt_len=args.prompt_len or 32, gen=args.gen,
                      seed=args.seed, sampling=sampling, device=args.device)
        else:
            r = serve_paged(
                args.arch, requests=args.requests, gen=args.gen,
                page_size=args.page_size, num_pages=args.num_pages,
                seed=args.seed, eos_id=args.eos_id, sampling=sampling,
                prefix_cache=not args.no_prefix_cache,
                max_seq_len=args.max_seq_len, prompt_len=args.prompt_len,
                lazy_pages=args.lazy_pages, watermark=args.watermark,
                priority=args.priority, deadline_ms=args.deadline_ms,
                tbt_deadline_ms=args.tbt_deadline_ms,
                admission=args.admission, aging_ticks=args.aging_ticks,
                kv_dtype=args.kv_dtype, class_precision=class_precision,
                device=args.device)
    except ValueError as e:
        ap.error(str(e))
    if args.engine == "batch":
        print(f"[serve] prefill={r['prefill_s'] * 1e3:.0f}ms "
              f"decode={r['decode_s'] * 1e3:.0f}ms "
              f"throughput={r['tokens_per_s']:.1f} tok/s")
        print("[serve] sample tokens:", r["generated"][0][:12].tolist())
        return
    m = r["metrics"]
    print(f"[serve.paged] device={r['engine'].device} "
          f"kv_dtype={m['kv_dtype']} page_bytes={m['page_bytes']:.0f}")
    print(f"[serve.paged] {m['completed']:.0f} requests "
          f"{m['generated_tokens']:.0f} tokens in {m['wall_s'] * 1e3:.0f}ms "
          f"({m['tokens_per_s']:.1f} tok/s) "
          f"ttft_avg={m['ttft_avg_s'] * 1e3:.0f}ms "
          f"peak_page_util={m['peak_page_utilization']:.2f} "
          f"prefix_hit_rate={m['prefix_hit_rate']:.2f} "
          f"preemptions={m['preemptions']:.0f}")
    print("[serve.paged] sample tokens:", r["finished"][0].generated[:12])


if __name__ == "__main__":
    main()
