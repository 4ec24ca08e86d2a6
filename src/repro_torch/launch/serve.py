"""Serving entry points of the port (counterpart of ``repro.launch.serve``):

- ``serve`` (``--engine batch``, the default, as in the JAX CLI): one
  static batch of prompts through ``models.model.prefill`` and then
  ``decode_step`` token by token — the fixed-slot path, with the flash
  prefill and dense decode kernels on the card;
- ``serve_paged`` (``--engine paged``): a mixed-length request stream
  through ``runtime.serving.PagedServingEngine``, reporting its metrics
  (TTFT, tokens/s, page utilization, prefix-hit rate);
- ``serve_fleet`` (``--fleet``): several models (``--models``, default
  ``qwen3-1.7b:2,llama3-8b``) behind one ``runtime.router.ModelFleet``,
  one shared page budget (``--total-pages``) and a replica selection
  policy (``--selection``), over one mixed request stream.

Weights are drawn from a ``torch.Generator`` seeded with ``--seed`` on the
device (model ``i`` of a fleet with ``seed + i``), each matmul weight cast
to the compute dtype as it is drawn
(``models.convert.init_params_for_compute``), prompts from
``numpy.random.default_rng(seed)``.  All run on the card unless
``device="cpu"`` (``--device cpu``) is given.

The paged engine and the fleet take the telemetry flags
(``--metrics-port``, ``--flight-recorder``, ``--trace-export``,
``--profile-ticks``, ``--postmortem``; see :func:`add_telemetry_args`);
the static batch has no scheduler to observe and refuses them.
``--tuning-preset alloc`` re-executes the interpreter once with tcmalloc
preloaded (see :func:`build_tuning_env`).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
      --batch 4 --prompt-len 128 --gen 16
  PYTHONPATH=src python -m repro_torch.launch.serve --engine paged \\
      --arch qwen3-1.7b --requests 8 --gen 16 --temperature 0.8 --top-p 0.95
  PYTHONPATH=src python -m repro_torch.launch.serve --engine paged \\
      --device cpu --kv-dtype fp8 --requests 6 --gen 10
  PYTHONPATH=src python -m repro_torch.launch.serve --engine paged \\
      --device cpu --arch qwen2-moe-a2.7b --requests 6 --gen 10
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --arch whisper-base --batch 2 --gen 5
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --arch phi-3-vision-4.2b --batch 2 --gen 5
  PYTHONPATH=src python -m repro_torch.launch.serve --engine paged \\
      --device cpu --profile-ticks --trace-export trace.json
  PYTHONPATH=src python -m repro_torch.launch.serve --fleet --device cpu \\
      --models qwen3-1.7b:2,llama3-8b:1:fp8 --selection slo-aware
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import get_config, reduced_config, resolve_arch
from repro_torch.core.mixed_precision import KV_DTYPES
from repro_torch.models import model as M
from repro_torch.models.convert import init_params_for_compute
from repro_torch.runtime.router import (FleetModel, ModelFleet,
                                        parse_models_spec)
from repro_torch.runtime.sampler import Sampler, SamplingParams
from repro_torch.runtime.serving import PagedServingEngine, resolve_device
from repro_torch.runtime.telemetry import (MetricsServer, Telemetry,
                                           prometheus_text, write_perfetto)


# ---------------------------------------------------------------------------
# Host allocator tuning preset
# ---------------------------------------------------------------------------
#
# The serving loop allocates host memory every tick (token vectors,
# metrics, trace tuples); the default glibc malloc serializes those on a
# global lock.  ``LD_PRELOAD`` is read by the dynamic loader at process
# start, so applying a preset re-executes the interpreter once with the
# adjusted environment.

TCMALLOC_PATH = "/usr/lib/x86_64-linux-gnu/libtcmalloc.so.4"
_TUNED_MARKER = "_REPRO_TUNED"          # guards against re-exec loops


def build_tuning_env(preset: str, env: Dict[str, str], *,
                     tcmalloc_path: str = TCMALLOC_PATH) -> Dict[str, str]:
    """Environment additions for a ``--tuning-preset`` (pure — no exec).

    ``off`` returns {}.  ``alloc`` preloads tcmalloc (skipped with no
    effect when the library is absent) and silences its large-allocation
    reports.  ``full`` adds the same as ``alloc``: the JAX package's
    ``full`` adds XLA flags on top (the step marker and the host
    platform's device count), which mean nothing to PyTorch.  An existing
    ``LD_PRELOAD`` is appended to, never clobbered, and already-present
    values are left alone (idempotent).

    Raises:
      ValueError: an unknown preset name."""
    if preset == "off":
        return {}
    if preset not in ("alloc", "full"):
        raise ValueError(f"unknown tuning preset {preset!r}; "
                         "expected off/alloc/full")
    add: Dict[str, str] = {}
    if os.path.exists(tcmalloc_path):
        prior = env.get("LD_PRELOAD", "")
        if tcmalloc_path not in prior.split(":"):
            add["LD_PRELOAD"] = ":".join(
                p for p in (prior, tcmalloc_path) if p)
        if "TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD" not in env:
            add["TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD"] = "60000000000"
    return add


def apply_tuning_preset(preset: str, argv: List[str]) -> None:
    """Re-execute ``python -m repro_torch.launch.serve argv`` with the
    preset environment applied.

    Must run before anything touches the card: ``LD_PRELOAD`` is consumed
    by the dynamic loader at process start.  No-op (returns) when the
    preset is ``off``, the environment is already tuned (the
    ``_REPRO_TUNED`` marker, set on exec, breaks the exec loop), or the
    preset adds nothing."""
    if preset == "off" or os.environ.get(_TUNED_MARKER):
        return
    add = build_tuning_env(preset, dict(os.environ))
    if not add:                          # nothing to change; just mark
        os.environ[_TUNED_MARKER] = "1"
        return
    env = {**os.environ, **add, _TUNED_MARKER: "1"}
    os.execve(sys.executable,
              [sys.executable, "-m", "repro_torch.launch.serve", *argv], env)


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

    An encoder-decoder config (whisper-base) also takes stub frame
    embeddings ``(batch, encoder_len, frontend_dim)``, standard normal
    f32 drawn from the same numpy generator after the prompts.  The JAX
    package's ``serve`` draws its frames with ``jax.random`` in
    ``make_example_batch``, which this port cannot reproduce, so the two
    entry points feed different frames at the same seed.  A vision config
    (phi-3-vision-4.2b) takes stub patch embeddings ``(batch,
    frontend_len, frontend_dim)`` the same way, standard normal f32 from
    the numpy generator after the prompts (the JAX package's again from
    ``jax.random``), written over each prompt's first ``frontend_len``
    rows.

    Returns ``{"generated": (batch, gen) int32 numpy array, "prefill_s",
    "decode_s", "tokens_per_s"}``; the times end in a device synchronize.

    Raises:
      ValueError: ``batch``, ``prompt_len`` or ``gen`` below 1, or, for a
          vision config, ``prompt_len`` below its ``frontend_len`` patch
          rows (checked before anything is built)."""
    if min(batch, prompt_len, gen) < 1:
        raise ValueError(f"--batch {batch}, --prompt-len {prompt_len} and "
                         f"--gen {gen} must all be >= 1")
    cfg = get_config(arch)
    if reduced:
        cfg = reduced_config(cfg)
    if cfg.frontend == "vision" and prompt_len < cfg.frontend_len:
        raise ValueError(f"--prompt-len {prompt_len} is shorter than "
                         f"{cfg.name}'s {cfg.frontend_len} patch rows "
                         "(frontend_len)")
    dev = resolve_device(device)
    opts = M.RunOptions(q_chunk=min(prompt_len, 512))
    gen_t = torch.Generator(device=dev).manual_seed(seed)
    params = init_params_for_compute(M.param_specs(cfg), gen_t,
                                     M.compute_dtype(cfg), device=dev)
    rng = np.random.default_rng(seed)
    req = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (batch, prompt_len)).astype(np.int32)).to(dev)}
    if cfg.encoder_decoder:
        req["audio"] = torch.from_numpy(rng.standard_normal(
            (batch, cfg.encoder_len, cfg.frontend_dim),
            dtype=np.float32)).to(dev)
    if cfg.frontend == "vision":
        req["patches"] = torch.from_numpy(rng.standard_normal(
            (batch, cfg.frontend_len, cfg.frontend_dim),
            dtype=np.float32)).to(dev)
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
    logits, cache = M.prefill(params, cfg, req, opts)
    cache = M.grow_cache(cache, prompt_len + gen)
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
                telemetry: Optional[Telemetry] = None,
                metrics_port: Optional[int] = None,
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

    ``telemetry`` attaches the observability plane (flight recorder, tick
    profiler); ``metrics_port`` serves Prometheus text exposition of the
    live engine metrics on 127.0.0.1 for the duration of the run (0 = an
    ephemeral port).

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
        cfg, init_params_for_compute(M.param_specs(cfg), gen_t,
                                     M.compute_dtype(cfg), device=dev),
        page_size=page_size, num_pages=num_pages, max_seats=max_seats,
        max_seq_len=max_seq_len, prefill_chunk=prefill_chunk,
        prefix_cache=prefix_cache, lazy_pages=lazy_pages,
        watermark=watermark, admission=admission, aging_ticks=aging_ticks,
        kv_dtype=kv_dtype, class_precision=class_precision,
        telemetry=telemetry, device=dev)
    rng = np.random.default_rng(seed)
    for _ in range(requests):
        plen = (prompt_len if prompt_len
                else int(rng.integers(min_prompt_len, max_seq_len - gen)))
        eng.submit(rng.integers(0, cfg.vocab_size, plen).astype(np.int32),
                   max_new_tokens=int(rng.integers(min_gen, gen + 1)),
                   eos_id=eos_id, sampling=sampling,
                   priority=priority, deadline_ms=deadline_ms,
                   tbt_deadline_ms=tbt_deadline_ms)
    server = None
    if metrics_port is not None:
        server = MetricsServer(
            lambda: prometheus_text({arch: eng.metrics}), port=metrics_port)
        print(f"[serve.paged] metrics: {server.url}")
    try:
        done = eng.run()
    finally:
        if server is not None:
            server.close()
    return {"finished": done, "metrics": eng.metrics.snapshot(),
            "engine": eng}


def serve_fleet(models, *, requests: int = 12, gen: int = 8,
                page_size: int = 16, total_pages: int = 64,
                max_seats: int = 4, prefill_chunk: int = 16,
                reduced: bool = True, seed: int = 0,
                eos_id: Optional[int] = None,
                sampling: Optional[SamplingParams] = None,
                prefix_cache: bool = True,
                max_seq_len: Optional[int] = None,
                prompt_len: Optional[int] = None,
                lazy_pages: bool = True, watermark: float = 0.05,
                priority: str = "standard",
                deadline_ms: Optional[float] = None,
                tbt_deadline_ms: Optional[float] = None,
                admission: str = "fcfs", aging_ticks: int = 64,
                selection: str = "least-loaded",
                kv_dtype: Optional[str] = None,
                class_precision: Optional[Dict[str, str]] = None,
                telemetry: Optional[Telemetry] = None,
                metrics_port: Optional[int] = None,
                device=None):
    """Drive a multi-model fleet over one mixed request stream.

    ``models`` is a ``--models``-style spec string
    (``llama3-8b:2:fp8,qwen3-1.7b``; module-style aliases like
    ``llama3_8b`` resolve too) or a pre-parsed
    [(name, replicas[, kv_dtype]), ...] list.  ``kv_dtype`` is the
    fleet-wide KV storage default for models whose spec entry leaves it
    unset; ``class_precision`` maps SLO classes to minimum precisions,
    steering those classes to replicas whose pool qualifies.  Every
    engine in the fleet shares one ``total_pages`` host budget —
    denominated in bytes when precisions are mixed, so quantized
    replicas' cheaper pages draw proportionally less; requests cycle
    across the models round-robin and rids are fleet-global, so
    per-request outputs match dedicated solo engines.  Model ``i``'s
    weights come from a ``torch.Generator`` seeded with ``seed + i`` on
    ``device``; the fleet casts them for compute, and the float32 trees
    go when it is built.  ``device`` defaults to CUDA and raises
    when CUDA is absent.  Returns the finished requests plus the fleet
    metrics snapshot (per-model tokens/s, TTFT, prefix hits,
    preemptions, SLO classes, budget accounting) and the fleet.

    ``telemetry`` attaches one shared observability plane (flight
    recorder tagged per ``model/replica`` engine, ``fleet_tick``
    heartbeat counters); ``metrics_port`` serves per-replica Prometheus
    exposition during the run.

    Raises:
      ValueError: a malformed ``models`` spec, an unknown model, or
          infeasible flag combinations, named."""
    if isinstance(models, str):
        try:
            models = parse_models_spec(models)
        except ValueError as e:
            raise ValueError(f"--models: {e}") from None
    try:
        models = [(resolve_arch(m[0]), m[1],
                   m[2] if len(m) > 2 and m[2] is not None else kv_dtype)
                  for m in models]
    except KeyError as e:
        raise ValueError(f"--models: {e.args[0]}") from None
    if max_seq_len is None:
        max_seq_len = (prompt_len if prompt_len else 3 * page_size) + gen
    if prompt_len is not None and prompt_len + gen > max_seq_len:
        raise ValueError(
            f"--prompt-len {prompt_len} + --gen {gen} exceeds "
            f"--max-seq-len {max_seq_len}")
    if prompt_len is None and max_seq_len - gen < 2:
        raise ValueError(
            f"--max-seq-len {max_seq_len} leaves no room for prompts "
            f"after --gen {gen}; raise it or pass --prompt-len")
    dev = resolve_device(device)
    entries = []
    for i, (name, reps, dt) in enumerate(models):
        cfg = get_config(name)
        if reduced:
            cfg = reduced_config(cfg)
        gen_t = torch.Generator(device=dev).manual_seed(seed + i)
        entries.append(FleetModel(
            name, cfg, init_params_for_compute(
                M.param_specs(cfg), gen_t, M.compute_dtype(cfg), device=dev),
            replicas=reps, kv_dtype=dt))
    fleet = ModelFleet(entries, total_pages=total_pages,
                       page_size=page_size, max_seats=max_seats,
                       max_seq_len=max_seq_len,
                       prefill_chunk=prefill_chunk, selection=selection,
                       prefix_cache=prefix_cache, lazy_pages=lazy_pages,
                       watermark=watermark, admission=admission,
                       aging_ticks=aging_ticks,
                       class_precision=class_precision,
                       telemetry=telemetry, device=dev)
    del entries                     # the float32 trees
    rng = np.random.default_rng(seed)
    for i in range(requests):
        name = models[i % len(models)][0]
        cfg = fleet.group(name).cfg
        plen = (prompt_len if prompt_len
                else int(rng.integers(1, max_seq_len - gen)))
        fleet.submit(model=name,
                     prompt=rng.integers(0, cfg.vocab_size,
                                         plen).astype(np.int32),
                     max_new_tokens=int(rng.integers(2, gen + 1)),
                     eos_id=eos_id, sampling=sampling,
                     priority=priority, deadline_ms=deadline_ms,
                     tbt_deadline_ms=tbt_deadline_ms)
    server = None
    if metrics_port is not None:
        server = MetricsServer(
            lambda: prometheus_text(
                {f"{n}/{i}": e.metrics
                 for n, i, e in fleet._engines()}),
            port=metrics_port)
        print(f"[serve.fleet] metrics: {server.url}")
    try:
        done = fleet.run()
    finally:
        if server is not None:
            server.close()
    return {"finished": done, "metrics": fleet.metrics_snapshot(),
            "fleet": fleet}


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


def add_telemetry_args(ap: argparse.ArgumentParser) -> None:
    """The observability flags of the paged engine."""
    ap.add_argument("--metrics-port", type=int, default=None,
                    metavar="PORT",
                    help="serve Prometheus text exposition of the live "
                         "engine metrics on 127.0.0.1:PORT for the "
                         "duration of the run (0 = ephemeral port, "
                         "printed at startup)")
    ap.add_argument("--flight-recorder", type=int, default=0,
                    metavar="N",
                    help="keep the last N structured trace events in a "
                         "ring buffer; a scheduler stall dumps them "
                         "plus a full engine-state snapshot as "
                         "postmortem JSON (0 = off unless another "
                         "telemetry flag turns telemetry on)")
    ap.add_argument("--trace-export", default=None, metavar="PATH",
                    help="after the run, write the recorded events as "
                         "Chrome trace-event JSON (open in "
                         "https://ui.perfetto.dev — one track per "
                         "engine seat)")
    ap.add_argument("--profile-ticks", action="store_true",
                    help="time the tick phases (admission / prefill / "
                         "decode, plus the fused tick's sync / dispatch "
                         "/ host / sample sub-phases) and print the "
                         "breakdown after the run")
    ap.add_argument("--postmortem", default=None, metavar="PATH",
                    help="where a stall postmortem JSON is written "
                         "(default: postmortem.json next to the run)")


def telemetry_from_args(args) -> Optional[Telemetry]:
    """One :class:`Telemetry` from ``add_telemetry_args`` flags, or None
    when every flag is at its off default (keeping the engine on the
    zero-overhead path)."""
    wanted = (args.flight_recorder or args.trace_export
              or args.profile_ticks or args.metrics_port is not None)
    if not wanted:
        return None
    return Telemetry(ring=args.flight_recorder or 4096,
                     profile=args.profile_ticks,
                     postmortem_path=args.postmortem or "postmortem.json")


def report_telemetry(args, telemetry: Optional[Telemetry],
                     tag: str) -> None:
    """Post-run telemetry outputs: the Perfetto export and the
    tick-phase profile table."""
    if telemetry is None:
        return
    rec = telemetry.recorder
    if args.trace_export:
        write_perfetto(args.trace_export, telemetry.events())
        print(f"[{tag}] wrote Perfetto trace {args.trace_export} "
              f"({rec.total} events recorded, {rec.dropped} aged out "
              f"of the {rec.capacity}-event ring)")
    if telemetry.profiler is not None:
        snap = telemetry.profiler.snapshot()
        print(f"[{tag}] tick-phase profile over {snap['ticks']} ticks:")
        for phase, ph in snap["phases"].items():
            print(f"[{tag}]   {phase:<16} {ph['total_s'] * 1e3:8.2f} ms "
                  f"total  {ph['share'] * 100:5.1f}%")


def model_name(name: str) -> str:
    """argparse ``type=`` resolver for ``--model``/``--arch``."""
    try:
        return resolve_arch(name)
    except KeyError as e:
        raise argparse.ArgumentTypeError(e.args[0]) from None


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Serve on the port: a static batch (fixed-slot path), "
                    "a request stream on the paged engine, or a "
                    "multi-model fleet.")
    ap.add_argument("--engine", choices=("batch", "paged"), default="batch",
                    help="batch: one static batch, prefill then decode "
                         "(default); paged: the paged continuous-batching "
                         "engine over --requests")
    ap.add_argument("--fleet", action="store_true",
                    help="serve a multi-model fleet (--models) instead of "
                         "one engine; implies the paged engine")
    ap.add_argument("--models", default="qwen3-1.7b:2,llama3-8b",
                    help="fleet spec: comma-separated "
                         "name[:replicas[:kv_dtype]], e.g. "
                         "llama3-8b:2:fp8,qwen3-1.7b (--fleet mode)")
    ap.add_argument("--selection",
                    choices=("least-loaded", "round-robin", "slo-aware"),
                    default="least-loaded",
                    help="replica selection policy (--fleet mode); "
                         "slo-aware folds premium queue depth into the "
                         "least-loaded key")
    ap.add_argument("--total-pages", type=int, default=64,
                    help="shared host page budget across all fleet "
                         "engines (--fleet mode)")
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
    ap.add_argument("--tuning-preset", choices=("off", "alloc", "full"),
                    default="off",
                    help="host allocator preset: alloc (and full, the "
                         "same here) preloads tcmalloc (re-executes once "
                         "to apply)")
    add_telemetry_args(ap)
    return ap


def main(argv=None):
    ap = build_parser()
    if argv is None:
        argv = sys.argv[1:]
    args = ap.parse_args(argv)
    apply_tuning_preset(args.tuning_preset, argv)
    telemetry = telemetry_from_args(args)
    if telemetry is not None and not args.fleet and args.engine != "paged":
        ap.error("--metrics-port/--flight-recorder/--trace-export/"
                 "--profile-ticks need --engine paged or --fleet (the "
                 "static batch path has no scheduler to observe)")
    try:
        class_precision = (parse_class_precision(args.class_precision)
                           if args.class_precision else None)
        sampling = SamplingParams(temperature=args.temperature,
                                  top_k=args.top_k, top_p=args.top_p,
                                  seed=args.seed)
        if args.fleet:
            r = serve_fleet(
                args.models, requests=args.requests, gen=args.gen,
                page_size=args.page_size, total_pages=args.total_pages,
                seed=args.seed, eos_id=args.eos_id, sampling=sampling,
                prefix_cache=not args.no_prefix_cache,
                max_seq_len=args.max_seq_len, prompt_len=args.prompt_len,
                lazy_pages=args.lazy_pages, watermark=args.watermark,
                priority=args.priority, deadline_ms=args.deadline_ms,
                tbt_deadline_ms=args.tbt_deadline_ms,
                admission=args.admission, aging_ticks=args.aging_ticks,
                selection=args.selection, kv_dtype=args.kv_dtype,
                class_precision=class_precision, telemetry=telemetry,
                metrics_port=args.metrics_port, device=args.device)
        elif args.engine == "batch":
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
                telemetry=telemetry, metrics_port=args.metrics_port,
                device=args.device)
    except ValueError as e:
        ap.error(str(e))
    if args.fleet:
        m = r["metrics"]
        f = m["fleet"]
        print(f"[serve.fleet] device={r['fleet'].device} "
              f"{f['completed']:.0f} requests "
              f"{f['generated_tokens']:.0f} tokens in "
              f"{f['wall_s'] * 1e3:.0f}ms ({f['tokens_per_s']:.1f} tok/s) "
              f"across {len(m['models'])} models; "
              f"budget {m['budget']['total_pages']} pages "
              f"(surplus {m['budget']['surplus_pages']})")
        for name, mm in m["models"].items():
            print(f"[serve.fleet]   model={name} "
                  f"replicas={len(mm['replicas'])} "
                  f"completed={mm['completed']:.0f} "
                  f"tok/s={mm['tokens_per_s']:.1f} "
                  f"ttft_avg={mm['ttft_avg_s'] * 1e3:.0f}ms "
                  f"prefix_hit_rate={mm['prefix_hit_rate']:.2f} "
                  f"preemptions={mm['preemptions']:.0f}")
        rid0 = min(r["finished"])
        print("[serve.fleet] sample tokens:",
              r["finished"][rid0].generated[:12])
        report_telemetry(args, telemetry, "serve.fleet")
        return
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
    report_telemetry(args, telemetry, "serve.paged")


if __name__ == "__main__":
    main()
