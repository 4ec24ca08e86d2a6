"""Observability plane of the port's serving stack (counterpart of
``repro.runtime.telemetry``): flight recorder, spans, metrics registry,
tick profiler and SLO burn-rate monitor.

The serving runtime's flat ``Scheduler.trace`` list of ``(tick, event,
rid)`` tuples and its terminal metrics snapshot get a structured layer
underneath, which never touches a tensor:

- :class:`TraceEvent` — a structured event (monotonic tick, injected-
  clock wall time, engine id, rid, kind, small attrs dict) emitted from
  every ``Scheduler._trace`` site.
- :class:`FlightRecorder` — a bounded ring buffer of the last N events;
  on a ``SchedulerStallError`` the ring plus a full engine-state
  snapshot (:func:`scheduler_state`: queue, seats, ``BlockManager``
  partition) is dumped as a postmortem JSON artifact.
- span building + Chrome trace-event export (:func:`build_spans`,
  :func:`perfetto_trace`) — per-request timelines (queued → prefill →
  first token → decode → preempt → replay → finish), one track per
  engine seat, viewable in Perfetto (https://ui.perfetto.dev).
- :class:`MetricsRegistry` — counters, gauges and log-bucketed
  *mergeable* :class:`Histogram`\\ s with Prometheus text exposition
  (served by :class:`MetricsServer` behind ``launch/serve.py
  --metrics-port``).
- :class:`TickProfiler` — wall-time breakdown of the tick phases
  (admission / prefill / decode, and the fused tick's sync / dispatch /
  host-crossing / sample sub-phases).
- :class:`BurnRateMonitor` — sliding-window TTFT/TBT miss rates per SLO
  class, emitting edge-triggered ``slo_burn`` warning events.

Every event, span, document, exposition text and postmortem equals the
JAX package's for the same submissions under the same clock.  Contracts
this module keeps:

- **stdlib only** — no torch, no numpy, no package imports.
  ``paged_kv`` imports :class:`Histogram`, so any heavier dependency
  would cycle, and the dumps render on a bare Python.
- **free when off** — the emit path is reached only behind a single
  ``telemetry is not None`` check in the Scheduler.
- **zero device syncs** — every function here is pure host bookkeeping.
- **injected-clock time** — event timestamps are whatever the
  Scheduler's ``clock`` returns (wall seconds in serving, virtual
  seconds under a simulated clock), never a private ``perf_counter``
  call, so simulated timelines are deterministic.

The fleet router's ``fleet_tick`` heartbeat (counter tracks) is read
here already; the router itself is a later slice of the port.
"""
from __future__ import annotations

import http.server
import json
import math
import threading
from collections import OrderedDict, deque
from typing import (Callable, Deque, Dict, Iterable, List, NamedTuple,
                    Optional, Tuple)


class TraceEvent(NamedTuple):
    """One structured trace event.

    tick: the emitting scheduler's monotonic tick counter.
    t: injected-clock time, seconds (virtual under a simulated clock).
    engine: ``"model/replica"`` in a fleet, ``""`` on a solo engine.
    rid: request id; -1 for engine-level events (``fleet_tick``,
        ``slo_burn``).
    kind: event name — the ``Scheduler.trace`` events (admit /
        prefix_hit / prefill_chunk / first_token / decode / preempt /
        deadline_miss / tbt_miss / finish) plus the telemetry-only
        ``submit``, ``fleet_tick``, ``slo_burn`` and
        ``slo_burn_clear``.
    attrs: small JSON-safe dict of extras, or None (hot events carry
        None — no per-event allocation on the decode path)."""
    tick: int
    t: float
    engine: str
    rid: int
    kind: str
    attrs: Optional[dict]

    def to_dict(self) -> dict:
        d = {"tick": self.tick, "t": self.t, "engine": self.engine,
             "rid": self.rid, "kind": self.kind}
        if self.attrs:
            d["attrs"] = self.attrs
        return d


def event_from_dict(d: dict) -> TraceEvent:
    """Inverse of :meth:`TraceEvent.to_dict` (postmortem round-trip)."""
    return TraceEvent(int(d["tick"]), float(d["t"]),
                      str(d.get("engine", "")), int(d["rid"]),
                      str(d["kind"]), d.get("attrs"))


class FlightRecorder:
    """Bounded ring buffer of the last ``capacity`` trace events.

    The ring is a ``deque(maxlen=...)`` — appends are O(1) and the
    oldest events fall off silently; ``dropped`` counts them so a
    postmortem states how much history it is missing."""

    def __init__(self, capacity: int = 4096):
        if capacity < 1:
            raise ValueError(f"ring capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._ring: Deque[TraceEvent] = deque(maxlen=capacity)
        self.total = 0

    def append(self, ev: TraceEvent) -> None:
        self._ring.append(ev)
        self.total += 1

    @property
    def dropped(self) -> int:
        """Events that aged out of the ring."""
        return self.total - len(self._ring)

    def events(self) -> List[TraceEvent]:
        """The retained events, oldest first."""
        return list(self._ring)

    def clear(self) -> None:
        self._ring.clear()
        self.total = 0

    def snapshot(self) -> dict:
        """JSON-safe dump: capacity, totals, and the retained events."""
        return {"capacity": self.capacity, "total": self.total,
                "dropped": self.dropped,
                "events": [e.to_dict() for e in self._ring]}


# ---------------------------------------------------------------------------
# Metrics: log-bucketed histograms, registry, Prometheus exposition
# ---------------------------------------------------------------------------

#: Bucket key for non-positive samples (durations can be exactly 0.0
#: under the virtual clock when two emissions share a tick).
ZERO_BUCKET = -(10 ** 9)


class Histogram:
    """Log-bucketed mergeable histogram.

    Bucket ``i`` holds samples in ``(base**(i-1), base**i]``; samples
    <= 0 land in a dedicated zero bucket below every real one.  Merging
    is pure per-bucket count addition, so it is associative and
    commutative —
    replica histograms merge into model and fleet aggregates without
    ever re-touching the raw samples.

    Quantile contract: :meth:`quantile_bucket` applies exactly the
    nearest-rank rule of ``paged_kv._quantile`` to the bucket
    cumulative counts, and bucketing is monotone, so the bucket it
    returns always contains the exact sample quantile of the observed
    values — the histogram answer is the exact answer coarsened to one
    bucket width."""

    def __init__(self, base: float = 2.0):
        if base <= 1.0:
            raise ValueError(f"histogram base must be > 1, got {base}")
        self.base = base
        self.counts: Dict[int, int] = {}
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def bucket_index(self, x: float) -> int:
        """The bucket a sample lands in (monotone in ``x``)."""
        if x <= 0.0:
            return ZERO_BUCKET
        # round() guards float fuzz at exact powers of the base so
        # x == base**k maps to bucket k (the (base**(k-1), base**k]
        # interval that contains it), not k+1
        return math.ceil(round(math.log(x, self.base), 9))

    def bucket_le(self, i: int) -> float:
        """Inclusive upper bound of bucket ``i``."""
        return 0.0 if i == ZERO_BUCKET else self.base ** i

    def observe(self, x: float) -> None:
        i = self.bucket_index(x)
        self.counts[i] = self.counts.get(i, 0) + 1
        self.count += 1
        self.sum += x
        self.min = x if self.min is None else min(self.min, x)
        self.max = x if self.max is None else max(self.max, x)

    def merge(self, other: "Histogram") -> "Histogram":
        """A new histogram holding both operands' samples."""
        if other.base != self.base:
            raise ValueError(f"cannot merge histograms with bases "
                             f"{self.base} and {other.base}")
        out = Histogram(self.base)
        out.counts = dict(self.counts)
        for i, n in other.counts.items():
            out.counts[i] = out.counts.get(i, 0) + n
        out.count = self.count + other.count
        out.sum = self.sum + other.sum
        mins = [m for m in (self.min, other.min) if m is not None]
        maxs = [m for m in (self.max, other.max) if m is not None]
        out.min = min(mins) if mins else None
        out.max = max(maxs) if maxs else None
        return out

    def quantile_bucket(self, q: float) -> Optional[int]:
        """Bucket index of the nearest-rank ``q`` quantile (None when
        empty).  Rank rule identical to ``paged_kv._quantile``:
        1-based rank ``ceil(q * n)``, clamped to [1, n]."""
        if self.count == 0:
            return None
        rank = max(1, min(self.count,
                          math.ceil(round(q * self.count, 9))))
        seen = 0
        for i in sorted(self.counts):
            seen += self.counts[i]
            if seen >= rank:
                return i
        return max(self.counts)                   # unreachable

    def quantile_bound(self, q: float) -> float:
        """Upper bound of the ``q``-quantile bucket (0.0 when empty)."""
        i = self.quantile_bucket(q)
        return 0.0 if i is None else self.bucket_le(i)

    def to_dict(self) -> dict:
        return {"base": self.base, "count": self.count, "sum": self.sum,
                "min": self.min, "max": self.max,
                "counts": {str(i): n for i, n in sorted(self.counts.items())}}

    @classmethod
    def from_dict(cls, d: dict) -> "Histogram":
        h = cls(float(d.get("base", 2.0)))
        h.counts = {int(i): int(n) for i, n in d.get("counts", {}).items()}
        h.count = int(d.get("count", 0))
        h.sum = float(d.get("sum", 0.0))
        h.min = d.get("min")
        h.max = d.get("max")
        return h


def _fmt(v: float) -> str:
    """Prometheus sample-value formatting (no exponent surprises for
    the common cases, stable round-trip for the rest)."""
    if v == math.inf:
        return "+Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return format(float(v), ".9g")


def _labels_text(labels: Optional[Dict[str, str]],
                 extra: Optional[Dict[str, str]] = None) -> str:
    merged: Dict[str, str] = dict(labels or {})
    if extra:
        merged.update(extra)
    if not merged:
        return ""
    body = ",".join(f'{k}="{v}"' for k, v in sorted(merged.items()))
    return "{" + body + "}"


class MetricsRegistry:
    """Counters, gauges and histograms with Prometheus text exposition
    (format 0.0.4: ``# HELP`` / ``# TYPE`` headers, cumulative
    ``_bucket{le=...}`` lines, ``_sum`` and ``_count``).

    The serving stack does not mutate a registry on the hot path — it
    rebuilds one at scrape time from ``EngineMetrics`` (which carries
    the incrementally maintained histograms), so scrapes cost the
    scraper, never the tick loop."""

    _TYPES = ("counter", "gauge", "histogram")

    def __init__(self):
        # name -> {"type", "help", "samples": [(labels, value)]}
        self._fams: "OrderedDict[str, dict]" = OrderedDict()

    def _family(self, name: str, kind: str, help_: str) -> dict:
        fam = self._fams.get(name)
        if fam is None:
            fam = {"type": kind, "help": help_, "samples": []}
            self._fams[name] = fam
        elif fam["type"] != kind:
            raise ValueError(f"metric {name!r} registered as "
                             f"{fam['type']}, not {kind}")
        return fam

    def counter(self, name: str, value: float,
                labels: Optional[Dict[str, str]] = None,
                help: str = "") -> None:
        self._family(name, "counter", help)["samples"].append(
            (dict(labels or {}), float(value)))

    def gauge(self, name: str, value: float,
              labels: Optional[Dict[str, str]] = None,
              help: str = "") -> None:
        self._family(name, "gauge", help)["samples"].append(
            (dict(labels or {}), float(value)))

    def histogram(self, name: str, hist: Histogram,
                  labels: Optional[Dict[str, str]] = None,
                  help: str = "") -> None:
        self._family(name, "histogram", help)["samples"].append(
            (dict(labels or {}), hist))

    def render(self) -> str:
        """The whole registry as Prometheus exposition text."""
        lines: List[str] = []
        for name, fam in self._fams.items():
            if fam["help"]:
                lines.append(f"# HELP {name} {fam['help']}")
            lines.append(f"# TYPE {name} {fam['type']}")
            for labels, value in fam["samples"]:
                if fam["type"] == "histogram":
                    self._render_hist(lines, name, labels, value)
                else:
                    lines.append(
                        f"{name}{_labels_text(labels)} {_fmt(value)}")
        return "\n".join(lines) + "\n"

    @staticmethod
    def _render_hist(lines: List[str], name: str,
                     labels: Dict[str, str], h: Histogram) -> None:
        cum = 0
        for i in sorted(h.counts):
            cum += h.counts[i]
            le = _fmt(h.bucket_le(i))
            lines.append(f"{name}_bucket"
                         f"{_labels_text(labels, {'le': le})} {cum}")
        lines.append(f"{name}_bucket"
                     f"{_labels_text(labels, {'le': '+Inf'})} {h.count}")
        lines.append(f"{name}_sum{_labels_text(labels)} {_fmt(h.sum)}")
        lines.append(f"{name}_count{_labels_text(labels)} {h.count}")


def registry_from_metrics(named_metrics: Dict[str, object]
                          ) -> MetricsRegistry:
    """Build a scrape-time registry from ``{engine_id: EngineMetrics}``.

    Duck-typed over the ``EngineMetrics`` counter fields and the
    per-class TTFT/TBT histograms it maintains incrementally; works
    for any object carrying the same attributes (so telemetry never
    imports paged_kv — the import runs the other way)."""
    reg = MetricsRegistry()
    counters = (
        ("repro_requests_submitted_total", "submitted",
         "Requests accepted by submit()"),
        ("repro_requests_admitted_total", "admitted",
         "Requests placed on a seat"),
        ("repro_requests_completed_total", "completed",
         "Requests finished (eos or max_new_tokens)"),
        ("repro_tokens_prefill_total", "prefill_tokens",
         "Prompt tokens prefilled (replays included)"),
        ("repro_tokens_decode_total", "decode_tokens",
         "Decode tokens emitted"),
        ("repro_preemptions_total", "preemptions",
         "Requests preempted under page pressure"),
        ("repro_page_evictions_total", "evictions",
         "Reclaimable prefix-cache pages evicted"),
        ("repro_ticks_total", "ticks", "Engine ticks run"),
    )
    gauges = (
        ("repro_pages_in_use", "pages_in_use",
         "Pages referenced by live requests (last tick)"),
        ("repro_page_capacity", "page_capacity",
         "Usable KV pages in the pool"),
        ("repro_queue_depth", "queued", "Queued requests (last tick)"),
        ("repro_active_seats", "active", "Occupied seats (last tick)"),
    )
    for engine, m in named_metrics.items():
        lbl = {"engine": engine or "engine"}
        for name, field, help_ in counters:
            reg.counter(name, getattr(m, field, 0), lbl, help=help_)
        for name, field, help_ in gauges:
            reg.gauge(name, getattr(m, field, 0), lbl, help=help_)
        for cls, n in sorted(getattr(m, "completed_by_class",
                                     {}).items()):
            reg.counter("repro_class_completed_total", n,
                        {**lbl, "class": cls},
                        help="Completions per SLO class")
        for kind, misses in (("ttft", "deadline_misses_by_class"),
                             ("tbt", "tbt_misses_by_class")):
            for cls, n in sorted(getattr(m, misses, {}).items()):
                reg.counter("repro_slo_misses_total", n,
                            {**lbl, "class": cls, "kind": kind},
                            help="Deadline misses per class and kind "
                                 "(ttft|tbt)")
        for name, field, help_ in (
                ("repro_ttft_seconds", "ttft_hist_by_class",
                 "Time to first token (log-bucketed)"),
                ("repro_tbt_seconds", "tbt_hist_by_class",
                 "Time between decode tokens (log-bucketed)")):
            for cls, h in sorted(getattr(m, field, {}).items()):
                reg.histogram(name, h, {**lbl, "class": cls},
                              help=help_)
    return reg


def prometheus_text(named_metrics: Dict[str, object]) -> str:
    """One-call Prometheus exposition for ``{engine_id: metrics}``."""
    return registry_from_metrics(named_metrics).render()


class MetricsServer:
    """Background Prometheus scrape endpoint over ``http.server``.

    ``collect`` is a zero-arg callable returning exposition text; it
    runs on the server thread at scrape time, so the serving loop never
    pays for a scrape.  ``port=0`` binds an ephemeral port (tests)."""

    def __init__(self, collect: Callable[[], str], *, port: int = 0,
                 host: str = "127.0.0.1"):
        server = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):                     # noqa: N802 (stdlib API)
                if self.path.split("?")[0] not in ("/", "/metrics"):
                    self.send_error(404)
                    return
                try:
                    body = server.collect().encode()
                except Exception as e:            # surface, don't kill
                    self.send_error(500, str(e))
                    return
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4; "
                                 "charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):         # silence per-request noise
                pass

        self.collect = collect
        self._httpd = http.server.ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self.url = f"http://{host}:{self.port}/metrics"
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="repro-metrics",
            daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)


# ---------------------------------------------------------------------------
# Tick-phase profiler
# ---------------------------------------------------------------------------

class TickProfiler:
    """Wall-time breakdown of the engine tick phases.

    Phases at the step level: ``admission``, ``prefill``, ``decode``,
    ``bookkeeping``; the fused decode tick refines its share into
    ``sync`` (staging and upload of the device state), ``dispatch``
    (the fused tick's enqueue: a CUDA-graph replay on the card), ``host``
    (the blocking device→host token pull, which holds the wait for the
    device) and
    ``sample`` (host-side token acceptance).  Measured with
    ``time.perf_counter`` by the instrumented code — profiling is a
    wall-time tool and stays off under the virtual clock, where every
    phase would read as zero."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.calls: Dict[str, int] = {}
        self.ticks = 0

    def add(self, phase: str, dt: float) -> None:
        self.totals[phase] = self.totals.get(phase, 0.0) + dt
        self.calls[phase] = self.calls.get(phase, 0) + 1

    def note_tick(self) -> None:
        self.ticks += 1

    def snapshot(self) -> dict:
        """Per-phase totals, call counts, and share of profiled wall.

        The share denominator is the sum of *top-level* phases only
        (no ``/`` in the name): ``decode/dispatch`` etc. re-slice the
        wall already counted under ``decode``, so including them would
        double-count decode time and dilute every share."""
        wall = sum(t for p, t in self.totals.items() if "/" not in p) \
            or sum(self.totals.values()) or 1.0
        return {"ticks": self.ticks,
                "phases": {p: {"total_s": t,
                               "calls": self.calls[p],
                               "share": t / wall}
                           for p, t in sorted(self.totals.items())}}


# ---------------------------------------------------------------------------
# SLO burn-rate monitor
# ---------------------------------------------------------------------------

class BurnRateMonitor:
    """Sliding-window SLO miss rates per (class, kind).

    Every deadlined verdict — TTFT at first token, TBT per decode
    token — lands here with its injected-clock timestamp; entries
    strictly older than the window (``t <= now - window_s``, so an
    entry at exactly the boundary is out) are evicted on the next
    observation.  When a (class, kind) rate crosses ``threshold`` with
    at least ``min_samples`` in window, :meth:`observe` returns a
    ``fire`` transition exactly once (edge-triggered); dropping back
    returns one ``clear``.  The Telemetry facade turns transitions
    into ``slo_burn`` / ``slo_burn_clear`` warning events."""

    def __init__(self, *, window_s: float = 1.0, threshold: float = 0.5,
                 min_samples: int = 16):
        if window_s <= 0:
            raise ValueError(f"window_s must be > 0, got {window_s}")
        if not 0.0 <= threshold <= 1.0:
            raise ValueError(f"threshold must be in [0, 1], "
                             f"got {threshold}")
        self.window_s = window_s
        self.threshold = threshold
        self.min_samples = max(1, min_samples)
        self._entries: Deque[Tuple[float, Tuple[str, str], bool]] = deque()
        self._counts: Dict[Tuple[str, str], List[int]] = {}  # [n, missed]
        self._alert: Dict[Tuple[str, str], bool] = {}

    def _evict(self, now: float) -> None:
        cutoff = now - self.window_s
        entries = self._entries
        while entries and entries[0][0] <= cutoff:
            _, key, missed = entries.popleft()
            c = self._counts[key]
            c[0] -= 1
            if missed:
                c[1] -= 1

    def observe(self, now: float, priority: str, kind: str,
                missed: bool) -> Optional[dict]:
        """Record one deadlined verdict; returns an alert transition
        dict (``state`` = ``fire`` | ``clear``) or None."""
        self._evict(now)
        key = (priority, kind)
        c = self._counts.setdefault(key, [0, 0])
        c[0] += 1
        if missed:
            c[1] += 1
        self._entries.append((now, key, missed))
        n, bad = c
        rate = bad / n
        burning = n >= self.min_samples and rate > self.threshold
        if burning and not self._alert.get(key, False):
            self._alert[key] = True
            state = "fire"
        elif not burning and self._alert.get(key, False):
            self._alert[key] = False
            state = "clear"
        else:
            return None
        return {"state": state, "class": priority, "kind": kind,
                "miss_rate": rate, "samples": n,
                "window_s": self.window_s,
                "threshold": self.threshold}

    def rates(self, now: Optional[float] = None) -> Dict[str, dict]:
        """Current in-window rates keyed ``"class/kind"`` (evicting
        first when ``now`` is given)."""
        if now is not None:
            self._evict(now)
        return {f"{cls}/{kind}": {"samples": n, "missed": bad,
                                  "miss_rate": bad / n if n else 0.0}
                for (cls, kind), (n, bad) in sorted(self._counts.items())
                if n}


# ---------------------------------------------------------------------------
# Telemetry facade
# ---------------------------------------------------------------------------

class Telemetry:
    """One observability context shared by an engine or a whole fleet.

    Pass one instance as the ``telemetry=`` argument of
    :class:`~repro_torch.runtime.serving.Scheduler` or either engine
    façade.  ``None`` (the default everywhere) keeps the stack on the
    zero-overhead path."""

    def __init__(self, *, ring: int = 4096, profile: bool = False,
                 burn_window_s: float = 1.0,
                 burn_threshold: float = 0.5,
                 burn_min_samples: int = 16,
                 heartbeat_every: int = 64,
                 postmortem_path: Optional[str] = None):
        self.recorder = FlightRecorder(ring)
        self.profiler: Optional[TickProfiler] = (
            TickProfiler() if profile else None)
        self.burn = BurnRateMonitor(window_s=burn_window_s,
                                    threshold=burn_threshold,
                                    min_samples=burn_min_samples)
        if heartbeat_every < 1:
            raise ValueError(f"heartbeat_every must be >= 1, "
                             f"got {heartbeat_every}")
        self.heartbeat_every = heartbeat_every
        self.postmortem_path = postmortem_path
        self.last_postmortem: Optional[dict] = None

    # -- hot path: once per trace event inside the decode loop --------------

    def emit(self, tick: int, t: float, engine: str, rid: int,
             kind: str, attrs: Optional[dict] = None) -> None:
        """Record one structured event (pure host bookkeeping: a
        NamedTuple build and a ring append — no device access, ever)."""
        self.recorder.append(TraceEvent(tick, t, engine, rid, kind, attrs))

    def observe_slo(self, now: float, tick: int, engine: str,
                    priority: str, kind: str, missed: bool) -> None:
        """Feed one deadlined TTFT/TBT verdict to the burn monitor,
        emitting an ``slo_burn``/``slo_burn_clear`` event on an alert
        transition."""
        transition = self.burn.observe(now, priority, kind, missed)
        if transition is not None:
            state = transition.pop("state")
            kind_ev = "slo_burn" if state == "fire" else "slo_burn_clear"
            self.recorder.append(
                TraceEvent(tick, now, engine, -1, kind_ev, transition))

    # -- cold path -----------------------------------------------------------

    def events(self) -> List[TraceEvent]:
        return self.recorder.events()

    def postmortem(self, reason: str, *,
                   engines: Optional[Dict[str, object]] = None,
                   budget: Optional[dict] = None,
                   extra: Optional[dict] = None) -> dict:
        """Build (and remember) a postmortem dict: the ring's last N
        events plus a full state snapshot of every named engine
        (queue, seats, BlockManager partition) and the HostBudget
        grants."""
        pm = {"reason": reason,
              "flight_recorder": self.recorder.snapshot(),
              "engines": {name: scheduler_state(eng)
                          for name, eng in (engines or {}).items()}}
        if budget is not None:
            pm["budget"] = budget
        if self.profiler is not None:
            pm["profile"] = self.profiler.snapshot()
        burn = self.burn.rates()
        if burn:
            pm["slo_burn_rates"] = burn
        if extra:
            pm["extra"] = extra
        self.last_postmortem = pm
        return pm

    def write_postmortem(self, reason: str, *,
                         engines: Optional[Dict[str, object]] = None,
                         budget: Optional[dict] = None,
                         extra: Optional[dict] = None,
                         path: Optional[str] = None) -> Optional[str]:
        """Build a postmortem and write it as JSON to ``path`` (falling
        back to ``postmortem_path``); returns the path written, or None
        when neither is set (the dict still lands in
        ``last_postmortem``)."""
        pm = self.postmortem(reason, engines=engines, budget=budget,
                             extra=extra)
        path = path if path is not None else self.postmortem_path
        if path is None:
            return None
        with open(path, "w") as f:
            json.dump(pm, f, indent=1, default=str)
        return path


# ---------------------------------------------------------------------------
# Engine-state snapshots (postmortem ingredients, duck-typed)
# ---------------------------------------------------------------------------

def request_state(req) -> dict:
    """JSON-safe snapshot of one request's scheduler-owned state."""
    return {"rid": getattr(req, "rid", -1),
            "priority": getattr(req, "priority", None),
            "prompt_tokens": len(getattr(req, "prompt", ())),
            "generated": len(getattr(req, "generated", ())),
            "max_new_tokens": getattr(req, "max_new_tokens", None),
            "slot": getattr(req, "slot", None),
            "pages": [int(p) for p in getattr(req, "pages", [])],
            "prefill_pos": getattr(req, "prefill_pos", 0),
            "cached_tokens": getattr(req, "cached_tokens", 0),
            "times_preempted": getattr(req, "times_preempted", 0),
            "deadline_ms": getattr(req, "deadline_ms", None),
            "tbt_deadline_ms": getattr(req, "tbt_deadline_ms", None)}


def block_manager_state(bm) -> dict:
    """Snapshot of a ``BlockManager``'s page partition: live refcounts,
    the free list, the reclaimable LRU list, and whether the three sets
    still partition pages ``1..capacity`` (a postmortem that fails
    ``partition_ok`` names the corruption directly)."""
    live = {int(p): int(n) for p, n in getattr(bm, "_ref", {}).items()}
    free = sorted(int(p) for p in getattr(bm, "_free", []))
    reclaimable = sorted(int(p) for p in getattr(bm, "_reclaim", {}))
    capacity = int(getattr(bm, "capacity", 0))
    sets = [set(live), set(free), set(reclaimable)]
    disjoint = sum(len(s) for s in sets) == len(set().union(*sets))
    partition_ok = (disjoint and set().union(*sets)
                    == set(range(1, capacity + 1)))
    return {"capacity": capacity,
            "page_size": int(getattr(bm, "page_size", 0)),
            "in_use": int(getattr(bm, "in_use", 0)),
            "live_refcounts": {str(p): n
                               for p, n in sorted(live.items())},
            "free": free, "reclaimable": reclaimable,
            "evictions": int(getattr(bm, "evictions", 0)),
            "partition_ok": bool(partition_ok)}


def scheduler_state(sched) -> dict:
    """Full engine snapshot for a postmortem: tick, queue, seats, and
    the policy's BlockManager partition when it has one.  Duck-typed —
    works for a bare Scheduler or either engine façade."""
    queue = [request_state(r) for r in getattr(sched, "queue", [])]
    seats = {str(s): request_state(r)
             for s, r in sorted(getattr(sched, "seats", {}).items())}
    out = {"engine": getattr(sched, "engine_id", ""),
           "tick": getattr(sched, "_tick", 0),
           "queued": len(queue), "active": len(seats),
           "queue": queue, "seats": seats}
    bm = getattr(getattr(sched, "policy", None), "bm", None)
    if bm is not None:
        out["block_manager"] = block_manager_state(bm)
    return out


# ---------------------------------------------------------------------------
# Span timelines + Chrome trace-event (Perfetto) export
# ---------------------------------------------------------------------------

#: Reserved thread id for the per-engine queue track; seats map to
#: ``seat + 1`` so seat 0 keeps its own track.
QUEUE_TID = 0

_INSTANT_KINDS = ("preempt", "deadline_miss", "tbt_miss", "prefix_hit",
                  "slo_burn", "slo_burn_clear")


def build_spans(events: Iterable[TraceEvent]) -> dict:
    """Reduce a trace-event stream to per-request span timelines.

    Returns ``{"spans", "instants", "counters"}``:

    - spans: ``{engine, rid, seat, name, t0, t1}`` with names
      ``queued`` (submit/preempt → admit, on the queue track),
      ``prefill`` (admit → first token), ``replay`` (a re-admission's
      prefill — the request was preempted before, so its TTFT token
      already exists and decode resumes directly), and ``decode``
      (first/resumed token → finish or preempt).
    - instants: point events (preempt, deadline_miss, tbt_miss,
      prefix_hit, slo_burn...).
    - counters: ``fleet_tick`` heartbeat samples (queue depth, active
      seats, pages) for Perfetto counter tracks.

    The reducer is forgiving: a ring that dropped a request's early
    events simply yields that request's later spans only."""
    spans: List[dict] = []
    instants: List[dict] = []
    counters: List[dict] = []
    # (engine, rid) -> mutable request cursor
    state: Dict[Tuple[str, int], dict] = {}
    last_t = 0.0

    def cursor(ev: TraceEvent) -> dict:
        return state.setdefault((ev.engine, ev.rid), {
            "seat": None, "queue_t0": None, "phase": None,
            "t0": None, "preempted": 0})

    def close(ev: TraceEvent, cur: dict, t1: float,
              next_phase: Optional[str]) -> None:
        if cur["phase"] is not None and cur["t0"] is not None:
            spans.append({"engine": ev.engine, "rid": ev.rid,
                          "seat": cur["seat"], "name": cur["phase"],
                          "t0": cur["t0"], "t1": t1})
        cur["phase"], cur["t0"] = next_phase, (
            t1 if next_phase is not None else None)

    for ev in events:
        last_t = max(last_t, ev.t)
        if ev.kind == "fleet_tick":
            counters.append({"engine": ev.engine, "t": ev.t,
                             "attrs": ev.attrs or {}})
            continue
        if ev.kind in _INSTANT_KINDS or ev.rid < 0:
            if ev.kind in _INSTANT_KINDS:
                cur = state.get((ev.engine, ev.rid))
                instants.append({
                    "engine": ev.engine, "rid": ev.rid, "kind": ev.kind,
                    "seat": cur["seat"] if cur else None, "t": ev.t,
                    "attrs": ev.attrs})
            if ev.kind != "preempt":
                continue                      # preempt also edits spans
        cur = cursor(ev)
        if ev.kind == "submit":
            cur["queue_t0"] = ev.t
        elif ev.kind == "admit":
            if ev.attrs and "seat" in ev.attrs:
                cur["seat"] = ev.attrs["seat"]
            if cur["queue_t0"] is not None:
                spans.append({"engine": ev.engine, "rid": ev.rid,
                              "seat": None, "name": "queued",
                              "t0": cur["queue_t0"], "t1": ev.t})
                cur["queue_t0"] = None
            close(ev, cur, ev.t,
                  "replay" if cur["preempted"] else "prefill")
        elif ev.kind == "first_token":
            close(ev, cur, ev.t, "decode")
        elif ev.kind == "decode":
            if cur["phase"] in ("prefill", "replay"):
                # replay path: no second first_token — decode resumes
                # straight after the re-prefill completes
                close(ev, cur, ev.t, "decode")
        elif ev.kind == "preempt":
            close(ev, cur, ev.t, None)
            cur["preempted"] += 1
            cur["queue_t0"] = ev.t
            cur["seat"] = None
        elif ev.kind == "finish":
            close(ev, cur, ev.t, None)
    # requests still open when the stream ends (mid-run export): close
    # their spans at the last seen timestamp so the timeline renders
    for (engine, rid), cur in state.items():
        if cur["phase"] is not None and cur["t0"] is not None:
            spans.append({"engine": engine, "rid": rid,
                          "seat": cur["seat"], "name": cur["phase"],
                          "t0": cur["t0"], "t1": last_t})
    return {"spans": spans, "instants": instants, "counters": counters}


def perfetto_trace(events: Iterable[TraceEvent]) -> dict:
    """Chrome trace-event JSON (the format Perfetto's legacy importer
    and chrome://tracing read): one process per engine, one thread per
    engine seat plus a ``queue`` track, ``X`` complete events for
    spans, ``i`` instants for point events, ``C`` counters from the
    fleet heartbeat.  Timestamps are microseconds of injected-clock
    time."""
    reduced = build_spans(events)
    engines = sorted({s["engine"] for s in reduced["spans"]}
                     | {i["engine"] for i in reduced["instants"]}
                     | {c["engine"] for c in reduced["counters"]})
    pid_of = {e: p for p, e in enumerate(engines, start=1)}
    out: List[dict] = []
    for engine, pid in pid_of.items():
        out.append({"ph": "M", "name": "process_name", "pid": pid,
                    "tid": 0,
                    "args": {"name": engine or "engine"}})
        out.append({"ph": "M", "name": "thread_name", "pid": pid,
                    "tid": QUEUE_TID, "args": {"name": "queue"}})
    named_tids = {(pid, QUEUE_TID) for pid in pid_of.values()}

    def tid_for(engine: str, seat) -> int:
        pid = pid_of[engine]
        tid = QUEUE_TID if seat is None else int(seat) + 1
        if tid != QUEUE_TID and (pid, tid) not in named_tids:
            named_tids.add((pid, tid))
            out.append({"ph": "M", "name": "thread_name", "pid": pid,
                        "tid": tid, "args": {"name": f"seat {seat}"}})
        return tid

    for s in reduced["spans"]:
        out.append({"ph": "X", "name": s["name"], "cat": "serving",
                    "pid": pid_of[s["engine"]],
                    "tid": tid_for(s["engine"], s["seat"]),
                    "ts": s["t0"] * 1e6,
                    "dur": max(0.0, (s["t1"] - s["t0"]) * 1e6),
                    "args": {"rid": s["rid"]}})
    for i in reduced["instants"]:
        args = {"rid": i["rid"]}
        if i["attrs"]:
            args.update(i["attrs"])
        out.append({"ph": "i", "name": i["kind"], "cat": "serving",
                    "pid": pid_of[i["engine"]],
                    "tid": tid_for(i["engine"], i["seat"]),
                    "ts": i["t"] * 1e6, "s": "t", "args": args})
    for c in reduced["counters"]:
        attrs = {k: v for k, v in c["attrs"].items()
                 if isinstance(v, (int, float))}
        if attrs:
            out.append({"ph": "C", "name": "load", "cat": "serving",
                        "pid": pid_of[c["engine"]], "tid": QUEUE_TID,
                        "ts": c["t"] * 1e6, "args": attrs})
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def validate_chrome_trace(doc) -> List[str]:
    """Schema errors for a Chrome trace-event JSON object (empty list =
    valid).  Checks the subset :func:`perfetto_trace` emits."""
    errors: List[str] = []
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        return ["document must be an object with a 'traceEvents' array"]
    evs = doc["traceEvents"]
    if not isinstance(evs, list):
        return ["'traceEvents' must be an array"]
    for n, ev in enumerate(evs):
        where = f"traceEvents[{n}]"
        if not isinstance(ev, dict):
            errors.append(f"{where}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in ("X", "i", "I", "C", "M", "B", "E"):
            errors.append(f"{where}: unknown phase {ph!r}")
            continue
        if not isinstance(ev.get("name"), str) or not ev["name"]:
            errors.append(f"{where}: missing event name")
        for key in ("pid", "tid"):
            if not isinstance(ev.get(key), int):
                errors.append(f"{where}: {key} must be an int")
        if ph != "M":
            ts = ev.get("ts")
            if not isinstance(ts, (int, float)):
                errors.append(f"{where}: ts must be a number")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errors.append(f"{where}: X event needs dur >= 0")
        if ph in ("i", "I") and ev.get("s") not in (None, "t", "p", "g"):
            errors.append(f"{where}: instant scope must be t|p|g")
        if ph == "C" and not isinstance(ev.get("args"), dict):
            errors.append(f"{where}: C event needs numeric args")
    return errors


def write_perfetto(path: str, events: Iterable[TraceEvent]) -> str:
    """Export ``events`` as Chrome trace-event JSON at ``path``."""
    with open(path, "w") as f:
        json.dump(perfetto_trace(events), f)
    return path
