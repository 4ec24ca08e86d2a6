"""Continuous-batching serving stack of the port (counterpart of
``repro.runtime.serving``: the :class:`Scheduler`, the admission
policies, the fixed-slot :class:`FixedSlotPolicy` /
:class:`ServingEngine` and the paged :class:`PagedPolicy` /
:class:`PagedServingEngine`).

One :class:`Scheduler` tick admits queued requests (FCFS or SLO order),
runs the policy's prefill round and one decode step for every seat whose
prefill is complete.  Scheduling is deterministic, and the flat ``trace``
of ``(tick, event, rid)`` tuples equals the JAX engine's on the same
submissions.

- Fixed slots: every seat owns a dense ``max_len + 1`` cache row (the
  last index is the scratch position idle slots write to); a whole
  prompt prefills in its admission tick (``models.model.prefill``, the
  flash kernel on the card) and is written into its slot in place; a
  decode tick runs ``models.model.decode_step`` (the dense decode kernel)
  over all slots and samples on the host side of one transfer.
- Paged: a shared pool of fixed-size pages
  (``runtime.paged_kv.BlockManager``) with refcounted prefix caching and
  copy-on-write of the last partially shared page, lazy page growth and
  preempt-and-replay under page pressure.  The serving state lives on the
  device in fixed ``(max_seats,)`` tensors that the fused tick
  (``models.model.fused_decode_tick``) updates in place; a steady tick
  moves exactly one ``(max_seats,)`` int32 token vector to the host.

The counterpart of the reference's jitted steps over donated buffers is
a CUDA graph over fixed device buffers (:class:`_Step`): on a CUDA
device the paged engine captures its fused decode tick and its prefill
chunk, and the fixed-slot engine its decode step, once, at construction;
every tick replays them, and churn copies the host's state into the
same buffers (:class:`_Staged`).  ``PagedServingEngine(fused=False)`` is
the eager per-tick oracle (host-side sampling, no graph).  Whole-prompt
prefill of the fixed-slot engine runs eagerly: its shape changes with
every prompt.  On the CPU the same functions run eagerly over the same
buffers.  The engines run on the card unless the caller passes
``device="cpu"``.

Every ``_trace`` site also feeds the optional telemetry plane
(``telemetry=`` a :class:`~repro_torch.runtime.telemetry.Telemetry`):
the same events, plus a telemetry-only ``submit``, land in a bounded
flight recorder as ``TraceEvent`` records carrying injected-clock time,
the engine id and small attrs, exportable as Perfetto span timelines and
dumped with a full engine-state snapshot when ``run`` stalls; its tick
profiler times the step's phases and the fused tick's sub-phases by the
host's wall clock.  It adds no kernel launch and no device sync: with
the default ``telemetry=None`` the hot path pays one attribute load and
a None check per event.  ``runtime.router.ModelFleet`` puts several
paged engines behind one ``submit`` and one shared host page budget.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from collections import Counter, deque
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import mixed_precision
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import ops
from repro_torch.models import model as M
from repro_torch.models.convert import cast_for_compute
from repro_torch.runtime.paged_kv import BlockManager, EngineMetrics, PrefixMatch
from repro_torch.runtime.sampler import GREEDY, Sampler, SamplingParams


def resolve_device(device=None) -> torch.device:
    """The engine's device: ``"cuda"`` unless the caller names one.

    Raises:
      RuntimeError: CUDA was asked for (explicitly or by default) on a
          machine without it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the port runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain versions on "
            "the CPU")
    return dev


class SchedulerStallError(RuntimeError):
    """``run`` exhausted ``max_ticks`` with requests still queued/active.

    The message names every stalled request as ``rid(priority)`` so
    starvation and deadline bugs are debuggable straight from the
    exception (and the trace): a stall whose stragglers are all
    ``batch`` under an aggressive aging bound reads very differently
    from one whose ``premium`` head is blocked on pages."""


#: Priority classes, best first.  Lower level = higher priority; the
#: admission and preemption orderings compare these levels, never the
#: class names.
PRIORITIES: Dict[str, int] = {"premium": 0, "standard": 1, "batch": 2}

DEFAULT_PRIORITY = "standard"

#: Reusable no-op context manager: the fused decode tick wraps its
#: dispatch in ``torch.profiler.record_function`` only while the tick
#: profiler is live, and this stand-in keeps the unprofiled path free.
_NULL_CTX = contextlib.nullcontext()


def priority_level(req: "Request") -> int:
    """Numeric level of ``req``'s priority class (0 = most urgent)."""
    return PRIORITIES[req.priority]


class FCFSAdmission:
    """Strict first-come-first-served admission (the default).

    Always proposes the queue head and nothing else; if the head cannot
    be placed, admission stops for the tick (no skip-ahead — a convoy
    of small requests cannot starve a large head).  This is exactly the
    pre-SLO Scheduler behavior: with it, traces are bit-identical to
    engines built before admission became pluggable."""

    name = "fcfs"

    def select(self, sched: "Scheduler") -> Optional["Request"]:
        """Return the next admission candidate or None when the queue
        is empty.  The Scheduler stops admitting for the tick when the
        returned candidate cannot be placed."""
        return sched.queue[0] if sched.queue else None


class SLOAdmission:
    """Priority + earliest-deadline-first admission with aging.

    Candidates are ranked by ``(effective class, absolute TTFT
    deadline, rid)``:

    - *effective class* is the request's priority level minus one for
      every ``aging_ticks`` ticks it has waited in the queue (time
      spent decoding on a seat never counts: preemption restarts the
      aging base at the preemption tick).  The boost is unclamped, so
      any request — ``batch`` included — eventually outranks an
      endless stream of fresh ``premium`` arrivals: the starvation
      bound is ``(level_gap + 1) * aging_ticks`` ticks of queue wait.
    - within a class, requests sort earliest *effective deadline*
      first (EDF).  The effective deadline is the earlier of the TTFT
      deadline (``t_submit + deadline_ms``) and — for TBT-deadlined
      requests — the next-token due time (last emission, or submit
      when nothing is emitted yet, plus ``tbt_deadline_ms``): a
      preempted decode-deadline request re-queues with the urgency of
      its *next* token, and a fresh TBT-deadlined request carries its
      first-token urgency from submit.  Requests with neither
      deadline sort after all deadlined peers;
    - remaining ties fall back to submit order (rid), i.e. FCFS — a
      uniform-priority, no-deadline workload admits in exactly the
      FCFS order.

    Like FCFS, admission is strict head-of-line over this ordering:
    when the best-ranked candidate cannot be placed, nothing else is
    admitted this tick (skipping ahead would hand the pages the head
    is waiting for to lower-ranked work)."""

    name = "slo"

    def __init__(self, aging_ticks: int = 64):
        if aging_ticks < 1:
            raise ValueError(f"aging_ticks must be >= 1, got {aging_ticks}")
        self.aging_ticks = aging_ticks

    def rank(self, req: "Request", tick: int) -> Tuple[int, float, int]:
        """Admission key for ``req`` at scheduler ``tick`` (lower is
        admitted first): (aged priority level, effective absolute
        deadline seconds or +inf, rid).  The effective deadline is the
        earlier of the TTFT deadline and the TBT next-token due time
        (see the class docstring)."""
        waited = max(0, tick - req.submit_tick)
        eff = priority_level(req) - waited // self.aging_ticks
        deadline = (req.t_submit + req.deadline_ms / 1e3
                    if req.deadline_ms is not None else math.inf)
        tbt_ms = getattr(req, "tbt_deadline_ms", None)  # stub-tolerant
        if tbt_ms is not None:
            base = (req.t_last_token if req.t_last_token is not None
                    else req.t_submit)
            deadline = min(deadline, base + tbt_ms / 1e3)
        return (eff, deadline, req.rid)

    def select(self, sched: "Scheduler") -> Optional["Request"]:
        """Best-ranked queued request for this tick, or None.

        Single manual pass with :meth:`rank`'s key computation inlined:
        this scan is O(queue) per free seat per tick and dominates an
        overloaded engine's host time (the load harness drives queues
        thousands deep), where ``min(queue, key=...)`` pays a Python
        frame per element.  Must order identically to
        ``min(queue, key=lambda r: self.rank(r, tick))``."""
        queue = sched.queue
        if not queue:
            return None
        tick, aging = sched._tick, self.aging_ticks
        levels = PRIORITIES
        best = None
        best_key: Tuple[int, float, int] = (0, 0.0, 0)
        for req in queue:
            waited = tick - req.submit_tick
            eff = levels[req.priority] - (waited if waited > 0 else 0) // aging
            deadline = (req.t_submit + req.deadline_ms / 1e3
                        if req.deadline_ms is not None else math.inf)
            tbt_ms = req.tbt_deadline_ms
            if tbt_ms is not None:
                due = (req.t_last_token if req.t_last_token is not None
                       else req.t_submit) + tbt_ms / 1e3
                if due < deadline:
                    deadline = due
            key = (eff, deadline, req.rid)
            if best is None or key < best_key:
                best, best_key = req, key
        return best


def _make_admission(admission, aging_ticks: int):
    """Resolve an admission spec — ``"fcfs"``, ``"slo"`` or a policy
    object with ``select(scheduler)`` — into a policy instance."""
    if isinstance(admission, str):
        if admission == "fcfs":
            return FCFSAdmission()
        if admission == "slo":
            return SLOAdmission(aging_ticks)
        raise ValueError(f"unknown admission policy {admission!r}; "
                         "expected 'fcfs' or 'slo'")
    if not hasattr(admission, "select"):
        raise TypeError(f"admission policy {admission!r} has no select()")
    return admission


@dataclasses.dataclass
class Request:
    """One serving request and its scheduler-owned lifecycle state.

    Constructor-facing fields (set via :meth:`Scheduler.submit`):
      rid: engine-assigned id, monotonically increasing in submit order.
      prompt: (P,) int32 token ids.
      max_new_tokens: generation budget (the eos token counts toward it).
      eos_id: stop decoding early when this token is produced.
      sampling: per-request :class:`SamplingParams` (greedy by default).
      priority: SLO class name — one of :data:`PRIORITIES`.
      deadline_ms: optional TTFT deadline, milliseconds from submit;
          drives EDF ordering under :class:`SLOAdmission` and the
          deadline-miss metric/trace event under every policy.
      tbt_deadline_ms: optional per-token TBT (time-between-tokens)
          decode deadline, milliseconds between consecutive emitted
          tokens.  Under :class:`SLOAdmission` the request's *next*
          token due time (last emission + TBT budget) joins the EDF
          key, so a preempted TBT-deadlined request re-admits with
          real urgency; :meth:`Scheduler.pick_victim` never prefers a
          TBT-deadlined request as a preemption victim while a
          same-or-lower-class victim without one exists; TBT misses
          are counted per class under every policy.
    The remaining fields are filled in by the engine as the request
    moves through admit → prefill → decode → finish (or preempt)."""
    rid: int
    prompt: np.ndarray              # (P,) int32
    max_new_tokens: int
    eos_id: Optional[int] = None
    sampling: SamplingParams = GREEDY
    priority: str = DEFAULT_PRIORITY
    deadline_ms: Optional[float] = None
    tbt_deadline_ms: Optional[float] = None
    # filled by the engine:
    generated: List[int] = dataclasses.field(default_factory=list)
    slot: Optional[int] = None      # seat index (paged) / cache slot (fixed)
    pages: List[int] = dataclasses.field(default_factory=list)
    prefill_pos: int = 0            # prompt tokens already placed (paged)
    cached_tokens: int = 0          # prompt tokens served by the prefix cache
    registered_pages: int = 0       # prompt pages published to the prefix index
    match_version: Optional[int] = None  # BlockManager.version at last failed
    #                                      admission attempt (re-match gate)
    resume_tokens: Optional[np.ndarray] = None  # replay prefill source after
    #                                             a preemption (prompt +
    #                                             generated[:-1])
    times_preempted: int = 0
    done: bool = False
    submit_tick: int = 0            # scheduler tick at submit (aging base)
    t_submit: float = 0.0
    t_first_token: Optional[float] = None
    t_last_token: Optional[float] = None  # latest emission (TBT base)
    t_done: Optional[float] = None

    @property
    def prefill_src(self) -> np.ndarray:
        """Tokens the policy must (re)prefill: the prompt, or — after a
        preemption — the prompt plus all generated tokens but the last
        (the last one re-enters through the normal decode feed, so the
        replayed KV and sampling steps line up exactly with an
        uncontended run)."""
        return self.prompt if self.resume_tokens is None else self.resume_tokens




class Scheduler:
    """Engine-agnostic serving loop: queue, seats, admission, sampling,
    completion, metrics and trace.  All KV placement and model calls live
    in the bound policy."""

    default_max_ticks = 100_000

    def __init__(self, policy, *, max_seats: int,
                 sampler: Optional[Sampler] = None, page_capacity: int = 0,
                 admission="fcfs", aging_ticks: int = 64,
                 clock=None, record_trace: bool = True, telemetry=None):
        """Bind ``policy`` (the KV placement + model arithmetic) to a
        fresh scheduler.

        Args:
          policy: placement policy (:class:`FixedSlotPolicy` or
              :class:`PagedPolicy`); ``policy.bind(self)`` is called.
          max_seats: concurrent-request limit (seats ``0..max_seats-1``).
          sampler: host :class:`~repro_torch.runtime.sampler.Sampler`
              for first tokens of stochastic requests.
          page_capacity: usable KV pages, for :class:`EngineMetrics`.
          admission: ``"fcfs"`` (default), ``"slo"`` (priority + EDF +
              aging) or a policy object with ``select(scheduler)``.
          aging_ticks: SLO anti-starvation bound (ignored by FCFS).
          clock: zero-arg callable returning monotonic seconds (default
              ``time.perf_counter``).
          record_trace: keep the per-event ``trace`` list (default).
          telemetry: optional
              :class:`~repro_torch.runtime.telemetry.Telemetry` — every
              ``_trace`` site then also emits a structured ``TraceEvent``
              (injected-clock time, ``engine_id``, attrs) into its flight
              recorder, deadlined TTFT/TBT verdicts feed its SLO
              burn-rate monitor, ``run`` dumps a postmortem through it on
              a stall, and its tick profiler (when enabled) times the
              step phases.  None (default) keeps the hot path at one
              attribute load + None check per event.

        Raises:
          ValueError: unknown ``admission`` name or ``aging_ticks < 1``.
          TypeError: ``admission`` object without a ``select`` method.
        """
        self.policy = policy
        self.max_seats = max_seats
        self.sampler = sampler or Sampler()
        self.admission = _make_admission(admission, aging_ticks)
        self.clock = clock if clock is not None else time.perf_counter
        self.seats: Dict[int, Request] = {}             # seat -> request
        self.queue: Deque[Request] = deque()
        self.finished: List[Request] = []
        self.metrics = EngineMetrics(page_capacity=page_capacity)
        self.trace: Optional[List[Tuple[int, str, int]]] = (
            [] if record_trace else None)
        self.telemetry = telemetry
        self.engine_id = ""
        self._next_rid = 0
        self._tick = 0
        policy.bind(self)

    def _trace(self, event: str, rid: int,
               attrs: Optional[dict] = None) -> None:
        """Append one (tick, event, rid) trace tuple — no-op when the
        trace is disabled — and mirror the event into the telemetry
        flight recorder when one is attached.  ``attrs`` never reaches
        the flat trace; hot callers pass None so the off path allocates
        nothing."""
        if self.trace is not None:
            self.trace.append((self._tick, event, rid))
        tel = self.telemetry
        if tel is not None:
            tel.emit(self._tick, self.clock(), self.engine_id, rid,
                     event, attrs)

    # -- queue ---------------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int = 16,
               eos_id: Optional[int] = None,
               sampling: Optional[SamplingParams] = None,
               priority: str = DEFAULT_PRIORITY,
               deadline_ms: Optional[float] = None,
               tbt_deadline_ms: Optional[float] = None,
               rid: Optional[int] = None) -> int:
        """Queue one request; returns its engine-assigned rid.

        Args:
          prompt: 1-D int32 token ids (non-empty).
          max_new_tokens: generation budget, >= 1.
          eos_id: optional early-stop token id.
          sampling: per-request :class:`SamplingParams` (greedy when
              None); streams are keyed by (seed, rid, step) only.
          priority: SLO class, one of :data:`PRIORITIES`.
          deadline_ms: optional TTFT deadline in ms from now (> 0).
          tbt_deadline_ms: optional per-token decode deadline in ms (> 0).
          rid: explicit request id; must keep rids strictly increasing.

        Raises:
          ValueError: unknown priority, non-positive deadline, a
              non-monotonic explicit ``rid``, or a prompt/budget the
              bound policy cannot ever place.
        """
        if priority not in PRIORITIES:
            raise ValueError(f"unknown priority {priority!r}; expected one "
                             f"of {sorted(PRIORITIES)}")
        if deadline_ms is not None and deadline_ms <= 0:
            raise ValueError(f"deadline_ms must be > 0, got {deadline_ms}")
        if tbt_deadline_ms is not None and tbt_deadline_ms <= 0:
            raise ValueError(
                f"tbt_deadline_ms must be > 0, got {tbt_deadline_ms}")
        if rid is None:
            rid = self._next_rid
        elif rid < self._next_rid:
            # rid order is load-bearing: prefill picks the lowest rid,
            # preemption the highest, SLO ties break on rid
            raise ValueError(
                f"explicit rid {rid} is not monotonic: this engine has "
                f"already assigned rids up to {self._next_rid - 1}")
        req = Request(rid, np.asarray(prompt, np.int32),
                      max_new_tokens, eos_id, sampling or GREEDY,
                      priority=priority, deadline_ms=deadline_ms,
                      tbt_deadline_ms=tbt_deadline_ms,
                      submit_tick=self._tick, t_submit=self.clock())
        self.policy.validate(req)
        self._next_rid = rid + 1
        self.queue.append(req)
        self.metrics.submitted += 1
        tel = self.telemetry
        if tel is not None:
            # telemetry-only event: the flat trace starts at admit
            tel.emit(self._tick, req.t_submit, self.engine_id, req.rid,
                     "submit", {"priority": req.priority,
                                "prompt_tokens": int(req.prompt.size),
                                "max_new_tokens": req.max_new_tokens})
        return req.rid

    def _free_seats(self) -> List[int]:
        return [s for s in range(self.max_seats) if s not in self.seats]

    def _admit_from_queue(self):
        """Admit while the admission policy's candidate has a seat AND a
        placement; the first unplaceable candidate ends the tick's
        admissions (strict head-of-line)."""
        for seat in self._free_seats():
            req = self.admission.select(self)
            if req is None:
                break
            if not self.policy.try_admit(req, seat):
                break
            self.queue.remove(req)
            req.slot = seat
            self.seats[seat] = req
            self.metrics.admitted += 1
            self._trace("admit", req.rid,
                        None if self.telemetry is None else
                        {"seat": seat, "priority": req.priority,
                         "cached_tokens": req.cached_tokens,
                         "preempted_before": req.times_preempted})
            if req.cached_tokens:
                self.metrics.cached_prompt_tokens += req.cached_tokens
                self._trace("prefix_hit", req.rid)

    # -- token bookkeeping ----------------------------------------------------

    def _emit_first_tokens(self, ready: List[Tuple[Request, object]]) -> None:
        """Sample the TTFT token for every request whose prefill
        completed this tick, in one batched call with one device→host
        transfer, then timestamp all of them after the batch.

        ready: ``[(req, logits_row)]`` in emission (rid) order, each row
        the last prompt position's ``(V,)`` logits: tensors on the
        device, or numpy arrays from a model-free policy, whose rows
        never leave the host and take the same algebra in numpy."""
        if not ready:
            return
        greedy = all(req.sampling.greedy for req, _ in ready)
        if all(isinstance(row, np.ndarray) for _, row in ready):
            host = np.stack([row for _, row in ready])
            if greedy:
                toks = np.argmax(host, axis=-1).astype(np.int32)
        else:
            rows = torch.stack([row for _, row in ready])
            if greedy:
                # one on-device argmax over the burst; K ints cross to host
                toks = torch.argmax(rows, dim=-1).to(torch.int32).cpu().numpy()
            else:
                host = rows.float().cpu().numpy()    # one (K, V) transfer
        if not greedy:
            toks = [self.sampler.sample(host[i], req.sampling,
                                        rid=req.rid, step=0)
                    for i, (req, _) in enumerate(ready)]
        now = self.clock()
        for (req, _), tok in zip(ready, toks):
            tok = int(tok)
            req.generated.append(tok)
            req.t_first_token = now
            req.t_last_token = now
            ttft = now - req.t_submit
            missed = (req.deadline_ms is not None
                      and ttft * 1e3 > req.deadline_ms)
            self.metrics.note_first_token(
                req.priority, ttft, deadlined=req.deadline_ms is not None,
                missed=missed)
            tel = self.telemetry
            self._trace("first_token", req.rid,
                        None if tel is None else {"ttft_s": ttft})
            if tel is not None and req.deadline_ms is not None:
                tel.observe_slo(now, self._tick, self.engine_id,
                                req.priority, "ttft", missed)
            if missed:
                self._trace("deadline_miss", req.rid,
                            None if tel is None else
                            {"ttft_s": ttft,
                             "deadline_ms": req.deadline_ms})
            hit_eos = req.eos_id is not None and tok == req.eos_id
            if req.max_new_tokens <= 1 or hit_eos:
                self.finish(req)

    def _sample_decode_batch(self, last_logits: torch.Tensor,
                             seat_ids: List[int]) -> Dict[int, int]:
        """Next token per seat from ``(max_seats, V)`` device logits (the
        fixed-slot path; the paged engine samples inside its fused tick).
        Only the active seats' rows are reduced or moved: greedy batches
        move K ints to the host, and the (K, V) active rows cross only
        when a stochastic seat needs them."""
        sel = last_logits[torch.tensor(seat_ids, device=last_logits.device)]
        if all(self.seats[s].sampling.greedy for s in seat_ids):
            toks = torch.argmax(sel, dim=-1).to(torch.int32).cpu().numpy()
            return {s: int(toks[i]) for i, s in enumerate(seat_ids)}
        rows = sel.float().cpu().numpy()
        return {s: self.sampler.sample(rows[i], self.seats[s].sampling,
                                       rid=self.seats[s].rid,
                                       step=len(self.seats[s].generated))
                for i, s in enumerate(seat_ids)}

    def _emit_decode_token(self, req: Request, tok: int) -> None:
        req.generated.append(tok)
        self.metrics.decode_tokens += 1
        now = self.clock()
        # TBT = gap since the previous emission; preemption replay gaps
        # land here by design
        tbt = now - req.t_last_token
        req.t_last_token = now
        deadlined = req.tbt_deadline_ms is not None
        missed = deadlined and tbt * 1e3 > req.tbt_deadline_ms
        self.metrics.note_decode_token(req.priority, tbt,
                                       deadlined=deadlined, missed=missed)
        self._trace("decode", req.rid)
        tel = self.telemetry
        if tel is not None and deadlined:
            tel.observe_slo(now, self._tick, self.engine_id,
                            req.priority, "tbt", missed)
        if missed:
            self._trace("tbt_miss", req.rid,
                        None if tel is None else
                        {"tbt_s": tbt,
                         "tbt_deadline_ms": req.tbt_deadline_ms})
        hit_eos = req.eos_id is not None and tok == req.eos_id
        if len(req.generated) >= req.max_new_tokens or hit_eos:
            self.finish(req)

    def finish(self, req: Request) -> None:
        """Complete ``req``: the policy releases its KV placement, the
        seat frees, and completion counters and the ``finish`` trace
        event are recorded."""
        req.done = True
        req.t_done = self.clock()
        self.policy.release(req)
        del self.seats[req.slot]
        self.finished.append(req)
        self.metrics.note_completion(req.priority)
        self._trace("finish", req.rid)

    def preempt(self, req: Request) -> None:
        """Evict a decoding request under memory pressure: the policy
        frees its placement and stashes the replay source, generated
        tokens are kept, and the request returns to the queue head.

        Raises:
          ValueError: ``req`` has not emitted its first token yet."""
        if not req.generated:
            raise ValueError(
                f"cannot preempt request {req.rid} before its first "
                "token; only decoding requests are preemptible (a "
                "mid-prefill request has no tokens to replay)")
        self.policy.preempt(req)
        del self.seats[req.slot]
        req.slot = None
        self.queue.appendleft(req)
        # aging measures queue wait, not lifetime
        req.submit_tick = self._tick
        req.times_preempted += 1
        self.metrics.note_preemption(req.priority)
        self._trace("preempt", req.rid)

    def pick_victim(self, victims: List[Request],
                    grower: Request) -> Request:
        """Priority-aware preemption victim among ``victims`` on behalf
        of ``grower``: lowest class first; within a class, requests
        without a TBT deadline first; youngest (highest rid) breaks the
        remaining ties — and a grower never preempts a strictly higher
        class than its own (it evicts itself instead)."""
        victim = max(victims, key=lambda r: (
            priority_level(r), r.tbt_deadline_ms is None, r.rid))
        if priority_level(victim) < priority_level(grower):
            return grower
        return victim

    # -- one engine tick -----------------------------------------------------

    def step(self):
        """One engine tick: admission, one prefill round, one decode
        round, then a metrics sample.  When the attached telemetry
        carries a live tick profiler the phases run through
        :meth:`_step_profiled` instead (identical order and effects, plus
        wall-time attribution)."""
        tel = self.telemetry
        if tel is not None and tel.profiler is not None:
            return self._step_profiled(tel.profiler)
        self.metrics.begin(self.clock())
        self._tick += 1
        self._admit_from_queue()
        self.policy.prefill_tick()
        self.policy.decode_tick()
        self._tick_bookkeeping()

    def _step_profiled(self, prof):
        """The tick with per-phase wall-time attribution (``admission`` /
        ``prefill`` / ``decode`` / ``bookkeeping``; the fused paged
        decode refines its share into ``decode/*`` sub-phases).  Measured
        with ``time.perf_counter``, never the injected clock, which may
        be virtual and would time every phase as 0; nothing here waits
        for the device."""
        self.metrics.begin(self.clock())
        self._tick += 1
        t0 = time.perf_counter()
        self._admit_from_queue()
        t1 = time.perf_counter()
        prof.add("admission", t1 - t0)
        self.policy.prefill_tick()
        t2 = time.perf_counter()
        prof.add("prefill", t2 - t1)
        self.policy.decode_tick()
        t3 = time.perf_counter()
        prof.add("decode", t3 - t2)
        self._tick_bookkeeping()
        prof.add("bookkeeping", time.perf_counter() - t3)
        prof.note_tick()

    def _tick_bookkeeping(self):
        """The tick's closing metrics sample (shared by the plain and
        profiled step paths)."""
        cached, evictions = self.policy.cache_stats()
        pages_by_class: Dict[str, int] = {}
        for r in self.seats.values():
            if r.pages:
                pages_by_class[r.priority] = (
                    pages_by_class.get(r.priority, 0) + len(r.pages))
        self.metrics.tick(queued=len(self.queue), active=len(self.seats),
                          pages_in_use=self.policy.pages_in_use(),
                          cached_pages=cached, evictions=evictions,
                          pages_by_class=pages_by_class,
                          now=self.clock())

    def run(self, max_ticks: Optional[int] = None) -> List[Request]:
        """Tick until every submitted request finishes; returns the
        finished requests in completion order.

        Raises:
          SchedulerStallError: ticks ran out with work still pending;
              with telemetry attached, a postmortem (flight recorder and
              engine state) is written through it first."""
        if max_ticks is None:
            max_ticks = self.default_max_ticks
        t = 0
        while (self.queue or self.seats) and t < max_ticks:
            self.step()
            t += 1
        if self.queue or self.seats:
            stalled = sorted(list(self.queue) + list(self.seats.values()),
                             key=lambda r: r.rid)
            msg = (f"run() exhausted max_ticks={max_ticks} with "
                   f"{len(self.queue)} queued and {len(self.seats)} "
                   f"active requests: "
                   + ", ".join(f"{r.rid}({r.priority})" for r in stalled))
            if self.telemetry is not None:
                # the stall is exactly when the evidence is hot
                self.telemetry.write_postmortem(
                    "SchedulerStallError: " + msg,
                    engines={self.engine_id or "engine": self})
            raise SchedulerStallError(msg)
        return self.finished


# ---------------------------------------------------------------------------
# Fixed device buffers and captured steps
# ---------------------------------------------------------------------------

class _Staged:
    """Fixed device buffers of one dtype, named views into one tensor
    (``dev``), with a host twin to stage their values in (numpy views
    from :meth:`stage`; pinned memory on a CUDA device), so that an upload
    is one copy for all of them.  ``layout`` lists ``(name, shape)`` in order.  The
    device views never move: a captured step reads them by address."""

    def __init__(self, layout: Sequence[Tuple[str, tuple]],
                 dtype: torch.dtype, device: torch.device):
        sizes = [math.prod(shape) for _, shape in layout]
        self._dev = torch.zeros(sum(sizes), dtype=dtype, device=device)
        cuda = self._dev.is_cuda
        self._buf = torch.zeros(sum(sizes), dtype=dtype, pin_memory=cuda)
        self.dev: Dict[str, torch.Tensor] = {}
        self._host: Dict[str, np.ndarray] = {}
        self._ends: Dict[str, int] = {}
        at = 0
        for (name, shape), size in zip(layout, sizes):
            self.dev[name] = self._dev[at:at + size].view(shape)
            self._host[name] = self._buf[at:at + size].numpy().reshape(shape)
            at += size
            self._ends[name] = at
        # recorded after each upload: the host twin is written again
        # only once the copy that reads it has run
        self._read = torch.cuda.Event() if cuda else None

    def stage(self) -> Dict[str, np.ndarray]:
        """The host views, to be filled, once the last upload has read
        them."""
        if self._read is not None:
            self._read.synchronize()
        return self._host

    def upload(self, through: Optional[str] = None) -> None:
        """Copy the host twin into the device buffers: all of them, or
        those up to and including ``through``; asynchronous on a CUDA
        device."""
        n = self._ends[through] if through else self._dev.numel()
        self._dev[:n].copy_(self._buf[:n], non_blocking=True)
        if self._read is not None:
            self._read.record()


class _Step:
    """A model step over fixed tensors, run by calling it.

    With ``capture`` (a CUDA device), ``fn`` runs once on a side stream,
    which builds the kernels' libraries, compiles the Triton kernels and
    sets up the CUDA libraries, and is then captured there as a CUDA
    graph (``torch.cuda.graph``); each call replays the graph and returns
    the tensors the capture returned.  Without, each call runs ``fn``.
    Both the warm-up and the capture run ``fn`` for real, so the caller
    puts its inputs in an idle state first, one that changes no live
    state.  A failed capture or replay raises.

    The kernel wrappers count their launches in Python
    (``kernels.ops.launches``), which a replay does not run: the counts
    the capture recorded (``launches``) are added at each replay, and
    those of the warm-up and the capture, set-up rather than serving,
    are taken back out."""

    def __init__(self, fn: Callable, capture: bool):
        self.fn = fn
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.launches: Counter = Counter()
        if not capture:
            return
        before = Counter(ops.launches)
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            fn()
        warm = Counter(ops.launches)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, stream=stream):
            self.out = fn()
        torch.cuda.current_stream().wait_stream(stream)
        self.launches = ops.launches - warm
        ops.launches.clear()
        ops.launches.update(before)

    def __call__(self):
        if self.graph is None:
            return self.fn()
        self.graph.replay()
        ops.launches.update(self.launches)
        return self.out


# ---------------------------------------------------------------------------
# KV placement policies
# ---------------------------------------------------------------------------

def _place(full, row, key: str, slot: int, P: int) -> None:
    """Write leaf ``key`` of one request's prefill cache ``row`` into slot
    ``slot`` of the fixed-slot cache ``full`` (G, slots, ...), in place,
    as the JAX policy's ``place()`` does: K/V rows 0..P-1, the rest of
    the row, the scratch position included, zeroed; every other leaf
    whole: an SSM layer's conv tail and state, which also resets what an
    idle slot's ride through the batched decode left there, and an
    encoder-decoder model's cross K/V (``ck``/``cv``, ``encoder_len``
    rows, no scratch position)."""
    if key in ("k", "v"):
        full[:, slot, :P] = row
        full[:, slot, P:] = 0
    else:
        full[:, slot] = row


class FixedSlotPolicy:
    """Dense fixed-slot placement: ``slots`` cache rows of ``max_len``
    tokens, whole-prompt prefill written into the slot.  Wastes
    ``max_len - len`` KV tokens per short request, and is the arithmetic
    oracle for the paged path.

    The cache carries one extra *scratch position* at index ``max_len``
    (the fixed-slot analogue of the paged pool's scratch page 0): idle
    slots still ride through the batched ``decode_step``, and parking
    their write position there keeps them from rewriting KV their
    previous occupant left behind.  No live query attends to it (live
    positions are < ``max_len`` and the mask drops keys past the query).
    An idle slot's query attends to all ``max_len + 1`` keys, and its
    logits are thrown away.  An SSM layer's slot holds a fixed-size state
    instead (the conv tail and the f32 SSM state, whatever ``max_len``),
    which an idle slot's ride advances on token 0: admission, and the
    replay after a preemption, write the slot's whole state anew.  An
    encoder-decoder model's slot also holds the encoder's K/V of its
    request (``ck``/``cv``, ``encoder_len`` rows each), which prefill
    writes whole and decode only reads; the prefill's frames are the
    reference's stub, zeros of ``(1, encoder_len, frontend_dim)``.  A
    vision model's prefill is fed the reference's stub patches, zeros of
    ``(1, frontend_len, frontend_dim)``, on every admission (a resumed
    request's replay too), so its first ``frontend_len`` rows embed as
    zero vectors; its prompts must be at least that long (``validate``).

    Weights move to ``device`` and the matmul weights are cast once to the
    compute dtype; the cache lives there and is written in place.  The
    write positions ``pos`` stay on the host and go up with each tick's
    tokens in one upload into a fixed ``(2, slots)`` feed buffer, over
    which the decode step is captured as a CUDA graph on a CUDA device
    (:class:`_Step`; warm-up and capture with every slot on the scratch
    position, the idle slot)."""

    def __init__(self, cfg, params, *, slots: int, max_len: int,
                 device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = cast_for_compute(
            {k: _to_device(v, self.device) for k, v in params.items()},
            M.compute_dtype(cfg))
        self.slots = slots
        self.max_len = max_len
        self.opts = M.RunOptions(q_chunk=min(max_len, 512))
        self.cache = M.init_cache(cfg, slots, max_len + 1,
                                  device=self.device)
        # next write position; max_len = scratch (slot idle)
        self.pos = np.full((slots,), max_len, np.int32)
        self.decode_ticks = 0
        # device-side health flag: stays True while every logit of a live
        # row was finite (read it after a run; no tick syncs)
        self.logits_finite = torch.ones((), dtype=torch.bool,
                                        device=self.device)
        # the decode step's input: tokens and write positions
        self._feed = _Staged([("tokens", (slots,)), ("pos", (slots,))],
                             torch.int32, self.device)
        self._feed.dev["pos"].fill_(max_len)      # idle: every slot parked
        cuda = self.device.type == "cuda"
        if cuda:
            self._tickets = da.reserve_tickets(
                self.device, slots * cfg.padded_kv_heads)
        self._decode_fn = _Step(self._decode_body, capture=cuda)

    def _decode_body(self) -> torch.Tensor:
        """One decode step over the feed buffer; returns the ``(slots,
        V)`` logits."""
        feed = self._feed.dev
        logits, _ = M.decode_step(self.params, self.cfg, self.cache,
                                  feed["tokens"][:, None], feed["pos"])
        last = logits[:, -1]
        # idle rows (parked on scratch) are garbage by contract
        self.logits_finite &= (torch.isfinite(last).all(dim=-1)
                               | (feed["pos"] >= self.max_len)).all()
        return last

    def bind(self, sched: Scheduler) -> None:
        """Attach the owning :class:`Scheduler` (called once, by its
        constructor)."""
        self.sched = sched

    def pages_in_use(self) -> int:
        """Always 0 — fixed slots are not page-accounted."""
        return 0

    def cache_stats(self) -> Tuple[int, int]:
        """(cached reclaimable pages, evictions) — both always 0: the
        fixed-slot layout has no prefix cache."""
        return 0, 0

    def validate(self, req: Request) -> None:
        """Reject a request this layout could never place.

        Raises:
          ValueError: empty prompt, prompt >= ``max_len``,
              ``prompt + max_new_tokens`` > ``max_len`` (decode would
              write past the slot), or, in a vision model, a prompt
              shorter than the ``frontend_len`` patch rows its prefill
              writes (the reference's prefill fails on it mid-run)."""
        total = len(req.prompt) + req.max_new_tokens
        if len(req.prompt) == 0:
            raise ValueError("empty prompt")
        if (self.cfg.frontend == "vision"
                and len(req.prompt) < self.cfg.frontend_len):
            raise ValueError(f"prompt length {len(req.prompt)} < "
                             f"frontend_len={self.cfg.frontend_len} of "
                             f"{self.cfg.name}'s patch rows")
        if len(req.prompt) >= self.max_len:
            raise ValueError(f"prompt length {len(req.prompt)} >= "
                             f"max_len={self.max_len}")
        if total > self.max_len:
            raise ValueError(f"request needs {total} tokens > "
                             f"max_len={self.max_len}; decode would clamp "
                             "into the last cache slot and corrupt KV")

    def try_admit(self, req: Request, seat: int) -> bool:
        """Always True: the seat is the only fixed-slot resource."""
        return True

    def release(self, req: Request) -> None:
        """Park a finished request's write position on the scratch index,
        so the idle slot stops touching the KV its occupant wrote."""
        self.pos[req.slot] = self.max_len

    def preempt(self, req: Request) -> None:
        """Hook parity with :class:`PagedPolicy` (the fixed-slot engine
        never preempts on its own, but ``Scheduler.preempt`` works on
        either policy): the slot goes back to scratch and the request
        replays ``prompt + generated[:-1]`` on re-admission."""
        self.pos[req.slot] = self.max_len
        req.resume_tokens = np.concatenate(
            [req.prompt, np.asarray(req.generated[:-1], np.int32)])
        req.prefill_pos = 0

    def prefill_tick(self) -> None:
        """Whole-prompt prefill for every seat admitted this tick, in rid
        order, so it decodes in the same tick; the burst's first tokens
        are sampled in one batched call after all the prefills."""
        pending = sorted((r for r in self.sched.seats.values()
                          if r.prefill_pos < len(r.prefill_src)),
                         key=lambda r: r.rid)
        ready = []
        for req in pending:
            row = self._prefill_one(req)
            if row is not None:
                ready.append((req, row))
        self.sched._emit_first_tokens(ready)

    def _prefill_one(self, req: Request):
        slot = req.slot
        src = req.prefill_src
        P = len(src)
        batch = {"tokens": torch.from_numpy(
            np.asarray(src, np.int32)[None]).to(self.device)}
        if self.cfg.frontend == "vision":
            batch["patches"] = torch.zeros(
                (1, self.cfg.frontend_len, self.cfg.frontend_dim),
                dtype=torch.float32, device=self.device)
        if self.cfg.frontend == "audio":
            batch["audio"] = torch.zeros(
                (1, self.cfg.encoder_len, self.cfg.frontend_dim),
                dtype=torch.float32, device=self.device)
        logits, row_cache = M.prefill(self.params, self.cfg, batch,
                                      self.opts)
        for pos, ent in self.cache.items():
            for key, full in ent.items():
                _place(full, row_cache[pos][key][:, 0], key, slot, P)
        self.logits_finite &= torch.isfinite(logits).all()
        self.pos[slot] = P
        req.prefill_pos = P
        self.sched.metrics.prefill_tokens += P
        if req.resume_tokens is None:
            return logits[0, -1]         # first token sampled in the batch
        # replay after a preemption: the first token was emitted before;
        # decode resumes by feeding generated[-1]
        return None

    def decode_tick(self) -> None:
        """One token for every active slot (prefill completes in the
        admission tick, so every seat is decode-ready): the tokens and
        write positions go up in one upload, the decode step runs (a
        graph replay on a CUDA device), and the sampled tokens come back
        in one transfer."""
        sched = self.sched
        if not sched.seats:
            return
        feed = self._feed.stage()
        feed["tokens"][:] = 0
        feed["pos"][:] = self.pos
        for slot, req in sched.seats.items():
            feed["tokens"][slot] = req.generated[-1]
        self._feed.upload()
        last = self._decode_fn()
        self.decode_ticks += 1
        toks = sched._sample_decode_batch(last, list(sched.seats))
        active = list(sched.seats.items())
        # advance positions before emitting: a token that finishes its
        # request triggers release(), whose scratch reset must stand
        for slot, _ in active:
            self.pos[slot] += 1
        for slot, req in active:
            sched._emit_decode_token(req, toks[slot])


class PagedPolicy:
    """Paged-KV placement: shared page pool on the device, chunked
    prefill, page-table decode, refcounted prefix caching with
    copy-on-write of the last partially shared page, and — with
    ``lazy_pages`` (default) — on-demand page growth with
    preempt-and-recompute under pressure.

    ``fused`` (default) runs each decode tick as one fused step over
    fixed device buffers — the model step, the batched sampler and the
    state's advance — captured with the prefill chunk as CUDA graphs on
    a CUDA device; ``fused=False`` is the eager per-tick oracle (model
    step, then host-side sampling)."""

    def __init__(self, cfg, params, *, page_size: int, num_pages: int,
                 max_seats: int, max_seq_len: int, prefill_chunk: int,
                 prefix_cache: bool = True, lazy_pages: bool = True,
                 watermark: float = 0.05, fused: bool = True,
                 kv_dtype: Optional[str] = None,
                 class_precision: Optional[Dict[str, str]] = None,
                 impl: str = "auto", device=None):
        if not M.paged_cache_supported(cfg):
            raise ValueError(
                f"{cfg.name}: paged KV needs a pure-attention decoder; "
                "use ServingEngine for ssm/enc-dec/frontend archs")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = params
        self.impl = impl
        self.page_size = page_size
        self.max_seats = max_seats
        self.max_seq_len = max_seq_len
        self.prefill_chunk = prefill_chunk
        # KV pool storage precision (None = the config's compute dtype)
        # and the per-SLO-class precision floors enforced by validate()
        if kv_dtype is not None:
            mixed_precision.kv_storage_dtype(kv_dtype)   # validate early
        self.kv_dtype = kv_dtype
        self.kv_dtype_name = kv_dtype or (
            "bf16" if M.compute_dtype(cfg) == torch.bfloat16 else "f32")
        self.class_precision = dict(class_precision or {})
        for cls, want in self.class_precision.items():
            if cls not in PRIORITIES:
                raise ValueError(
                    f"class_precision names unknown class {cls!r}; "
                    f"expected one of {sorted(PRIORITIES)}")
            mixed_precision.kv_precision_bits(want)       # validate dtype
        self.page_bytes = M.paged_page_bytes(cfg, page_size, kv_dtype)

        self.bm = BlockManager(num_pages, page_size, prefix_cache=prefix_cache,
                               page_bytes=self.page_bytes)
        self.n_tables = max(1, -(-max_seq_len // page_size))
        self.lazy = lazy_pages
        # admission headroom so live requests usually grow unopposed;
        # waived when the pool is idle
        self.watermark_pages = (
            max(1, math.ceil(watermark * self.bm.capacity))
            if lazy_pages and watermark > 0 else 0)
        if lazy_pages and self.n_tables > self.bm.capacity:
            # liveness bound: any admitted request must be completable
            # with the whole pool to itself
            raise ValueError(
                f"lazy_pages needs the pool to cover one max-length "
                f"request: max_seq_len={max_seq_len} spans "
                f"{self.n_tables} pages > capacity {self.bm.capacity}; "
                "raise num_pages, lower max_seq_len, or set "
                "lazy_pages=False")
        self.page_table = np.zeros((max_seats, self.n_tables), np.int32)
        self.pos = np.zeros((max_seats,), np.int32)     # next write position
        self.fused = fused
        # the request whose table row the prefill buffers hold
        self._prefill_rid: Optional[int] = None
        # the device copies of the serving state are refilled only on
        # churn (self._dirty); between churn events decode ticks run
        # entirely off the buffers the previous fused tick updated in place
        self._dirty = True
        self.decode_ticks = 0
        self._init_model_state(num_pages)

    def _init_model_state(self, num_pages: int) -> None:
        """Move the weights to the device and cast the matmul and
        embedding weights once to the compute dtype (a no-op on a tree
        already cast there, which is then shared), allocate the device
        KV pool and the tick's fixed device buffers, set the copy-on-write
        hook, and on a CUDA device with ``fused`` capture the fused decode
        tick and the prefill chunk as CUDA graphs over them.  Split out of
        ``__init__`` as the reference splits it: a model-free policy
        keeps the placement bookkeeping and replaces all of this (its
        ``params`` may be None, its ``cache`` None and its ``_cow_fn``
        the identity).

        The buffers start in the all-idle state, in which both steps
        change no live state (every valid count 0: writes go to the
        scratch page, ``pos`` and ``step`` advance by 0, ``last`` keeps
        its tokens), so the warm-up and the capture run on them as they
        are."""
        cfg, dev = self.cfg, self.device
        A, n, C = self.max_seats, self.n_tables, self.prefill_chunk
        self.params = cast_for_compute(
            {k: _to_device(v, dev) for k, v in self.params.items()},
            M.compute_dtype(cfg))
        # device-side health flag: stays True while every logit the
        # engine computed was finite (read it after a run; no tick syncs)
        self.logits_finite = torch.ones((), dtype=torch.bool, device=dev)
        # prefix copy-on-write of one page, in place (returns the pool)
        self._cow_fn = M.copy_paged_page
        self.cache = M.init_paged_cache(cfg, num_pages, self.page_size,
                                        kv_dtype=self.kv_dtype, device=dev)
        # the fused tick's state, one buffer per dtype (the dtypes of
        # M.fused_decode_tick), so a churn sync is three copies
        self._i32 = _Staged([("last", (A,)), ("pos", (A,)), ("nv", (A,)),
                             ("top_k", (A,)), ("table", (A, n))],
                            torch.int32, dev)
        self._f32 = _Staged([("temp", (A,)), ("top_p", (A,))],
                            torch.float32, dev)
        self._i64 = _Staged([("seed", (A,)), ("rid", (A,)), ("step", (A,))],
                            torch.int64, dev)
        self._f32.dev["top_p"].fill_(1.0)
        self._dev = {**self._i32.dev, **self._f32.dev, **self._i64.dev}
        # the prefill chunk's input: tokens, (start, valid count) and the
        # seat's page-table row
        self._prefill = _Staged([("tokens", (1, C)), ("meta", (2,)),
                                 ("row", (1, n))], torch.int32, dev)
        self._chunk_cols = torch.arange(C, dtype=torch.int32, device=dev)
        graphs = self.fused and dev.type == "cuda"
        if dev.type == "cuda":
            self._tickets = da.reserve_tickets(dev, A * cfg.padded_kv_heads)
        self._tick_fn = _Step(self._tick_body, capture=graphs)
        self._prefill_fn = _Step(self._prefill_body, capture=graphs)

    def _note_finite(self, logits: torch.Tensor,
                     ignore: torch.Tensor) -> None:
        """Fold ``logits`` (rows, V) into the health flag on the device;
        rows where ``ignore`` holds (idle seats, chunk padding) are
        garbage by contract.  A masked reduction, no boolean indexing,
        so no host sync."""
        self.logits_finite &= (torch.isfinite(logits).all(dim=-1)
                               | ignore).all()

    def _tick_body(self):
        """The fused tick over the state buffers; returns ``(tokens,
        logits (A, V))``, ``tokens`` being the ``last`` buffer."""
        d = self._dev
        toks, logits = M.fused_decode_tick(
            self.params, self.cfg, self.cache, d["last"], d["pos"],
            d["table"], d["nv"], d["temp"], d["top_k"], d["top_p"],
            d["seed"], d["rid"], d["step"], impl=self.impl)
        self._note_finite(logits, d["nv"] == 0)
        return toks, logits

    def _prefill_body(self) -> torch.Tensor:
        """One prefill chunk over the prefill buffers; returns its
        logits (1, C, V)."""
        b = self._prefill.dev
        meta = b["meta"]
        logits, _ = M.paged_decode_step(
            self.params, self.cfg, self.cache, b["tokens"], meta[:1],
            b["row"], meta[1:], impl=self.impl)
        self._note_finite(logits[0], self._chunk_cols >= meta[1])
        return logits

    def _step_body(self) -> torch.Tensor:
        """The unfused decode step (``fused=False``) over the state
        buffers; returns the logits (A, V)."""
        d = self._dev
        logits, _ = M.paged_decode_step(
            self.params, self.cfg, self.cache, d["last"][:, None], d["pos"],
            d["table"], d["nv"], impl=self.impl)
        logits = logits[:, 0]
        self._note_finite(logits, d["nv"] == 0)
        return logits

    def bind(self, sched: Scheduler) -> None:
        """Attach the owning :class:`Scheduler` (called once, by its
        constructor)."""
        self.sched = sched

    def pages_in_use(self) -> int:
        """Pages currently referenced by at least one live request."""
        return self.bm.in_use

    def cache_stats(self) -> Tuple[int, int]:
        """(reclaimable prefix-cache pages, evictions so far)."""
        return self.bm.cached, self.bm.evictions

    def validate(self, req: Request) -> None:
        """Reject a request this pool could never place.

        Raises:
          ValueError: empty prompt; ``prompt + max_new_tokens`` >
              ``max_seq_len``; the request's class carries a precision
              floor this pool does not meet; or (reserved mode only) a
              page demand over the pool's capacity."""
        total = len(req.prompt) + req.max_new_tokens
        if len(req.prompt) == 0:
            raise ValueError("empty prompt")
        want = self.class_precision.get(req.priority)
        if want is not None and (mixed_precision.kv_precision_bits(
                self.kv_dtype_name)
                < mixed_precision.kv_precision_bits(want)):
            raise ValueError(
                f"request class {req.priority!r} requires kv precision "
                f">= {want} but this engine's pool stores "
                f"{self.kv_dtype_name}; drop the class's precision floor "
                "or serve it from a full-precision engine")
        if total > self.max_seq_len:
            raise ValueError(f"request needs {total} tokens > "
                             f"max_seq_len={self.max_seq_len}")
        if not self.lazy and self.bm.pages_needed(total) > self.bm.capacity:
            raise ValueError(f"request needs {self.bm.pages_needed(total)} "
                             f"pages > pool capacity {self.bm.capacity}")

    # -- admission: seat + page budget + prefix reuse -------------------------

    def try_admit(self, req: Request, seat: int) -> bool:
        """Place ``req`` at ``seat`` if the pool allows: reserve its pages
        (prompt-only in lazy mode, prompt + full budget otherwise), take
        refs on cached prefix pages, copy-on-write a partially matching
        page, and point the seat's page-table row at the result.  Returns
        False — with no side effects — when the pool cannot cover it."""
        # a starved queue head re-attempts every tick; skip the O(prompt)
        # prefix match until the pool/index actually changed
        if req.match_version == self.bm.version:
            return False
        src = req.prefill_src
        if self.lazy:
            need = self.bm.pages_needed(len(src))
            gate = self.watermark_pages if self.sched.seats else 0
        else:
            need = self.bm.pages_needed(len(src) + req.max_new_tokens)
            gate = 0
        match = self.bm.match_prefix(src)
        # feasibility before any side effect: acquiring a reclaimable
        # matched (or CoW-source) page consumes one allocatable slot
        pinned = list(match.pages)
        if match.cow_src is not None:
            pinned.append(match.cow_src)
        reclaimed = sum(1 for pg in pinned if self.bm.refcount(pg) == 0)
        if not self.bm.can_alloc(need - len(match.pages) + reclaimed + gate):
            if match.cow_src is not None:
                # forgo the partial-page match rather than defer
                match = PrefixMatch(match.pages, None,
                                    len(match.pages) * self.page_size)
                pinned = list(match.pages)
                reclaimed = sum(1 for pg in pinned
                                if self.bm.refcount(pg) == 0)
            if not self.bm.can_alloc(need - len(match.pages)
                                     + reclaimed + gate):
                req.match_version = self.bm.version
                return False
        for pg in pinned:                        # pin shares AND the CoW
            self.bm.acquire(pg, req.rid)         # source before alloc can
        fresh = self.bm.alloc(need - len(match.pages), req.rid)  # evict them
        if fresh is None:                        # unreachable after the guard
            self.bm.free(pinned)
            return False
        if match.cow_src is not None:
            # copy the partially matched page, then own the copy; the pin
            # kept the source out of alloc's reach
            self.cache = self._cow_fn(self.cache, match.cow_src, fresh[0])
            self.bm.free([match.cow_src])
        req.pages = match.pages + fresh
        req.prefill_pos = req.cached_tokens = match.n_cached
        req.registered_pages = len(match.pages)
        row = np.zeros((self.n_tables,), np.int32)
        row[:len(req.pages)] = req.pages
        self.page_table[seat] = row
        self.pos[seat] = 0
        self._dirty = True
        return True

    def release(self, req: Request) -> None:
        """Drop a finished request's page refs and clear its page-table
        row."""
        self.bm.free(req.pages)
        self.page_table[req.slot] = 0
        self.pos[req.slot] = 0
        self._dirty = True
        self._prefill_rid = None

    def preempt(self, req: Request) -> None:
        """Free the request's placement for replay: it will re-prefill
        ``prompt + generated[:-1]`` before feeding ``generated[-1]`` back
        through the normal decode path."""
        self.bm.free(req.pages)
        self.page_table[req.slot] = 0
        self.pos[req.slot] = 0
        self._dirty = True
        self._prefill_rid = None
        req.resume_tokens = np.concatenate(
            [req.prompt, np.asarray(req.generated[:-1], np.int32)])
        req.pages = []
        req.prefill_pos = 0
        req.cached_tokens = 0
        req.registered_pages = 0
        req.match_version = None

    # -- prefill / decode ------------------------------------------------------

    def prefill_tick(self) -> None:
        """One prompt chunk for the oldest mid-prefill request: the chunk
        and its (start, count) go up in one copy into the prefill
        buffers, and the prefill step runs (a graph replay on a CUDA
        device with ``fused``)."""
        cands = [r for r in self.sched.seats.values()
                 if r.prefill_pos < len(r.prefill_src)]
        if not cands:
            return
        req = min(cands, key=lambda r: r.rid)
        seat = req.slot
        src = req.prefill_src
        start = req.prefill_pos
        chunk = src[start:start + self.prefill_chunk]
        c = len(chunk)
        buf = self._prefill.stage()
        buf["tokens"][:] = 0
        buf["tokens"][0, :c] = chunk
        buf["meta"][:] = (start, c)
        if self._prefill_rid != req.rid:
            # the seat's table row cannot change mid-prefill: upload it
            # once per request, not per chunk
            buf["row"][0] = self.page_table[seat]
            self._prefill.upload()
            self._prefill_rid = req.rid
        else:
            self._prefill.upload(through="meta")
        # on a CUDA device the logits are the graph's output buffer, which
        # the next replay overwrites; the first token is read from it in
        # this tick, ahead of any later replay on the stream
        logits = self._prefill_fn()
        req.prefill_pos += c
        self.sched.metrics.prefill_tokens += c
        self.sched._trace("prefill_chunk", req.rid)
        self._register_full_pages(req)
        if req.prefill_pos == len(src):
            self.pos[seat] = len(src)
            self._dirty = True           # seat joins the decoding set
            if req.resume_tokens is None:
                self.sched._emit_first_tokens([(req, logits[0, c - 1])])
            # else: replay — the first token was emitted before the
            # preemption; decode resumes by feeding generated[-1]

    def _register_full_pages(self, req: Request) -> None:
        """Publish every page now fully covered by prefill tokens to the
        prefix index."""
        if not self.bm.prefix_cache:
            return
        src = req.prefill_src
        full = req.prefill_pos // self.page_size
        while req.registered_pages < full:
            i = req.registered_pages
            self.bm.register_prefix(src[:(i + 1) * self.page_size],
                                    req.pages[i])
            req.registered_pages += 1

    def _decoding_seats(self) -> List[int]:
        return [s for s, r in self.sched.seats.items()
                if r.prefill_pos >= len(r.prefill_src)]

    def _grow_tick(self) -> None:
        """Lazy mode: hand each decoding seat the page its next write
        needs, oldest request first; when the pool cannot grow, preempt
        the :meth:`Scheduler.pick_victim` choice until the allocation
        succeeds or the grower is gone."""
        sched = self.sched
        for s in sorted(self._decoding_seats(),
                        key=lambda s: sched.seats[s].rid):
            req = sched.seats.get(s)
            if req is None:                  # preempted for an older seat
                continue
            if self.pos[s] < len(req.pages) * self.page_size:
                continue                     # next write is covered
            pg = self.bm.try_grow(req.rid)
            while pg is None:
                victims = [sched.seats[v] for v in self._decoding_seats()]
                victim = sched.pick_victim(victims, req)
                sched.preempt(victim)
                if victim is req:
                    break                    # grower evicted itself
                pg = self.bm.try_grow(req.rid)
            if pg is not None:
                self.page_table[s, len(req.pages)] = pg
                req.pages.append(pg)
                self._dirty = True       # table row changed on host

    def _sync_device(self) -> None:
        """Refill the device-resident tick state from the host mirrors
        after a churn event (admit / finish / preempt / page growth /
        prefill completion): staged on the host, then one copy per dtype
        into the fixed buffers, which keep their shapes and addresses."""
        i32, f32, i64 = (self._i32.stage(), self._f32.stage(),
                         self._i64.stage())
        for a in (*i32.values(), *i64.values()):
            a[:] = 0
        f32["temp"][:] = 0
        f32["top_p"][:] = 1
        i32["pos"][:] = self.pos
        i32["table"][:] = self.page_table
        for s, r in self.sched.seats.items():
            if r.prefill_pos < len(r.prefill_src):
                continue                 # still prefilling: stays masked
            i32["nv"][s] = 1
            i32["last"][s] = r.generated[-1]
            sp = r.sampling
            f32["temp"][s] = sp.temperature
            i32["top_k"][s] = sp.top_k
            f32["top_p"][s] = sp.top_p
            i64["seed"][s] = sp.seed & 0xFFFFFFFF
            i64["rid"][s] = r.rid & 0xFFFFFFFF
            i64["step"][s] = len(r.generated)
        for staged in (self._i32, self._f32, self._i64):
            staged.upload()
        self._dirty = False

    def decode_tick(self) -> None:
        """One token for every seat whose prefill is complete (growing
        page tables first in lazy mode).

        Fused (default): one fused tick over the device-resident state
        (a graph replay on a CUDA device), and one ``(max_seats,)`` int32
        token vector back to the host.  ``fused=False``: the token and
        position vectors go up, the model step runs eagerly, and the
        sampler runs on the host side of the logits' transfer
        (``Scheduler._sample_decode_batch``), as the reference's
        pre-fusion path does.

        While a tick profiler is live, the fused tick's share of the
        step's ``decode`` phase is refined into ``decode/sync`` (staging
        and the one upload per dtype, on churn), ``decode/dispatch`` (the
        fused tick's enqueue, inside a ``fused_decode_tick``
        ``record_function`` range), ``decode/host`` (the token pull,
        which holds the wait for the device) and ``decode/sample`` (host
        acceptance), by the host's wall clock and without any added sync;
        ``fused=False`` gets the step-level phases only."""
        sched = self.sched
        if self.lazy:
            self._grow_tick()
        decoding = self._decoding_seats()
        if not decoding:
            return
        tel = sched.telemetry
        prof = None if tel is None or not self.fused else tel.profiler
        t0 = time.perf_counter() if prof is not None else 0.0
        if self._dirty:
            self._sync_device()
            if prof is not None:
                now = time.perf_counter()
                prof.add("decode/sync", now - t0)
                t0 = now
        elif not self.fused:
            # the eager step advances nothing on the device
            feed = self._i32.stage()
            feed["last"][:] = 0
            for s in decoding:
                feed["last"][s] = sched.seats[s].generated[-1]
            feed["pos"][:] = self.pos
            self._i32.upload(through="pos")
        if self.fused:
            # the range wraps the replay, never the capture
            with (torch.profiler.record_function("fused_decode_tick")
                  if prof is not None else _NULL_CTX):
                toks_dev, _ = self._tick_fn()
            if prof is not None:
                now = time.perf_counter()
                prof.add("decode/dispatch", now - t0)
                t0 = now
            toks = toks_dev.cpu().numpy()  # the tick's one device->host sync
            if prof is not None:
                now = time.perf_counter()
                prof.add("decode/host", now - t0)
                t0 = now
        else:
            toks = sched._sample_decode_batch(self._step_body(), decoding)
        self.decode_ticks += 1
        for s in decoding:
            req = sched.seats[s]
            self.pos[s] += 1
            sched._emit_decode_token(req, int(toks[s]))
        if prof is not None:
            prof.add("decode/sample", time.perf_counter() - t0)


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


# ---------------------------------------------------------------------------
# Engine façades (public API)
# ---------------------------------------------------------------------------

class ServingEngine(Scheduler):
    """Fixed-slot continuous-batching engine: the Scheduler bound to
    :class:`FixedSlotPolicy`, the equivalence oracle for the paged engine.

    ``slots`` seats of ``max_len`` tokens each; the dense prefill (the
    CPU path) chunks queries by ``min(max_len, 512)``.  ``admission``
    selects the queue policy (``"fcfs"``/``"slo"``) and ``aging_ticks``
    its anti-starvation bound.  The kernels run on CUDA, the plain
    versions on the CPU (``kernels.ops``).  ``device`` defaults to
    ``"cuda"`` and raises when CUDA is absent; pass ``"cpu"`` to run on
    the CPU."""

    default_max_ticks = 10_000

    def __init__(self, cfg, params, *, slots: int = 4, max_len: int = 256,
                 sampler: Optional[Sampler] = None,
                 admission="fcfs", aging_ticks: int = 64,
                 clock=None, record_trace: bool = True, telemetry=None,
                 device=None):
        policy = FixedSlotPolicy(cfg, params, slots=slots, max_len=max_len,
                                 device=device)
        super().__init__(policy, max_seats=slots, sampler=sampler,
                         admission=admission, aging_ticks=aging_ticks,
                         clock=clock, record_trace=record_trace,
                         telemetry=telemetry)
        self.cfg = cfg
        self.params = policy.params
        self.B = slots
        self.max_len = max_len
        self.opts = policy.opts
        self.device = policy.device

    @property
    def active(self) -> Dict[int, Request]:
        return self.seats

    @property
    def cache(self):
        return self.policy.cache

    @property
    def pos(self) -> np.ndarray:
        return self.policy.pos


class PagedServingEngine(Scheduler):
    """Paged-KV continuous-batching engine: the Scheduler bound to
    :class:`PagedPolicy`.

    ``prefix_cache=False`` disables page sharing; ``lazy_pages`` (default
    True) reserves only prompt pages at admission and grows on demand,
    preempting under page pressure; ``watermark`` is the lazy admission
    gate's free-page headroom as a fraction of pool capacity.
    ``fused`` (default True) runs each decode tick as one fused step —
    model step, batched on-device sampling and the state's advance over
    fixed device buffers — captured, with the prefill chunk, as a CUDA
    graph at construction on a CUDA device, so a steady tick is one
    graph replay and one ``(max_seats,)`` token vector back to the
    host; ``fused=False`` is the eager per-tick path with host-side
    sampling (the equivalence oracle).
    ``admission`` selects the queue policy (``"fcfs"``/``"slo"``) and
    ``aging_ticks`` its anti-starvation bound.  ``kv_dtype`` picks the
    pool's storage precision (``f32``/``bf16``/``fp8``/``int8``; None =
    the compute dtype) and ``class_precision`` maps SLO classes to
    minimum precisions, rejected at submit when the pool is below them.
    ``impl`` picks kernels or plain versions (``kernels.ops``; ``auto``
    = the kernels on CUDA).  ``device`` defaults to ``"cuda"`` and
    raises when CUDA is absent; pass ``"cpu"`` to run on the CPU.
    ``policy_cls`` replaces :class:`PagedPolicy` (None = it) with a
    subclass built with the same arguments.
    """

    default_max_ticks = 100_000

    def __init__(self, cfg, params, *, page_size: int = 16,
                 num_pages: int = 64, max_seats: int = 8,
                 max_seq_len: int = 256, prefill_chunk: int = 32,
                 sampler: Optional[Sampler] = None,
                 prefix_cache: bool = True, lazy_pages: bool = True,
                 watermark: float = 0.05, fused: bool = True,
                 admission="fcfs", aging_ticks: int = 64,
                 kv_dtype: Optional[str] = None,
                 class_precision: Optional[Dict[str, str]] = None,
                 clock=None, record_trace: bool = True,
                 telemetry=None, impl: str = "auto", device=None,
                 policy_cls: Optional[type] = None):
        # policy_cls swaps the placement + arithmetic implementation and
        # keeps every Scheduler behaviour (a model-free policy for load
        # tests overrides PagedPolicy._init_model_state and the ticks)
        policy = (policy_cls or PagedPolicy)(
            cfg, params, page_size=page_size, num_pages=num_pages,
            max_seats=max_seats, max_seq_len=max_seq_len,
            prefill_chunk=prefill_chunk, prefix_cache=prefix_cache,
            lazy_pages=lazy_pages, watermark=watermark, fused=fused,
            kv_dtype=kv_dtype, class_precision=class_precision, impl=impl,
            device=device)
        super().__init__(policy, max_seats=max_seats, sampler=sampler,
                         page_capacity=policy.bm.capacity,
                         admission=admission, aging_ticks=aging_ticks,
                         clock=clock, record_trace=record_trace,
                         telemetry=telemetry)
        self.metrics.kv_dtype = policy.kv_dtype_name
        self.metrics.page_bytes = policy.page_bytes
        self.cfg = cfg
        self.params = policy.params
        self.page_size = page_size
        self.max_seq_len = max_seq_len
        self.prefill_chunk = prefill_chunk
        self.device = policy.device

    @property
    def kv_dtype(self) -> str:
        """The pool's storage precision name (resolved)."""
        return self.policy.kv_dtype_name

    @property
    def bm(self) -> BlockManager:
        return self.policy.bm

    @property
    def n_tables(self) -> int:
        return self.policy.n_tables

    @property
    def cache(self):
        return self.policy.cache

    @property
    def page_table(self) -> np.ndarray:
        return self.policy.page_table

    @property
    def pos(self) -> np.ndarray:
        return self.policy.pos
