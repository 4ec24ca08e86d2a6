"""Multi-model fleet router: N serving engines behind one submit() API.

One process, one shared host, several models — the operating reality of
a managed GPU cluster where many LLM workloads of different shapes
coexist on the same bare-metal hosts.  A :class:`ModelFleet` owns a set
of :class:`~repro_torch.runtime.serving.PagedServingEngine` instances —
possibly different architectures, each with its own KV page pool, the
replicas of one model sharing one tree of weights on the device — and
routes requests to them behind a single
``submit(model=..., prompt=...)`` call plus an outer tick loop that
interleaves ``engine.step()`` across the fleet::

    submit(model, prompt, priority, deadline_ms, session_id)
         │
         ▼
    ReplicaGroup[model] ── session affinity ──► home replica
         │ (no session / first turn)
         ▼
    replica selection          LeastLoaded (default) | RoundRobin
         │
         ▼
    engine.submit(prompt, rid=<fleet-global rid>)
         │                         │
         ▼                         ▼
    ModelFleet.step()        HostBudget — shared page budget:
      engine.step() per        per-model floors, surplus
      engine with work         redistributed at admission time

The three load-bearing properties:

**rid namespacing.**  The fleet assigns every request's rid from one
fleet-global counter, so each engine's rid set is a disjoint slice of
one monotonic sequence and sampler keys ``(seed, rid, step)`` never
collide across the fleet — two engines serving same-seed stochastic
requests produce independent streams.  Because the rid is fixed at
submit time (before and independent of routing), a routed request's
token stream is bit-identical to the same request submitted to a
dedicated solo engine with the same explicit rid: routing decides
*where* a request runs, never *which* tokens it produces
(``tests/test_torch_router.py`` fuzzes this against random routing
schedules and holds the streams to the JAX package's fleet).

**shared host budget.**  All engines' page pools answer to one
:class:`HostBudget`: each model guarantees itself ``floor`` pages
(default: enough for one max-length request, so preempt-and-recompute
always converges), and the remaining surplus is granted to whichever
engine asks first, re-evaluated at every admission and growth attempt
(``BlockManager.can_alloc`` consults the budget; freeing pages in one
engine invalidates its siblings' admission caches so their starved
heads re-attempt).  A busy model borrows an idle model's headroom and
hands it back under pressure — no static partitioning decision.

**session affinity.**  A ``session_id``'s follow-up turns route to the
replica that served its earlier turns, where the session's prompt
pages are still registered in that replica's prefix index — the
multi-turn prefix hit is only warm on the home replica.

Fleet-level observability aggregates per-replica
:class:`~repro_torch.runtime.paged_kv.EngineMetrics` via
``EngineMetrics.merged``: per-model tokens/s, TTFT percentiles,
prefix-hit rate, preemptions and SLO-class breakdowns, surfaced through
``repro_torch.launch.serve --fleet``.

The port's counterpart of ``repro.runtime.router``, under the same names.
Its differences: the fleet resolves one ``device`` (CUDA unless the
caller names another) and passes it to every engine; it moves and casts
each model's weights for compute once and gives that one tree to all of
the model's replicas, which therefore share its storage (``params=None``,
for a model-free ``policy_cls``, is passed through);
the reference's sharding ``rules`` and ``RunOptions`` have no
counterpart in the port's engines.  The engines step one after another
on one stream, which the decode kernels' shared split-K tickets
(``kernels.decode_attention.reserve_tickets``) rely on.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core import mixed_precision
from repro_torch.models import model as M
from repro_torch.models.convert import cast_for_compute
from repro_torch.runtime.paged_kv import BlockManager, EngineMetrics
from repro_torch.runtime.sampler import Sampler, SamplingParams
from repro_torch.runtime.serving import (DEFAULT_PRIORITY, PagedServingEngine,
                                         Request, SchedulerStallError,
                                         _to_device, priority_level,
                                         resolve_device)


class HostBudget:
    """One total figure carved across engines: floors + surplus.

    Each registered :class:`BlockManager` is guaranteed ``floor`` live
    pages; the surplus belongs to no engine and is granted on demand:
    an engine may hold its floor plus whatever surplus its siblings
    have not borrowed at any instant.  The grant is re-evaluated at
    every allocation (:meth:`allows` is called from
    ``BlockManager.can_alloc``), so the split between models tracks
    the live load instead of a static partition — *surplus
    redistribution at admission time*.

    The budget is denominated in BYTES, not pages, when engines differ
    in KV precision: ``total_pages`` is interpreted as pages of
    ``page_bytes`` bytes each (the reference page — by convention the
    fleet's most expensive page), and each registered manager's live
    pages are weighted by its own ``BlockManager.page_bytes``.  An fp8
    engine whose pages cost a quarter of an f32 engine's can therefore
    borrow ~4× as many pages from the same surplus — byte-for-byte
    fairness across precisions.  With the default ``page_bytes=1`` on
    both the budget and every manager, all the arithmetic collapses to
    plain page counting (the single-precision behavior, unchanged).

    Reclaimable prefix-cache pages do not count against the budget:
    they are evictable at will by their own engine, so only *live*
    (referenced) pages represent un-reclaimable host commitment.

    Freeing pages in one engine must un-starve queued admissions in the
    others, so any registered manager's state change bumps its
    siblings' ``version`` counters (:meth:`invalidate`) — the paged
    admission path caches failed attempts against that counter.
    """

    def __init__(self, total_pages: int, *, page_bytes: int = 1):
        if total_pages < 1:
            raise ValueError(f"total_pages must be >= 1, got {total_pages}")
        if page_bytes < 1:
            raise ValueError(f"page_bytes must be >= 1, got {page_bytes}")
        self.total = total_pages
        self.page_bytes = page_bytes
        self.total_bytes = total_pages * page_bytes
        self._floors: Dict[object, int] = {}
        self._managers: Dict[object, BlockManager] = {}

    def _floor_bytes(self) -> int:
        return sum(f * self._managers[k].page_bytes
                   for k, f in self._floors.items())

    @property
    def surplus_bytes(self) -> int:
        """Bytes beyond the floors, shared on demand."""
        return self.total_bytes - self._floor_bytes()

    @property
    def surplus(self) -> int:
        """The surplus in reference pages (``surplus_bytes`` at
        ``page_bytes`` per page) — equals ``total - sum(floors)`` when
        every engine shares the budget's page cost."""
        return self.surplus_bytes // self.page_bytes

    def register(self, key, bm: BlockManager, floor: int) -> None:
        """Put ``bm`` under this budget with a guaranteed ``floor`` (in
        ``bm``'s own pages).

        Raises:
          ValueError: duplicate key, non-positive floor, or floors
              exceeding the total (the surplus must stay >= 0)."""
        if key in self._managers:
            raise ValueError(f"budget key {key!r} already registered")
        if floor < 1:
            raise ValueError(f"floor must be >= 1, got {floor} for {key!r}")
        if self._floor_bytes() + floor * bm.page_bytes > self.total_bytes:
            raise ValueError(
                f"floors exceed the host budget: registering {key!r} with "
                f"floor {floor} ({floor * bm.page_bytes} bytes) on top of "
                f"{self._floor_bytes()} already-guaranteed bytes > total "
                f"{self.total_bytes}")
        bm.attach_budget(self, key)     # raises first: a rejected manager
        self._floors[key] = floor       # must leave this budget untouched
        self._managers[key] = bm

    def borrowed(self, key) -> int:
        """Live pages ``key`` currently holds beyond its floor (in its
        own pages)."""
        return max(0, self._managers[key].in_use - self._floors[key])

    def borrowed_bytes(self, key) -> int:
        """Bytes ``key`` currently holds beyond its floor."""
        return self.borrowed(key) * self._managers[key].page_bytes

    def allows(self, key, n: int) -> bool:
        """Whether engine ``key`` may take ``n`` more live pages now:
        its post-alloc overshoot past its floor, plus what the other
        engines have already borrowed, must fit in the surplus — all
        weighted by each engine's own page cost in bytes."""
        bm = self._managers[key]
        over = max(0, bm.in_use + n - self._floors[key]) * bm.page_bytes
        others = sum(self.borrowed_bytes(k)
                     for k in self._managers if k != key)
        return over + others <= self.surplus_bytes

    def invalidate(self, source: BlockManager) -> None:
        """Bump every *other* registered manager's version: pages freed
        (or taken) in ``source`` change what their next admission
        attempt could get, so cached failed attempts must retry."""
        for bm in self._managers.values():
            if bm is not source:
                bm.version += 1

    def usage(self) -> Dict[str, object]:
        """Budget accounting snapshot: total / surplus (pages and
        bytes) plus per-engine floor, live pages, borrowed-beyond-floor
        counts and byte footprints."""
        return {
            "total_pages": self.total,
            "surplus_pages": self.surplus,
            "total_bytes": self.total_bytes,
            "surplus_bytes": self.surplus_bytes,
            "engines": {
                str(k): {"floor": self._floors[k],
                         "in_use": self._managers[k].in_use,
                         "borrowed": self.borrowed(k),
                         "page_bytes": self._managers[k].page_bytes,
                         "bytes_in_use": self._managers[k].bytes_in_use,
                         "borrowed_bytes": self.borrowed_bytes(k)}
                for k in sorted(self._managers, key=str)},
        }


@dataclasses.dataclass
class FleetModel:
    """One model's entry in a :class:`ModelFleet`.

    name: routing key (the registry arch id by convention).
    cfg: the model's (usually reduced) ModelConfig.
    params: the model's parameter tree — moved to the fleet's device and
        cast for compute once by :class:`ModelFleet`, and that one tree
        shared read-only across the model's replicas (pass it already
        cast to keep no second copy alive); None for a model-free
        ``policy_cls``.
    replicas: engine count for this model (>= 1); each replica gets its
        own KV page pool and prefix index.
    floor: guaranteed live pages per replica under the shared
        :class:`HostBudget`; None = enough pages for one max-length
        request (the minimum that keeps preempt-and-recompute
        convergent).
    kv_dtype: KV pool storage precision per replica — None (compute
        dtype everywhere), one dtype name for all replicas, or a
        per-replica sequence (e.g. ``["f32", "fp8"]``: one
        full-precision replica for precision-floored classes, one
        quantized replica holding ~4× the tokens per byte)."""
    name: str
    cfg: object
    params: object
    replicas: int = 1
    floor: Optional[int] = None
    kv_dtype: object = None         # None | str | Sequence[Optional[str]]

    def replica_dtypes(self) -> List[Optional[str]]:
        """Per-replica kv_dtype list, length ``replicas``.

        Raises:
          ValueError: a per-replica sequence of the wrong length."""
        if self.kv_dtype is None or isinstance(self.kv_dtype, str):
            return [self.kv_dtype] * self.replicas
        dts = list(self.kv_dtype)
        if len(dts) != self.replicas:
            raise ValueError(
                f"model {self.name!r}: kv_dtype sequence has {len(dts)} "
                f"entries for {self.replicas} replicas")
        return dts


@dataclasses.dataclass
class ReplicaGroup:
    """A model's replicas inside the fleet (internal)."""
    name: str
    cfg: object
    engines: List[PagedServingEngine]
    floor: int


class LeastLoaded:
    """Default replica selection: fewest (active + queued) requests
    first, then fewest live pages, then lowest replica index — new work
    lands on the replica with the most immediate headroom."""

    name = "least-loaded"

    def select(self, group: ReplicaGroup) -> int:
        """Index of the least-loaded replica in ``group``."""
        return min(
            range(len(group.engines)),
            key=lambda i: (len(group.engines[i].seats)
                           + len(group.engines[i].queue),
                           group.engines[i].policy.pages_in_use(), i))


class RoundRobin:
    """Alternative replica selection: strict rotation per model,
    ignoring load — useful as a predictable baseline and for tests."""

    name = "round-robin"

    def __init__(self):
        self._next: Dict[str, int] = {}

    def select(self, group: ReplicaGroup) -> int:
        """Next replica index in rotation for ``group``."""
        i = self._next.get(group.name, 0) % len(group.engines)
        self._next[group.name] = i + 1
        return i


class SLOAware:
    """Fleet-aware SLO placement: premium backlog depth leads the
    selection key, so new work steers away from replicas where
    premium requests are already waiting — total load and page
    pressure only break ties.

    :class:`LeastLoaded` counts *requests* and treats a replica with
    five queued batch jobs as busier than one with four queued premium
    jobs, even though the premium queue is where TTFT/TBT deadlines go
    to die.  This policy orders replicas by (queued premium-class
    requests, active + queued total, live pages, index): a standard or
    batch request avoids deepening a premium hot spot, and a premium
    request lands where it will see the shortest premium line.  With no
    premium traffic anywhere the first key is uniformly 0 and the
    policy degenerates to exactly :class:`LeastLoaded`."""

    name = "slo-aware"

    @staticmethod
    def premium_depth(eng: PagedServingEngine) -> int:
        """Queued top-class (premium) requests on ``eng``."""
        return sum(1 for r in eng.queue if priority_level(r) == 0)

    def select(self, group: ReplicaGroup) -> int:
        """Index of the replica with the shallowest premium backlog."""
        return min(
            range(len(group.engines)),
            key=lambda i: (self.premium_depth(group.engines[i]),
                           len(group.engines[i].seats)
                           + len(group.engines[i].queue),
                           group.engines[i].policy.pages_in_use(), i))


def _make_selection(selection):
    """Resolve a selection spec — ``"least-loaded"``, ``"round-robin"``,
    ``"slo-aware"`` or an object with ``select(group) -> int`` — into a
    policy."""
    if isinstance(selection, str):
        if selection == "least-loaded":
            return LeastLoaded()
        if selection == "round-robin":
            return RoundRobin()
        if selection == "slo-aware":
            return SLOAware()
        raise ValueError(f"unknown replica selection {selection!r}; "
                         "expected 'least-loaded', 'round-robin' or "
                         "'slo-aware'")
    if not hasattr(selection, "select"):
        raise TypeError(f"selection policy {selection!r} has no select()")
    return selection


class ModelFleet:
    """N paged serving engines — several models, optional replicas —
    behind one submit() API, one shared host page budget, and one outer
    tick loop (see module docstring).

    Every replica's physical pool is sized ``floor + surplus`` usable
    pages so it can absorb the whole surplus when its siblings are
    idle; the :class:`HostBudget` keeps the *live* total across the
    fleet within ``total_pages``.  Engine knobs (``page_size``,
    ``max_seats``, ``max_seq_len``, ``prefill_chunk``, sampling,
    admission) apply fleet-wide.
    """

    default_max_ticks = 100_000

    def __init__(self, models: Sequence[FleetModel], *,
                 total_pages: int, page_size: int = 16,
                 max_seats: int = 8, max_seq_len: int = 256,
                 prefill_chunk: int = 32, selection="least-loaded",
                 sampler: Optional[Sampler] = None,
                 prefix_cache: bool = True, lazy_pages: bool = True,
                 watermark: float = 0.05, admission="fcfs",
                 aging_ticks: int = 64,
                 class_precision: Optional[Dict[str, str]] = None,
                 clock=None, record_trace: bool = True,
                 telemetry=None, policy_cls: Optional[type] = None,
                 device=None):
        """Build one engine per (model, replica) and carve the budget.

        Args:
          models: :class:`FleetModel` entries; names must be unique and
              every cfg must support the paged KV layout.
          total_pages: the host's total live-page budget, shared across
              every engine in the fleet.  When replicas differ in KV
              precision the budget is denominated in bytes — a
              ``total_pages`` figure of the fleet's most expensive page
              kind — and cheaper (quantized) pages draw
              proportionally less from it (see :class:`HostBudget`).
          selection: replica selection policy — ``"least-loaded"``
              (default), ``"round-robin"``, ``"slo-aware"``, or an
              object with ``select(group) -> int``.
          class_precision: SLO-class → minimum KV precision map applied
              fleet-wide (e.g. ``{"premium": "f32"}``); routing only
              considers replicas whose pool meets the class's floor,
              and every engine enforces the same floor at submit.
          clock: zero-arg time source shared by every engine (None =
              wall time); the load harness injects a virtual clock.
          record_trace: keep per-engine event traces (default); the
              load harness disables them to bound memory at 10⁵⁻⁶
              requests.
          telemetry: one shared
              :class:`~repro_torch.runtime.telemetry.Telemetry` for the whole
              fleet — every engine emits into its flight recorder with
              its ``"model/replica"`` engine id, the router's outer
              loop adds stride-gated ``fleet_tick`` heartbeat events
              (queue depth / active seats / pages per engine), and a
              fleet stall dumps a postmortem covering every engine
              plus the :class:`HostBudget` grants.  None = off.
          policy_cls: placement-policy class per engine (None =
              :class:`~repro_torch.runtime.serving.PagedPolicy`); a
              model-free subclass (the load harness's oracle) takes
              ``params=None``.
          device: the one device of every engine (default ``"cuda"``,
              which raises when CUDA is absent; ``"cpu"`` runs the plain
              versions on the CPU).  Each model's weights move there and
              are cast for compute once, shared by its replicas.
          (remaining args: per-engine knobs, as on
              :class:`PagedServingEngine`.)

        Raises:
          ValueError: no models, duplicate names, replicas < 1, a floor
              too small to hold one max-length request, floors that
              exceed ``total_pages``, or a ``class_precision`` floor no
              replica of some model can meet (the class would be
              unroutable there).
        """
        if not models:
            raise ValueError("a fleet needs at least one model")
        names = [m.name for m in models]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate model names in fleet: {names}")
        n_tables = max(1, -(-max_seq_len // page_size))
        floors: List[Tuple[FleetModel, int]] = []
        for fm in models:
            if fm.replicas < 1:
                raise ValueError(
                    f"model {fm.name!r}: replicas must be >= 1, "
                    f"got {fm.replicas}")
            floor = n_tables if fm.floor is None else fm.floor
            if floor < n_tables:
                raise ValueError(
                    f"model {fm.name!r}: floor {floor} pages cannot hold "
                    f"one max-length request ({n_tables} pages at "
                    f"max_seq_len={max_seq_len}, page_size={page_size}); "
                    "preempt-and-recompute could never converge")
            floors.append((fm, floor))
        total_floor = sum(f * fm.replicas for fm, f in floors)
        if total_floor > total_pages:
            raise ValueError(
                f"per-model floors need {total_floor} pages > "
                f"total_pages={total_pages}; raise the budget or lower "
                "replicas/floors")

        # byte-denominate the budget against the fleet's most expensive
        # page: a uniform-precision fleet collapses to page counting,
        # while quantized replicas' cheaper pages draw proportionally
        # less, so the same surplus grants them ~4x the pages
        page_costs = {
            (fm.name, i): M.paged_page_bytes(fm.cfg, page_size, dt)
            for fm, _ in floors
            for i, dt in enumerate(fm.replica_dtypes())}
        ref_bytes = max(page_costs.values())
        dev = resolve_device(device)
        self.device = dev
        self.budget = HostBudget(total_pages, page_bytes=ref_bytes)
        self.page_size = page_size
        self.max_seq_len = max_seq_len
        self.selection = _make_selection(selection)
        self.class_precision = dict(class_precision or {})
        self._groups: Dict[str, ReplicaGroup] = {}
        self._sessions: Dict[Tuple[str, str], int] = {}
        self._routes: Dict[int, Tuple[str, int]] = {}   # rid -> (model, idx)
        self._next_rid = 0
        self._tick = 0
        self.telemetry = telemetry
        surplus_bytes = (total_pages - total_floor) * ref_bytes
        for fm, floor in floors:
            # one tree on the device per model, cast once; the engines'
            # own move and cast are then no-ops on it, so the replicas
            # share its storage
            params = (None if fm.params is None else cast_for_compute(
                _to_device(fm.params, dev), M.compute_dtype(fm.cfg)))
            engines = []
            for i, dt in enumerate(fm.replica_dtypes()):
                # physical pool big enough to absorb the whole surplus
                # at THIS replica's page cost (cheap pages -> more of
                # them); the budget caps the live total in bytes
                surplus_i = surplus_bytes // page_costs[(fm.name, i)]
                eng = PagedServingEngine(
                    fm.cfg, params, page_size=page_size,
                    num_pages=floor + surplus_i + 1,   # +1: scratch page
                    max_seats=max_seats, max_seq_len=max_seq_len,
                    prefill_chunk=prefill_chunk, sampler=sampler,
                    prefix_cache=prefix_cache,
                    lazy_pages=lazy_pages, watermark=watermark,
                    admission=admission, aging_ticks=aging_ticks,
                    kv_dtype=dt, class_precision=self.class_precision,
                    clock=clock, record_trace=record_trace,
                    telemetry=telemetry, policy_cls=policy_cls,
                    device=dev)
                eng.engine_id = f"{fm.name}/{i}"
                self.budget.register((fm.name, i), eng.bm, floor)
                engines.append(eng)
            group = ReplicaGroup(fm.name, fm.cfg, engines, floor)
            for cls, want in self.class_precision.items():
                if not any(self._replica_meets(eng, want)
                           for eng in engines):
                    raise ValueError(
                        f"class_precision requires {want} for class "
                        f"{cls!r} but no replica of model {fm.name!r} "
                        f"stores KV at >= {want}; add a full-precision "
                        "replica or drop the floor")
            self._groups[fm.name] = group

    @staticmethod
    def _replica_meets(eng: PagedServingEngine, want: Optional[str]) -> bool:
        """Whether ``eng``'s pool meets the precision floor ``want``."""
        if want is None:
            return True
        return (mixed_precision.kv_precision_bits(eng.kv_dtype)
                >= mixed_precision.kv_precision_bits(want))

    # -- routing ---------------------------------------------------------------

    @property
    def models(self) -> List[str]:
        """Routing keys, registration order."""
        return list(self._groups)

    def group(self, model: str) -> ReplicaGroup:
        """The replica group serving ``model``.

        Raises:
          ValueError: unknown model name."""
        try:
            return self._groups[model]
        except KeyError:
            raise ValueError(f"unknown model {model!r}; fleet serves "
                             f"{sorted(self._groups)}") from None

    def home_replica(self, model: str, session_id: str) -> Optional[int]:
        """The replica index ``session_id`` is pinned to, or None when
        the session has not been seen on ``model``."""
        self.group(model)
        return self._sessions.get((model, session_id))

    def submit(self, *, model: str, prompt, max_new_tokens: int = 16,
               eos_id: Optional[int] = None,
               sampling: Optional[SamplingParams] = None,
               priority: str = DEFAULT_PRIORITY,
               deadline_ms: Optional[float] = None,
               tbt_deadline_ms: Optional[float] = None,
               session_id: Optional[str] = None) -> int:
        """Route one request to a replica of ``model``; returns its
        fleet-global rid.

        A ``session_id``'s first turn picks a replica via the selection
        policy and pins the session to it; follow-up turns go to that
        home replica, where the session's earlier prompt pages are
        still registered in the prefix index (the multi-turn cache is
        replica-local).  When ``class_precision`` floors the request's
        class, only replicas whose pool meets the floor are considered
        — a pinned home replica that falls short is bypassed for this
        request (the pin is kept for the session's other classes).
        The rid comes from the fleet-global counter — see the module
        docstring for why that makes routing token-transparent.

        Raises:
          ValueError: unknown model, or any :meth:`Scheduler.submit`
              validation failure (priority, deadline, placement)."""
        group = self.group(model)
        want = self.class_precision.get(priority)
        eligible = [i for i, eng in enumerate(group.engines)
                    if self._replica_meets(eng, want)]
        if not eligible:        # unreachable: constructor validated floors
            raise ValueError(
                f"no replica of {model!r} stores KV at >= {want} as "
                f"class {priority!r} requires")
        idx = None
        if session_id is not None:
            idx = self._sessions.get((model, session_id))
            if idx is not None and idx not in eligible:
                idx = None                  # precision floor beats affinity
        if idx is None:
            if len(eligible) == 1:
                idx = eligible[0]
            elif len(eligible) == len(group.engines):
                idx = self.selection.select(group)
            else:
                sub = ReplicaGroup(group.name, group.cfg,
                                   [group.engines[i] for i in eligible],
                                   group.floor)
                idx = eligible[self.selection.select(sub)]
            if not 0 <= idx < len(group.engines):
                raise ValueError(
                    f"selection policy returned replica {idx} for "
                    f"{model!r} with {len(group.engines)} replicas")
        rid = self._next_rid
        group.engines[idx].submit(
            prompt, max_new_tokens=max_new_tokens, eos_id=eos_id,
            sampling=sampling, priority=priority, deadline_ms=deadline_ms,
            tbt_deadline_ms=tbt_deadline_ms, rid=rid)
        # commit routing state only after the engine accepted the
        # request: a validation failure must not pin the session to a
        # replica that holds none of its pages
        if session_id is not None:
            self._sessions[(model, session_id)] = idx
        self._next_rid = rid + 1
        self._routes[rid] = (model, idx)
        return rid

    def route(self, rid: int) -> Tuple[str, int]:
        """(model, replica index) a submitted rid was routed to."""
        return self._routes[rid]

    # -- the outer tick loop ---------------------------------------------------

    def _engines(self) -> List[Tuple[str, int, PagedServingEngine]]:
        return [(name, i, eng)
                for name, group in self._groups.items()
                for i, eng in enumerate(group.engines)]

    def pending(self) -> bool:
        """Any request still queued or on a seat anywhere in the fleet."""
        return any(eng.queue or eng.seats for _, _, eng in self._engines())

    def step(self) -> None:
        """One fleet tick: every engine with work gets one
        ``Scheduler.step()`` (admission, one prefill chunk, one decode
        round), in model-registration then replica order, on one
        stream.  Idle engines are skipped — their graphs are not
        replayed and their metrics windows are not diluted."""
        self._tick += 1
        for _, _, eng in self._engines():
            if eng.queue or eng.seats:
                eng.step()
        tel = self.telemetry
        if tel is not None and self._tick % tel.heartbeat_every == 0:
            # stride-gated heartbeat: one fleet_tick event per engine
            # feeds the Perfetto counter tracks (queue depth, seats,
            # pages) without growing the ring once per engine tick
            for name, i, eng in self._engines():
                tel.emit(self._tick, eng.clock(), f"{name}/{i}", -1,
                         "fleet_tick",
                         {"queued": len(eng.queue),
                          "active": len(eng.seats),
                          "pages_in_use": eng.policy.pages_in_use()})

    def run(self, max_ticks: Optional[int] = None) -> Dict[int, Request]:
        """Tick the fleet until every submitted request finishes.

        Returns:
          rid -> finished :class:`Request` for every request the fleet
          has completed (including earlier ``run`` calls).

        Raises:
          SchedulerStallError: ``max_ticks`` fleet ticks elapsed with
              work still pending; the message names each stalled
              request as ``model/replica:rid(priority)``."""
        if max_ticks is None:
            max_ticks = self.default_max_ticks
        t = 0
        while self.pending() and t < max_ticks:
            self.step()
            t += 1
        if self.pending():
            stalled = []
            for name, i, eng in self._engines():
                for r in sorted(list(eng.queue) + list(eng.seats.values()),
                                key=lambda r: r.rid):
                    stalled.append(f"{name}/{i}:{r.rid}({r.priority})")
            msg = (f"fleet run() exhausted max_ticks={max_ticks} with "
                   f"{len(stalled)} requests pending: " + ", ".join(stalled))
            if self.telemetry is not None:
                # full-fleet postmortem: ring events + every engine's
                # queue/seats/BlockManager partition + budget grants
                self.telemetry.write_postmortem(
                    "SchedulerStallError: " + msg,
                    engines={f"{name}/{i}": eng
                             for name, i, eng in self._engines()},
                    budget=self.budget.usage())
            raise SchedulerStallError(msg)
        return self.finished()

    def finished(self) -> Dict[int, Request]:
        """rid -> finished :class:`Request` across the whole fleet."""
        out: Dict[int, Request] = {}
        for _, _, eng in self._engines():
            for r in eng.finished:
                out[r.rid] = r
        return out

    # -- observability ---------------------------------------------------------

    def metrics_snapshot(self) -> Dict[str, object]:
        """Fleet observability: per-model and fleet-total
        ``EngineMetrics`` snapshots (tokens/s, TTFT percentiles,
        prefix-hit rate, preemptions, per-SLO-class breakdowns) plus
        per-replica snapshots and the :class:`HostBudget` accounting.
        Merged figures follow ``EngineMetrics.merged`` semantics (peaks
        are sums of per-replica peaks)."""
        per_model: Dict[str, object] = {}
        for name, group in self._groups.items():
            merged = EngineMetrics.merged([e.metrics for e in group.engines])
            snap = merged.snapshot()
            snap["replicas"] = [e.metrics.snapshot() for e in group.engines]
            per_model[name] = snap
        fleet = EngineMetrics.merged(
            [eng.metrics for _, _, eng in self._engines()]).snapshot()
        return {"models": per_model, "fleet": fleet,
                "budget": self.budget.usage(), "ticks": self._tick}


def parse_models_spec(spec: str) -> List[Tuple[str, int, Optional[str]]]:
    """Parse a ``--models`` fleet spec: comma-separated
    ``name[:replicas[:kv_dtype]]`` entries, e.g.
    ``llama3-8b:2:fp8,qwen3-1.7b`` (the registry's module-style aliases
    like ``llama3_8b`` work too — resolution happens in the caller via
    ``configs.resolve_arch``).  The optional third field picks the
    model's paged-KV storage precision (one of
    :data:`repro_torch.core.mixed_precision.KV_DTYPES`); omitted means the
    engine default (full compute precision).

    Returns:
      [(name, replicas, kv_dtype_or_None), ...] in spec order (names
      unresolved).

    Raises:
      ValueError: empty spec/entry, a non-integer or < 1 replica
          count, an unknown kv dtype, or a duplicated name."""
    entries: List[Tuple[str, int, Optional[str]]] = []
    if not spec.strip():
        raise ValueError("empty --models spec")
    for part in spec.split(","):
        part = part.strip()
        if not part:
            raise ValueError(f"empty entry in --models spec {spec!r}")
        fields = [f.strip() for f in part.split(":")]
        if len(fields) > 3:
            raise ValueError(
                f"too many ':' fields in --models entry {part!r}; "
                "expected name[:replicas[:kv_dtype]]")
        name = fields[0]
        if not name:
            raise ValueError(f"missing model name in entry {part!r}")
        count = fields[1] if len(fields) > 1 else ""
        if count:
            try:
                replicas = int(count)
            except ValueError:
                raise ValueError(
                    f"bad replica count {count!r} in --models entry "
                    f"{part!r}; expected name[:replicas[:kv_dtype]]"
                ) from None
        else:
            replicas = 1
        if replicas < 1:
            raise ValueError(
                f"replica count must be >= 1 in --models entry {part!r}")
        kv_dtype: Optional[str] = None
        if len(fields) > 2 and fields[2]:
            kv_dtype = fields[2]
            if kv_dtype not in mixed_precision.KV_DTYPES:
                raise ValueError(
                    f"unknown kv dtype {kv_dtype!r} in --models entry "
                    f"{part!r}; expected one of "
                    f"{', '.join(mixed_precision.KV_DTYPES)}")
        if name in [n for n, _, _ in entries]:
            raise ValueError(f"model {name!r} appears twice in --models "
                             f"spec {spec!r}")
        entries.append((name, replicas, kv_dtype))
    return entries
