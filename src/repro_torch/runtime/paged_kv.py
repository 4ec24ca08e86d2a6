"""Paged KV-cache bookkeeping: refcounted block manager + serving metrics.

The KV cache is a shared pool of fixed-size pages (``page_size`` tokens
each).  A request's cache is whatever pages its page table names — pages
are handed out by the :class:`BlockManager` and released when the request
completes, so short requests stop paying for the longest request's
``max_len``.  Physical page 0 is *reserved scratch*: idle seats and
chunk-padding tokens write there, live requests never own it.

Pages are refcounted so shared prompt prefixes are free: the serving
engine registers every page that fills with prompt tokens in an
exact-token *prefix index*; a later request whose prompt starts with the
same page-aligned token run points its leading page-table entries at
those physical pages (``acquire`` → refcount++) instead of re-prefilling
them, and copy-on-writes only the last partially matching page.

Page lifecycle::

    free ──alloc / try_grow (ref=1)──► live ──acquire──► shared (ref+=1)
      ▲                      │ release/preempt (ref-=1) ... ref==0:
      │                      ├─ registered in prefix index ─► reclaimable
      └──────────────────────┴─ unregistered ────────────────┘   (LRU)

    reclaimable ──prefix hit (acquire)──► live again, content intact
    reclaimable ──alloc under pressure──► evicted + unregistered

Lazy serving (``PagedPolicy`` with ``lazy_pages=True``, the default)
allocates only the prompt's pages at admission and calls
:meth:`BlockManager.try_grow` for one page whenever a request's decode
crosses a page boundary; a low-watermark admission gate (default: 5% of
capacity, at least one page) keeps enough headroom that live requests
usually grow without conflict.  When growth still fails, the scheduler
*preempts* the youngest decoding request: ``free`` drops its refcounts
(shared prefix pages stay live for their other holders; its registered
full prompt pages park reclaimable, content intact), and on re-admission
the request recomputes by re-prefilling ``prompt + generated[:-1]``
(the last generated token re-enters through the normal decode feed) —
the prompt part usually a prefix hit against those reclaimable pages, so
recompute costs roughly the generated tokens only.

Only *full prefill pages* are ever registered — prompt pages normally,
plus replayed generated-token pages after a preemption (still keyed by
their exact tokens) — and full pages are never written again (all
writes are positional), so a reclaimable page's content is immutable
and a prefix hit can revive it as-is.

Known scale limit: the index keys chains by their full parent-token
tuple (exactness over compactness), so one cached L-token chain holds
O(L^2 / page_size) ints of bookkeeping.  Fine for the prompt lengths
this repo serves today; re-keying children by parent page id (with
subtree invalidation on eviction) is the planned fix for multi-k-token
system prompts — see ROADMAP "Serving".

The page lifecycle, prefix-cache CoW and the scheduler that drives all
of this are documented end-to-end in docs/serving.md.
"""
from __future__ import annotations

import dataclasses
import math
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

from repro_torch.runtime.telemetry import Histogram


TokenTuple = Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class PrefixMatch:
    """Result of :meth:`BlockManager.match_prefix`.

    pages: physical pages holding the matched *full* page-aligned prefix
        (not yet acquired — the caller takes the refs).
    cow_src: physical page whose leading ``n_cached - len(pages)*page``
        tokens extend the match; the caller copies it (copy-on-write)
        rather than sharing, because it will write its own tokens into
        the remainder of that page.  None when no partial match.
    n_cached: total prompt tokens covered (always < len(prompt): the
        final prompt token is recomputed so admission has logits to
        sample the first output token from).
    """
    pages: List[int]
    cow_src: Optional[int]
    n_cached: int


class BlockManager:
    """Refcounted allocator over physical KV pages 1..num_pages-1
    (page 0 = scratch) with an exact-token prefix index.

    Invariants (exercised by tests/test_paged_kv.py and
    tests/test_prefix_cache.py):
      - every usable page is in exactly one of {live (ref > 0), free,
        reclaimable}; page 0 is never handed out
      - ``free``/``release`` of a page whose refcount is already 0
        raises (double-free protection)
      - a page's refcount equals the number of live requests whose page
        tables name it
    """

    def __init__(self, num_pages: int, page_size: int, *,
                 prefix_cache: bool = True, page_bytes: int = 1):
        assert num_pages >= 2, "need at least scratch + one usable page"
        self.num_pages = num_pages
        self.page_size = page_size
        self.prefix_cache = prefix_cache
        # bytes one physical page costs (models.model.paged_page_bytes);
        # lets byte-denominated budgets (runtime.router.HostBudget)
        # compare pools of different KV precisions.  1 = unit weight:
        # plain page counting, the single-precision default.
        self.page_bytes = page_bytes
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self._ref: Dict[int, int] = {}           # page -> live refcount
        # debugging aid only: SOME current holder (the allocating/reviving
        # rid — NOT updated by acquire-for-sharing, dropped at refcount 0)
        self._owner: Dict[int, int] = {}
        self._reclaim: "OrderedDict[int, None]" = OrderedDict()  # LRU order
        # prefix index: parent prefix tokens -> {page's tokens -> page}
        self._children: Dict[TokenTuple, Dict[TokenTuple, int]] = {}
        self._page_key: Dict[int, Tuple[TokenTuple, TokenTuple]] = {}
        self.peak_in_use = 0
        self.evictions = 0
        self.grows = 0          # pages handed out by try_grow (lazy decode)
        # bumped on any state change that could alter a future alloc or
        # match — admission caches its failed attempt against this
        self.version = 0
        # optional shared host budget (runtime.router.HostBudget): when
        # set, can_alloc also asks the budget whether THIS manager may
        # take n more live pages, and local state changes invalidate the
        # sibling managers' versions (a starved head in another engine
        # must re-attempt admission when pages free up here)
        self._budget = None
        self._budget_key = None

    # -- accounting -----------------------------------------------------------

    @property
    def capacity(self) -> int:
        """Usable pages (excludes the scratch page)."""
        return self.num_pages - 1

    @property
    def available(self) -> int:
        """Pages an ``alloc`` can hand out: free + reclaimable cached."""
        return len(self._free) + len(self._reclaim)

    @property
    def in_use(self) -> int:
        """Pages referenced by at least one live request."""
        return len(self._ref)

    @property
    def cached(self) -> int:
        """Reclaimable pages kept only for their cached prefix content."""
        return len(self._reclaim)

    @property
    def bytes_in_use(self) -> int:
        """Live-page footprint in bytes (``in_use * page_bytes``)."""
        return self.in_use * self.page_bytes

    @property
    def capacity_tokens(self) -> int:
        """Effective token capacity of the usable pool — the figure a
        quantized pool roughly multiplies at equal byte budget."""
        return self.capacity * self.page_size

    def refcount(self, page: int) -> int:
        return self._ref.get(page, 0)

    def pages_needed(self, tokens: int) -> int:
        return max(1, math.ceil(tokens / self.page_size))

    def can_alloc(self, n: int) -> bool:
        """Whether ``alloc(n)`` would succeed: enough local pages AND —
        when this manager is registered with a shared
        :class:`~repro.runtime.router.HostBudget` — the host budget
        grants this engine ``n`` more live pages (its floor plus
        whatever surplus its siblings have not borrowed)."""
        if n > self.available:
            return False
        return self._budget is None or self._budget.allows(self._budget_key, n)

    def attach_budget(self, budget, key) -> None:
        """Register this manager under a shared host budget (called by
        ``HostBudget.register``).  Must happen before any allocation —
        the budget gate assumes it has seen every live page.

        Raises:
          ValueError: a budget is already attached, or pages are
              already live (either would corrupt the budget's floor /
              borrowed accounting)."""
        if self._budget is not None:
            raise ValueError(
                f"BlockManager already answers to a budget as "
                f"{self._budget_key!r}; cannot attach a second one")
        if self._ref:
            raise ValueError(
                f"attach_budget requires a pristine manager; {len(self._ref)} "
                "pages are already live and would escape budget accounting")
        self._budget = budget
        self._budget_key = key

    def _bump(self) -> None:
        """Version bump on any state change that could alter a future
        alloc or prefix match; with a shared budget, sibling managers
        are invalidated too (pages freed here may unblock admission
        there)."""
        self.version += 1
        if self._budget is not None:
            self._budget.invalidate(self)

    def owner(self, page: int) -> Optional[int]:
        """One current holder of ``page`` (debugging aid): the rid that
        alloc'd or revived it.  Shared pages have more holders than this
        reports — use :meth:`refcount` for sharing questions."""
        return self._owner.get(page)

    def utilization(self) -> float:
        return self.in_use / max(self.capacity, 1)

    # -- alloc / share / release ----------------------------------------------

    def alloc(self, n: int, rid: int) -> Optional[List[int]]:
        """Take ``n`` fresh pages for request ``rid``.

        Args:
          n: pages wanted (0 returns an empty list).
          rid: requesting id, recorded as the debugging ``owner``.

        Returns:
          ``n`` page ids, each at refcount 1 — LRU reclaimable cached
          pages are evicted (and unregistered) under pressure — or
          None when fewer than ``n`` are available: callers queue
          instead of crashing, and no state changes on None."""
        if not self.can_alloc(n):
            return None
        pages = []
        for _ in range(n):
            if self._free:
                pg = self._free.pop()
            else:
                pg, _ = self._reclaim.popitem(last=False)   # LRU victim
                self._unregister(pg)
                self.evictions += 1
            pages.append(pg)
        for pg in pages:
            self._ref[pg] = 1
            self._owner[pg] = rid
        self.peak_in_use = max(self.peak_in_use, self.in_use)
        self._bump()
        return pages

    def try_grow(self, rid: int) -> Optional[int]:
        """One more page (refcount 1) for a live request whose decode is
        about to cross a page boundary (lazy on-demand growth).

        Returns:
          The page id (the ``grows`` counter increments), or None under
          pressure — the caller preempts instead of crashing."""
        pages = self.alloc(1, rid)
        if pages is None:
            return None
        self.grows += 1
        return pages[0]

    def acquire(self, page: int, rid: Optional[int] = None) -> None:
        """Add a reference to a live or reclaimable page (prefix hit).

        Args:
          page: page id to share; a reclaimable page revives with its
              content intact.
          rid: recorded as the debugging ``owner`` when reviving.

        Raises:
          ValueError: ``page`` is neither live nor reclaimable."""
        if page in self._ref:
            self._ref[page] += 1
        elif page in self._reclaim:
            del self._reclaim[page]
            self._ref[page] = 1
            if rid is not None:
                self._owner[page] = rid
        else:
            raise ValueError(f"acquire of unallocated page {page}")
        self.peak_in_use = max(self.peak_in_use, self.in_use)
        self._bump()

    def free(self, pages: List[int]) -> None:
        """Drop one reference per page.  At refcount 0 a page returns to
        the free list — or to the reclaimable LRU list if it is registered
        in the prefix index (its content stays revivable).

        Raises:
          ValueError: a page's refcount is already 0 (double free /
              foreign page)."""
        for pg in pages:
            if self._ref.get(pg, 0) <= 0:
                raise ValueError(f"double free / foreign page {pg}")
            self._ref[pg] -= 1
            if self._ref[pg] == 0:
                del self._ref[pg]
                self._owner.pop(pg, None)
                if pg in self._page_key:
                    self._reclaim[pg] = None      # most-recently released
                else:
                    self._free.append(pg)
        self._bump()

    release = free      # refcount-decrement reading of the same operation

    # -- prefix index ---------------------------------------------------------

    def register_prefix(self, prefix_tokens, page: int) -> None:
        """Record that ``page`` holds the K/V of the last ``page_size``
        tokens of ``prefix_tokens`` (whose length must be page-aligned).
        No-op if that chain position is already registered, or if the
        page already serves another chain, or caching is off."""
        if not self.prefix_cache:
            return
        toks = tuple(int(t) for t in prefix_tokens)
        assert toks and len(toks) % self.page_size == 0, len(toks)
        parent, tail = toks[:-self.page_size], toks[-self.page_size:]
        kids = self._children.setdefault(parent, {})
        if tail in kids or page in self._page_key:
            return
        kids[tail] = page
        self._page_key[page] = (parent, tail)
        self._bump()

    def match_prefix(self, prompt) -> PrefixMatch:
        """Longest cached page-aligned prefix of ``prompt`` (plus an
        optional partial-page copy-on-write source), capped at
        ``len(prompt) - 1`` so at least the final prompt token is always
        recomputed."""
        if not self.prefix_cache:
            return PrefixMatch([], None, 0)
        toks = tuple(int(t) for t in prompt)
        limit = len(toks) - 1
        pages: List[int] = []
        key: TokenTuple = ()
        i = 0
        while (i + 1) * self.page_size <= limit:
            tail = toks[i * self.page_size:(i + 1) * self.page_size]
            pg = self._children.get(key, {}).get(tail)
            if pg is None:
                break
            pages.append(pg)
            key = key + tail
            i += 1
        n_cached = i * self.page_size
        want = toks[n_cached:limit][:self.page_size]
        cow, cow_len = None, 0
        for tail, pg in self._children.get(key, {}).items():
            r = 0
            for a, b in zip(tail, want):
                if a != b:
                    break
                r += 1
            if r > cow_len:
                cow, cow_len = pg, r
        return PrefixMatch(pages, cow, n_cached + cow_len)

    def _unregister(self, page: int) -> None:
        parent, tail = self._page_key.pop(page)
        kids = self._children[parent]
        del kids[tail]
        if not kids:
            del self._children[parent]


def _quantile(xs: List[float], q: float) -> float:
    """Nearest-rank quantile of ``xs`` (0.0 when empty) — enough for
    the per-class TTFT/TBT p50/p95 the serving metrics report without
    pulling numpy into this module.

    Contract (tests/test_load_harness.py pins it): the result is the
    element at 1-based rank ``ceil(q * n)`` of the sorted sample —
    order-insensitive, always an element of ``xs``, ``s[0]`` for
    ``q <= 1/n`` and ``s[-1]`` for ``q = 1`` — i.e. the classic
    nearest-rank percentile ``statistics`` texts define.  The rank is
    computed on a rounded product because binary float can overshoot
    an exact integer (``0.95 * 20 == 19.000000000000004``; a raw
    ``ceil`` would skip rank 19 and report the sample maximum as
    p95)."""
    if not xs:
        return 0.0
    s = sorted(xs)
    n = len(s)
    rank = max(1, min(n, math.ceil(round(q * n, 9))))
    return s[rank - 1]


@dataclasses.dataclass
class EngineMetrics:
    """Counters the serving engine updates in place; ``snapshot`` derives
    the headline serving numbers (TTFT, tokens/s, page utilization,
    prefix-hit rate) plus a per-priority-class breakdown (TTFT
    percentiles, preemption counts, deadline-miss rate, peak pages) —
    the observable side of the SLO classes described in
    docs/serving.md."""
    page_capacity: int = 0
    # KV storage precision of the pool behind these counters ("f32" /
    # "bf16" / "fp8" / "int8"; "mixed" after merging differing engines)
    # and bytes per physical page — the byte-denominated view of the
    # pool that makes cross-precision comparisons honest
    kv_dtype: Optional[str] = None
    page_bytes: int = 1
    submitted: int = 0
    admitted: int = 0
    completed: int = 0
    ticks: int = 0
    prefill_tokens: int = 0
    cached_prompt_tokens: int = 0  # prompt tokens served from the prefix cache
    first_tokens: int = 0        # one per completed prefill (the TTFT token)
    decode_tokens: int = 0
    preemptions: int = 0         # decoding requests evicted under pressure
    pages_in_use: int = 0
    bytes_in_use: int = 0        # pages_in_use * page_bytes, kept in tick()
    peak_pages_in_use: int = 0
    cached_pages: int = 0        # reclaimable prefix-cache pages (ref 0)
    evictions: int = 0           # cached pages reclaimed under pressure
    queued: int = 0
    active: int = 0
    peak_active: int = 0         # admitted concurrency high-water mark
    ttft_s: List[float] = dataclasses.field(default_factory=list)
    # per-priority-class accounting (keys are class names; only classes
    # actually seen appear — a uniform-priority run reports one class)
    ttft_s_by_class: Dict[str, List[float]] = \
        dataclasses.field(default_factory=dict)
    completed_by_class: Dict[str, int] = \
        dataclasses.field(default_factory=dict)
    preemptions_by_class: Dict[str, int] = \
        dataclasses.field(default_factory=dict)
    deadline_requests_by_class: Dict[str, int] = \
        dataclasses.field(default_factory=dict)
    deadline_misses_by_class: Dict[str, int] = \
        dataclasses.field(default_factory=dict)
    peak_pages_by_class: Dict[str, int] = \
        dataclasses.field(default_factory=dict)
    # per-token decode latency (TBT = gap between consecutive token
    # emissions, preemption replay gaps included); samples per class
    # plus miss accounting for requests carrying a TBT deadline
    tbt_s_by_class: Dict[str, List[float]] = \
        dataclasses.field(default_factory=dict)
    tbt_deadline_tokens_by_class: Dict[str, int] = \
        dataclasses.field(default_factory=dict)
    tbt_misses_by_class: Dict[str, int] = \
        dataclasses.field(default_factory=dict)
    # log-bucketed mergeable latency histograms (telemetry.Histogram),
    # maintained next to the raw sample lists: replica histograms merge
    # by pure bucket addition into fleet aggregates, and they are what
    # the Prometheus exposition publishes as repro_{ttft,tbt}_seconds
    ttft_hist_by_class: Dict[str, Histogram] = \
        dataclasses.field(default_factory=dict)
    tbt_hist_by_class: Dict[str, Histogram] = \
        dataclasses.field(default_factory=dict)
    _t_start: Optional[float] = None
    _t_last: Optional[float] = None

    def begin(self, now: Optional[float] = None) -> None:
        """Call at the START of the first tick so the throughput window
        includes the first tick's work (jit compile, first prefill).
        ``now`` lets an engine on a virtual clock stamp the window
        deterministically (None = wall time).

        Clock contract: the Scheduler always passes ``now=self.clock()``
        here and in :meth:`tick`, so under an injected clock the
        ``perf_counter`` fallback is never reached — it exists only for
        callers driving EngineMetrics standalone."""
        if self._t_start is None:
            self._t_start = time.perf_counter() if now is None else now

    def note_first_token(self, priority: str, ttft: float, *,
                         deadlined: bool = False,
                         missed: bool = False) -> None:
        """Record one TTFT emission: ``ttft`` seconds for a request of
        class ``priority``; ``deadlined`` marks the request as carrying
        a TTFT deadline and ``missed`` that the deadline was blown
        (per-class miss *rate* = misses / deadlined requests)."""
        self.ttft_s.append(ttft)
        self.first_tokens += 1
        self.ttft_s_by_class.setdefault(priority, []).append(ttft)
        h = self.ttft_hist_by_class.get(priority)
        if h is None:
            h = self.ttft_hist_by_class[priority] = Histogram()
        h.observe(ttft)
        if deadlined:
            self.deadline_requests_by_class[priority] = \
                self.deadline_requests_by_class.get(priority, 0) + 1
            if missed:
                self.deadline_misses_by_class[priority] = \
                    self.deadline_misses_by_class.get(priority, 0) + 1

    def note_decode_token(self, priority: str, tbt: float, *,
                          deadlined: bool = False,
                          missed: bool = False) -> None:
        """Record one decode-token emission: ``tbt`` seconds since the
        request's previous emission, for a request of class
        ``priority``; ``deadlined`` marks the token as governed by a
        per-token TBT deadline and ``missed`` that the gap blew it
        (per-class miss *rate* = misses / deadlined tokens).  The
        ``decode_tokens`` counter is maintained by the engine itself —
        this method owns only the latency/deadline tallies."""
        self.tbt_s_by_class.setdefault(priority, []).append(tbt)
        h = self.tbt_hist_by_class.get(priority)
        if h is None:
            h = self.tbt_hist_by_class[priority] = Histogram()
        h.observe(tbt)
        if deadlined:
            self.tbt_deadline_tokens_by_class[priority] = \
                self.tbt_deadline_tokens_by_class.get(priority, 0) + 1
            if missed:
                self.tbt_misses_by_class[priority] = \
                    self.tbt_misses_by_class.get(priority, 0) + 1

    def note_completion(self, priority: str) -> None:
        """Record one finished request of class ``priority``."""
        self.completed += 1
        self.completed_by_class[priority] = \
            self.completed_by_class.get(priority, 0) + 1

    def note_preemption(self, priority: str) -> None:
        """Record one preemption of a request of class ``priority``."""
        self.preemptions += 1
        self.preemptions_by_class[priority] = \
            self.preemptions_by_class.get(priority, 0) + 1

    def tick(self, *, queued: int, active: int, pages_in_use: int,
             cached_pages: int = 0, evictions: int = 0,
             pages_by_class: Optional[Dict[str, int]] = None,
             now: Optional[float] = None) -> None:
        # same clock contract as begin(): engine callers inject
        # now=clock(); the wall-time fallback is for standalone use
        if now is None:
            now = time.perf_counter()
        if self._t_start is None:
            self._t_start = now
        self._t_last = now
        self.ticks += 1
        self.queued = queued
        self.active = active
        self.peak_active = max(self.peak_active, active)
        self.pages_in_use = pages_in_use
        self.bytes_in_use = pages_in_use * self.page_bytes
        self.peak_pages_in_use = max(self.peak_pages_in_use, pages_in_use)
        self.cached_pages = cached_pages
        self.evictions = evictions
        for cls, n in (pages_by_class or {}).items():
            self.peak_pages_by_class[cls] = \
                max(self.peak_pages_by_class.get(cls, 0), n)

    @classmethod
    def merged(cls, parts: List["EngineMetrics"]) -> "EngineMetrics":
        """Aggregate metrics across several engines (a replica group or
        a whole :class:`~repro.runtime.router.ModelFleet`): counters and
        per-class tallies sum, TTFT samples concatenate (so the merged
        ``snapshot()`` reports fleet-level percentiles), and the
        throughput window spans the earliest start to the latest
        activity across the parts.

        ``peak_*`` figures are the SUM of per-engine peaks — an upper
        bound on concurrent fleet-wide usage (per-engine peaks need not
        be simultaneous); ``ticks`` is the max (fleet engines tick in
        lockstep, idle engines skip).  The parts are not mutated."""
        out = cls()
        dtypes = {m.kv_dtype for m in parts if m.kv_dtype is not None}
        if dtypes:
            out.kv_dtype = dtypes.pop() if len(dtypes) == 1 else "mixed"
        for m in parts:
            out.page_capacity += m.page_capacity
            out.submitted += m.submitted
            out.admitted += m.admitted
            out.completed += m.completed
            out.ticks = max(out.ticks, m.ticks)
            out.prefill_tokens += m.prefill_tokens
            out.cached_prompt_tokens += m.cached_prompt_tokens
            out.first_tokens += m.first_tokens
            out.decode_tokens += m.decode_tokens
            out.preemptions += m.preemptions
            out.pages_in_use += m.pages_in_use
            out.bytes_in_use += m.bytes_in_use
            out.peak_pages_in_use += m.peak_pages_in_use
            out.cached_pages += m.cached_pages
            out.evictions += m.evictions
            out.queued += m.queued
            out.active += m.active
            out.peak_active += m.peak_active
            out.ttft_s.extend(m.ttft_s)
            for cls_name, ts in m.ttft_s_by_class.items():
                out.ttft_s_by_class.setdefault(cls_name, []).extend(ts)
            for cls_name, ts in m.tbt_s_by_class.items():
                out.tbt_s_by_class.setdefault(cls_name, []).extend(ts)
            for acc, src in ((out.ttft_hist_by_class, m.ttft_hist_by_class),
                             (out.tbt_hist_by_class, m.tbt_hist_by_class)):
                for cls_name, h in src.items():
                    prev = acc.get(cls_name)
                    acc[cls_name] = h.merge(prev) if prev is not None \
                        else h.merge(Histogram(h.base))
            for acc, src in (
                    (out.completed_by_class, m.completed_by_class),
                    (out.preemptions_by_class, m.preemptions_by_class),
                    (out.deadline_requests_by_class,
                     m.deadline_requests_by_class),
                    (out.deadline_misses_by_class,
                     m.deadline_misses_by_class),
                    (out.tbt_deadline_tokens_by_class,
                     m.tbt_deadline_tokens_by_class),
                    (out.tbt_misses_by_class, m.tbt_misses_by_class),
                    (out.peak_pages_by_class, m.peak_pages_by_class)):
                for k, v in src.items():
                    acc[k] = acc.get(k, 0) + v
            if m._t_start is not None:
                out._t_start = (m._t_start if out._t_start is None
                                else min(out._t_start, m._t_start))
            if m._t_last is not None:
                out._t_last = (m._t_last if out._t_last is None
                               else max(out._t_last, m._t_last))
        return out

    def class_snapshot(self) -> Dict[str, Dict[str, float]]:
        """Per-priority-class summary: completed count, TTFT mean /
        p50 / p95, TBT mean / p50 / p95 with per-token deadline-miss
        accounting, preemptions, TTFT deadline totals and miss rate,
        and the class's peak concurrent page footprint.  Classes appear
        once any request of theirs reaches a counter."""
        classes = (set(self.ttft_s_by_class) | set(self.completed_by_class)
                   | set(self.preemptions_by_class)
                   | set(self.tbt_s_by_class)
                   | set(self.peak_pages_by_class))
        out: Dict[str, Dict[str, float]] = {}
        for cls in sorted(classes):
            ttfts = self.ttft_s_by_class.get(cls, [])
            tbts = self.tbt_s_by_class.get(cls, [])
            dl_n = self.deadline_requests_by_class.get(cls, 0)
            dl_miss = self.deadline_misses_by_class.get(cls, 0)
            tbt_n = self.tbt_deadline_tokens_by_class.get(cls, 0)
            tbt_miss = self.tbt_misses_by_class.get(cls, 0)
            out[cls] = {
                "completed": self.completed_by_class.get(cls, 0),
                "ttft_avg_s": sum(ttfts) / len(ttfts) if ttfts else 0.0,
                "ttft_p50_s": _quantile(ttfts, 0.50),
                "ttft_p95_s": _quantile(ttfts, 0.95),
                "tbt_avg_s": sum(tbts) / len(tbts) if tbts else 0.0,
                "tbt_p50_s": _quantile(tbts, 0.50),
                "tbt_p95_s": _quantile(tbts, 0.95),
                "tbt_deadline_tokens": tbt_n,
                "tbt_misses": tbt_miss,
                "tbt_miss_rate": tbt_miss / max(tbt_n, 1),
                "preemptions": self.preemptions_by_class.get(cls, 0),
                "deadline_requests": dl_n,
                "deadline_misses": dl_miss,
                "deadline_miss_rate": dl_miss / max(dl_n, 1),
                "peak_pages": self.peak_pages_by_class.get(cls, 0),
            }
        return out

    def snapshot(self) -> Dict[str, object]:
        """Headline serving numbers derived from the live counters —
        scalar rates/totals plus the dict-valued ``classes`` per-class
        breakdown.  Safe to call at any point; benchmarks diff two
        snapshots to exclude warmup."""
        wall = ((self._t_last - self._t_start)
                if self._t_start is not None and self._t_last is not None
                else 0.0)
        gen = self.decode_tokens + self.first_tokens
        prompt_toks = self.prefill_tokens + self.cached_prompt_tokens
        return {
            "submitted": self.submitted,
            "admitted": self.admitted,
            "completed": self.completed,
            "queued": self.queued,
            "active": self.active,
            "ticks": self.ticks,
            "prefill_tokens": self.prefill_tokens,
            "cached_prompt_tokens": self.cached_prompt_tokens,
            "prefix_hit_rate": self.cached_prompt_tokens / max(prompt_toks, 1),
            "decode_tokens": self.decode_tokens,
            "generated_tokens": gen,
            "preemptions": self.preemptions,
            "peak_active": self.peak_active,
            "page_capacity": self.page_capacity,
            "kv_dtype": self.kv_dtype,
            "page_bytes": self.page_bytes,
            "kv_bytes_in_use": self.bytes_in_use,
            "pages_in_use": self.pages_in_use,
            "peak_pages_in_use": self.peak_pages_in_use,
            "cached_pages": self.cached_pages,
            "evictions": self.evictions,
            "page_utilization": self.pages_in_use / max(self.page_capacity, 1),
            # live + cached prefix content: how full the pool really is
            "kv_occupancy": (self.pages_in_use + self.cached_pages)
                / max(self.page_capacity, 1),
            "peak_page_utilization":
                self.peak_pages_in_use / max(self.page_capacity, 1),
            "ttft_avg_s": (sum(self.ttft_s) / len(self.ttft_s)
                           if self.ttft_s else 0.0),
            "ttft_max_s": max(self.ttft_s) if self.ttft_s else 0.0,
            "wall_s": wall,
            "tokens_per_s": gen / wall if wall > 0 else 0.0,
            # per-priority-class breakdown (dict-valued — the one
            # non-scalar entry; see class_snapshot)
            "classes": self.class_snapshot(),
        }
