"""The port's telemetry plane against the JAX package's, on the CPU.

Reduced qwen3-1.7b with f32 compute (tokens agree across the packages)
and JAX-initialized weights carried across; both packages' engines read
a virtual clock that the test advances by a fixed step between ticks,
so every timestamp agrees however often each package reads it.  Held
exactly, on the same submissions: the flight recorder's events (times
and attrs included), the Perfetto document, the Prometheus text and the
stall postmortem, with a preemption, with SLO deadlines that fire and
clear a burn alert, and through the fixed-slot ``ServingEngine``.  The
reference's own script ``scripts/trace_view.py`` reads the port's dumps.
Then the reference's pure cases of ``tests/test_telemetry.py`` against
the port's classes (hypothesis derandomized), the zero-intrusion
contract (tokens and flat trace identical with telemetry off, on and
profiling), the metrics server (port 0, a time limit per request) and
the CLI flags.
"""
import argparse
import json
import sys
import urllib.error
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _hypothesis_compat import given, settings, st  # noqa: E402

from repro.configs import get_config, reduced_config  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.runtime import telemetry as jtel  # noqa: E402
from repro.runtime.sampler import SamplingParams as JSamplingParams  # noqa: E402
from repro.runtime.serving import PagedServingEngine as JPaged  # noqa: E402
from repro.runtime.serving import SchedulerStallError as JStall  # noqa: E402
from repro.runtime.serving import ServingEngine as JFixed  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.configs import reduced_config as treduced  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.runtime import telemetry as ttel  # noqa: E402
from repro_torch.runtime.paged_kv import BlockManager, _quantile  # noqa: E402
from repro_torch.runtime.sampler import SamplingParams as TSamplingParams  # noqa: E402
from repro_torch.runtime.serving import PagedServingEngine as TPaged  # noqa: E402
from repro_torch.runtime.serving import SchedulerStallError as TStall  # noqa: E402
from repro_torch.runtime.serving import ServingEngine as TFixed  # noqa: E402
from repro_torch.runtime.telemetry import (  # noqa: E402
    ZERO_BUCKET, BurnRateMonitor, FlightRecorder, Histogram, MetricsRegistry,
    MetricsServer, Telemetry, TickProfiler, TraceEvent, block_manager_state,
    build_spans, event_from_dict, perfetto_trace, prometheus_text,
    validate_chrome_trace, write_perfetto)

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
import trace_view  # noqa: E402

DT = 0.01                    # virtual seconds between ticks
URL_TIMEOUT_S = 10           # each request to the metrics server


class _Clock:
    """Virtual seconds; the test advances them between ticks."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


def _drive(eng, clock: _Clock, max_ticks: int = 500) -> None:
    for _ in range(max_ticks):
        if not (eng.queue or eng.seats):
            return
        eng.step()
        clock.t += DT
    raise AssertionError(f"not idle after {max_ticks} ticks")


@pytest.fixture(scope="module")
def setup():
    cfg = reduced_config(get_config("qwen3-1.7b"), compute_dtype="float32")
    jp = JM.init_params(JM.param_specs(cfg), jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    tcfg = treduced(tget("qwen3-1.7b"), compute_dtype="float32")
    return cfg, jp, tcfg, tp


# -- the three scenarios, each run by both packages --------------------------

def _preempt(pkg, eng_cls, sp_cls, params, cfg, clock, tel):
    """A pool too small for two requests' growth: preemption and replay,
    with stochastic sampling."""
    eng = eng_cls(cfg, params, page_size=4, num_pages=8, max_seats=2,
                  max_seq_len=28, prefill_chunk=8, clock=clock,
                  telemetry=tel, **pkg)
    sps = [dict(temperature=0.9, seed=5),
           dict(temperature=1.1, top_k=11, seed=6)]
    for k, sp in enumerate(sps):
        eng.submit((np.arange(8, dtype=np.int32) * (3 + 4 * k))
                   % cfg.vocab_size, max_new_tokens=20,
                   sampling=sp_cls(**sp))
    _drive(eng, clock)
    return eng


def _slo(pkg, eng_cls, sp_cls, params, cfg, clock, tel):
    """SLO admission with TTFT and TBT deadlines: the queued requests
    miss their TTFT deadline (the burn alert fires), requests submitted
    to an idle engine then meet it (the alert clears); the premium
    requests' TBT deadline is shorter than a tick (its alert fires)."""
    eng = eng_cls(cfg, params, page_size=8, num_pages=32, max_seats=2,
                  max_seq_len=48, prefill_chunk=8, admission="slo",
                  clock=clock, telemetry=tel, **pkg)
    rng = np.random.default_rng(3)
    for i in range(6):
        eng.submit(rng.integers(0, cfg.vocab_size,
                                int(rng.integers(9, 15))).astype(np.int32),
                   max_new_tokens=4, deadline_ms=35,
                   tbt_deadline_ms=(5, 15)[i % 2],
                   priority=("premium", "standard")[i % 2])
    _drive(eng, clock)
    for _ in range(4):
        eng.submit(rng.integers(0, cfg.vocab_size, 5).astype(np.int32),
                   max_new_tokens=3, deadline_ms=35, tbt_deadline_ms=15)
        _drive(eng, clock)
    return eng


def _fixed(pkg, eng_cls, sp_cls, params, cfg, clock, tel):
    """The fixed-slot engine: whole-prompt prefill, a queue behind two
    slots, a TTFT deadline that the queued requests miss."""
    eng = eng_cls(cfg, params, slots=2, max_len=32, clock=clock,
                  telemetry=tel, **pkg)
    rng = np.random.default_rng(4)
    for i in range(5):
        eng.submit(rng.integers(0, cfg.vocab_size,
                                int(rng.integers(3, 12))).astype(np.int32),
                   max_new_tokens=int(rng.integers(2, 7)),
                   deadline_ms=25, sampling=sp_cls(temperature=0.8, seed=i))
    _drive(eng, clock)
    return eng


SCENARIOS = {"preempt": (_preempt, "paged"), "slo": (_slo, "paged"),
             "fixed": (_fixed, "fixed")}
TEL_KW = dict(burn_window_s=0.1, burn_min_samples=2)


@pytest.fixture(scope="module")
def runs(setup):
    """``{scenario: (jax engine, port engine)}``, each engine with its own
    package's ``Telemetry`` and its own virtual clock, run on demand."""
    cfg, jp, tcfg, tp = setup
    cache = {}

    def get(name):
        if name not in cache:
            make, kind = SCENARIOS[name]
            jcls, tcls = (JPaged, TPaged) if kind == "paged" else \
                (JFixed, TFixed)
            cache[name] = (
                make({}, jcls, JSamplingParams, jp, cfg, _Clock(),
                     jtel.Telemetry(**TEL_KW)),
                make({"device": "cpu"}, tcls, TSamplingParams, tp, tcfg,
                     _Clock(), Telemetry(**TEL_KW)))
        return cache[name]
    return get


def _dicts(eng):
    return [e.to_dict() for e in eng.telemetry.events()]


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_events_equal_jax(runs, scenario):
    """Every flight-recorder event (tick, time, rid, kind, attrs) equal
    to the JAX engine's, and the tokens and flat traces equal too."""
    jeng, teng = runs(scenario)
    assert {r.rid: list(r.generated) for r in teng.finished} == \
        {r.rid: list(r.generated) for r in jeng.finished}
    assert teng.trace == jeng.trace
    assert _dicts(teng) == _dicts(jeng)
    assert teng.telemetry.burn.rates() == jeng.telemetry.burn.rates()
    state = json.loads(json.dumps(ttel.scheduler_state(teng)))
    assert state == json.loads(json.dumps(jtel.scheduler_state(jeng)))
    kinds = {e["kind"] for e in _dicts(teng)}
    assert {"submit", "admit", "first_token", "decode", "finish"} <= kinds
    if scenario == "preempt":
        assert teng.metrics.preemptions > 0 and "preempt" in kinds
        assert state["block_manager"]["evictions"] > 0
    if scenario == "slo":
        assert {"slo_burn", "slo_burn_clear", "deadline_miss",
                "tbt_miss"} <= kinds
        burns = {(e["attrs"]["class"], e["attrs"]["kind"], e["kind"])
                 for e in _dicts(teng) if e["kind"].startswith("slo_burn")}
        assert {("standard", "ttft", "slo_burn"),
                ("standard", "ttft", "slo_burn_clear"),
                ("premium", "tbt", "slo_burn")} <= burns
    if scenario == "fixed":
        assert "deadline_miss" in kinds
    # the flat trace never carries the telemetry-only submit event
    assert all(ev != "submit" for _, ev, _ in teng.trace)


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_perfetto_equal_jax_and_valid(runs, scenario, tmp_path):
    jeng, teng = runs(scenario)
    tdoc = perfetto_trace(teng.telemetry.events())
    assert tdoc == jtel.perfetto_trace(jeng.telemetry.events())
    assert validate_chrome_trace(tdoc) == []
    assert jtel.validate_chrome_trace(tdoc) == []
    path = write_perfetto(str(tmp_path / "t.json"), teng.telemetry.events())
    assert json.loads(Path(path).read_text()) == json.loads(json.dumps(tdoc))
    spans = build_spans(teng.telemetry.events())["spans"]
    names = {s["name"] for s in spans}
    assert {"queued", "prefill", "decode"} <= names
    if scenario == "preempt":
        assert "replay" in names


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_prometheus_text_equal_jax(runs, scenario):
    jeng, teng = runs(scenario)
    text = prometheus_text({"m": teng.metrics})
    assert text == jtel.prometheus_text({"m": jeng.metrics})
    assert 'repro_ttft_seconds_bucket{class=' in text
    assert ("repro_slo_misses_total" in text) == (scenario != "preempt")


def test_trace_view_reads_the_ports_dumps(runs, tmp_path):
    """The reference's ``scripts/trace_view.py`` reads the port's Perfetto
    export and postmortem, and finds the same spans in both."""
    _, teng = runs("preempt")
    tel = teng.telemetry
    ptrace = tmp_path / "trace.json"
    write_perfetto(str(ptrace), tel.events())
    spans_p, inst_p = trace_view.load_trace(str(ptrace))
    pm = tmp_path / "pm.json"
    tel.write_postmortem("round trip", engines={"engine": teng},
                         path=str(pm))
    spans_f, inst_f = trace_view.load_trace(str(pm))
    assert len(spans_p) == len(spans_f) and len(inst_p) == len(inst_f)
    out = trace_view.render(spans_f, inst_f)
    assert "replay" in out and "preempt" in out
    rid = next(i["rid"] for i in inst_f if i["kind"] == "preempt")
    md = trace_view.render(spans_p, inst_p, rid=rid, fmt="md")
    assert f"### rid {rid}" in md and "| replay |" in md


@pytest.mark.parametrize("kind", ["paged", "fixed"])
def test_stall_postmortem_equal_jax(setup, tmp_path, kind):
    """A forced stall raises in both packages and writes postmortems that
    are equal as whole JSON documents (no value that ``default=str``
    writes differs in type between the packages), which name the stalled
    rids and, for the paged engine, a consistent ``BlockManager``
    partition."""
    cfg, jp, tcfg, tp = setup
    pms = {}
    for pkg, (eng_cls, tel_cls, stall, params, c, extra) in {
            "jax": ((JPaged if kind == "paged" else JFixed), jtel.Telemetry,
                    JStall, jp, cfg, {}),
            "torch": ((TPaged if kind == "paged" else TFixed), Telemetry,
                      TStall, tp, tcfg, {"device": "cpu"})}.items():
        path = tmp_path / f"{pkg}.json"
        tel = tel_cls(ring=64, postmortem_path=str(path))
        kw = (dict(page_size=4, num_pages=16, max_seats=2, max_seq_len=32,
                   prefill_chunk=4) if kind == "paged"
              else dict(slots=2, max_len=32))
        eng = eng_cls(c, params, clock=_Clock(), telemetry=tel, **kw,
                      **extra)
        for n in (6, 9, 5):
            eng.submit(np.arange(n, dtype=np.int32), max_new_tokens=8,
                       priority="batch" if n == 5 else "standard")
        with pytest.raises(stall, match="max_ticks=2"):
            eng.run(max_ticks=2)
        pms[pkg] = json.loads(path.read_text())
        assert tel.last_postmortem["reason"] == pms[pkg]["reason"]
    assert pms["torch"] == pms["jax"]
    pm = pms["torch"]
    assert pm["reason"].startswith("SchedulerStallError")
    state = pm["engines"]["engine"]
    stalled = ({r["rid"] for r in state["seats"].values()}
               | {r["rid"] for r in state["queue"]})
    assert stalled == {0, 1, 2}
    assert "0(standard), 1(standard), 2(batch)" in pm["reason"]
    assert {0, 1, 2} <= {d["rid"] for d in pm["flight_recorder"]["events"]}
    if kind == "paged":
        bm = state["block_manager"]
        assert bm["partition_ok"] is True
        assert len(bm["free"]) + len(bm["reclaimable"]) + \
            len(bm["live_refcounts"]) == bm["capacity"]


# -- telemetry is free: tokens and flat trace on vs off vs profiled ----------

@pytest.mark.parametrize("fused", [True, False])
def test_tokens_and_trace_identical_off_on_profiled(setup, fused):
    """The port's paged engine with ``telemetry=None``, ``Telemetry()``
    and ``Telemetry(profile=True)`` over the preemption workload: the
    same tokens and the same flat trace; the profiled fused tick splits
    its decode phase into sync / dispatch / host / sample, the eager
    path keeps the step-level phases only."""
    _, _, tcfg, tp = setup
    outs = {}
    tels = {"off": None, "on": Telemetry(), "profiled": Telemetry(profile=True)}
    for name, tel in tels.items():
        eng = _preempt({"device": "cpu", "fused": fused}, TPaged,
                       TSamplingParams, tp, tcfg, _Clock(), tel)
        outs[name] = ({r.rid: list(r.generated) for r in eng.finished},
                      list(eng.trace))
    assert outs["on"] == outs["off"] == outs["profiled"]
    snap = tels["profiled"].profiler.snapshot()
    top = {"admission", "prefill", "decode", "bookkeeping"}
    sub = {"decode/sync", "decode/dispatch", "decode/host", "decode/sample"}
    assert snap["ticks"] == eng._tick
    assert top <= set(snap["phases"])
    assert (sub <= set(snap["phases"])) == fused
    assert not (set(snap["phases"]) - top - sub)
    if fused:
        assert snap["phases"]["decode/dispatch"]["calls"] == \
            eng.policy.decode_ticks
    assert sum(ph["share"] for p, ph in snap["phases"].items()
               if "/" not in p) == pytest.approx(1.0)


def test_profiled_tick_runs_the_dispatch_in_a_record_function(setup):
    """The fused tick's dispatch runs inside a ``fused_decode_tick``
    ``record_function`` range while profiling, and outside any range
    otherwise."""
    import torch
    _, _, tcfg, tp = setup
    names = {}
    for name, tel in (("off", None), ("profiled", Telemetry(profile=True))):
        eng = TPaged(tcfg, tp, page_size=8, num_pages=16, max_seats=2,
                     max_seq_len=32, prefill_chunk=8, device="cpu",
                     clock=_Clock(), telemetry=tel)
        eng.submit(np.arange(6, dtype=np.int32), max_new_tokens=3)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            eng.run()
        names[name] = sum(1 for e in prof.events()
                          if e.name == "fused_decode_tick")
        ticks = eng.policy.decode_ticks
    assert names == {"off": 0, "profiled": ticks}


# -- the reference's pure cases, on the port's classes -----------------------

def test_ring_bounds_and_drop_count():
    fr = FlightRecorder(capacity=4)
    for i in range(10):
        fr.append(TraceEvent(i, float(i), "e", i, "decode", None))
    assert [e.tick for e in fr.events()] == [6, 7, 8, 9]
    assert fr.total == 10 and fr.dropped == 6
    snap = fr.snapshot()
    assert snap["capacity"] == 4 and snap["dropped"] == 6
    assert [d["tick"] for d in snap["events"]] == [6, 7, 8, 9]
    with pytest.raises(ValueError):
        FlightRecorder(capacity=0)
    fr.clear()
    assert fr.events() == [] and fr.dropped == 0


def test_event_dict_round_trip_across_packages():
    ev = TraceEvent(3, 1.5, "m0/0", 7, "admit", {"seat": 2})
    assert event_from_dict(ev.to_dict()) == ev
    assert ev.to_dict() == jtel.TraceEvent(*ev).to_dict()
    assert jtel.event_from_dict(ev.to_dict()) == tuple(ev)
    bare = TraceEvent(0, 0.0, "e", 1, "finish", None)
    assert "attrs" not in bare.to_dict()
    assert event_from_dict(bare.to_dict()) == bare


def test_histogram_bucket_edges_and_errors():
    h = Histogram(base=2.0)
    assert h.bucket_index(0.0) == ZERO_BUCKET == jtel.ZERO_BUCKET
    assert h.bucket_index(-1.0) == ZERO_BUCKET
    assert h.bucket_index(1.0) == 0
    assert h.bucket_index(1.5) == 1
    assert h.bucket_index(2.0) == 1          # boundary goes low
    assert h.bucket_le(ZERO_BUCKET) == 0.0
    assert h.bucket_le(3) == 8.0
    with pytest.raises(ValueError):
        Histogram(base=2.0).merge(Histogram(base=10.0))
    with pytest.raises(ValueError):
        Histogram(base=1.0)
    assert Histogram().quantile_bucket(0.5) is None
    assert Histogram().quantile_bound(0.5) == 0.0


pos_floats = st.floats(min_value=1e-6, max_value=1e6,
                       allow_nan=False, allow_infinity=False)


def _hist(mod, vals):
    h = mod.Histogram()
    for v in vals:
        h.observe(v)
    return h


@settings(max_examples=60, deadline=None, derandomize=True)
@given(st.lists(pos_floats, min_size=1, max_size=40),
       st.lists(pos_floats, min_size=0, max_size=40),
       st.lists(pos_floats, min_size=0, max_size=40))
def test_histogram_merge_laws(xs, ys, zs):
    a, b, c = _hist(ttel, xs), _hist(ttel, ys), _hist(ttel, zs)
    ab_c = a.merge(b).merge(c)
    assert ab_c.counts == a.merge(b.merge(c)).counts
    assert a.merge(b).counts == b.merge(a).counts
    assert ab_c.count == len(xs) + len(ys) + len(zs)
    assert ab_c.sum == pytest.approx(sum(xs) + sum(ys) + sum(zs))
    assert a.count == len(xs) and b.count == len(ys)      # merge is pure
    # the same samples give the reference's histogram, merged or not
    assert ab_c.to_dict() == \
        _hist(jtel, xs).merge(_hist(jtel, ys)).merge(_hist(jtel, zs)).to_dict()


@settings(max_examples=60, deadline=None, derandomize=True)
@given(st.lists(pos_floats, min_size=1, max_size=50),
       st.sampled_from([0.5, 0.9, 0.95, 0.99, 1.0]))
def test_quantile_bucket_matches_exact_quantile(xs, q):
    h = _hist(ttel, xs)
    exact = _quantile(xs, q)
    assert h.quantile_bucket(q) == h.bucket_index(exact)
    assert h.quantile_bound(q) >= exact
    assert h.quantile_bound(q) == _hist(jtel, xs).quantile_bound(q)


def test_histogram_json_round_trip():
    h = _hist(ttel, (0.0, 0.001, 0.5, 3.0, 3.0, 100.0))
    h2 = Histogram.from_dict(json.loads(json.dumps(h.to_dict())))
    assert h2.counts == h.counts and h2.count == h.count
    assert h2.sum == h.sum and h2.base == h.base
    assert (h2.min, h2.max) == (0.0, 100.0)
    assert h.to_dict() == _hist(jtel, (0.0, 0.001, 0.5, 3.0, 3.0,
                                       100.0)).to_dict()


def test_burn_window_boundary_is_exclusive():
    m = BurnRateMonitor(window_s=1.0, threshold=0.5, min_samples=2)
    m.observe(0.0, "rt", "ttft", True)
    m.observe(0.0, "rt", "ttft", True)
    assert m.rates(0.999)["rt/ttft"]["samples"] == 2
    assert "rt/ttft" not in m.rates(1.0)      # t <= now - window evicts


def test_burn_edge_triggered_fire_then_clear():
    m = BurnRateMonitor(window_s=10.0, threshold=0.5, min_samples=2)
    assert m.observe(0.0, "rt", "tbt", True) is None     # n=1 < min
    alert = m.observe(0.1, "rt", "tbt", True)
    assert alert == {"state": "fire", "class": "rt", "kind": "tbt",
                     "miss_rate": 1.0, "samples": 2, "window_s": 10.0,
                     "threshold": 0.5}
    assert m.observe(0.2, "rt", "tbt", True) is None     # no repeat
    cleared, t = None, 0.3
    while cleared is None and t < 5.0:
        cleared = m.observe(t, "rt", "tbt", False)
        t += 0.1
    assert cleared and cleared["state"] == "clear"
    assert m.observe(t, "rt", "tbt", False) is None      # stays clear


def test_burn_classes_independent_and_validated():
    m = BurnRateMonitor(window_s=10.0, threshold=0.5, min_samples=2)
    m.observe(0.0, "rt", "ttft", True)
    m.observe(0.0, "batch", "ttft", False)
    m.observe(0.1, "batch", "ttft", False)
    alert = m.observe(0.1, "rt", "ttft", True)
    assert alert and alert["class"] == "rt"
    assert m.rates(0.2)["batch/ttft"]["miss_rate"] == 0.0
    for bad in (dict(window_s=0.0), dict(threshold=1.5)):
        with pytest.raises(ValueError):
            BurnRateMonitor(**bad)
    with pytest.raises(ValueError):
        Telemetry(heartbeat_every=0)


def test_observe_slo_emits_burn_events():
    tel = Telemetry(ring=64, burn_window_s=10.0, burn_threshold=0.5,
                    burn_min_samples=2)
    tel.observe_slo(0.0, 1, "e", "rt", "ttft", True)
    tel.observe_slo(0.1, 2, "e", "rt", "ttft", True)
    assert [e.kind for e in tel.events()] == ["slo_burn"]
    ev = tel.events()[0]
    assert ev.rid == -1 and ev.attrs["class"] == "rt"
    assert "state" not in ev.attrs            # popped into the kind


def test_registry_renders_prometheus_text_as_the_reference():
    h = _hist(ttel, (0.1, 0.2, 0.4))
    texts = []
    for mod, hist in ((ttel, h), (jtel, _hist(jtel, (0.1, 0.2, 0.4)))):
        reg = mod.MetricsRegistry()
        reg.counter("repro_ticks_total", 5, {"engine": "e0"}, help="ticks")
        reg.gauge("repro_pages_in_use", 7.5, {"engine": "e0"})
        reg.histogram("repro_ttft_seconds", hist, {"engine": "e0"})
        texts.append(reg.render())
    text = texts[0]
    assert text == texts[1]
    assert "# TYPE repro_ticks_total counter" in text
    assert 'repro_ticks_total{engine="e0"} 5' in text
    assert 'repro_pages_in_use{engine="e0"} 7.5' in text
    inf_line = [ln for ln in text.splitlines() if 'le="+Inf"' in ln][0]
    assert inf_line.endswith(" 3")
    reg = MetricsRegistry()
    reg.counter("repro_ticks_total", 1)
    with pytest.raises(ValueError):
        reg.gauge("repro_ticks_total", 1.0)      # type collision


def test_profiler_shares_over_top_level_phases():
    p = TickProfiler()
    p.add("admission", 0.25)
    p.add("decode", 0.75)
    p.add("decode/dispatch", 0.5)
    p.add("decode/host", 0.25)
    p.note_tick()
    snap = p.snapshot()
    assert snap["ticks"] == 1
    assert snap["phases"]["decode"]["share"] == pytest.approx(0.75)
    assert snap["phases"]["decode/dispatch"]["share"] == pytest.approx(0.5)
    q = jtel.TickProfiler()
    for phase, t in p.totals.items():
        q.add(phase, t)
    q.note_tick()
    assert q.snapshot() == snap


def test_block_manager_state_direct():
    bm = BlockManager(num_pages=8, page_size=4)
    pages = bm.alloc(3, rid=1)
    st_ = block_manager_state(bm)
    assert st_["partition_ok"] is True
    assert st_["capacity"] == 7          # page 0 is scratch
    assert st_["in_use"] == 3
    assert sorted(int(k) for k in st_["live_refcounts"]) == sorted(pages)
    bm._free.append(pages[0])            # a page both live and free
    assert block_manager_state(bm)["partition_ok"] is False


# -- the metrics server -----------------------------------------------------

def _get(url: str):
    with urllib.request.urlopen(url, timeout=URL_TIMEOUT_S) as resp:
        return resp.status, resp.headers["Content-Type"], resp.read()


def test_metrics_server_serves_and_404s():
    body = ["# boot\n"]
    srv = MetricsServer(lambda: body[0], port=0)
    try:
        assert srv.port > 0
        status, ctype, data = _get(srv.url)
        assert status == 200 and "version=0.0.4" in ctype
        assert data == b"# boot\n"
        body[0] = "repro_ticks_total 9\n"
        assert b"repro_ticks_total 9" in _get(srv.url)[2]
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(srv.url.replace("/metrics", "/nope"))
        assert ei.value.code == 404
    finally:
        srv.close()
    assert not srv._thread.is_alive()


def test_metrics_server_serves_an_engines_families(runs):
    _, teng = runs("slo")
    srv = MetricsServer(lambda: prometheus_text({"qwen": teng.metrics}),
                        port=0)
    try:
        text = _get(srv.url)[2].decode()
    finally:
        srv.close()
    assert not srv._thread.is_alive()
    assert text == prometheus_text({"qwen": teng.metrics})
    for family in ("repro_requests_completed_total", "repro_ticks_total",
                   "repro_pages_in_use", "repro_ttft_seconds",
                   "repro_tbt_seconds", "repro_slo_misses_total"):
        assert f"# TYPE {family} " in text, family


# -- the serve CLI ----------------------------------------------------------

def test_serve_cli_exports_a_trace_and_prints_the_phase_table(
        tmp_path, capsys):
    trace = tmp_path / "trace.json"
    tserve.main(["--engine", "paged", "--device", "cpu", "--requests", "3",
                 "--gen", "4", "--flight-recorder", "64", "--trace-export",
                 str(trace), "--profile-ticks"])
    out = capsys.readouterr().out
    assert "wrote Perfetto trace" in out and "tick-phase profile" in out
    for phase in ("admission", "prefill", "decode/dispatch", "decode/host",
                  "bookkeeping"):
        assert f"[serve.paged]   {phase}" in out, phase
    doc = json.loads(trace.read_text())
    assert validate_chrome_trace(doc) == [] and doc["traceEvents"]


def test_serve_cli_refuses_telemetry_with_the_static_batch(capsys):
    for flag in (["--profile-ticks"], ["--flight-recorder", "8"],
                 ["--trace-export", "x.json"], ["--metrics-port", "0"]):
        with pytest.raises(SystemExit):
            tserve.main(["--device", "cpu", *flag])
        assert "need --engine paged" in capsys.readouterr().err


def test_telemetry_from_args_as_the_reference():
    for flags in ([], ["--profile-ticks"], ["--flight-recorder", "16"],
                  ["--metrics-port", "0", "--postmortem", "p.json"]):
        ap = argparse.ArgumentParser()
        tserve.add_telemetry_args(ap)
        tel = tserve.telemetry_from_args(ap.parse_args(flags))
        jap = argparse.ArgumentParser()
        jserve.add_telemetry_args(jap)
        jt = jserve.telemetry_from_args(jap.parse_args(flags))
        assert (tel is None) == (jt is None)
        if tel is not None:
            assert (tel.recorder.capacity, tel.profiler is None,
                    tel.postmortem_path) == (jt.recorder.capacity,
                                             jt.profiler is None,
                                             jt.postmortem_path)


def test_build_tuning_env_as_the_reference(tmp_path):
    lib = tmp_path / "libtcmalloc.so.4"
    lib.write_bytes(b"")
    envs = [{}, {"LD_PRELOAD": "/x/liba.so"},
            {"LD_PRELOAD": str(lib),
             "TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD": "1"}]
    for path in (str(lib), str(tmp_path / "absent.so")):
        for env in envs:
            for preset in ("off", "alloc"):
                assert tserve.build_tuning_env(
                    preset, env, tcmalloc_path=path) == \
                    jserve.build_tuning_env(preset, env, tcmalloc_path=path)
            # full adds only XLA flags on top of alloc in the reference
            want = {k: v for k, v in jserve.build_tuning_env(
                "full", env, tcmalloc_path=path).items() if k != "XLA_FLAGS"}
            assert tserve.build_tuning_env(
                "full", env, tcmalloc_path=path) == want
    assert tserve.build_tuning_env("alloc", {}, tcmalloc_path=str(lib)) == {
        "LD_PRELOAD": str(lib),
        "TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD": "60000000000"}
    with pytest.raises(ValueError):
        tserve.build_tuning_env("turbo", {})


def test_apply_tuning_preset_reexecutes_the_serve_module(monkeypatch):
    """``alloc`` re-executes ``python -m repro_torch.launch.serve`` with
    the preset's environment and the marker that stops a second exec; a
    tuned environment, ``off`` or a preset that adds nothing does not."""
    calls = []
    monkeypatch.setattr(tserve.os, "execve",
                        lambda exe, args, env: calls.append((args, env)))
    monkeypatch.delenv("_REPRO_TUNED", raising=False)
    monkeypatch.setattr(tserve, "build_tuning_env",
                        lambda preset, env: {"LD_PRELOAD": "/x/tc.so"})
    tserve.apply_tuning_preset("off", ["--engine", "paged"])
    assert calls == []
    tserve.apply_tuning_preset("alloc", ["--engine", "paged"])
    (args, env), = calls
    assert args[1:] == ["-m", "repro_torch.launch.serve", "--engine",
                        "paged"]
    assert env["LD_PRELOAD"] == "/x/tc.so" and env["_REPRO_TUNED"] == "1"
    monkeypatch.setenv("_REPRO_TUNED", "1")
    tserve.apply_tuning_preset("alloc", [])
    assert len(calls) == 1
    monkeypatch.delenv("_REPRO_TUNED")
    monkeypatch.setattr(tserve, "build_tuning_env", lambda preset, env: {})
    tserve.apply_tuning_preset("full", [])
    assert len(calls) == 1 and tserve.os.environ["_REPRO_TUNED"] == "1"
