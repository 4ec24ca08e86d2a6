"""The port's fleet router against the JAX package's, on the CPU.

Reduced qwen3-1.7b and llama3-8b with f32 compute (tokens agree across
the packages) and JAX-initialized weights carried across.  The claims of
the reference's ``tests/test_router.py`` and its fleet cases in
``tests/test_kv_quant.py``, each held on the port and, where a JAX
fleet is built too, equal to it: ``HostBudget`` states compared whole
(no model involved), ``parse_models_spec`` and ``_make_selection`` with
the reference's messages, the constructor's validation, round-robin
rotation, least-loaded spread, session affinity with home-replica prefix
hits, SLO-aware and precision-floored placement, raw-rid collision
against fleet namespacing, the two-schedule routing fuzz (streams equal
to solo port engines and to the JAX fleet's), surplus borrowing against a
static split, ``metrics_snapshot()`` with its budget block, and the
fleet stall's message and postmortem, these two under one injected
clock.

Then the ``_init_model_state`` contract: a model-free subclass of the
port's ``PagedPolicy`` with the bodies of the reference's
``OraclePolicy``, built with ``params=None``, gives through
``PagedServingEngine(policy_cls=...)`` and ``ModelFleet(policy_cls=...)``
exactly the reference's oracle engine and ``oracle_fleet``: flat traces,
finished streams and metrics on a fixed-seed workload of hundreds of
requests, each side on its own virtual clock.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest

from benchmarks.load_harness import drive_workload
from repro.configs import get_config, reduced_config
from repro.models import model as JM
from repro.runtime import router as jrouter
from repro.runtime import telemetry as jtel
from repro.runtime.paged_kv import BlockManager as JBlockManager
from repro.runtime.sampler import SamplingParams as JSamplingParams
from repro.runtime.serving import PagedServingEngine as JPaged
from repro.runtime.serving import SchedulerStallError as JStall
from repro.runtime.workload import (OracleModel, OraclePolicy, VirtualClock,
                                    WorkloadSpec, generate_workload,
                                    oracle_fleet)
from repro_torch.configs import get_config as tget
from repro_torch.configs import reduced_config as treduced
from repro_torch.models.convert import params_from_jax
from repro_torch.runtime import router as trouter
from repro_torch.runtime.paged_kv import BlockManager as TBlockManager
from repro_torch.runtime.sampler import _MASK32, sample_tokens_np
from repro_torch.runtime.sampler import SamplingParams as TSamplingParams
from repro_torch.runtime.serving import PagedPolicy
from repro_torch.runtime.serving import PagedServingEngine as TPaged
from repro_torch.runtime.serving import SchedulerStallError as TStall
from repro_torch.runtime.telemetry import Telemetry

KW = dict(page_size=4, max_seats=2, max_seq_len=16, prefill_chunk=4)
N_TABLES = 4            # ceil(max_seq_len / page_size)
DT = 0.01               # virtual seconds per fleet tick


def prompt_for(vocab, i, n=6):
    return ((np.arange(n, dtype=np.int32) * (2 * i + 3) + i)
            % vocab).astype(np.int32)


def _models(arch, seed):
    cfg = reduced_config(get_config(arch), compute_dtype="float32")
    jp = JM.init_params(JM.param_specs(cfg), jax.random.PRNGKey(seed))
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    return {"jax": (cfg, jp),
            "torch": (treduced(tget(arch), compute_dtype="float32"), tp)}


@pytest.fixture(scope="module")
def models():
    return {"q": _models("qwen3-1.7b", 0), "l": _models("llama3-8b", 1)}


class Side:
    """One package's fleet surface, so a scenario runs on either."""

    def __init__(self, pkg, models):
        self.pkg, self.models = pkg, models
        torch_ = pkg == "torch"
        self.r = trouter if torch_ else jrouter
        self.Engine = TPaged if torch_ else JPaged
        self.Stall = TStall if torch_ else JStall
        self.Telemetry = Telemetry if torch_ else jtel.Telemetry
        self.stoch = (TSamplingParams if torch_ else JSamplingParams)(
            temperature=0.9, seed=11)
        self.dev = {"device": "cpu"} if torch_ else {}

    def cfg(self, key):
        return self.models[key][self.pkg][0]

    def fm(self, name, **kw):
        cfg, params = self.models[name][self.pkg]
        return self.r.FleetModel(name, cfg, params, **kw)

    def fleet(self, fms, **kw):
        return self.r.ModelFleet(fms, **{**KW, **kw}, **self.dev)

    def engine(self, key, **kw):
        cfg, params = self.models[key][self.pkg]
        return self.Engine(cfg, params, **{**KW, **kw}, **self.dev)

    def solo(self, key, submits):
        """[(rid, prompt, gen)] on one dedicated engine with explicit
        rids; returns rid -> generated."""
        eng = self.engine(key, num_pages=65)
        for rid, p, g in submits:
            eng.submit(p, max_new_tokens=g, sampling=self.stoch, rid=rid)
        eng.run()
        return {r.rid: r.generated for r in eng.finished}


def _sides(models):
    return {pkg: Side(pkg, models) for pkg in ("jax", "torch")}


def _state(fleet):
    """What a fleet run leaves: routes, per-engine flat traces, streams."""
    return {"routes": dict(fleet._routes),
            "traces": {f"{n}/{i}": list(e.trace)
                       for n, i, e in fleet._engines()},
            "streams": {r: q.generated for r, q in fleet.finished().items()}}


# ---------------------------------------------------------------------------
# HostBudget + BlockManager gate (no models): states compared whole
# ---------------------------------------------------------------------------

def _budget(hb, bm_cls, total, floors, **bm_kw):
    budget = hb(total)
    bms = []
    for i, floor in enumerate(floors):
        bm = bm_cls(total + 1, 4, **bm_kw)
        budget.register(f"m{i}", bm, floor)
        bms.append(bm)
    return budget, bms


def _surplus_and_floor(hb, bm_cls):
    budget, (a, b) = _budget(hb, bm_cls, 10, (3, 3), prefix_cache=False)
    assert budget.surplus == 4
    log = [budget.usage()]
    assert a.alloc(3, rid=0) is not None and budget.borrowed("m0") == 0
    assert a.can_alloc(4) and not a.can_alloc(5)
    borrowed = a.alloc(4, rid=0)
    assert borrowed is not None and budget.borrowed("m0") == 4
    log.append(budget.usage())
    assert b.can_alloc(3) and not b.can_alloc(4)
    assert b.alloc(3, rid=1) is not None
    assert not b.can_alloc(1) and b.alloc(1, rid=1) is None
    a.free(borrowed[:2])
    assert b.can_alloc(2) and not b.can_alloc(3)
    return log + [budget.usage(), a.version, b.version]


def _usage(hb, bm_cls):
    budget, (a, b) = _budget(hb, bm_cls, 10, (3, 3), prefix_cache=False)
    a.alloc(5, rid=0)
    u = budget.usage()
    assert u["total_pages"] == 10 and u["surplus_pages"] == 4
    m0 = u["engines"]["m0"]
    assert (m0["floor"], m0["in_use"], m0["borrowed"]) == (3, 5, 2)
    assert (m0["page_bytes"], m0["bytes_in_use"],
            m0["borrowed_bytes"]) == (1, 5, 2)
    assert u["engines"]["m1"]["in_use"] == 0
    return [u]


def _invalidation(hb, bm_cls):
    budget, (a, b) = _budget(hb, bm_cls, 8, (2, 2), prefix_cache=False)
    pages = a.alloc(6, rid=0)               # floor 2 + all 4 surplus
    assert not b.can_alloc(3)
    v = b.version
    a.free(pages[:2])
    assert b.version > v                    # sibling invalidated
    assert b.can_alloc(3)
    return [budget.usage(), a.version, b.version]


def _reclaimable(hb, bm_cls):
    budget, (a, b) = _budget(hb, bm_cls, 8, (2, 2), prefix_cache=True)
    pages = a.alloc(6, rid=0)
    a.register_prefix(list(range(4)), pages[0])
    a.free(pages)                           # page parks reclaimable
    assert a.cached == 1 and a.in_use == 0
    assert b.can_alloc(6)                   # A's cached page is evictable
    return [budget.usage(), a.cached]


def _byte_weighted(hb, bm_cls):
    budget = hb(8, page_bytes=4)            # 32 bytes total
    exp = bm_cls(num_pages=9, page_size=4, page_bytes=4)
    cheap = bm_cls(num_pages=25, page_size=4, page_bytes=1)
    budget.register("exp", exp, floor=2)
    budget.register("cheap", cheap, floor=4)
    assert (budget.surplus_bytes, budget.surplus) == (20, 5)
    got = cheap.alloc(24, rid=0)            # floor 4 + 20 borrowed
    assert got is not None and budget.borrowed_bytes("cheap") == 20
    assert not budget.allows("exp", 3) and budget.allows("exp", 2)
    log = [budget.usage()]
    cheap.free(got[:20])
    assert budget.allows("exp", 7)
    return log + [budget.usage()]


@pytest.mark.parametrize("case", [_surplus_and_floor, _usage, _invalidation,
                                  _reclaimable, _byte_weighted],
                         ids=lambda f: f.__name__.strip("_"))
def test_host_budget_states_equal_jax(case):
    """Each claim holds on both packages, and the budget's ``usage()``
    and the managers' versions along the way are equal."""
    got = case(trouter.HostBudget, TBlockManager)
    assert got == case(jrouter.HostBudget, JBlockManager)


def _raised(fn):
    with pytest.raises((ValueError, TypeError)) as e:
        fn()
    return type(e.value).__name__, str(e.value)


def _register_errors(hb, bm_cls):
    budget = hb(6)
    budget.register("a", bm_cls(8, 4), 3)
    used = bm_cls(8, 4)
    used.alloc(1, rid=0)
    clean = bm_cls(8, 4)
    hb(6).register("x", clean, 2)
    return [_raised(lambda: budget.register("a", bm_cls(8, 4), 1)),
            _raised(lambda: budget.register("b", bm_cls(8, 4), 0)),
            _raised(lambda: budget.register("c", bm_cls(8, 4), 4)),
            _raised(lambda: hb(0)),
            _raised(lambda: hb(4, page_bytes=0)),
            _raised(lambda: hb(6).register("u", used, 2)),
            _raised(lambda: hb(6).register("b", clean, 2))]


def test_host_budget_register_validation_equal_jax():
    got = _register_errors(trouter.HostBudget, TBlockManager)
    assert got == _register_errors(jrouter.HostBudget, JBlockManager)
    for (_, msg), want in zip(got, ("already registered", "floor must be",
                                    "exceed the host budget", "total_pages",
                                    "page_bytes", "pristine",
                                    "already answers")):
        assert want in msg


# ---------------------------------------------------------------------------
# CLI spec + selection plumbing (no models)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [
    "llama3-8b:2,qwen3-1.7b", " a:1 , b:3 ", "a:2:fp8,b:1:f32,c", "a::int8",
    "", "a,,b", ":2", "a:x", "a:0", "a,a", "a:2:fp7", "a:2:fp8:x"])
def test_parse_models_spec_equal_jax(spec):
    def parse(mod):
        try:
            return mod.parse_models_spec(spec)
        except ValueError as e:
            return "ValueError", str(e)
    assert parse(trouter) == parse(jrouter)


def test_make_selection_equal_jax():
    for name, cls in (("least-loaded", "LeastLoaded"),
                      ("round-robin", "RoundRobin"),
                      ("slo-aware", "SLOAware")):
        assert type(trouter._make_selection(name)).__name__ == cls
        assert trouter._make_selection(name).name == name
    for bad in ("random", 42):
        assert _raised(lambda: trouter._make_selection(bad)) == \
            _raised(lambda: jrouter._make_selection(bad))
    sentinel = trouter.RoundRobin()
    assert trouter._make_selection(sentinel) is sentinel


def _ctor_errors(side):
    fm = side.fm
    cases = [([], 16, {}),
             ([fm("q"), fm("q")], 32, {}),
             ([fm("q", replicas=0)], 16, {}),
             ([fm("q", floor=N_TABLES - 1)], 16, {}),
             ([fm("q", replicas=2)], 2 * N_TABLES - 1, {}),
             ([fm("q", kv_dtype=["f32"] * 2)], 16, {}),
             ([fm("q", kv_dtype="fp8")], 16,
              {"class_precision": {"premium": "f32"}})]
    return [_raised(lambda: side.fleet(fms, total_pages=t, **kw))
            for fms, t, kw in cases]


def test_fleet_constructor_validation_equal_jax(models):
    sides = _sides(models)
    got = _ctor_errors(sides["torch"])
    assert got == _ctor_errors(sides["jax"])
    for (_, msg), want in zip(got, (
            "at least one model", "duplicate model names", "replicas must be",
            "cannot hold", "floors need", "kv_dtype sequence has 2",
            "class_precision requires f32")):
        assert want in msg


def test_fleet_defaults_to_cuda_and_raises_without_it(models, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, params = models["q"]["torch"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trouter.ModelFleet([trouter.FleetModel("q", cfg, params)],
                           total_pages=16, **KW)


# ---------------------------------------------------------------------------
# Routing: selection policies, affinity, precision floors (both packages)
# ---------------------------------------------------------------------------

def _round_robin(side):
    fleet = side.fleet([side.fm("q", replicas=2)], total_pages=4 * N_TABLES,
                       selection="round-robin")
    vocab = side.cfg("q").vocab_size
    rids = [fleet.submit(model="q", prompt=prompt_for(vocab, i),
                         max_new_tokens=2) for i in range(4)]
    assert [fleet.route(r) for r in rids] == \
        [("q", 0), ("q", 1), ("q", 0), ("q", 1)]
    fleet.run()
    return _state(fleet)


def _least_loaded(side):
    fleet = side.fleet([side.fm("q", replicas=2)], total_pages=4 * N_TABLES)
    vocab = side.cfg("q").vocab_size
    r0, r1 = (fleet.submit(model="q", prompt=prompt_for(vocab, i),
                           max_new_tokens=2) for i in range(2))
    assert {fleet.route(r0)[1], fleet.route(r1)[1]} == {0, 1}
    errs = [_raised(lambda: fleet.submit(model="x",
                                         prompt=prompt_for(vocab, 0))),
            _raised(lambda: fleet.home_replica("x", "s"))]
    assert "unknown model 'x'" in errs[0][1]
    fleet.run()
    return {**_state(fleet), "errors": errs}


def _affinity(side):
    """Turn 2 of a session lands on the replica that served turn 1 and
    hits that replica's prefix cache."""
    fleet = side.fleet([side.fm("q", replicas=2)], total_pages=6 * N_TABLES)
    vocab = side.cfg("q").vocab_size
    t1 = {}
    for s in range(2):
        prompt = prompt_for(vocab, s, n=6)  # > page_size: full page cached
        t1[s] = (fleet.submit(model="q", prompt=prompt, max_new_tokens=3,
                              session_id=f"s{s}"), prompt)
    done = fleet.run()
    homes = {s: fleet.home_replica("q", f"s{s}") for s in range(2)}
    assert set(homes.values()) == {0, 1}
    for s in range(2):
        rid1, prompt = t1[s]
        follow = np.concatenate(
            [prompt, np.asarray(done[rid1].generated, np.int32),
             prompt_for(vocab, 9 + s, n=2)])
        rid2 = fleet.submit(model="q", prompt=follow, max_new_tokens=2,
                            session_id=f"s{s}")
        assert fleet.route(rid2) == ("q", homes[s])
    fleet.run()
    for s in range(2):
        home = fleet.group("q").engines[homes[s]]
        assert any(k == "prefix_hit" for (_, k, _) in home.trace), s
        assert home.metrics.cached_prompt_tokens > 0
    assert fleet.metrics_snapshot()["models"]["q"]["prefix_hit_rate"] > 0
    return _state(fleet)


def _slo_aware(side):
    """Premium backlog leads the key: a standard request steers away from
    a replica with a queued premium request, a premium one lands on the
    shortest premium line; with no premium traffic the policy is
    least-loaded.  Routing is decided at submit, before any step."""
    out = {}
    for selection in ("slo-aware", "least-loaded"):
        fleet = side.fleet([side.fm("q", replicas=2)],
                           total_pages=4 * N_TABLES, selection=selection,
                           admission="slo")
        vocab = side.cfg("q").vocab_size
        rids = [fleet.submit(model="q", prompt=prompt_for(vocab, i),
                             max_new_tokens=2, priority=p)
                for i, p in enumerate(("premium", "standard", "premium",
                                       "standard"))]
        out[selection] = [fleet.route(r)[1] for r in rids]
    assert out == {"slo-aware": [0, 1, 1, 0], "least-loaded": [0, 1, 0, 1]}
    return out


def _precision(side):
    """A precision-floored class routes only to replicas whose pool
    meets it, and the floor beats session affinity; the quantized
    replica's cheaper pages buy it a larger pool from the same bytes."""
    fleet = side.fleet([side.fm("q", replicas=2, kv_dtype=["fp8", None])],
                       total_pages=64, max_seq_len=32, prefill_chunk=8,
                       class_precision={"premium": "f32"},
                       selection="round-robin")
    e_q, e_full = fleet.group("q").engines
    assert (e_q.kv_dtype, e_full.kv_dtype) == ("fp8", "f32")
    assert e_q.policy.bm.capacity > e_full.policy.bm.capacity
    a = fleet.submit(model="q", prompt=[1, 2], max_new_tokens=2,
                     session_id="s1")
    assert fleet.route(a) == ("q", 0)       # pinned to the fp8 replica
    b = fleet.submit(model="q", prompt=[1, 2], max_new_tokens=2,
                     session_id="s1", priority="premium")
    assert fleet.route(b) == ("q", 1)       # floor beats the pin
    prem = [fleet.submit(model="q", prompt=[1, 2, 3], max_new_tokens=2,
                         priority="premium") for _ in range(2)]
    assert all(fleet.route(r) == ("q", 1) for r in prem)
    fleet.run()
    u = fleet.budget.usage()
    assert all(e["bytes_in_use"] == 0 for e in u["engines"].values())
    return {**_state(fleet), "usage": u}


@pytest.mark.parametrize("scenario", [_round_robin, _least_loaded,
                                      _affinity, _slo_aware, _precision],
                         ids=lambda f: f.__name__.strip("_"))
def test_routing_equal_jax(models, scenario):
    """Each routing claim holds on the port, whose routes, per-engine
    flat traces and streams equal the JAX fleet's."""
    sides = _sides(models)
    assert scenario(sides["torch"]) == scenario(sides["jax"])


# ---------------------------------------------------------------------------
# rid namespacing: sampler isolation, replay stability, routing invariance
# ---------------------------------------------------------------------------

def _namespaced(side, p):
    fleet = side.fleet([side.fm("q", replicas=2)], total_pages=4 * N_TABLES,
                       selection="round-robin")
    rids = [fleet.submit(model="q", prompt=p, max_new_tokens=5,
                         sampling=side.stoch) for _ in range(2)]
    done = fleet.run()
    assert rids == [0, 1]
    assert {fleet.route(r)[1] for r in rids} == {0, 1}
    return {r: q.generated for r, q in done.items()}


def test_raw_rid_collision_vs_fleet_namespacing(models):
    """Two same-seed engines with overlapping raw rids emit the same
    stochastic stream for the same prompt; through a fleet the two
    submissions get distinct fleet-global rids: independent streams, each
    replayed bit for bit by a fresh fleet, by a solo engine and by the
    JAX fleet."""
    sides = _sides(models)
    side = sides["torch"]
    p = prompt_for(side.cfg("q").vocab_size, 0)
    a, b = side.engine("q", num_pages=17), side.engine("q", num_pages=17)
    for eng in (a, b):
        eng.submit(p, max_new_tokens=5, sampling=side.stoch)
        eng.run()
    assert a.finished[0].rid == b.finished[0].rid == 0
    assert a.finished[0].generated == b.finished[0].generated
    done = _namespaced(side, p)
    assert done[0] != done[1]               # independent streams
    assert _namespaced(side, p) == done     # replay-stable
    assert side.solo("q", [(0, p, 5), (1, p, 5)]) == done
    assert _namespaced(sides["jax"], p) == done


class SeededSelection:
    """Deterministic 'random' replica selection for the fuzz."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)

    def select(self, group):
        return int(self.rng.integers(0, len(group.engines)))


def _fuzz_stream(models):
    rng = np.random.default_rng(3)
    stream = []
    for i in range(8):
        key = "q" if rng.random() < 0.7 else "l"
        vocab = models[key]["torch"][0].vocab_size
        stream.append((key, prompt_for(vocab, i, n=int(rng.integers(3, 9))),
                       int(rng.integers(2, 6))))
    return stream


def _fuzz_run(side, stream, schedule_seed):
    fleet = side.fleet([side.fm("q", replicas=2), side.fm("l")],
                       total_pages=6 * N_TABLES,
                       selection=SeededSelection(schedule_seed))
    rids = [fleet.submit(model=m, prompt=p, max_new_tokens=g,
                         sampling=side.stoch) for m, p, g in stream]
    done = fleet.run()
    return {r: done[r].generated for r in rids}


def test_fuzz_random_routing_token_identical_to_solo_and_jax(models):
    """Any routing schedule gives the per-rid stochastic streams of
    dedicated solo engines fed the same (rid, prompt) pairs, and of the
    JAX fleet."""
    stream = _fuzz_stream(models)
    sides = _sides(models)
    port = [_fuzz_run(sides["torch"], stream, seed) for seed in (0, 1)]
    assert port[0] == port[1]
    solo = {}
    for key in ("q", "l"):
        solo.update(sides["torch"].solo(
            key, [(rid, p, g) for rid, (m, p, g) in enumerate(stream)
                  if m == key]))
    assert port[0] == solo
    assert port[0] == _fuzz_run(sides["jax"], stream, 1)


# ---------------------------------------------------------------------------
# Shared budget at fleet level, observability, stalls
# ---------------------------------------------------------------------------

def test_surplus_borrowing_vs_static_split(models):
    """With minimal floors the busy model's engine climbs past its floor
    into the surplus; a zero-surplus static split pins it at the floor;
    same tokens either way."""
    side = Side("torch", models)
    total = 4 * N_TABLES
    vocab = side.cfg("q").vocab_size

    def run(floors):
        fleet = side.fleet([side.fm("q", floor=floors[0]),
                            side.fm("l", floor=floors[1])],
                           total_pages=total)
        for i in range(5):
            fleet.submit(model="q", prompt=prompt_for(vocab, i),
                         max_new_tokens=8)
        done = fleet.run()
        return (fleet.group("q").engines[0].metrics.peak_pages_in_use,
                {r: q.generated for r, q in done.items()})

    shared_peak, shared_out = run((N_TABLES, N_TABLES))
    static_peak, static_out = run((total // 2, total // 2))
    assert shared_peak > N_TABLES
    assert static_peak <= total // 2
    assert shared_out == static_out


def _observed(side, tmp_path):
    """A forced stall (one fleet tick for four requests) on a fleet with
    telemetry and a virtual clock advanced per tick, then the run to its
    end; returns the stall message, the postmortem, the ``fleet_tick``
    heartbeats and the metrics snapshot."""
    clock = VirtualClock()
    path = tmp_path / f"{side.pkg}.json"
    tel = side.Telemetry(ring=256, heartbeat_every=2,
                         postmortem_path=str(path))
    fleet = side.fleet([side.fm("q", replicas=2), side.fm("l")],
                       total_pages=6 * N_TABLES, clock=clock, telemetry=tel)
    for i in range(4):
        key = "q" if i % 2 else "l"
        fleet.submit(model=key, prompt=prompt_for(side.cfg(key).vocab_size,
                                                  i), max_new_tokens=3,
                     priority=("standard", "batch")[i // 2])
    with pytest.raises(side.Stall) as e:
        fleet.run(max_ticks=1)
    clock.advance(DT)
    while fleet.pending():
        fleet.step()
        clock.advance(DT)
    beats = [(ev.tick, ev.engine, ev.attrs) for ev in tel.events()
             if ev.kind == "fleet_tick"]
    return {"message": str(e.value), "postmortem": json.loads(
        path.read_text()), "heartbeats": beats,
        "metrics": fleet.metrics_snapshot(), "state": _state(fleet)}


def test_fleet_stall_metrics_and_heartbeats_equal_jax(models, tmp_path):
    """Under one injected clock: the stall message names each stalled
    request as ``model/replica:rid(priority)``, the fleet postmortem
    names every engine and holds the budget block, the stride-gated
    ``fleet_tick`` heartbeats cover every engine, and the whole
    ``metrics_snapshot()`` (per model, per replica, fleet, budget) — all
    equal to the JAX fleet's."""
    sides = _sides(models)
    got = _observed(sides["torch"], tmp_path)
    assert got == _observed(sides["jax"], tmp_path)
    assert got["message"].endswith(
        "exhausted max_ticks=1 with 4 requests pending: q/0:1(standard), "
        "q/1:3(batch), l/0:0(standard), l/0:2(batch)")
    pm = got["postmortem"]
    assert set(pm["engines"]) == {"q/0", "q/1", "l/0"}
    assert set(pm["budget"]["engines"]) == \
        {"('q', 0)", "('q', 1)", "('l', 0)"}
    assert pm["budget"]["total_pages"] == 6 * N_TABLES
    ticks = sorted({t for t, _, _ in got["heartbeats"]})
    assert ticks and all(t % 2 == 0 for t in ticks)
    assert len(got["heartbeats"]) == 3 * len(ticks)
    m = got["metrics"]
    assert set(m["models"]) == {"q", "l"} and m["fleet"]["completed"] == 4
    assert m["models"]["q"]["completed"] + m["models"]["l"]["completed"] == 4
    assert len(m["models"]["q"]["replicas"]) == 2
    assert m["fleet"]["tokens_per_s"] > 0 and m["ticks"] == ticks[-1] + 1


# ---------------------------------------------------------------------------
# The _init_model_state contract: a model-free policy, as the reference's
# OraclePolicy, on the port's PagedPolicy
# ---------------------------------------------------------------------------

class PortOracle(PagedPolicy):
    """The reference's ``OraclePolicy`` bodies on the port's
    ``PagedPolicy``: no weights, no pool, no graph; hash logits from the
    reference's ``OracleModel`` and the port's batched host sampler."""

    vocab = 64

    def _init_model_state(self, num_pages):
        self.cache = None
        self._cow_fn = lambda cache, src, dst: cache
        self.model = OracleModel(self.vocab)

    def prefill_tick(self):
        sched = self.sched
        cands = [r for r in sched.seats.values()
                 if r.prefill_pos < len(r.prefill_src)]
        if not cands:
            return
        req = min(cands, key=lambda r: r.rid)
        src = req.prefill_src
        c = min(self.prefill_chunk, len(src) - req.prefill_pos)
        req.prefill_pos += c
        sched.metrics.prefill_tokens += c
        sched._trace("prefill_chunk", req.rid)
        self._register_full_pages(req)
        if req.prefill_pos == len(src):
            self.pos[req.slot] = len(src)
            self._dirty = True
            if req.resume_tokens is None:
                row = self.model.logits_row(req.rid, 0, int(src[-1]))
                sched._emit_first_tokens([(req, row)])

    def decode_tick(self):
        sched = self.sched
        if self.lazy:
            self._grow_tick()
        decoding = self._decoding_seats()
        if not decoding:
            return
        reqs = [sched.seats[s] for s in decoding]
        rids = np.asarray([r.rid & _MASK32 for r in reqs], np.uint32)
        steps = np.asarray([len(r.generated) & _MASK32 for r in reqs],
                           np.uint32)
        last = np.asarray([r.generated[-1] & _MASK32 for r in reqs],
                          np.uint32)
        logits = self.model.logits_batch(rids, steps, last)
        toks = sample_tokens_np(
            logits,
            np.asarray([r.sampling.temperature for r in reqs], np.float32),
            np.asarray([r.sampling.top_k for r in reqs], np.int32),
            np.asarray([r.sampling.top_p for r in reqs], np.float32),
            np.asarray([r.sampling.seed & _MASK32 for r in reqs], np.uint32),
            rids, steps)
        for i, s in enumerate(decoding):
            self.pos[s] += 1
            sched._emit_decode_token(reqs[i], int(toks[i]))


def _port_events(events):
    """The workload with the port's SamplingParams."""
    return [dataclasses.replace(e, sampling=TSamplingParams(
        **dataclasses.asdict(e.sampling))) for e in events]


def test_model_free_policy_engine_equals_reference_oracle():
    """``PagedServingEngine(policy_cls=...)`` with ``params=None`` on the
    CPU (which raised before the contract was repaired) gives the
    reference oracle engine's trace, streams and metrics, through
    prefix hits and copy-on-write, preemption and SLO admission."""
    spec = WorkloadSpec(requests=60, max_total_len=64, prefix_len=16,
                        prompt_median=12, out_median=6)
    events = generate_workload(spec, seed=5)
    out = {}
    for pkg, cls, evs in (("jax", (JPaged, OraclePolicy), events),
                          ("torch", (TPaged, PortOracle),
                           _port_events(events))):
        eng_cls, policy = cls
        kw = {"device": "cpu"} if pkg == "torch" else {}
        eng = eng_cls(reduced_config(get_config("qwen3-1.7b")) if pkg == "jax"
                      else treduced(tget("qwen3-1.7b")), None, page_size=8,
                      num_pages=16, max_seats=4, max_seq_len=64,
                      prefill_chunk=16, admission="slo", clock=VirtualClock(),
                      policy_cls=policy, **kw)
        assert eng.policy.cache is None and eng.params is None
        for e in evs:
            eng.submit(e.prompt, max_new_tokens=e.max_new_tokens,
                       priority=e.priority, deadline_ms=e.deadline_ms,
                       tbt_deadline_ms=e.tbt_deadline_ms,
                       sampling=e.sampling)
        eng.run()
        out[pkg] = (eng.trace, {r.rid: r.generated for r in eng.finished},
                    eng.metrics.snapshot())
    assert out["torch"] == out["jax"]
    kinds = {k for _, k, _ in out["torch"][0]}
    assert {"prefix_hit", "preempt"} <= kinds
    assert out["torch"][2]["completed"] == 60


def _port_oracle_fleet(spec, *, replicas, total_pages, clock):
    """``oracle_fleet``'s fleet, built from the port."""
    cfg = treduced(tget("qwen3-1.7b"))
    models = [trouter.FleetModel(name=m, cfg=cfg, params=None,
                                 replicas=replicas) for m in spec.models]
    return trouter.ModelFleet(
        models, total_pages=total_pages, page_size=8, max_seats=8,
        max_seq_len=spec.max_total_len, prefill_chunk=32,
        selection="slo-aware", admission="slo", aging_ticks=64, clock=clock,
        record_trace=True, policy_cls=PortOracle, device="cpu")


def test_oracle_fleet_equals_reference_oracle_fleet():
    """``ModelFleet(policy_cls=...)`` of model-free engines against the
    reference's ``oracle_fleet``, both driven by the load harness's
    ``drive_workload`` on a virtual clock over 400 requests of two models
    on two replicas each, with a budget that binds: flat traces,
    finished streams, routes, budget state and ``metrics_snapshot()``
    exactly equal."""
    spec = WorkloadSpec(requests=400, models=("m0", "m1"),
                        arrival_rate=250.0)
    events = generate_workload(spec, seed=1)
    out = {}
    for pkg in ("jax", "torch"):
        clock = VirtualClock()
        if pkg == "jax":
            fleet = oracle_fleet(spec, replicas=2, total_pages=104,
                                 clock=clock, record_trace=True)
            evs = events
        else:
            fleet = _port_oracle_fleet(spec, replicas=2, total_pages=104,
                                       clock=clock)
            evs = _port_events(events)
        res = drive_workload(fleet, evs, clock, invariant_interval=32)
        assert res.invariant_violations == []
        out[pkg] = (_state(fleet), fleet.metrics_snapshot(), res.ticks,
                    res.virtual_s, res.token_digest)
    assert out["torch"] == out["jax"]
    state, snap = out["torch"][:2]
    assert sorted(state["streams"]) == list(range(400))
    assert snap["fleet"]["preemptions"] > 0
    floor = spec.max_total_len // 8
    assert any(rep["peak_pages_in_use"] > floor             # borrowed
               for m in snap["models"].values() for rep in m["replicas"])
