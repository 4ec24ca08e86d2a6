"""The port's one-dispatch decode tick against the JAX engine's: reduced
qwen3-1.7b with f32 compute and JAX-initialized weights carried across,
the port on the CPU, where the steps that a CUDA device captures as
graphs run eagerly over the same fixed buffers.

The contract of the reference's ``tests/test_fused_tick.py``, held across
the two packages: the fused tick (``fused=True``) and the pre-fusion
per-tick path (``fused=False``, host-side sampling) give identical token
streams and flat traces, with mixed sampling and under preemption (also
on an fp8 pool), and equal to JAX's in both modes; churn never rebinds
the fixed device buffers; the device state is synced on churn only; and
each mode runs only its own decode step.
"""
import jax
import numpy as np
import pytest

from repro.configs import get_config, reduced_config
from repro.models import model as JM
from repro.runtime.sampler import SamplingParams as JSamplingParams
from repro.runtime.serving import PagedServingEngine as JEngine
from repro_torch.configs import get_config as tget
from repro_torch.configs import reduced_config as treduced
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_jax
from repro_torch.runtime import serving as tserving
from repro_torch.runtime.sampler import SamplingParams as TSamplingParams
from repro_torch.runtime.serving import PagedServingEngine as TEngine


@pytest.fixture(scope="module")
def setup():
    cfg = reduced_config(get_config("qwen3-1.7b"), compute_dtype="float32")
    jp = JM.init_params(JM.param_specs(cfg), jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    tcfg = treduced(tget("qwen3-1.7b"), compute_dtype="float32")
    return cfg, jp, tcfg, tp


def _mixed_sampling(n):
    """Alternating greedy / temperature / top-k / top-p, as dicts."""
    variants = [dict(),
                dict(temperature=0.8, seed=11),
                dict(temperature=1.2, top_k=7, seed=22),
                dict(temperature=0.7, top_p=0.85, seed=33)]
    return [variants[i % len(variants)] for i in range(n)]


def _mixed_workload(vocab):
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, vocab, int(n)).astype(np.int32)
               for n in rng.integers(3, 20, size=6)]
    gens = [int(g) for g in rng.integers(2, 9, size=6)]
    kw = dict(page_size=8, num_pages=16, max_seats=2, max_seq_len=32,
              prefill_chunk=4)
    return prompts, gens, _mixed_sampling(6), kw


def _preempt_workload(vocab):
    prompts = [(np.arange(8, dtype=np.int32) * (3 + 4 * k)) % vocab
               for k in range(2)]
    sps = [dict(temperature=0.9, seed=5),
           dict(temperature=1.1, top_k=11, seed=6)]
    kw = dict(page_size=4, num_pages=8, max_seats=2, max_seq_len=28,
              prefill_chunk=8)
    return prompts, [20, 20], sps, kw


def _run(eng, sp_cls, prompts, gens, sps):
    for p, g, sp in zip(prompts, gens, sps):
        eng.submit(p, max_new_tokens=g, sampling=sp_cls(**sp))
    eng.run()
    return {r.rid: list(r.generated) for r in eng.finished}


SCENARIOS = {"mixed": (_mixed_workload, None),
             "preempt": (_preempt_workload, None),
             "preempt-fp8": (_preempt_workload, "fp8")}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_fused_and_per_tick_match_jax(setup, scenario):
    """JAX and the port, each with ``fused=True`` and ``fused=False``, on
    the same submissions: four identical token streams and traces (and
    preemption counts, above 0 in the preemption scenarios)."""
    cfg, jp, tcfg, tp = setup
    make, kv_dtype = SCENARIOS[scenario]
    prompts, gens, sps, kw = make(cfg.vocab_size)
    kw = dict(kw, kv_dtype=kv_dtype)
    engines = {}
    for fused in (True, False):
        engines["jax", fused] = (JEngine(cfg, jp, fused=fused, **kw),
                                 JSamplingParams)
        engines["torch", fused] = (TEngine(tcfg, tp, fused=fused,
                                           device="cpu", **kw),
                                   TSamplingParams)
    streams = {key: _run(eng, sp_cls, prompts, gens, sps)
               for key, (eng, sp_cls) in engines.items()}
    want = streams["jax", True]
    assert len(want) == len(prompts)
    jtrace = engines["jax", True][0].trace
    preempted = engines["jax", True][0].metrics.preemptions
    for key, (eng, _) in engines.items():
        assert streams[key] == want, key
        assert eng.trace == jtrace, key
        assert eng.metrics.preemptions == preempted, key
    if scenario.startswith("preempt"):
        assert preempted > 0
    pol = engines["torch", True][0].policy
    assert pol._tick_fn.graph is None           # the CPU runs eagerly
    assert bool(pol.logits_finite)


def _buffers(pol):
    """Every fixed device tensor of a paged policy, by name."""
    out = {f"state.{k}": t for k, t in pol._dev.items()}
    out.update({f"prefill.{k}": t for k, t in pol._prefill.dev.items()})
    out.update({f"cache.{p}.{k}": t for p, ent in pol.cache.items()
                for k, t in ent.items()})
    out["logits_finite"] = pol.logits_finite
    return out


@pytest.mark.parametrize("fused", [True, False])
def test_churn_never_rebinds_buffers(setup, fused):
    """Admission, prefill, finish and preemption leave every fixed buffer
    in place: the same tensor at the same address as after
    ``_init_model_state``."""
    _, _, tcfg, tp = setup
    prompts, gens, sps, kw = _preempt_workload(tcfg.vocab_size)
    eng = TEngine(tcfg, tp, fused=fused, device="cpu", **kw)
    before = {k: (t, t.data_ptr()) for k, t in _buffers(eng.policy).items()}
    _run(eng, TSamplingParams, prompts, gens, sps)
    assert eng.metrics.preemptions > 0 and len(eng.finished) == 2
    after = _buffers(eng.policy)
    assert after.keys() == before.keys()
    for k, (t, ptr) in before.items():
        assert after[k] is t and t.data_ptr() == ptr, k


def _sync_count(eng, monkeypatch):
    calls = {"n": 0}
    orig = eng.policy._sync_device

    def counting():
        calls["n"] += 1
        orig()
    monkeypatch.setattr(eng.policy, "_sync_device", counting)
    return calls


def test_sync_only_on_churn(setup, monkeypatch):
    """One request decoding 30 tokens: the device state is refilled on
    churn only (admission and prefill completion, one lazy page growth
    per page boundary), fewer than 10 times, as often as JAX's engine
    refills its mirrors."""
    cfg, jp, tcfg, tp = setup
    kw = dict(page_size=8, num_pages=16, max_seats=2, max_seq_len=64,
              prefill_chunk=8)
    counts = {}
    for name, eng in (("jax", JEngine(cfg, jp, **kw)),
                      ("torch", TEngine(tcfg, tp, device="cpu", **kw))):
        calls = _sync_count(eng, monkeypatch)
        eng.submit(np.arange(8, dtype=np.int32), max_new_tokens=30)
        done = eng.run()
        assert len(done) == 1 and len(done[0].generated) == 30
        counts[name] = calls["n"]
    assert counts["torch"] < 10
    assert counts["torch"] == counts["jax"]


@pytest.mark.parametrize("fused", [True, False])
def test_each_mode_runs_its_own_step(setup, monkeypatch, fused):
    """``fused=True`` runs every decode tick through the fused tick and
    never the unfused step or the host sampler; ``fused=False`` never
    runs the fused tick, and runs one unfused step and one host sampling
    per decode tick."""
    _, _, tcfg, tp = setup
    prompts, gens, sps, kw = _mixed_workload(tcfg.vocab_size)
    n = {"fused": 0, "unfused": 0, "host_sample": 0, "inside": False}
    fused_tick, step = TM.fused_decode_tick, TM.paged_decode_step
    sample = tserving.Scheduler._sample_decode_batch

    def counting_tick(*a, **k):
        n["fused"] += 1
        n["inside"] = True
        try:
            return fused_tick(*a, **k)
        finally:
            n["inside"] = False

    def counting_step(params, cfg, cache, tokens, *a, **k):
        if tokens.shape[1] == 1 and not n["inside"]:
            n["unfused"] += 1
        return step(params, cfg, cache, tokens, *a, **k)

    def counting_sample(self, *a, **k):
        n["host_sample"] += 1
        return sample(self, *a, **k)
    monkeypatch.setattr(TM, "fused_decode_tick", counting_tick)
    monkeypatch.setattr(TM, "paged_decode_step", counting_step)
    monkeypatch.setattr(tserving.Scheduler, "_sample_decode_batch",
                        counting_sample)
    eng = TEngine(tcfg, tp, fused=fused, device="cpu", **kw)
    _run(eng, TSamplingParams, prompts, gens, sps)
    ticks = eng.policy.decode_ticks
    assert ticks > 0
    if fused:
        assert (n["fused"], n["unfused"], n["host_sample"]) == (ticks, 0, 0)
    else:
        assert (n["fused"], n["unfused"], n["host_sample"]) == (
            0, ticks, ticks)
