"""The port's PagedServingEngine against the JAX PagedServingEngine on the
same submissions: reduced qwen3-1.7b with f32 compute and JAX-initialized
weights carried across, the port on the CPU.  Per-rid token streams and
the flat ``(tick, event, rid)`` trace must be identical, greedy and
stochastic, in four scenarios: prefix-cache copy-on-write, lazy growth
with preemption replay, an fp8 pool, and SLO admission.

Every stream below compares token for token.  The logits differ from
JAX's by ~1e-6 (f32 sums in another order), which could flip a greedy
near-tie; none occurs on these submissions, so no position is exempted
(docs/benchmarks.md §"Greedy agreement" describes the decided-position
comparison a flip would call for).
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced_config
from repro.models import model as JM
from repro.runtime.sampler import SamplingParams as JSamplingParams
from repro.runtime.serving import PagedServingEngine as JEngine
from repro_torch.configs import get_config as tget
from repro_torch.configs import reduced_config as treduced
from repro_torch.models.convert import params_from_jax
from repro_torch.runtime.sampler import SamplingParams as TSamplingParams
from repro_torch.runtime.serving import PagedServingEngine as TEngine

STOCHASTIC = dict(temperature=0.8, top_p=0.9, seed=11)


@pytest.fixture(scope="module")
def setup():
    cfg = reduced_config(get_config("qwen3-1.7b"), compute_dtype="float32")
    jp = JM.init_params(JM.param_specs(cfg), jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    tcfg = treduced(tget("qwen3-1.7b"), compute_dtype="float32")
    return cfg, jp, tcfg, tp


def _drive(eng, sp_cls, reqs, sampling, stagger):
    for r in reqs:
        kw = dict(r)
        prompt = kw.pop("prompt")
        sp = kw.pop("sampling", sampling)
        eng.submit(prompt, sampling=None if sp is None else sp_cls(**sp),
                   **kw)
        for _ in range(stagger):
            eng.step()
    eng.run()
    return {r.rid: list(r.generated) for r in eng.finished}


def _pair(setup, reqs, *, sampling=None, stagger=0, **kw):
    cfg, jp, tcfg, tp = setup
    jeng = JEngine(cfg, jp, **kw)
    teng = TEngine(tcfg, tp, device="cpu", **kw)
    jout = _drive(jeng, JSamplingParams, reqs, sampling, stagger)
    tout = _drive(teng, TSamplingParams, reqs, sampling, stagger)
    assert tout == jout
    assert teng.trace == jeng.trace
    for key in ("preemptions", "cached_prompt_tokens", "prefill_tokens",
                "decode_tokens", "completed"):
        assert getattr(teng.metrics, key) == getattr(jeng.metrics, key), key
    assert teng.bm.in_use == 0 and teng.bm.available == teng.bm.capacity
    return jeng, teng


def _events(eng, kind):
    return [r for (_, k, r) in eng.trace if k == kind]


def _prefix_workload(vocab):
    rng = np.random.default_rng(17)
    base = rng.integers(0, vocab, 16).astype(np.int32)
    extra = [rng.integers(0, vocab, n).astype(np.int32) for n in (5, 3, 7)]
    return [dict(prompt=base, max_new_tokens=5),
            dict(prompt=np.concatenate([base, extra[0]]), max_new_tokens=4),
            dict(prompt=base.copy(), max_new_tokens=5),     # exact repeat
            dict(prompt=np.concatenate([base[:8], extra[1]]),
                 max_new_tokens=3),
            dict(prompt=extra[2], max_new_tokens=4)]        # cold


PREFIX_KW = dict(page_size=8, num_pages=24, max_seats=3, max_seq_len=32,
                 prefill_chunk=8)


@pytest.mark.parametrize("sampling", [None, STOCHASTIC],
                         ids=["greedy", "stochastic"])
def test_prefix_cache_copy_on_write_matches_jax(setup, sampling):
    cfg = setup[0]
    jeng, teng = _pair(setup, _prefix_workload(cfg.vocab_size),
                       sampling=sampling, stagger=3, **PREFIX_KW)
    assert teng.metrics.cached_prompt_tokens > 0
    assert _events(teng, "prefix_hit")


def test_twin_prompt_shares_pages_and_copies_the_partial_one(setup):
    cfg = setup[0]
    prompt = (np.arange(12, dtype=np.int32) * 5) % cfg.vocab_size
    reqs = [dict(prompt=prompt, max_new_tokens=8)] * 2
    _, teng = _pair(setup, reqs, stagger=4, page_size=4, num_pages=16,
                    max_seats=2, max_seq_len=24, prefill_chunk=4)
    gens = {r.rid: r.generated for r in teng.finished}
    assert gens[0] == gens[1]
    b = next(r for r in teng.finished if r.rid == 1)
    assert b.cached_tokens == 11                  # full pages + CoW page


PREEMPT_KW = dict(page_size=4, max_seats=2, max_seq_len=24, prefill_chunk=8)


def _preempt_reqs(vocab):
    return [dict(prompt=(np.arange(8, dtype=np.int32) * 3) % vocab,
                 max_new_tokens=10),
            dict(prompt=(np.arange(8, dtype=np.int32) * 7) % vocab,
                 max_new_tokens=10)]


@pytest.mark.parametrize("sampling", [None, STOCHASTIC],
                         ids=["greedy", "stochastic"])
def test_lazy_growth_preemption_replay_matches_jax(setup, sampling):
    cfg = setup[0]
    _, teng = _pair(setup, _preempt_reqs(cfg.vocab_size), sampling=sampling,
                    num_pages=7, **PREEMPT_KW)
    assert teng.metrics.preemptions >= 1
    assert set(_events(teng, "preempt")) == {1}


@pytest.mark.parametrize("scenario", ["prefix", "preempt"])
def test_fp8_pool_matches_jax(setup, scenario):
    cfg = setup[0]
    if scenario == "prefix":
        _, teng = _pair(setup, _prefix_workload(cfg.vocab_size), stagger=3,
                        kv_dtype="fp8", **PREFIX_KW)
        assert teng.metrics.cached_prompt_tokens > 0
    else:
        _, teng = _pair(setup, _preempt_reqs(cfg.vocab_size),
                        sampling=STOCHASTIC, kv_dtype="fp8", num_pages=7,
                        **PREEMPT_KW)
        assert teng.metrics.preemptions >= 1
    assert teng.kv_dtype == "fp8"
    assert teng.cache["pos0"]["k"].dtype == torch.uint8


@pytest.mark.parametrize("sampling", [None, STOCHASTIC],
                         ids=["greedy", "stochastic"])
def test_slo_admission_matches_jax(setup, sampling):
    """Mixed classes under SLO admission with a short aging bound, on a
    pool tight enough that priority-aware preemption picks victims."""
    cfg = setup[0]
    rng = np.random.default_rng(5)
    prios = ["batch", "standard", "premium", "batch", "premium", "standard"]
    reqs = [dict(prompt=rng.integers(0, cfg.vocab_size,
                                     int(rng.integers(3, 9))).astype(np.int32),
                 max_new_tokens=int(rng.integers(4, 9)), priority=p)
            for p in prios]
    jeng, teng = _pair(setup, reqs, sampling=sampling, admission="slo",
                       aging_ticks=3, page_size=4, num_pages=7, max_seats=2,
                       max_seq_len=20, prefill_chunk=4)
    admits = _events(teng, "admit")
    assert admits[:2] == [2, 4]               # premium first
    assert set(_events(teng, "preempt")) == {3}   # a batch-class victim
    assert teng.metrics.snapshot()["classes"].keys() == \
        jeng.metrics.snapshot()["classes"].keys()
