"""minicpm-2b (reduced: 2 layers, 4 heads over 4 of 64, a tied embedding
of 251 rows, f32 compute) on the port's two serving engines against the
JAX package's, on the CPU, with JAX-initialized weights carried across by
``params_from_jax``; then ``serve --arch minicpm-2b --device cpu`` on
both engines.

The paged engine, fused and per-tick, over: prefix sharing with
copy-on-write of a partial page, greedy and sampled; a lazy-growth
preemption with its replay, greedy and sampled; both on an fp8 pool.
The fixed-slot engine over more requests than slots (slot reuse),
greedy and sampled.  Streams, flat traces and the engines' counters are
compared exactly, as in ``test_torch_serving.py``: the logits differ
from JAX's by ~1e-6 (``test_torch_minicpm.py``), which could flip a
greedy near-tie; none occurs on these submissions.  Every sampled
token is drawn over the odd 251-wide row.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced_config
from repro.models import model as JM
from repro.runtime.sampler import SamplingParams as JSamplingParams
from repro.runtime.serving import PagedServingEngine as JPaged
from repro.runtime.serving import ServingEngine as JFixed
from repro_torch.configs import get_config as tget
from repro_torch.configs import reduced_config as treduced
from repro_torch.kernels import ops as tops
from repro_torch.models.convert import params_from_jax
from repro_torch.runtime.sampler import SamplingParams as TSamplingParams
from repro_torch.runtime.serving import PagedServingEngine as TPaged
from repro_torch.runtime.serving import ServingEngine as TFixed

ARCH = "minicpm-2b"
SMALL = dict(vocab_size=251, head_dim=64)
STOCHASTIC = dict(temperature=0.8, top_p=0.9, seed=11)


@pytest.fixture(scope="module")
def setup():
    cfg = reduced_config(get_config(ARCH), compute_dtype="float32", **SMALL)
    tcfg = treduced(tget(ARCH), compute_dtype="float32", **SMALL)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(tcfg)
    jp = JM.init_params(JM.param_specs(cfg), jax.random.PRNGKey(0))
    return cfg, tcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp))


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


def _events(eng, kind):
    return [r for (_, k, r) in eng.trace if k == kind]


def _prefix_reqs(vocab):
    """A 16-token base prompt, an extension of it, an exact repeat, a
    prompt sharing its first 8 tokens and a cold one; the base ends in
    token 250, the vocabulary's last row."""
    rng = np.random.default_rng(17)
    base = rng.integers(0, vocab, 16).astype(np.int32)
    base[-1] = vocab - 1
    extra = [rng.integers(0, vocab, n).astype(np.int32) for n in (5, 3, 7)]
    return [dict(prompt=base, max_new_tokens=5),
            dict(prompt=np.concatenate([base, extra[0]]), max_new_tokens=4),
            dict(prompt=base.copy(), max_new_tokens=5),
            dict(prompt=np.concatenate([base[:8], extra[1]]),
                 max_new_tokens=3),
            dict(prompt=extra[2], max_new_tokens=4)]


def _preempt_reqs(vocab):
    return [dict(prompt=(np.arange(8, dtype=np.int32) * 3) % vocab,
                 max_new_tokens=10),
            dict(prompt=(np.arange(8, dtype=np.int32) * 7) % vocab,
                 max_new_tokens=10)]


# (requests, stagger, engine arguments)
SCENARIOS = {
    "prefix": (_prefix_reqs, 3, dict(page_size=8, num_pages=24, max_seats=3,
                                     max_seq_len=32, prefill_chunk=8)),
    "preempt": (_preempt_reqs, 0, dict(page_size=4, num_pages=7,
                                       max_seats=2, max_seq_len=24,
                                       prefill_chunk=8)),
}


_JAX_RUNS = {}


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "per-tick"])
@pytest.mark.parametrize("kv_dtype", [None, "fp8"])
@pytest.mark.parametrize("sampling", [None, STOCHASTIC],
                         ids=["greedy", "sampled"])
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_paged_engine_matches_jax(setup, scenario, sampling, kv_dtype,
                                  fused):
    """The port's paged engine against JAX's (fused): streams, trace,
    preemptions, cached prompt tokens and token counts equal; the prefix
    scenario hits the cache and copies a partial page on write, the
    preemption one preempts and replays; every page back in the pool."""
    cfg, tcfg, jp, tp = setup
    make, stagger, kw = SCENARIOS[scenario]
    reqs = make(cfg.vocab_size)
    kw = dict(kw, kv_dtype=kv_dtype)
    key = (scenario, sampling is None, kv_dtype)
    if key not in _JAX_RUNS:                   # one JAX run for both modes
        jeng = JPaged(cfg, jp, **kw)
        _JAX_RUNS[key] = (_drive(jeng, JSamplingParams, reqs, sampling,
                                 stagger), jeng)
    want, jeng = _JAX_RUNS[key]
    teng = TPaged(tcfg, tp, fused=fused, device="cpu", **kw)
    copies, cow = [], teng.policy._cow_fn
    teng.policy._cow_fn = lambda c, src, dst: (copies.append((src, dst)),
                                               cow(c, src, dst))[1]
    got = _drive(teng, TSamplingParams, reqs, sampling, stagger)
    assert len(got) == len(reqs)
    assert got == want
    assert teng.trace == jeng.trace
    for name in ("preemptions", "cached_prompt_tokens", "prefill_tokens",
                 "decode_tokens", "completed"):
        assert getattr(teng.metrics, name) == getattr(jeng.metrics, name), \
            name
    assert teng.bm.in_use == 0 and teng.bm.available == teng.bm.capacity
    assert all(0 <= t < 251 for g in got.values() for t in g)
    if scenario == "prefix":
        assert teng.metrics.cached_prompt_tokens > 0
        assert _events(teng, "prefix_hit") and copies   # a partial page
    else:
        assert teng.metrics.preemptions >= 1
        assert set(_events(teng, "preempt")) == {1}
    if kv_dtype == "fp8":
        assert teng.cache["pos0"]["k"].dtype == torch.uint8


@pytest.mark.parametrize("sampling", [None, STOCHASTIC],
                         ids=["greedy", "sampled"])
def test_fixed_slot_engine_matches_jax_with_slot_reuse(setup, sampling):
    """Six requests of three prompt lengths through 2 slots, one engine
    step between submissions: streams, trace, write positions and
    counters equal to JAX's engine; every slot served more than one
    request."""
    cfg, tcfg, jp, tp = setup
    rng = np.random.default_rng(9)
    reqs = [dict(prompt=rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                 max_new_tokens=3 + i % 3)
            for i, n in enumerate((7, 12, 19, 7, 12, 19))]
    kw = dict(slots=2, max_len=40)
    jeng = JFixed(cfg, jp, **kw)
    teng = TFixed(tcfg, tp, device="cpu", **kw)
    want = _drive(jeng, JSamplingParams, reqs, sampling, 1)
    got = _drive(teng, TSamplingParams, reqs, sampling, 1)
    assert len(got) == len(reqs) and got == want
    assert teng.trace == jeng.trace
    np.testing.assert_array_equal(teng.pos, np.asarray(jeng.pos))
    for key in ("prefill_tokens", "decode_tokens", "completed", "admitted"):
        assert getattr(teng.metrics, key) == getattr(jeng.metrics, key), key
    assert len(_events(teng, "admit")) == 6 > kw["slots"]


@pytest.mark.parametrize("engine", ["paged", "batch"])
def test_serve_cli_minicpm_on_cpu(engine, capsys):
    """``serve --arch minicpm-2b --device cpu`` (the reduced config) on
    both engines; no kernel launches on the CPU."""
    from repro_torch.launch.serve import main
    tops.reset_launches()
    main(["--arch", ARCH, "--device", "cpu", "--engine", engine,
          "--requests", "4", "--gen", "6", "--batch", "2",
          "--prompt-len", "24"])
    out = capsys.readouterr().out
    assert ("[serve.paged]" if engine == "paged" else "throughput=") in out
    assert "device=cpu" in out or engine == "batch"
    assert not any(tops.launches.values())
