"""grok-1-314b (reduced: 2 layers, 12 heads over 2 of 16 — a GQA group of
6 —, 4 experts top-2 with no shared expert at the config's own capacity
factor of 1.25, an untied head, f32 compute) on the port's two serving
engines against the JAX package's, on the CPU, with JAX-initialized
weights carried across by ``params_from_jax``; then ``serve --arch
grok-1-314b --device cpu`` on both engines.

The paged engine, fused and per-tick, over: staggered arrivals into 12
seats with capacity drops in decode ticks (24 (token, expert) pairs into
4 experts of 8 slots) and in prefill chunks of 10 (20 pairs into 8
slots), half the requests sampled; prefix sharing with copy-on-write of
a partial page; a lazy-growth preemption with its replay; the last two
on an fp8 pool, with greedy and sampled requests mixed.  The
fixed-slot engine over more requests than slots (slot reuse), with
drops.  Streams, flat traces and the engines' counters are compared
exactly, as in ``test_torch_serving.py``: the logits differ from JAX's
by ~1e-6 (``test_torch_grok.py``), which could flip a greedy near-tie;
none occurs on these submissions.
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
from repro_torch.models import moe as tmoe
from repro_torch.models.convert import params_from_jax
from repro_torch.runtime.sampler import SamplingParams as TSamplingParams
from repro_torch.runtime.serving import PagedServingEngine as TPaged
from repro_torch.runtime.serving import ServingEngine as TFixed

ARCH = "grok-1-314b"
SMALL = dict(num_heads=12, num_kv_heads=2, compute_dtype="float32")
CF = 1.25                  # grok-1-314b's own capacity factor
SEATS, CHUNK = 12, 10
SAMPLING = (None, dict(temperature=0.9, seed=5))


def _cf(cfg):
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=CF))


@pytest.fixture(scope="module")
def setup():
    cfg = _cf(reduced_config(get_config(ARCH), **SMALL))
    tcfg = _cf(treduced(tget(ARCH), **SMALL))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(tcfg)
    assert tcfg.num_heads // tcfg.num_kv_heads == 6
    jp = JM.init_params(JM.param_specs(cfg), jax.random.PRNGKey(0))
    return cfg, tcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp))


@pytest.fixture
def drops(monkeypatch):
    """(T·k, dropped pairs) of every capacity-path call of the port."""
    seen = []
    inner = tmoe._expert_gemms_capacity

    def counting(p, m, xs, sizes, dt):
        C = tmoe.capacity(m, xs.shape[0])
        seen.append((xs.shape[0], int((sizes - C).clamp(min=0).sum())))
        return inner(p, m, xs, sizes, dt)
    monkeypatch.setattr(tmoe, "_expert_gemms_capacity", counting)
    return seen


def _dropped(seen, tk):
    return sum(n for t, n in seen if t == tk)


def _drive(eng, sp_cls, reqs, stagger=0, first_wave=None):
    """Submits ``reqs`` (every second one sampled at temperature 0.9),
    the first ``first_wave`` at once and then one every ``stagger``
    engine steps, and runs to the end."""
    first_wave = len(reqs) if first_wave is None else first_wave
    for i, r in enumerate(reqs):
        sp = SAMPLING[i % 2]
        eng.submit(r["prompt"], max_new_tokens=r["max_new_tokens"],
                   sampling=None if sp is None else sp_cls(**sp))
        if i >= first_wave:
            for _ in range(stagger):
                eng.step()
    eng.run()
    return {r.rid: list(r.generated) for r in eng.finished}


def _events(eng, kind):
    return [r for (_, k, r) in eng.trace if k == kind]


def _requests(vocab, n, lengths=None):
    """``n`` requests of 3-25 prompt tokens (or of ``lengths``, in turn)
    and 2-12 new tokens."""
    rng = np.random.default_rng(3)
    out = []
    for i in range(n):
        k = (int(rng.integers(3, 26)) if lengths is None
             else lengths[i % len(lengths)])
        out.append(dict(prompt=rng.integers(0, vocab, k).astype(np.int32),
                        max_new_tokens=int(rng.integers(2, 13))))
    return out


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "per-tick"])
def test_paged_engine_matches_jax_with_drops(setup, drops, fused):
    """The paged engine over 20 requests, 12 at once and then one every
    other step, half sampled: streams, trace and counters equal to the
    JAX engine's, with capacity drops in decode ticks and in prefill
    chunks."""
    cfg, tcfg, jp, tp = setup
    kw = dict(page_size=4, num_pages=120, max_seats=SEATS, max_seq_len=40,
              prefill_chunk=CHUNK)
    reqs = _requests(cfg.vocab_size, 20)
    jeng = JPaged(cfg, jp, **kw)
    want = _drive(jeng, JSamplingParams, reqs, stagger=2, first_wave=12)
    teng = TPaged(tcfg, tp, fused=fused, device="cpu", **kw)
    got = _drive(teng, TSamplingParams, reqs, stagger=2, first_wave=12)
    assert len(got) == len(reqs) and got == want
    assert teng.trace == jeng.trace
    for name in ("preemptions", "prefill_tokens", "decode_tokens",
                 "completed"):
        assert getattr(teng.metrics, name) == getattr(jeng.metrics, name), \
            name
    assert _dropped(drops, 2 * SEATS) > 0          # decode ticks
    assert _dropped(drops, 2 * CHUNK) > 0          # prefill chunks


def _prefix_reqs(vocab):
    """A 16-token base prompt, an extension of it, an exact repeat, a
    prompt sharing its first 8 tokens and a cold one."""
    rng = np.random.default_rng(17)
    base = rng.integers(0, vocab, 16).astype(np.int32)
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
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_paged_engine_on_an_fp8_pool_matches_jax(setup, scenario, fused):
    """The port's paged engine over an fp8 pool against JAX's (fused),
    with greedy and sampled requests mixed: streams, trace, preemptions,
    cached prompt tokens and token counts equal; the prefix scenario
    hits the cache and copies a partial page on write, the preemption
    one preempts and replays; every page back in the pool."""
    cfg, tcfg, jp, tp = setup
    make, stagger, kw = SCENARIOS[scenario]
    reqs = make(cfg.vocab_size)
    kw = dict(kw, kv_dtype="fp8")
    if scenario not in _JAX_RUNS:                   # one JAX run for both modes
        jeng = JPaged(cfg, jp, **kw)
        _JAX_RUNS[scenario] = (_drive(jeng, JSamplingParams, reqs, stagger,
                                      0), jeng)
    want, jeng = _JAX_RUNS[scenario]
    teng = TPaged(tcfg, tp, fused=fused, device="cpu", **kw)
    copies, cow = [], teng.policy._cow_fn
    teng.policy._cow_fn = lambda c, src, dst: (copies.append((src, dst)),
                                               cow(c, src, dst))[1]
    got = _drive(teng, TSamplingParams, reqs, stagger, 0)
    assert len(got) == len(reqs) and got == want
    assert teng.trace == jeng.trace
    for name in ("preemptions", "cached_prompt_tokens", "prefill_tokens",
                 "decode_tokens", "completed"):
        assert getattr(teng.metrics, name) == getattr(jeng.metrics, name), \
            name
    assert teng.bm.in_use == 0 and teng.bm.available == teng.bm.capacity
    if scenario == "prefix":
        assert teng.metrics.cached_prompt_tokens > 0
        assert _events(teng, "prefix_hit") and copies   # a partial page
    else:
        assert teng.metrics.preemptions >= 1
        assert set(_events(teng, "preempt")) == {1}
    assert teng.cache["pos0"]["k"].dtype == torch.uint8


def test_fixed_slot_engine_matches_jax_with_slot_reuse_and_drops(setup,
                                                                 drops):
    """The fixed-slot engine over 20 requests of three prompt lengths
    through 12 slots, 12 at once and then one every other step: streams,
    trace, write positions and counters equal to JAX's engine; slots
    served more than one request; drops in decode steps and in
    prefills."""
    cfg, tcfg, jp, tp = setup
    kw = dict(slots=SEATS, max_len=40)
    reqs = _requests(cfg.vocab_size, 20, lengths=(7, 12, 25))
    jeng = JFixed(cfg, jp, **kw)
    teng = TFixed(tcfg, tp, device="cpu", **kw)
    want = _drive(jeng, JSamplingParams, reqs, stagger=2, first_wave=12)
    got = _drive(teng, TSamplingParams, reqs, stagger=2, first_wave=12)
    assert len(got) == len(reqs) and got == want
    assert teng.trace == jeng.trace
    np.testing.assert_array_equal(teng.pos, np.asarray(jeng.pos))
    for key in ("prefill_tokens", "decode_tokens", "completed", "admitted"):
        assert getattr(teng.metrics, key) == getattr(jeng.metrics, key), key
    assert len(_events(teng, "admit")) == 20 > kw["slots"]
    assert _dropped(drops, 2 * SEATS) > 0
    assert sum(n for t, n in drops if t in (2 * 12, 2 * 25)) > 0


@pytest.mark.parametrize("engine", ["paged", "batch"])
def test_serve_cli_grok_on_cpu(engine, capsys):
    """``serve --arch grok-1-314b --device cpu`` (the reduced config) on
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
