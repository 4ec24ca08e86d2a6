"""qwen2-moe-a2.7b (reduced, f32 compute) through the port's model steps
and both serving engines against the JAX package's, on the CPU, with
JAX-initialized weights carried across by ``params_from_jax``.

The capacity factor is lowered to 0.5 so that experts overflow: with 16
seats a decode tick routes 32 (token, expert) pairs into 4 experts of 8
slots, and a prefill chunk of 12 tokens 24 pairs.  Every row routes, an
idle seat's too, so the engines must also hold for idle seats what the
reference's engines hold (token 0 at position 0 on the paged engine, the
scratch position on the fixed-slot one); requests arrive staggered so
that idle seats sit below active ones.

Tolerances: logits 1e-4 (f32 sums in another order, as in
``test_torch_model.py``); token streams and traces exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced_config
from repro.models import model as JM
from repro.parallel.sharding import SINGLE_DEVICE_RULES
from repro.runtime.sampler import SamplingParams as JSamplingParams
from repro.runtime.serving import PagedServingEngine as JPaged
from repro.runtime.serving import ServingEngine as JFixed
from repro_torch.configs import get_config as tget
from repro_torch.configs import reduced_config as treduced
from repro_torch.models import model as TM
from repro_torch.models import moe as tmoe
from repro_torch.models.convert import params_from_jax
from repro_torch.runtime.sampler import SamplingParams as TSamplingParams
from repro_torch.runtime.serving import PagedServingEngine as TPaged
from repro_torch.runtime.serving import ServingEngine as TFixed

ARCH = "qwen2-moe-a2.7b"
CF = 0.5
SEATS, CHUNK = 16, 12


def _cf(cfg):
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=CF))


@pytest.fixture(scope="module")
def setup():
    cfg = _cf(reduced_config(get_config(ARCH), compute_dtype="float32"))
    tcfg = _cf(treduced(tget(ARCH), compute_dtype="float32"))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(tcfg)
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


def test_prefill_and_paged_step_match_jax(setup, drops):
    """``prefill`` of a batch and ``paged_decode_step`` over a prefill
    chunk of 3 seats, then a decode step of 16 seats (the idle ones on
    the scratch page): logits equal JAX's, with capacity drops in every
    call."""
    cfg, tcfg, jp, tp = setup
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    jl, _ = JM.prefill(jp, cfg, {"tokens": jnp.asarray(tokens)},
                       SINGLE_DEVICE_RULES, JM.RunOptions(q_chunk=8))
    tl, _ = TM.prefill(tp, tcfg, {"tokens": torch.from_numpy(tokens)},
                       TM.RunOptions(q_chunk=8))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    assert _dropped(drops, 48) > 0

    n, page = 6, 4
    table = np.zeros((SEATS, n), np.int32)
    table[:3, :2] = [[1, 2], [3, 4], [5, 6]]
    step = jax.jit(lambda p, c, t, q, pt, nv: JM.paged_decode_step(
        p, cfg, c, t, q, pt, nv, SINGLE_DEVICE_RULES))
    jc = JM.init_paged_cache(cfg, 8, page)
    tc = TM.init_paged_cache(tcfg, 8, page)
    chunk = rng.integers(0, cfg.vocab_size, (3, 6)).astype(np.int32)
    nv = np.array([6, 4, 5], np.int32)
    args = (chunk, np.zeros(3, np.int32), table[:3], nv)
    jl, jc = step(jp, jc, *args)
    tl, _ = TM.paged_decode_step(tp, tcfg, tc,
                                 *(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    assert _dropped(drops, 36) > 0

    tok = rng.integers(0, cfg.vocab_size, (SEATS, 1)).astype(np.int32)
    pos = np.zeros(SEATS, np.int32)
    pos[:3] = nv
    live = np.zeros(SEATS, np.int32)
    live[:3] = 1
    live[9] = 1                      # an active seat above idle ones
    table[9, :2] = [7, 7]
    args = (tok, pos, table, live)
    jl, _ = step(jp, jc, *args)
    tl, _ = TM.paged_decode_step(tp, tcfg, tc,
                                 *(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(tl.numpy()[live > 0],
                               np.asarray(jl)[live > 0], atol=1e-4)
    assert _dropped(drops, 2 * SEATS) > 0


def test_prefill_ragged_matches_jax(setup):
    """``RunOptions(moe_impl="ragged")`` runs the dropless expert FFNs
    through ``prefill``, as the reference's option does: logits equal
    JAX's, and differ from the capacity path's, which drops."""
    cfg, tcfg, jp, tp = setup
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 12)).astype(np.int32)
    jl, _ = JM.prefill(jp, cfg, {"tokens": jnp.asarray(tokens)},
                       SINGLE_DEVICE_RULES,
                       JM.RunOptions(q_chunk=8, moe_impl="ragged"))
    batch = {"tokens": torch.from_numpy(tokens)}
    tl, _ = TM.prefill(tp, tcfg, batch,
                       TM.RunOptions(q_chunk=8, moe_impl="ragged"))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    capped, _ = TM.prefill(tp, tcfg, batch, TM.RunOptions(q_chunk=8))
    assert np.abs(capped.numpy() - tl.numpy()).max() > 1e-3


def _requests(vocab, lengths=None):
    """28 requests of 3-25 prompt tokens (or of ``lengths``, in turn) and
    2-12 new tokens."""
    rng = np.random.default_rng(3)
    out = []
    for i in range(28):
        n = (int(rng.integers(3, 26)) if lengths is None
             else lengths[i % len(lengths)])
        out.append(dict(prompt=rng.integers(0, vocab, n).astype(np.int32),
                        max_new_tokens=int(rng.integers(2, 13))))
    return out


SAMPLING = (None, dict(temperature=0.9, seed=5))


def _drive(eng, sp_cls, reqs):
    """Waves of arrivals: 18 requests, then one more every other step."""
    for i, r in enumerate(reqs):
        sp = SAMPLING[i % 2]
        eng.submit(r["prompt"], max_new_tokens=r["max_new_tokens"],
                   sampling=None if sp is None else sp_cls(**sp))
        if i >= 18:
            eng.step()
            eng.step()
    eng.run()
    return {r.rid: list(r.generated) for r in eng.finished}


@pytest.mark.parametrize("fused", [True, False],
                         ids=["fused", "per-tick"])
def test_paged_engine_matches_jax_with_drops(setup, drops, monkeypatch,
                                             fused):
    """The paged engine over 28 staggered requests, half sampled at
    temperature 0.9: streams and trace equal to the JAX engine's, with
    capacity drops in decode ticks and in prefill chunks, and ticks in
    which an idle seat sits below an active one."""
    cfg, tcfg, jp, tp = setup
    kw = dict(page_size=4, num_pages=160, max_seats=SEATS, max_seq_len=40,
              prefill_chunk=CHUNK)
    reqs = _requests(cfg.vocab_size)
    jeng = JPaged(cfg, jp, **kw)
    want = _drive(jeng, JSamplingParams, reqs)
    jtrace = jeng.trace

    gaps = []
    inner = TM.paged_decode_step

    def watching(params, cfg_, cache, tokens, pos, table, n_valid, **k):
        if tokens.shape[1] == 1:
            live = n_valid.numpy() > 0
            gaps.append(bool((~live[:np.flatnonzero(live).max()]).any()))
        return inner(params, cfg_, cache, tokens, pos, table, n_valid, **k)
    monkeypatch.setattr(TM, "paged_decode_step", watching)
    teng = TPaged(tcfg, tp, fused=fused, device="cpu", **kw)
    got = _drive(teng, TSamplingParams, reqs)
    assert len(got) == len(reqs)
    assert got == want
    assert teng.trace == jtrace
    assert teng.metrics.preemptions == jeng.metrics.preemptions == 0
    assert _dropped(drops, 2 * SEATS) > 0          # decode ticks
    assert _dropped(drops, 2 * CHUNK) > 0          # prefill chunks
    assert sum(gaps) > 0


def test_fixed_slot_engine_matches_jax_with_drops(setup, drops):
    """The fixed-slot engine over staggered requests of three prompt
    lengths (each length is one whole-prompt prefill shape for JAX to
    compile): streams, trace and write positions equal to the JAX
    engine's, with drops in decode steps and prefills."""
    cfg, tcfg, jp, tp = setup
    kw = dict(slots=SEATS, max_len=40)
    reqs = _requests(cfg.vocab_size, lengths=(6, 17, 25))
    jeng = JFixed(cfg, jp, **kw)
    want = _drive(jeng, JSamplingParams, reqs)
    teng = TFixed(tcfg, tp, device="cpu", **kw)
    got = _drive(teng, TSamplingParams, reqs)
    assert len(got) == len(reqs)
    assert got == want
    assert teng.trace == jeng.trace
    np.testing.assert_array_equal(teng.pos, np.asarray(jeng.pos))
    assert _dropped(drops, 2 * SEATS) > 0
    assert _dropped(drops, 2 * 25) > 0
