"""whisper-base (reduced: 2 encoder and 2 decoder layers, encoder_len 32,
f32 compute) on the port's fixed-slot ``ServingEngine`` against the JAX
package's, on the CPU, with JAX-initialized weights carried across by
``params_from_jax``; the paged engine refusing it with the JAX engine's
message; ``serve --arch whisper-base --device cpu``, and ``--engine
paged`` refusing.

The engines' prefill feeds the reference's stub frames, zeros, on which
the encoder's output, and so every slot's ``ck``/``cv`` and every
cross-attention output, is exactly zero (``test_torch_whisper.py``).
Each engine run is therefore made twice: as the engines are, and with
both engines' prefill handed frames drawn per request (standard normal,
from a numpy seed made of the request's prefill tokens: the same
substitution on both sides), under which each slot's ``ck``/``cv``
change from request to request and a wrong slot write shows.

Token streams and traces are compared exactly, as in
``test_torch_fixed_slot.py``: the f32 logits differ from JAX's by ~1e-5
(``test_torch_whisper.py``), which could flip a greedy near-tie; none
occurs on these submissions.
"""
import dataclasses

import jax
import jax.numpy as jnp
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
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_jax
from repro_torch.runtime import serving as tserving
from repro_torch.runtime.sampler import SamplingParams as TSamplingParams
from repro_torch.runtime.serving import PagedServingEngine as TPaged
from repro_torch.runtime.serving import ServingEngine as TFixed

ARCH = "whisper-base"
KW = dict(slots=3, max_len=40)
# prompt lengths, all below encoder_len (32), so that a slot write of
# the prompt's P rows alone leaves rows of ck/cv to the slot's last
# occupant
LENGTHS = (5, 29, 2, 16, 11)
PREEMPT_AT = 6          # engine steps before Scheduler.preempt


@pytest.fixture(scope="module")
def setup():
    cfg = reduced_config(get_config(ARCH), compute_dtype="float32")
    tcfg = treduced(tget(ARCH), compute_dtype="float32")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(tcfg)
    jp = JM.init_params(JM.param_specs(cfg), jax.random.PRNGKey(0))
    return cfg, tcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp))


def _requests(vocab):
    """9 requests (3 slots: each slot serves three) of LENGTHS prompt
    tokens in turn and 3-9 new tokens, every third sampled at
    temperature 0.9."""
    rng = np.random.default_rng(12)
    return [dict(prompt=rng.integers(0, vocab, LENGTHS[i % len(LENGTHS)])
                 .astype(np.int32),
                 max_new_tokens=int(rng.integers(3, 10)),
                 sampling=dict(temperature=0.9, seed=6) if i % 3 == 2
                 else None) for i in range(9)]


def _frames(cfg, tokens) -> np.ndarray:
    """(1, encoder_len, frontend_dim) standard-normal frames from a numpy
    seed made of a prefill's tokens (1, P)."""
    toks = np.asarray(tokens).reshape(-1).astype(np.int64)
    seed = int(toks.sum()) * 1000 + len(toks)
    return np.random.default_rng(seed).standard_normal(
        (1, cfg.encoder_len, cfg.frontend_dim)).astype(np.float32)


def _drive(eng, sp_cls, reqs):
    """Submit every request, step PREEMPT_AT times, preempt the request
    in the lowest seat (it replays prompt + generated[:-1] when it is
    seated again), run to the end.  Returns ({rid: stream}, trace)."""
    for r in reqs:
        sp = r["sampling"]
        eng.submit(r["prompt"], max_new_tokens=r["max_new_tokens"],
                   sampling=None if sp is None else sp_cls(**sp))
    for _ in range(PREEMPT_AT):
        eng.step()
    eng.preempt(eng.seats[min(eng.seats)])
    eng.run()
    return {r.rid: list(r.generated) for r in eng.finished}, eng.trace


def _jax_engine(cfg, jp, drawn: bool):
    eng = JFixed(cfg, jp, **KW)
    if drawn:
        pol, prefill = eng.policy, eng.policy._prefill
        pol._prefill = lambda p, b: prefill(
            p, {**b, "audio": jnp.asarray(_frames(cfg, b["tokens"]))})
    return eng


def _torch_engine(tcfg, tp, drawn: bool, monkeypatch):
    if drawn:
        prefill = TM.prefill

        def with_frames(params, cfg, batch, *args, **kw):
            frames = _frames(cfg, batch["tokens"].cpu().numpy())
            return prefill(params, cfg, {**batch, "audio": torch.from_numpy(
                frames)}, *args, **kw)
        monkeypatch.setattr(TM, "prefill", with_frames)
    return TFixed(tcfg, tp, device="cpu", **KW)


@pytest.fixture(scope="module")
def jax_runs(setup):
    cfg, _, jp, _ = setup
    reqs = _requests(cfg.vocab_size)
    return reqs, {drawn: _drive(_jax_engine(cfg, jp, drawn), JSamplingParams,
                                reqs) for drawn in (False, True)}


@pytest.mark.parametrize("drawn", [False, True], ids=["stub", "drawn"])
def test_fixed_slot_engine_matches_jax(setup, jax_runs, drawn, monkeypatch):
    """More requests than slots (each slot seats three) and one
    ``Scheduler.preempt`` replay: streams and trace equal to the JAX
    engine's, on the stub frames (every ``ck``/``cv`` zero) and on
    frames drawn per request (every slot's ``ck``/``cv`` its request's)."""
    _, tcfg, _, tp = setup
    reqs, runs = jax_runs
    want, jtrace = runs[drawn]
    eng = _torch_engine(tcfg, tp, drawn, monkeypatch)
    assert eng.cache["pos0"]["ck"].shape == (2, 3, 32, 4, 16)
    assert eng.cache["pos0"]["k"].shape == (2, 3, 41, 4, 16)
    got, trace = _drive(eng, TSamplingParams, reqs)
    assert len(got) == len(reqs)
    assert [ev for _, ev, _ in trace].count("preempt") == 1
    assert got == want
    assert trace == jtrace
    assert bool(eng.policy.logits_finite)
    assert bool(eng.cache["pos0"]["ck"].any()) == drawn


def test_planted_partial_cross_write_fails(setup, jax_runs, monkeypatch):
    """A slot write that gives ``ck``/``cv`` the K/V rule (only the
    prompt's ``[:, slot, :P]`` rows, the rest left to the slot's last
    occupant) must part from JAX's streams on drawn frames."""
    _, tcfg, _, tp = setup
    reqs, runs = jax_runs
    want, _ = runs[True]
    place = tserving._place

    def partial(full, row, key, slot, P):
        if key in ("ck", "cv"):
            full[:, slot, :P] = row[:, :P]
        else:
            place(full, row, key, slot, P)
    monkeypatch.setattr(tserving, "_place", partial)
    got, _ = _drive(_torch_engine(tcfg, tp, True, monkeypatch),
                    TSamplingParams, reqs)
    assert got != want


def test_paged_engine_refuses_whisper_as_jax_does(setup):
    cfg, tcfg, jp, tp = setup
    with pytest.raises(ValueError) as jerr:
        JPaged(cfg, jp)
    with pytest.raises(ValueError) as terr:
        TPaged(tcfg, tp, device="cpu")
    assert str(terr.value) == str(jerr.value)
    assert "enc-dec" in str(terr.value)


def test_serve_cli_whisper_on_cpu(capsys):
    """``serve --arch whisper-base --device cpu`` (the static batch, the
    default engine; the reduced config, frames drawn beside the prompts)
    finishes with no kernel launch; ``--engine paged`` exits with the
    paged engine's refusal."""
    from repro_torch.launch.serve import main, serve
    r = serve(ARCH, batch=2, prompt_len=9, gen=4, device="cpu")
    assert r["generated"].shape == (2, 4)
    tops.reset_launches()
    main(["--arch", ARCH, "--device", "cpu", "--batch", "2",
          "--prompt-len", "9", "--gen", "4"])
    out = capsys.readouterr().out
    assert "[serve] prefill=" in out and "sample tokens" in out
    assert not tops.launches
    with pytest.raises(SystemExit) as e:
        main(["--arch", ARCH, "--device", "cpu", "--engine", "paged"])
    assert e.value.code != 0
    assert "use ServingEngine for ssm/enc-dec" in capsys.readouterr().err
