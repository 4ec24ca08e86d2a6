"""phi-3-vision-4.2b (reduced: 2 layers, frontend_len 8, f32 compute) on
the port's fixed-slot ``ServingEngine`` against the JAX package's, on
the CPU, with JAX-initialized weights carried across by
``params_from_jax``; both paged engines refusing it with one message;
``serve --arch phi-3-vision-4.2b --device cpu``, its refusal of prompts
shorter than the patches, and ``--engine paged`` refusing.

The engines' prefill feeds the reference's stub patches, zeros, so the
first ``frontend_len`` rows of every prompt embed as zero vectors.  The
engine runs are made twice: as the engines are, and with both engines'
prefill handed patches drawn per request (standard normal, from a
numpy seed made of the request's prefill tokens: the same substitution
on both sides), under which a request's patch rows differ from every
other's.

Token streams and traces are compared exactly, as in
``test_torch_whisper_serving.py``: the f32 logits differ from JAX's by
~1e-5 (``test_torch_vision.py``), which could flip a greedy near-tie;
none occurs on these submissions.
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
from repro_torch.runtime.sampler import SamplingParams as TSamplingParams
from repro_torch.runtime.serving import PagedServingEngine as TPaged
from repro_torch.runtime.serving import ServingEngine as TFixed

ARCH = "phi-3-vision-4.2b"
KW = dict(slots=3, max_len=40)
# prompt lengths, from the patches' 8 rows (the least a prompt may be)
# up
LENGTHS = (8, 29, 9, 16, 11)
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
    rng = np.random.default_rng(13)
    return [dict(prompt=rng.integers(0, vocab, LENGTHS[i % len(LENGTHS)])
                 .astype(np.int32),
                 max_new_tokens=int(rng.integers(3, 10)),
                 sampling=dict(temperature=0.9, seed=6) if i % 3 == 2
                 else None) for i in range(9)]


def _patches(cfg, tokens) -> np.ndarray:
    """(1, frontend_len, frontend_dim) standard-normal patches from a
    numpy seed made of a prefill's tokens (1, P)."""
    toks = np.asarray(tokens).reshape(-1).astype(np.int64)
    seed = int(toks.sum()) * 1000 + len(toks)
    return np.random.default_rng(seed).standard_normal(
        (1, cfg.frontend_len, cfg.frontend_dim)).astype(np.float32)


def _drive(eng, sp_cls, reqs):
    """Submit every request, step PREEMPT_AT times, preempt the request
    in the lowest seat (it replays prompt + generated[:-1], on fresh
    patches, when it is seated again), run to the end.  Returns
    ({rid: stream}, trace)."""
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

        def with_patches(p, b):
            assert not np.any(np.asarray(b["patches"]))   # the stub
            return prefill(p, {**b, "patches": jnp.asarray(
                _patches(cfg, b["tokens"]))})
        pol._prefill = with_patches
    return eng


def _torch_engine(tcfg, tp, drawn: bool, monkeypatch):
    if drawn:
        prefill = TM.prefill

        def with_patches(params, cfg, batch, *args, **kw):
            assert not torch.any(batch["patches"])          # the stub
            patches = _patches(cfg, batch["tokens"].cpu().numpy())
            return prefill(params, cfg, {**batch, "patches": torch.from_numpy(
                patches)}, *args, **kw)
        monkeypatch.setattr(TM, "prefill", with_patches)
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
    engine's, on the stub patches and on patches drawn per request."""
    _, tcfg, _, tp = setup
    reqs, runs = jax_runs
    want, jtrace = runs[drawn]
    eng = _torch_engine(tcfg, tp, drawn, monkeypatch)
    assert set(eng.cache["pos0"]) == {"k", "v"}
    assert eng.cache["pos0"]["k"].shape == (2, 3, 41, 4, 16)
    got, trace = _drive(eng, TSamplingParams, reqs)
    assert len(got) == len(reqs)
    assert [ev for _, ev, _ in trace].count("preempt") == 1
    assert got == want
    assert trace == jtrace
    assert bool(eng.policy.logits_finite)


def test_drawn_patches_change_the_streams(jax_runs):
    """The patch rows reach the tokens: on drawn patches some stream
    differs from the stub run's (so the comparison above sees them)."""
    _, runs = jax_runs
    assert runs[True][0] != runs[False][0]


def test_short_prompt_refused_at_submit(setup):
    """The port's engine refuses a prompt shorter than the patch rows at
    ``submit``, naming both lengths, and assigns it no rid; the JAX
    engine takes it and fails in its prefill."""
    cfg, tcfg, jp, tp = setup
    eng = TFixed(tcfg, tp, device="cpu", **KW)
    with pytest.raises(ValueError, match="prompt length 7 < frontend_len=8"):
        eng.submit(np.arange(7, dtype=np.int32), max_new_tokens=2)
    assert eng.submit(np.arange(8, dtype=np.int32), max_new_tokens=2) == 0
    jeng = JFixed(cfg, jp, **KW)
    jeng.submit(np.arange(7, dtype=np.int32), max_new_tokens=2)
    with pytest.raises(TypeError):
        jeng.run()


def test_paged_engines_refuse_the_vision_model_alike(setup):
    cfg, tcfg, jp, tp = setup
    with pytest.raises(ValueError) as jerr:
        JPaged(cfg, jp)
    with pytest.raises(ValueError) as terr:
        TPaged(tcfg, tp, device="cpu")
    assert str(terr.value) == str(jerr.value)
    assert "frontend" in str(terr.value)


def test_serve_cli_vision_on_cpu(capsys, monkeypatch):
    """``serve --arch phi-3-vision-4.2b --device cpu`` (the static batch,
    the reduced config, patches drawn beside the prompts) finishes with
    no kernel launch, and its patches reach the tokens; a prompt shorter
    than the patches is refused before anything is built; ``--engine
    paged`` exits with the paged engine's refusal."""
    from repro_torch.launch.serve import main, serve
    r = serve(ARCH, batch=2, prompt_len=9, gen=4, device="cpu")
    assert r["generated"].shape == (2, 4)
    with pytest.raises(ValueError, match="--prompt-len 7 .* 8 patch rows"):
        serve(ARCH, batch=2, prompt_len=7, gen=4, device="no-such-device")
    tops.reset_launches()
    main(["--arch", ARCH, "--device", "cpu", "--batch", "2",
          "--prompt-len", "9", "--gen", "4"])
    out = capsys.readouterr().out
    assert "[serve] prefill=" in out and "sample tokens" in out
    assert not tops.launches
    with pytest.raises(SystemExit) as e:
        main(["--arch", ARCH, "--device", "cpu", "--engine", "paged"])
    assert e.value.code != 0
    assert "use ServingEngine for ssm/enc-dec/frontend" in \
        capsys.readouterr().err
    embed = TM._embed_inputs
    seen = []

    def spy(params, cfg, batch, **kw):
        seen.append(batch["patches"].shape)
        return embed(params, cfg, batch, **kw)
    monkeypatch.setattr(TM, "_embed_inputs", spy)
    serve(ARCH, batch=2, prompt_len=9, gen=2, device="cpu")
    assert seen == [(2, 8, 64)]
