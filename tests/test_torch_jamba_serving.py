"""jamba-v0.1-52b (reduced: 16 layers, two periods of 7 SSM layers and 1
attention layer, MoE 4 experts top-2 on odd layers; f32 compute) on the
port's fixed-slot ``ServingEngine`` against the JAX package's, on the CPU,
with JAX-initialized weights carried across by ``params_from_jax``;
``serve --arch jamba-v0.1-52b --device cpu``; and the paged engine and
``--engine paged`` refusing the arch, as JAX's do.

The slot cache mixes attention K/V (position 4 of each period) with SSM
conv tails and states (the other seven).  Token streams and traces are
compared exactly, as in ``test_torch_ssm_serving.py``: the logits differ
from JAX's within ``test_torch_jamba.py``'s f32 tolerance, which could
flip a greedy near-tie; none occurs on these submissions.
"""
import dataclasses

import jax
import numpy as np
import pytest

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

ARCH = "jamba-v0.1-52b"
KW = dict(slots=3, max_len=56)
# prompt lengths: below the conv's 3 rows, within one SSD chunk of 16,
# one chunk, and the padded path (37 -> 48)
LENGTHS = (5, 37, 2, 16, 11)
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
    rng = np.random.default_rng(11)
    return [dict(prompt=rng.integers(0, vocab, LENGTHS[i % len(LENGTHS)])
                 .astype(np.int32),
                 max_new_tokens=int(rng.integers(3, 10)),
                 sampling=dict(temperature=0.9, seed=5) if i % 3 == 2
                 else None) for i in range(9)]


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


def test_fixed_slot_engine_matches_jax_with_slot_reuse_and_preemption(
        setup):
    """More requests than slots and one ``Scheduler.preempt`` replay over
    the mixed slot cache: streams, trace and write positions equal to
    the JAX engine's."""
    cfg, tcfg, jp, tp = setup
    reqs = _requests(cfg.vocab_size)
    want, jtrace = _drive(JFixed(cfg, jp, **KW), JSamplingParams, reqs)
    eng = TFixed(tcfg, tp, device="cpu", **KW)
    assert set(eng.cache["pos4"]) == {"k", "v"}
    # max_len rows and the scratch row idle slots write to
    assert eng.cache["pos4"]["k"].shape == (2, 3, 57, 4, 16)
    assert eng.cache["pos0"]["ssm"].shape == (2, 3, 8, 16, 16)
    got, trace = _drive(eng, TSamplingParams, reqs)
    assert len(got) == len(reqs)
    assert [ev for _, ev, _ in trace].count("preempt") == 1
    assert sum(ev == "admit" for _, ev, _ in trace) == len(reqs) + 1
    assert got == want
    assert trace == jtrace
    assert bool(eng.policy.logits_finite)


def test_paged_engine_refuses_the_hybrid_as_jax_does(setup):
    cfg, tcfg, jp, tp = setup
    with pytest.raises(ValueError) as jerr:
        JPaged(cfg, jp)
    with pytest.raises(ValueError) as terr:
        TPaged(tcfg, tp, device="cpu")
    assert str(terr.value) == str(jerr.value)
    assert "use ServingEngine for ssm" in str(terr.value)


def test_serve_cli_jamba_on_cpu(capsys):
    """``serve --arch jamba-v0.1-52b --device cpu`` (the static batch, the
    default engine; the reduced config) finishes with no kernel launch;
    the alias resolves; ``--engine paged`` exits with the paged engine's
    refusal."""
    from repro_torch.launch.serve import main
    tops.reset_launches()
    main(["--arch", "jamba_v0_1_52b", "--device", "cpu", "--batch", "2",
          "--prompt-len", "21", "--gen", "5"])
    out = capsys.readouterr().out
    assert "[serve] prefill=" in out and "sample tokens" in out
    assert not tops.launches
    with pytest.raises(SystemExit) as e:
        main(["--arch", "jamba-v0.1-52b", "--device", "cpu", "--engine",
              "paged"])
    assert e.value.code != 0
    assert "use ServingEngine for ssm" in capsys.readouterr().err
