"""gemma3-12b (reduced: one period of 5 local layers and a global one,
window 32, GQA group 2, f32 compute) on the port's two serving engines
against the JAX package's, on the CPU, with JAX-initialized weights
carried across by ``params_from_jax``.  Prompts and generations cross
the window: in prefill chunks, in decode ticks and in the fixed-slot
engine's whole-prompt prefill and decode steps.  Then ``serve --arch
gemma3-12b --device cpu`` on both engines.

Token streams and traces are compared exactly, as in
``test_torch_serving.py``: the logits differ from JAX's by up to ~1e-4
here (``test_torch_gemma.py``), which could flip a greedy near-tie; none
occurs on these submissions.
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

ARCH = "gemma3-12b"
SMALL = dict(num_layers=6, num_kv_heads=2)
W = 32


@pytest.fixture(scope="module")
def setup():
    cfg = reduced_config(get_config(ARCH), compute_dtype="float32", **SMALL)
    tcfg = treduced(tget(ARCH), compute_dtype="float32", **SMALL)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(tcfg)
    assert cfg.sliding_window == W
    jp = JM.init_params(JM.param_specs(cfg), jax.random.PRNGKey(0))
    return cfg, tcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp))


def _requests(vocab, lengths):
    """12 requests of ``lengths`` prompt tokens in turn and 4-12 new
    tokens, every third one sampled at temperature 0.9."""
    rng = np.random.default_rng(7)
    return [dict(prompt=rng.integers(0, vocab, lengths[i % len(lengths)])
                 .astype(np.int32),
                 max_new_tokens=int(rng.integers(4, 13)),
                 sampling=dict(temperature=0.9, seed=3) if i % 3 == 2
                 else None) for i in range(12)]


def _drive(eng, sp_cls, reqs):
    """8 requests at once, then one more every other engine step."""
    for i, r in enumerate(reqs):
        sp = r["sampling"]
        eng.submit(r["prompt"], max_new_tokens=r["max_new_tokens"],
                   sampling=None if sp is None else sp_cls(**sp))
        if i >= 8:
            eng.step()
            eng.step()
    eng.run()
    return {r.rid: list(r.generated) for r in eng.finished}


def _crossings(reqs) -> int:
    """Requests whose positions run past the window."""
    return sum(len(r["prompt"]) + r["max_new_tokens"] > W for r in reqs)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "per-tick"])
def test_paged_engine_matches_jax_across_the_window(setup, fused):
    """The paged engine (chunks of 16, pages of 4) over 12 staggered
    requests of 9-53 prompt tokens: streams and trace equal to the JAX
    engine's, with prefill chunks and ticks past the window."""
    cfg, tcfg, jp, tp = setup
    kw = dict(page_size=4, num_pages=160, max_seats=6, max_seq_len=72,
              prefill_chunk=16)
    reqs = _requests(cfg.vocab_size, (9, 53, 27, 40, 31, 18))
    assert _crossings(reqs) >= 6
    jeng = JPaged(cfg, jp, **kw)
    want = _drive(jeng, JSamplingParams, reqs)
    teng = TPaged(tcfg, tp, fused=fused, device="cpu", **kw)
    got = _drive(teng, TSamplingParams, reqs)
    assert len(got) == len(reqs)
    assert got == want
    assert teng.trace == jeng.trace
    assert teng.metrics.preemptions == jeng.metrics.preemptions


def test_fixed_slot_engine_matches_jax_across_the_window(setup):
    """The fixed-slot engine over staggered requests of three prompt
    lengths (20, 45, 31: one whole-prompt prefill shape each for JAX to
    compile): streams, trace and write positions equal to the JAX
    engine's, with prefills and decode steps past the window."""
    cfg, tcfg, jp, tp = setup
    kw = dict(slots=4, max_len=60)
    reqs = _requests(cfg.vocab_size, (20, 45, 31))
    assert _crossings(reqs) >= 8
    jeng = JFixed(cfg, jp, **kw)
    want = _drive(jeng, JSamplingParams, reqs)
    teng = TFixed(tcfg, tp, device="cpu", **kw)
    got = _drive(teng, TSamplingParams, reqs)
    assert len(got) == len(reqs)
    assert got == want
    assert teng.trace == jeng.trace
    np.testing.assert_array_equal(teng.pos, np.asarray(jeng.pos))


@pytest.mark.parametrize("engine", ["paged", "batch"])
def test_serve_cli_gemma_on_cpu(engine, capsys):
    """``serve --arch gemma3-12b --device cpu`` (the reduced config) on
    both engines; no kernel launches on the CPU."""
    from repro_torch.launch.serve import main
    tops.reset_launches()
    main(["--arch", ARCH, "--device", "cpu", "--engine", engine,
          "--requests", "4", "--gen", "6", "--batch", "2",
          "--prompt-len", "40"])
    out = capsys.readouterr().out
    assert ("[serve.paged]" if engine == "paged" else "throughput=") in out
    assert not any(tops.launches.values())
