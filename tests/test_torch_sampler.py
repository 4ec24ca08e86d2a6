"""The port's torch sampler draws the JAX sampler's tokens: the batched
``sample_tokens`` is token-identical to the JAX ``sample_tokens`` and to
the numpy ``sample_tokens_np`` over the temperature / top-k / top-p /
seed / rid / step grids of tests/test_fused_tick.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime import sampler as jsampler
from repro_torch.runtime import sampler as tsampler

_jax_sample = jax.jit(jsampler.sample_tokens)


def _grid(rng, B, V):
    logits = rng.normal(scale=3.0, size=(B, V)).astype(np.float32)
    temp = rng.choice([0.0, 0.5, 0.9, 1.3], size=B).astype(np.float32)
    top_k = rng.choice([0, 1, 5, 40, V], size=B).astype(np.int32)
    top_p = rng.choice([1.0, 0.95, 0.6, 0.3], size=B).astype(np.float32)
    seed = rng.integers(0, 2**31, size=B, dtype=np.int64)
    rid = rng.integers(0, 10_000, size=B, dtype=np.int64)
    step = rng.integers(0, 4096, size=B, dtype=np.int64)
    return logits, temp, top_k, top_p, seed, rid, step


def _torch_tokens(logits, temp, top_k, top_p, seed, rid, step):
    return tsampler.sample_tokens(
        *[torch.from_numpy(a) for a in (logits, temp, top_k, top_p, seed,
                                        rid, step)]).numpy()


def _jax_tokens(logits, temp, top_k, top_p, seed, rid, step):
    return np.asarray(_jax_sample(
        jnp.asarray(logits), jnp.asarray(temp), jnp.asarray(top_k),
        jnp.asarray(top_p), jnp.asarray(seed.astype(np.uint32)),
        jnp.asarray(rid.astype(np.uint32)),
        jnp.asarray(step.astype(np.uint32))))


@pytest.mark.parametrize("trial", range(6))
def test_sample_tokens_matches_jax_and_numpy(trial):
    rng = np.random.default_rng(trial)
    args = _grid(rng, 32, 97)
    got = _torch_tokens(*args)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, _jax_tokens(*args))
    np.testing.assert_array_equal(got, tsampler.sample_tokens_np(*args))


@pytest.mark.parametrize("V", [256, 1000])
def test_sample_tokens_matches_host_oracle_per_row(V):
    """Against the per-row numpy Sampler (the scheduler's host path), at
    the reduced and a wider vocabulary; seeds up to 2**32 - 1."""
    rng = np.random.default_rng(V)
    logits, temp, top_k, top_p, seed, rid, step = _grid(rng, 16, V)
    seed[:4] = [0, 2**32 - 1, 2**31, 12345]
    got = _torch_tokens(logits, temp, top_k, top_p, seed, rid, step)
    oracle = tsampler.Sampler()
    for i in range(16):
        sp = tsampler.SamplingParams(temperature=float(temp[i]),
                                     top_k=int(top_k[i]),
                                     top_p=float(top_p[i]),
                                     seed=int(seed[i]))
        assert int(got[i]) == oracle.sample(logits[i], sp, rid=int(rid[i]),
                                            step=int(step[i])), i


def test_gumbel_hash_bits_match_numpy():
    """The int64 fmix32 reproduces numpy's uint32 wraparound hash bit
    for bit, so every stochastic token keys the same uniforms.  The
    Gumbel values ``-log(-log(u))`` then agree to float32 rounding of
    the two libraries' ``log`` (which the nested log amplifies near
    u = 1); the token tests above pin that this never moves a draw on
    these grids."""
    rng = np.random.default_rng(9)
    h = rng.integers(0, 2**32, size=4096, dtype=np.uint64).astype(np.uint32)
    got = tsampler._mix_torch(torch.from_numpy(h.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got.astype(np.uint32),
                                  tsampler._mix_np(h))
    for seed, rid, step in ((0, 0, 0), (2**32 - 1, 77, 4095), (5, 2**31, 9)):
        want = tsampler._gumbel_np(seed, rid, step, 300)
        got = tsampler._gumbel_torch(torch.tensor([seed]), torch.tensor([rid]),
                                     torch.tensor([step]), 300)[0].numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_sampling_params_copied():
    assert tsampler.GREEDY == tsampler.SamplingParams()
    assert tsampler.GREEDY.greedy
    with pytest.raises(ValueError, match="top_p"):
        tsampler.SamplingParams(top_p=0.0)
    with pytest.raises(ValueError, match="temperature"):
        tsampler.SamplingParams(temperature=-1.0)
