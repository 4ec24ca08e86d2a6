"""The hybrid family: jamba-v0.1-52b (reduced: 16 layers — two periods of
8 with SSM blocks on positions 0-3 and 5-7, attention on position 4 and
MoE, 4 experts top-2, on the odd positions — d_model 64, 4 heads of 16,
d_state 16, SSM head_dim 16, chunk 16) in the port against the JAX
package on the CPU, with JAX-initialized weights carried across by
``params_from_jax`` and tokens from numpy seeds.  The model code is the
one the dense, MoE and SSM slices ported (``models/model.py`` reads
``layer_kinds()`` and ``mlp_kinds()``): these tests hold its composition.

Tolerances.  At JAX's initial weights the SSM states grow into the
thousands, and f32 rounding compounds over the 16 layers: the two
packages sum in different orders (the SSD's inter-chunk recurrence chunk
by chunk against an associative scan; einsum contraction orders), and
layer 0, whose input is the same in both, is the only one held as
tightly as ``test_torch_ssm.py`` holds its two layers.  So:

- f32: logits within 5e-4 of the largest |logit|; layer 0's conv tail
  and state (the same input in both packages) within 1e-5 of their
  largest value, as ``test_torch_ssm.py`` holds its two layers; every
  other cache leaf within 1e-3;
- bf16: one layer's SSM block and MoE block within 2^-6 of the largest
  output (the MoE and SSM slices' figure: XLA rounds each bf16 op of
  ``silu`` and the conv's sum on its own).  At random weights those
  roundings compound through 16 layers of the whole bf16 model, so it
  is held at the block, as the bf16 hazard in ROADMAP.md advises.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced_config
from repro.models import model as JM
from repro.models import moe as jmoe
from repro.models import ssm as jssm
from repro.models.modules import count_params as jcount
from repro.parallel.sharding import SINGLE_DEVICE_RULES
from repro_torch.configs import get_config as tget
from repro_torch.configs import reduced_config as treduced
from repro_torch.kernels import ops as tops
from repro_torch.models import model as TM
from repro_torch.models import moe as tmoe
from repro_torch.models import ssm as tssm
from repro_torch.models.convert import cast_for_compute, params_from_jax

ARCH = "jamba-v0.1-52b"
F32_REL = 1e-5
DEEP_REL = 1e-3
LOGIT_REL = 5e-4
BF16_REL = 2.0 ** -6
OPTS = JM.RunOptions(q_chunk=32, xent_chunk=32)
SSM_POS = ("pos0", "pos1", "pos2", "pos3", "pos5", "pos6", "pos7")


def _close(got, want, rel, what=""):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    got = np.asarray(got, np.float64)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= rel * scale, f"{what}: max|Δ| {err:.3e} > {rel} × {scale:.3e}"


def _close_cache(got, want, what):
    """Layer 0's entries (g = 0, pos0) within F32_REL, every other leaf
    within DEEP_REL."""
    for pos, ent in got.items():
        for key, t in ent.items():
            for g in range(t.shape[0]):
                rel = F32_REL if (g, pos) == (0, "pos0") else DEEP_REL
                _close(t[g], want[pos][key][g], rel, f"{what} g{g} {pos}/{key}")


def _tokens(seed, B, S):
    return np.random.default_rng(seed).integers(0, 256, (B, S)) \
        .astype(np.int32)


@pytest.fixture(scope="module")
def setup():
    """The reduced config in f32, JAX's weights and the same weights as
    tensors."""
    cfg = reduced_config(get_config(ARCH), compute_dtype="float32")
    tcfg = treduced(tget(ARCH), compute_dtype="float32")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(tcfg)
    jp = JM.init_params(JM.param_specs(cfg), jax.random.PRNGKey(0))
    return cfg, tcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp))


def test_specs_match_jax_and_the_full_size(setup):
    """``param_specs`` equal to JAX's leaf for leaf; no shared-expert
    subtree; the full config's 51.460 B parameters at 32 layers and the
    25.998 B the card serves at 16 (two whole periods)."""
    cfg, tcfg, _, _ = setup
    is_spec = dict(is_leaf=lambda s: hasattr(s, "axes"))
    jshapes = jax.tree.map(lambda s: s.shape, JM.param_specs(cfg), **is_spec)
    tshapes = jax.tree.map(lambda s: s.shape, TM.param_specs(tcfg),
                           **is_spec)
    assert jshapes == tshapes
    blocks = tshapes["blocks"]
    assert set(blocks["pos4"]["mixer"]) == {"wq", "wk", "wv", "wo"}
    assert set(blocks["pos0"]["mixer"]) >= {"in_proj", "out_proj", "A_log"}
    assert set(blocks["pos1"]["moe"]) == {"router", "wg", "wu", "wd"}
    assert set(blocks["pos0"]) == {"ln1", "mixer", "ln2", "mlp"}
    full = tget(ARCH)
    n32 = TM.count_params(TM.param_specs(full))
    n16 = TM.count_params(TM.param_specs(
        dataclasses.replace(full, num_layers=16)))
    assert round(n32 / 1e9, 3) == 51.460
    assert round(n16 / 1e9, 3) == 25.998
    assert n32 == jcount(JM.param_specs(get_config(ARCH)))


def test_layer_pattern():
    """One period: ``ssm ×4, attn, ssm ×3``, MoE on the odd positions and
    the dense MLP on the even ones; two periods stacked at 16 layers."""
    for cfg in (tget(ARCH), treduced(tget(ARCH))):
        assert cfg.layer_kinds() == ("ssm",) * 4 + ("attn",) + ("ssm",) * 3
        assert cfg.mlp_kinds() == ("dense", "moe") * 4
        assert cfg.scan_period() == 8
    assert treduced(tget(ARCH)).num_layers == 16
    assert not TM.paged_cache_supported(tget(ARCH))


@pytest.mark.parametrize("S", [9, 16, 37],
                         ids=["below-chunk", "one-chunk", "padded"])
def test_prefill_logits_and_caches_match_jax(setup, S):
    """Prefill below the SSD chunk of 16, at one chunk and at 37 (zero-
    padded to 48): logits, every SSM layer's conv tail and f32 state,
    and the attention layer's K/V."""
    cfg, tcfg, jp, tp = setup
    toks = _tokens(S, 2, S)
    jl, jcache = JM.prefill(jp, cfg, {"tokens": jnp.asarray(toks)},
                            SINGLE_DEVICE_RULES, OPTS)
    tl, tcache = TM.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)},
                            TM.RunOptions(q_chunk=32))
    _close(tl, jl, LOGIT_REL, "logits")
    assert set(tcache) == {f"pos{i}" for i in range(8)}
    assert set(tcache["pos4"]) == {"k", "v"}
    assert tcache["pos4"]["k"].shape == (2, 2, S, 4, 16)
    for pos in SSM_POS:
        assert set(tcache[pos]) == {"conv", "ssm"}
        assert tcache[pos]["ssm"].shape == (2, 2, 8, 16, 16)
        assert tcache[pos]["ssm"].dtype == torch.float32
    _close_cache(tcache, jcache, "prefill")


def test_decode_step_matches_prefill_and_jax(setup):
    """``decode_step`` after a prefill of S - 1 tokens, on the cache grown
    to S rows, equals the prefill of S tokens and JAX's ``decode_step``
    on the same cache; the new states and K/V rows are written in
    place, equal to JAX's."""
    cfg, tcfg, jp, tp = setup
    B, S = 2, 21
    toks = _tokens(7, B, S)
    want, _ = TM.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    _, cache = TM.prefill(tp, tcfg,
                          {"tokens": torch.from_numpy(toks[:, :-1])})
    cache = TM.grow_cache(cache, S)
    jcache = jax.tree.map(lambda t: jnp.asarray(t.numpy().copy()), cache)
    held = {(p, k): t for p, ent in cache.items() for k, t in ent.items()}
    tok, pos = toks[:, -1:], np.full((B,), S - 1, np.int32)
    got, out = TM.decode_step(tp, tcfg, cache, torch.from_numpy(tok),
                              torch.from_numpy(pos))
    assert out is cache and all(cache[p][k] is t
                                for (p, k), t in held.items())
    _close(got, want, LOGIT_REL, "decode vs prefill")
    jl, jnew = JM.decode_step(jp, cfg, jcache, jnp.asarray(tok),
                              jnp.asarray(pos), SINGLE_DEVICE_RULES, OPTS)
    _close(got, jl, LOGIT_REL, "decode vs JAX")
    _close_cache(cache, jnew, "decode")


@pytest.mark.parametrize("block", ["ssm", "moe"])
def test_bf16_blocks_match_jax(setup, block):
    """bf16 compute on layer 1's own weights (first period, position 1:
    an SSM mixer and an MoE MLP): the block, prefill at S = 37, within
    2^-6 of the largest output of JAX's."""
    cfg, tcfg, jp, tp = setup
    bcfg = dataclasses.replace(cfg, compute_dtype="bfloat16")
    tbcfg = dataclasses.replace(tcfg, compute_dtype="bfloat16")
    sub = "mixer" if block == "ssm" else "moe"
    jw = jax.tree.map(lambda a: a[0], jp["blocks"]["pos1"][sub])
    tw = {k: v[0] for k, v in tp["blocks"]["pos1"][sub].items()}
    x = np.random.default_rng(5).normal(size=(2, 37, cfg.d_model))
    xb = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(np.array(xb.astype(jnp.float32))).bfloat16()
    if block == "ssm":
        want, _ = jax.jit(lambda p, x: jssm.ssm_block(p, bcfg, x))(jw, xb)
        got, (_, state) = tssm.ssm_block(tw, tbcfg, xt)
        assert state.dtype == torch.float32
    else:
        want = jmoe._moe_local(jw, bcfg, xb)
        got = tmoe._moe_local(cast_for_compute(tw, torch.bfloat16), tbcfg,
                              xt)
    assert got.dtype == torch.bfloat16
    _close(got, want, BF16_REL, f"bf16 {block}")


def test_norm_launches_per_layer(setup, monkeypatch):
    """Per decode step one lone ``rmsnorm`` at d_model (layer 0's ln1),
    two ``add_rmsnorm`` at d_model per layer (every layer has an MLP:
    the mixer's add into ln2, the MLP's into the next norm) and one
    ``rmsnorm`` at d_inner per SSM layer (the gated norm)."""
    _, tcfg, _, tp = setup
    calls = []
    for name in ("rmsnorm", "add_rmsnorm"):
        fn = getattr(tops, name)
        monkeypatch.setattr(tops, name, lambda *a, _n=name, _f=fn, **k: (
            calls.append((_n, a[0].shape[-1])), _f(*a, **k))[1])
    cache = TM.init_cache(tcfg, 2, 8)
    TM.decode_step(tp, tcfg, cache, torch.zeros((2, 1), dtype=torch.int32),
                   torch.zeros((2,), dtype=torch.int32))
    L = tcfg.num_layers
    n_ssm = L * 7 // 8
    assert sorted(calls) == sorted([("rmsnorm", 64)]
                                   + [("add_rmsnorm", 64)] * (2 * L)
                                   + [("rmsnorm", 128)] * n_ssm)
