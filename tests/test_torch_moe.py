"""The port's MoE block (``repro_torch.models.moe``) against the JAX
package's, on the CPU, with JAX-initialized weights carried across by
``params_from_jax`` and inputs drawn with numpy.

Tolerances: in f32 the block agrees to rtol 1e-5 and atol 1e-6 of the
largest output (XLA and torch sum the products in other orders, which
moves an output by a few ulps of the terms it sums; these outputs reach
16-38, and the largest difference read 2.6e-7 of it), with and without
capacity drops, and the router picks the same experts.  In bf16 it
picks the same experts too, the capacity path's three products equal
the reference's einsums bit for bit, and so does the combine, which adds
each token's k contributions in the reference's order; the block as a whole
does not, because XLA's ``silu`` rounds to bf16 after each of its
operations (``1 / (1 + exp(-x))``, then the product) where torch's
rounds once: outputs agree within 2⁻⁶ of the largest output (two bf16
steps at its magnitude).
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_train_inputs import loss_at_init

from repro.configs import get_config, reduced_config
from repro.configs.base import ModelConfig, MoEConfig
from repro.models import model as JM
from repro.models import moe as jmoe
from repro.models.modules import init_params as jinit
from repro_torch.configs import get_config as tget
from repro_torch.configs import reduced_config as treduced
from repro_torch.configs.base import ModelConfig as TConfig
from repro_torch.configs.base import MoEConfig as TMoEConfig
from repro_torch.models import model as TM
from repro_torch.models import moe as tmoe
from repro_torch.models.convert import (cast_for_compute,
                                        init_params_for_compute,
                                        params_from_jax)

D = 16


def assert_f32_close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())


# the reference's block, compiled once per (config, shape, impl)
_jax_moe = jax.jit(jmoe._moe_local, static_argnums=(1,),
                   static_argnames=("impl",))


def _cfgs(E, k, cf, shared=0):
    """The same small MoE config in both packages."""
    kw = dict(name="t", family="moe", num_layers=1, d_model=D, num_heads=2,
              num_kv_heads=2, d_ff=32, vocab_size=64, head_dim=8)
    m = dict(num_experts=E, top_k=k, d_ff_expert=24, capacity_factor=cf,
             num_shared_experts=shared, d_ff_shared=32 if shared else 0)
    return (ModelConfig(moe=MoEConfig(**m), **kw),
            TConfig(moe=TMoEConfig(**m), **kw))


def _setup(E, k, cf, shared=0, seed=0):
    jc, tc = _cfgs(E, k, cf, shared)
    jp = jinit(jmoe.moe_specs(jc), jax.random.PRNGKey(E * 10 + k))
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    # a mean offset skews the routing, so some experts overflow
    x = (np.random.default_rng(seed).standard_normal((4, 16, D))
         + 0.3).astype(np.float32)
    return jc, tc, jp, tp, x


def _jax_sizes(jp, jc, x):
    """The reference's routing of x: top-k ids and group sizes."""
    xt = jnp.asarray(x.reshape(-1, D))
    probs = jax.nn.softmax(xt @ jp["router"], axis=-1)
    _, idx = jax.lax.top_k(probs, jc.moe.top_k)
    idx = np.asarray(idx)
    return idx, np.bincount(idx.reshape(-1), minlength=jc.moe.num_experts)


# (E, k, shared, capacity factor with drops): every (E, k) also runs at
# cf = E, where no expert can overflow
CASES = [(6, 2, 0, 1.25), (8, 1, 0, 1.25), (4, 4, 0, 0.5), (4, 2, 2, 0.5)]


@pytest.mark.parametrize("drops", [False, True], ids=["cf=E", "drops"])
@pytest.mark.parametrize("E,k,shared,cf", CASES,
                         ids=[f"E{c[0]}k{c[1]}s{c[2]}" for c in CASES])
def test_block_matches_jax(E, k, shared, cf, drops):
    cf = cf if drops else float(E)
    jc, tc, jp, tp, x = _setup(E, k, cf, shared)
    jidx, sizes = _jax_sizes(jp, jc, x)
    _, _, tidx = tmoe.route(tp, tc.moe, torch.from_numpy(x.reshape(-1, D)))
    np.testing.assert_array_equal(tidx.numpy(), jidx)
    C = tmoe.capacity(tc.moe, jidx.size)
    assert (sizes.max() > C) == drops, (sizes, C)
    want = np.asarray(_jax_moe(jp, jc, jnp.asarray(x)))
    got = tmoe.moe_block(tp, tc, torch.from_numpy(x)).numpy()
    assert_f32_close(got, want)
    if shared:
        no_shared = {key: v for key, v in tp.items() if key != "shared"}
        alone = tmoe._moe_local(no_shared, tc, torch.from_numpy(x)).numpy()
        assert np.abs(got - alone).max() > 1e-3


def test_dropped_pairs_contribute_exactly_zero():
    """A (token, expert) pair past its expert's capacity adds nothing:
    the capacity path's output equals the ragged path's with the dropped
    pairs' weights set to 0."""
    jc, tc, jp, tp, x = _setup(8, 1, 1.25)
    xt = torch.from_numpy(x.reshape(-1, D))
    _, weights, idx = tmoe.route(tp, tc.moe, xt)
    flat = idx.reshape(-1)
    sort_idx = torch.argsort(flat, stable=True)
    sizes = tmoe.group_sizes(flat, 8)
    xs = xt[sort_idx // 1]
    y = tmoe._expert_gemms_capacity(tp, tc.moe, xs, sizes, torch.float32)
    C = tmoe.capacity(tc.moe, len(flat))
    offsets = torch.cumsum(sizes, 0) - sizes
    place = torch.arange(len(flat)) - offsets[flat[sort_idx]]
    dropped = place >= C
    assert int(dropped.sum()) == int((sizes - C).clamp(min=0).sum()) > 0
    assert not y[dropped].any()
    full = tmoe._expert_gemms_ragged(tp, tc.moe, xs, sizes, torch.float32)
    np.testing.assert_array_equal(y[~dropped].numpy(),
                                  full[~dropped].numpy())


@pytest.mark.parametrize("E,k", [(6, 2), (8, 1), (4, 4)])
def test_ragged_matches_jax(E, k):
    jc, tc, jp, tp, x = _setup(E, k, 1.25)
    want = np.asarray(_jax_moe(jp, jc, jnp.asarray(x), impl="ragged"))
    got = tmoe.moe_block(tp, tc, torch.from_numpy(x), impl="ragged")
    assert_f32_close(got.numpy(), want)


@pytest.mark.parametrize("E,k", [(6, 2), (8, 1), (4, 4)])
def test_aux_loss_matches_jax(E, k):
    jc, tc, jp, tp, x = _setup(E, k, 1.25)
    want = float(jmoe.aux_load_balance_loss(jp, jc, jnp.asarray(x)))
    got = tmoe.aux_load_balance_loss(tp, tc, torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


def test_router_ties_break_toward_the_lower_expert():
    """Equal probabilities pick the lower expert id first, as
    ``jax.lax.top_k`` does."""
    jc, tc, jp, tp, _ = _setup(6, 2, 6.0)
    router = np.zeros((D, 6), np.float32)
    router[0] = [1, 3, 3, 0, 3, 1]
    jp = dict(jp, router=jnp.asarray(router))
    tp = dict(tp, router=torch.from_numpy(router))
    x = np.zeros((1, 2, D), np.float32)
    x[0, :, 0] = 1.0
    jidx, _ = _jax_sizes(jp, jc, x)
    _, _, tidx = tmoe.route(tp, tc.moe, torch.from_numpy(x.reshape(-1, D)))
    np.testing.assert_array_equal(jidx, [[1, 2], [1, 2]])
    np.testing.assert_array_equal(tidx.numpy(), jidx)


def _bf16_bits(a) -> np.ndarray:
    """The int16 bit patterns of a bf16 torch tensor or JAX array."""
    if isinstance(a, torch.Tensor):
        assert a.dtype == torch.bfloat16, a.dtype
        return a.view(torch.int16).numpy()
    assert a.dtype == jnp.bfloat16, a.dtype
    return np.asarray(a).view(np.int16)


@pytest.mark.parametrize("E,k,shared", [(6, 2, 0), (4, 2, 2)])
def test_bf16_block_matches_jax(E, k, shared, monkeypatch):
    """In bf16 the router's top-k ids equal ``lax.top_k``'s over the
    reference's bf16 logits, and the capacity path's three products equal
    the reference's einsums bit for bit (the gate and up products on the
    same expert windows, the down product on the port's own SwiGLU
    output); the block agrees within 2⁻⁶ of its largest output, the
    ``silu`` step's rounding."""
    jc, tc, jp, tp, x = _setup(E, k, 1.25, shared)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    tb = cast_for_compute(tp, torch.bfloat16)
    xt = torch.from_numpy(x).bfloat16()

    logits = jnp.einsum("td,de->te", xb.reshape(-1, D),
                        jp["router"].astype(jnp.bfloat16))
    _, jidx = jax.lax.top_k(jax.nn.softmax(logits.astype(jnp.float32), -1),
                            k)
    _, _, tidx = tmoe.route(tb, tc.moe, xt.reshape(-1, D))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))

    # the reference's einsums and the port's bmms, recorded in call order
    jein, tbmm = [], []
    einsum, bmm = jnp.einsum, torch.bmm

    def rec_einsum(spec, a, b, **kw):
        out = einsum(spec, a, b, **kw)
        if spec.startswith("ec"):
            jein.append((a, out))
        return out

    def rec_bmm(a, b):
        out = bmm(a, b)
        tbmm.append((a, b, out))
        return out
    monkeypatch.setattr(jnp, "einsum", rec_einsum)
    monkeypatch.setattr(torch, "bmm", rec_bmm)
    want = jmoe._moe_local(jp, jc, xb)            # eager: concrete einsums
    got = tmoe._moe_local(tb, tc, xt)
    monkeypatch.undo()
    assert len(jein) == len(tbmm) == 3
    for (ja, jout), (ta, _, tout) in zip(jein[:2], tbmm[:2]):
        np.testing.assert_array_equal(_bf16_bits(ta), _bf16_bits(ja))
        np.testing.assert_array_equal(_bf16_bits(tout), _bf16_bits(jout))
    h, wd, down = tbmm[2]
    np.testing.assert_array_equal(_bf16_bits(down), _bf16_bits(jnp.einsum(
        "ecf,efd->ecd", jnp.asarray(h.float().numpy()).astype(jnp.bfloat16),
        jp["wd"].astype(jnp.bfloat16))))
    assert wd.dtype == torch.bfloat16

    want = np.asarray(want.astype(jnp.float32))
    got = got.float().numpy()
    assert np.abs(got - want).max() <= 2 ** -6 * np.abs(want).max()


def test_bf16_combine_is_the_references_sum_bit_for_bit():
    """Given the same bf16 expert outputs, weights and routing, the
    port's combine equals the reference's ``.at[tok_ids].add``."""
    T, k, E = 48, 4, 6
    rng = np.random.default_rng(1)
    idx = np.stack([rng.permutation(E)[:k] for _ in range(T)])
    w = rng.random((T, k)).astype(np.float32)
    w /= w.sum(-1, keepdims=True)
    y = (rng.standard_normal((T * k, D)) * 8).astype(np.float32)
    flat = jnp.asarray(idx.reshape(-1))
    sort_idx = jnp.argsort(flat)
    yb = jnp.asarray(y).astype(jnp.bfloat16)
    w_sorted = jnp.take(jnp.asarray(w).reshape(-1), sort_idx).astype(
        jnp.bfloat16)
    want = jnp.zeros((T, D), jnp.bfloat16).at[sort_idx // k].add(
        yb * w_sorted[:, None])
    got = tmoe.combine(torch.from_numpy(y).bfloat16(), torch.from_numpy(w),
                       torch.from_numpy(idx), torch.argsort(
                           torch.from_numpy(idx.reshape(-1)), stable=True))
    np.testing.assert_array_equal(
        got.view(torch.int16).numpy(),
        np.asarray(want).view(np.uint16).view(np.int16))


def test_mesh_is_refused(tmp_path):
    """``moe_block(mesh=)`` is no longer refused: it runs the sharded body.
    Two ranks over gloo (``tests/_torch_dist.py moe``, a subprocess) on
    the (1, 2) data × model mesh, each holding its half of the expert ff
    and the shared ff, against ``_moe_local`` on the whole params (4
    experts top-2, 2 shared, capacity factor 0.5): outputs within 1e-6 of
    the largest, the gradients of the input, the router, the gate and
    each rank's weight slices within 1e-6 of each leaf's largest (the
    ranks' partial outputs are summed in another order)."""
    import _mesh_inputs as MI
    out = str(tmp_path)
    MI.finish([MI.start([os.path.join(MI.HERE, "_torch_dist.py"), "moe",
                         out], out)], timeout=120)
    for r in range(2):
        res = torch.load(os.path.join(out, f"moe.rank{r}.pt"),
                         weights_only=False)
        top = float(res["out1"].abs().max())
        assert float((res["out"] - res["out1"]).abs().max()) <= 1e-6 * top
        assert set(res["grads"]) == set(res["grads1"])
        for k, g in res["grads"].items():
            want = res["grads1"][k]
            assert g.shape == want.shape, k
            assert float((g - want).abs().max()) <= \
                1e-6 * float(want.abs().max()), k


def test_specs_equal_the_references():
    jc, tc = _cfgs(4, 2, 1.25, shared=2)
    js = jmoe.moe_specs(jc)
    ts = tmoe.moe_specs(tc)
    flat_j = jax.tree.leaves_with_path(
        js, is_leaf=lambda s: hasattr(s, "axes"))
    flat_t = jax.tree.leaves_with_path(
        ts, is_leaf=lambda s: hasattr(s, "axes"))
    assert [(p, s.shape, s.axes, s.init, s.scale) for p, s in flat_j] == \
        [(p, s.shape, s.axes, s.init, s.scale) for p, s in flat_t]


def test_cast_as_drawn_equals_cast_after_drawing():
    """``init_params_for_compute`` draws the tree of
    ``cast_for_compute(init_params(...))`` bit for bit: the matmul,
    router, gate and embedding leaves in bf16, the norms in f32."""
    cfg = treduced(tget("qwen2-moe-a2.7b"))
    specs = TM.param_specs(cfg)
    want = cast_for_compute(TM.init_params(
        specs, torch.Generator().manual_seed(5)), torch.bfloat16)
    got = init_params_for_compute(specs, torch.Generator().manual_seed(5),
                                  torch.bfloat16)
    from repro_torch.tree import tree_flatten_with_paths
    w, g = tree_flatten_with_paths(want), tree_flatten_with_paths(got)
    assert [p for p, _ in w] == [p for p, _ in g]
    for (path, a), (_, b) in zip(w, g):
        assert a.dtype == b.dtype and torch.equal(a, b), path
        norm = path.rsplit("/", 1)[-1] in ("ln1", "ln2", "final_norm")
        assert a.dtype == (torch.float32 if norm else torch.bfloat16), path
    moe = got["blocks"]["pos0"]["moe"]
    assert moe["router"].dtype == moe["shared"]["gate"].dtype == \
        torch.bfloat16


def test_model_specs_match_jax_and_convert_one_to_one():
    cfg = reduced_config(get_config("qwen2-moe-a2.7b"))
    tcfg = treduced(tget("qwen2-moe-a2.7b"))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(tcfg)
    jshapes = jax.tree.map(lambda s: s.shape, JM.param_specs(cfg),
                           is_leaf=lambda s: hasattr(s, "axes"))
    tshapes = jax.tree.map(lambda s: s.shape, TM.param_specs(tcfg),
                           is_leaf=lambda s: hasattr(s, "axes"))
    assert jshapes == tshapes
    assert "moe" in tshapes["blocks"]["pos0"]
    assert "mlp" not in tshapes["blocks"]["pos0"]
    full = tget("qwen2-moe-a2.7b")
    n = TM.count_params(TM.param_specs(full))
    assert 14.30e9 < n < 14.35e9


def test_encoder_decoder_and_frontend_archs_stay_refused():
    """(The name is from when training a vision model was refused.)  A
    vision config builds ``frontend_proj`` and no encoder, and trains:
    the loss at initialization is finite and near ln(vocab) and
    ``frontend_proj`` takes a gradient through the patch rows; an
    encoder-decoder config builds the encoder stack and each decoder
    layer's cross-attention."""
    base = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
                d_ff=128, vocab_size=256, head_dim=16)
    vlm = TConfig(name="vlm", family="vlm", frontend="vision",
                  frontend_len=8, frontend_dim=64, **base)
    vspecs = TM.param_specs(vlm)
    assert vspecs["frontend_proj"].shape == (64, 64)
    assert "encoder" not in vspecs
    vp = TM.init_params(vspecs, torch.Generator().manual_seed(0))
    assert loss_at_init(vp, vlm)["frontend_proj"].abs().max() > 0
    specs = TM.param_specs(TConfig(name="encdec", family="audio",
                                   encoder_decoder=True, num_encoder_layers=2,
                                   encoder_len=32, **base))
    assert "cross" in specs["blocks"]["pos0"]
    assert "cross" not in specs["encoder"]["blocks"]["pos0"]
