"""The parts of the port's training path against the JAX package, on the
CPU at reduced sizes: LR schedules, AdamW, the token pipeline, the
chunked cross-entropy, ``lm_loss`` with its gradients, remat, gradient
accumulation over microbatches, and the elastic planner.  JAX params are
carried across with ``params_from_jax``; the JAX side runs with
``SINGLE_DEVICE_RULES`` and ``make_host_mesh()``.

Tolerances, f32 throughout:
- schedules: rtol 1e-6 (``cos`` and ``pow`` may differ by an ulp);
- AdamW: rtol 1e-6, atol 1e-9 (the same formula in the same order);
- token batches: bit-equal (numpy Philox on both sides);
- cross-entropy: loss rtol 1e-6, grads within 1e-5 of their largest
  magnitude; with ``w_out`` left unrounded (a planted fault) the loss
  moves by ~1e-4 relative and the grads by ~2e-3, so the fault misses;
- ``lm_loss``: loss rtol 1e-5; every grad within 1e-4 of its leaf's
  largest magnitude (XLA and torch sum the f32 matmuls in other orders);
  the output weight's grad, rounded to bf16 chunk by chunk on both sides,
  may land one bf16 step apart where the f32 sums straddle a rounding
  boundary: within 2^-7 of each element's magnitude (one step of bf16's
  7-bit mantissa) plus 1e-4 of the largest.  The same limits hold for
  the vision model (``patches``), the encoder-decoder model (``audio``;
  its encoder's leaves with remat on and off) and the SSM (S = 32 spans
  two SSD chunks of 16; the port's loop over chunks sums in another
  order than JAX's ``associative_scan``, and its leaves come within
  3e-5 of their largest, so they need no limit of their own).  The
  vision and encoder-decoder models' ``wq``/``wk`` are scaled to their
  true fan-in on both sides (``_torch_train_inputs.TRUE_FAN_IN`` says
  why); their gradients then come within 9.4e-5, the encoder's within
  4e-6;
- remat on and off: bit-equal (backward recomputes the same ops);
- microbatches: the tolerance of ``tests/test_torch_train.py``'s f32
  steps.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_train_inputs import (TRUE_FAN_IN, assert_grads, frontend_inputs,
                                 true_fan_in)

from repro.configs import get_config, reduced_config
from repro.configs.base import ShapeConfig
from repro.data.pipeline import TokenPipeline as JPipeline
from repro.launch.mesh import make_host_mesh
from repro.launch.steps import build_cell as jbuild_cell
from repro.models import model as JM
from repro.models import modules as JMod
from repro.optim import adamw as JA
from repro.optim import schedules as JS
from repro.parallel.sharding import SINGLE_DEVICE_RULES
from repro.runtime import elastic as JE
from repro_torch.configs import ShapeConfig as TShapeConfig
from repro_torch.configs import get_config as tget
from repro_torch.configs import reduced_config as treduced
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.kernels import ops as tops
from repro_torch.launch.steps import build_cell, value_and_grad
from repro_torch.models import model as TM
from repro_torch.models import modules as TMod
from repro_torch.models.convert import params_from_jax
from repro_torch.optim import adamw as TA
from repro_torch.optim import schedules as TS
from repro_torch.runtime import elastic as TE
from repro_torch.tree import tree_leaves, tree_map

B, S = 4, 32


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _torch_tree(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _setup(arch):
    cfg = reduced_config(get_config(arch), compute_dtype="float32")
    tcfg = treduced(tget(arch), compute_dtype="float32")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(tcfg)
    jp = JM.init_params(JM.param_specs(cfg), jax.random.PRNGKey(0))
    if arch in TRUE_FAN_IN:
        jp = jax.tree.map(jnp.asarray, true_fan_in(
            _np_tree(jp), cfg.d_model, TRUE_FAN_IN[arch]))
    return cfg, tcfg, jp, params_from_jax(_np_tree(jp))


def _batch(cfg, step=0):
    """The token pipeline's batch at ``step`` as numpy arrays, with the
    frontend's inputs at seed ``step``."""
    return {**{k: np.asarray(v) for k, v in
               JPipeline(cfg.vocab_size, S, B).get_batch(step).items()},
            **frontend_inputs(cfg, B, step)}


def _tb(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# schedules, AdamW, token pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["wsd_schedule", "cosine_schedule"])
def test_schedule_matches_jax_over_a_grid(name):
    kw = dict(peak=3e-3, warmup_steps=10, total_steps=300)
    steps = list(range(0, 40)) + list(range(260, 330))
    want = np.array([float(getattr(JS, name)(jnp.int32(s), **kw))
                     for s in steps], np.float32)
    got = [getattr(TS, name)(torch.tensor(s, dtype=torch.int32), **kw)
           for s in steps]
    assert all(g.dtype == torch.float32 and g.dim() == 0 for g in got)
    np.testing.assert_allclose(np.array([float(g) for g in got]), want,
                               rtol=1e-6)
    fn, kw2 = TS.get_schedule("wsd" if name == "wsd_schedule" else "cosine",
                              **kw)
    assert fn is getattr(TS, name) and kw2 == kw


def test_linear_warmup_matches_jax():
    for s in (0, 3, 7, 12):
        np.testing.assert_allclose(
            float(TS.linear_warmup(torch.tensor(float(s)), 8, 2e-3)),
            float(JS.linear_warmup(jnp.float32(s), 8, 2e-3)), rtol=1e-6)


@pytest.mark.parametrize("grad_scale,clipped", [(0.01, False), (10.0, True)])
def test_adamw_matches_jax(grad_scale, clipped):
    rng = np.random.default_rng(0)
    params = {"a": rng.standard_normal((8, 16)).astype(np.float32),
              "b": {"c": rng.standard_normal(5).astype(np.float32),
                    "d": rng.standard_normal((3, 4, 2)).astype(np.float32)}}
    jp = jax.tree.map(jnp.asarray, params)
    js = JA.init_opt_state(jp)
    tp = _torch_tree(params)
    ts = TA.init_opt_state(tp)
    assert ts["count"].dtype == torch.int32 and ts["count"].dim() == 0
    for step in range(3):
        grads = jax.tree.map(lambda x: (rng.standard_normal(x.shape)
                                        * grad_scale).astype(np.float32),
                             params)
        lr = 1e-2 * (step + 1)
        jp, js, jm = JA.adamw_update(jax.tree.map(jnp.asarray, grads), js,
                                     jp, lr)
        tp, ts, tm = TA.adamw_update(_torch_tree(grads), ts, tp,
                                     torch.tensor(lr))
        assert (float(jm["grad_norm"]) > 1.0) == clipped
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
    assert int(ts["count"]) == int(js["count"]) == 3
    for tree_j, tree_t in ((jp, tp), (js["mu"], ts["mu"]),
                           (js["nu"], ts["nu"])):
        for a, t in zip(jax.tree.leaves(tree_j), tree_leaves(tree_t)):
            np.testing.assert_allclose(t.numpy(), np.asarray(a), rtol=1e-6,
                                       atol=1e-9)


def test_global_norm_matches_jax():
    rng = np.random.default_rng(1)
    tree = {"x": rng.standard_normal((5, 7)).astype(np.float32),
            "y": {"z": rng.standard_normal(11).astype(np.float32)}}
    np.testing.assert_allclose(float(TA.global_norm(_torch_tree(tree))),
                               float(JA.global_norm(tree)), rtol=1e-6)


@pytest.mark.parametrize("vocab,seq,batch", [(256, 32, 4), (151_936, 17, 3)])
def test_token_pipeline_is_bit_equal(vocab, seq, batch):
    jp = JPipeline(vocab, seq, batch)
    tp = TokenPipeline(vocab, seq, batch, device="cpu")
    for step in (0, 1, 7, 123):
        want, got = jp.get_batch(step), tp.get_batch(step)
        for key in ("tokens", "labels"):
            assert got[key].dtype == torch.int32
            assert got[key].shape == (batch, seq)
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(want[key]))


# ---------------------------------------------------------------------------
# chunked cross-entropy, lm_loss, remat, microbatches
# ---------------------------------------------------------------------------

def _xent_inputs():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 32, 16)).astype(np.float32)
    w = (rng.standard_normal((16, 64)) * 0.3).astype(np.float32)
    labels = rng.integers(0, 64, (2, 32)).astype(np.int32)
    labels[0, :3] = -1                                 # masked positions
    return x, w, labels


def _xent_torch(x, w, labels, compute_dtype):
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    total, count = TMod.softmax_xent_chunked(
        tx, tw, torch.from_numpy(labels), chunk=8,
        compute_dtype=compute_dtype)
    gx, gw = torch.autograd.grad(total, (tx, tw))
    return float(total.detach()), float(count), gx.numpy(), gw.numpy()


def _xent_close(got, want) -> bool:
    (total, count, gx, gw), (jt, jc, jgx, jgw) = got, want
    return (count == jc
            and abs(total - jt) <= 1e-6 * abs(jt)
            and np.abs(gx - jgx).max() <= 1e-5 * np.abs(jgx).max()
            and np.abs(gw - jgw).max() <= 1e-5 * np.abs(jgw).max())


def test_softmax_xent_chunked_matches_jax_and_catches_unrounded_weights():
    x, w, labels = _xent_inputs()

    def f(x, w):
        return JMod.softmax_xent_chunked(x, w, labels, chunk=8)
    jt, jc = f(x, w)
    jgx, jgw = jax.grad(lambda a, b: f(a, b)[0], argnums=(0, 1))(x, w)
    want = (float(jt), float(jc), np.asarray(jgx), np.asarray(jgw))
    assert want[1] == 2 * 32 - 3
    assert _xent_close(_xent_torch(x, w, labels, torch.bfloat16), want)
    # planted fault: w_out not rounded to bf16
    assert not _xent_close(_xent_torch(x, w, labels, torch.float32), want)
    with torch.no_grad():
        total, count = TMod.softmax_xent_chunked(
            torch.from_numpy(x), torch.from_numpy(w),
            torch.from_numpy(labels), chunk=8)
    assert float(total) == pytest.approx(want[0], rel=1e-6)


def test_count_and_abstract_params_match_jax():
    for arch in ("qwen3-1.7b", "llama3-8b"):
        for reduce in (False, True):
            cfg, tcfg = get_config(arch), tget(arch)
            if reduce:
                cfg, tcfg = reduced_config(cfg), treduced(tcfg)
            specs, tspecs = JM.param_specs(cfg), TM.param_specs(tcfg)
            assert TM.count_params(tspecs) == JMod.count_params(specs)
            ab = jax.tree.leaves(JM.abstract_params(specs))
            tab = tree_leaves(TM.abstract_params(tspecs, torch.bfloat16))
            assert [a.shape for a in ab] == [tuple(t.shape) for t in tab]
            assert all(t.device.type == "meta" and t.dtype == torch.bfloat16
                       for t in tab)
    assert 1.70e9 < TM.count_params(TM.param_specs(tget("qwen3-1.7b"))) \
        < 1.75e9


def _loss_and_grads_vs_jax(arch, head, *, remat=True):
    """``lm_loss`` and its gradients at ``_setup(arch)``'s params and
    ``_batch``: loss rtol 1e-5 and ``assert_grads``.  Returns the
    port's ``(loss, grads)``."""
    cfg, tcfg, jp, tp = _setup(arch)
    assert cfg.tie_embeddings == (head == "embed")
    batch = _batch(cfg)
    opts = JM.RunOptions(q_chunk=16, xent_chunk=16, remat=remat)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: JM.lm_loss(p, cfg, b, SINGLE_DEVICE_RULES, opts),
        has_aux=True))(jp, batch)
    (tl, tm), tg = value_and_grad(
        tp, tcfg, _tb(batch), TM.RunOptions(q_chunk=16, xent_chunk=16,
                                            remat=remat))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(tm["xent"]), float(jm["xent"]),
                               rtol=1e-5)
    assert float(tm["aux_loss"]) == float(jm["aux_loss"]) == 0.0
    assert_grads(jg, tg, head)
    return tl, tg


@pytest.mark.parametrize("arch,head", [("qwen3-1.7b", "embed"),
                                       ("llama3-8b", "lm_head"),
                                       ("phi-3-vision-4.2b", "lm_head"),
                                       ("whisper-base", "lm_head"),
                                       ("mamba2-130m", "embed")])
def test_lm_loss_value_and_grads_match_jax(arch, head):
    """The vision batch carries ``patches``, the encoder-decoder batch
    ``audio``; the SSM's sequence spans two SSD chunks."""
    if arch == "mamba2-130m":
        assert S == 2 * treduced(tget(arch)).ssm.chunk_size
    _, g = _loss_and_grads_vs_jax(arch, head)
    reached = {"phi-3-vision-4.2b": lambda: [g["frontend_proj"]],
               "whisper-base": lambda: [g["frontend_proj"],
                                        *tree_leaves(g["encoder"])],
               "mamba2-130m": lambda: [g["blocks"]["pos0"]["mixer"][k]
                                       for k in ("A_log", "dt_bias", "D",
                                                 "conv_w")]}
    assert all(t.abs().max() > 0 for t in reached.get(arch, list)())


def test_encoder_grads_match_jax_with_remat_off_and_equal_remat_on():
    """The encoder's output reaches each remat'd decoder layer only
    through the cross-attention closure, so its gradient flows back
    through the checkpoint's saved-tensor hooks: with remat off too every
    leaf meets JAX's (``remat=False`` on both sides), and the port's
    loss and gradients with remat on and off are bit-equal."""
    l_off, g_off = _loss_and_grads_vs_jax("whisper-base", "lm_head",
                                          remat=False)
    _, tcfg, _, tp = _setup("whisper-base")
    (l_on, _), g_on = value_and_grad(tp, tcfg, _tb(_batch(tcfg)),
                                     TM.RunOptions(q_chunk=16,
                                                   xent_chunk=16))
    assert torch.equal(l_on, l_off)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(g_on),
                                                 tree_leaves(g_off)))
    assert all(g.abs().max() > 0 for g in tree_leaves(g_on["encoder"]))


@pytest.mark.parametrize("arch", ["whisper-base", "phi-3-vision-4.2b"])
def test_lm_loss_routes_every_op_to_plain(arch, monkeypatch):
    """No kernel has a backward, so every route under ``lm_loss`` is
    ``impl="plain"``: each ``ops.use_kernel`` call (attention asks it
    before ``ops.flash_attention``) and each ``ops`` wrapper's ``impl``,
    the whisper encoder's attention and norms among them, which
    ``"auto"`` would send to K5 and K3 on the card.  On the CPU ``"auto"``
    runs the plain versions too, so only the argument shows the route."""
    _, tcfg, _, tp = _setup(arch)
    routes = []
    for name in ("use_kernel", "flash_attention", "rmsnorm", "add_rmsnorm",
                 "rmsnorm_qk"):
        fn = getattr(tops, name)

        def spy(*a, _n=name, _f=fn, **k):
            impl = a[0] if _n == "use_kernel" else k.get("impl", "auto")
            routes.append((_n, impl))
            return _f(*a, **k)
        monkeypatch.setattr(tops, name, spy)
    value_and_grad(tp, tcfg, _tb(_batch(tcfg)),
                   TM.RunOptions(q_chunk=16, xent_chunk=16))
    assert {n for n, _ in routes} == {"use_kernel", "rmsnorm", "add_rmsnorm"}
    assert {impl for _, impl in routes} == {"plain"}, routes


def test_remat_on_equals_off_and_dots_policy_is_refused():
    # "dots" (the matmul outputs saved) is no longer refused: every
    # policy, and remat off, gives the same loss and grads bit for bit
    _, tcfg, _, tp = _setup("qwen3-1.7b")
    b = TokenPipeline(tcfg.vocab_size, S, B, device="cpu").get_batch(3)
    runs = [value_and_grad(tp, tcfg, b, TM.RunOptions(
        q_chunk=16, xent_chunk=16, remat=remat, remat_policy=policy))
        for remat, policy in ((True, "nothing"), (False, "nothing"),
                              (True, "none"), (True, "dots"),
                              (False, "dots"))]
    (l0, _), g0 = runs[0]
    for (l1, _), g1 in runs[1:]:
        assert torch.equal(l0, l1)
        assert all(torch.equal(a, c) for a, c in zip(tree_leaves(g0),
                                                     tree_leaves(g1)))


def test_bf16_weights_matches_jax():
    cfg, tcfg, jp, tp = _setup("qwen3-1.7b")
    batch = _batch(cfg, 2)
    opts = JM.RunOptions(q_chunk=16, xent_chunk=16, bf16_weights=True)
    jl, _ = jax.jit(lambda p, b: JM.lm_loss(p, cfg, b, SINGLE_DEVICE_RULES,
                                             opts))(jp, batch)
    tl, _ = TM.lm_loss(tp, tcfg, _tb(batch), TM.RunOptions(
        q_chunk=16, xent_chunk=16, bf16_weights=True))
    # bf16 weights with f32 activations: the products promote to f32, so
    # only the summation order differs
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)


def _microbatch_steps(arch):
    """Two steps at ``microbatches=2`` against JAX's accumulation."""
    cfg, tcfg, jp, tp = _setup(arch)
    mesh = make_host_mesh()
    shape = ShapeConfig("custom", S, B, "train")
    jopts = JM.RunOptions(q_chunk=16, xent_chunk=16, microbatches=2)
    cell = jbuild_cell(cfg, shape, mesh, opts=jopts, lr_peak=3e-3,
                       total_steps=100)
    tcell = build_cell(tcfg, TShapeConfig("custom", S, B, "train"),
                       TM.RunOptions(q_chunk=16, xent_chunk=16,
                                     microbatches=2),
                       lr_peak=3e-3, total_steps=100)
    jo, to = JA.init_opt_state(jp), TA.init_opt_state(tp)
    jpipe = JPipeline(cfg.vocab_size, S, B)
    tpipe = TokenPipeline(cfg.vocab_size, S, B, device="cpu")
    with mesh:
        fn = jax.jit(cell.fn)
        for step in range(2):
            extra = frontend_inputs(cfg, B, step)
            jp, jo, jm = fn(jp, jo, {**jpipe.get_batch(step), **extra})
            tp, to, tm = tcell.fn(tp, to, {**tpipe.get_batch(step),
                                           **_tb(extra)})
            for key in ("loss", "xent"):
                np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                           rtol=1e-5)
            np.testing.assert_allclose(float(tm["grad_norm"]),
                                       float(jm["grad_norm"]), rtol=1e-4)
    for a, t in zip(jax.tree.leaves(jp), tree_leaves(tp)):
        np.testing.assert_allclose(t.numpy(), np.asarray(a), atol=5e-5)


def test_microbatches_match_jax_accumulation():
    _microbatch_steps("qwen3-1.7b")


@pytest.mark.parametrize("arch", ["phi-3-vision-4.2b", "whisper-base"])
def test_microbatches_split_patches_and_audio(arch):
    """The split slices every batch key: each microbatch carries its own
    rows of ``patches`` or ``audio``, as the reference's ``reshape``."""
    _microbatch_steps(arch)


# ---------------------------------------------------------------------------
# elastic planner
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hosts,per_host,model,pods", [
    (9, 8, 16, 2), (2, 8, 16, 2), (10, 8, 16, 2), (7, 4, 8, 1),
    (100, 8, 8, 4), (3, 8, 4, 2)])
def test_plan_remesh_matches_reference(hosts, per_host, model, pods):
    survivors = [f"h{i}" for i in range(hosts)][::-1]
    want = JE.plan_remesh(survivors, per_host, model, num_pods=pods)
    got = TE.plan_remesh(survivors, per_host, model, num_pods=pods)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    single = dict(num_pods=pods, multi_pod=False)
    assert dataclasses.asdict(TE.plan_remesh(survivors, per_host, model,
                                             **single)) == \
        dataclasses.asdict(JE.plan_remesh(survivors, per_host, model,
                                          **single))
    with pytest.raises(RuntimeError):
        TE.plan_remesh(["h0"], 1, per_host * 2)


def test_elastic_coordinator_matches_reference():
    def drive(mod):
        hosts = [f"h{i}" for i in range(6)]
        coord = mod.ElasticCoordinator(hosts, devices_per_host=8,
                                       model_parallel=16, timeout_s=10.0,
                                       num_pods=2)
        plans = []
        for step in range(8):
            now = float(step * 4)
            for h in hosts:
                if not (h == "h5" and step >= 2):
                    coord.hb.beat(h, now=now)
                coord.straggle.record(h, 3.0 if h == "h1" else 1.0)
            plan = coord.check(step, now=now)
            plans.append(None if plan is None else dataclasses.asdict(plan))
        return plans, [dataclasses.asdict(e) for e in coord.events]
    assert drive(TE) == drive(JE)
