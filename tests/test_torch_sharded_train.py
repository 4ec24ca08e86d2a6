"""The port's data-parallel train step over gloo ranks on the CPU, held
to the JAX package on a virtual 4-device mesh.

One fixture per module runs, side by side, ``tests/_jax_mesh_ref.py
train`` (the reference, once) and ``tests/_torch_dist.py sharded`` (4
ranks on the (pod 2, data 2, model 1) mesh) and ``train`` (2 ranks under
torchrun's variables, then one rank on a world of one); each
subprocess has its own timeout.  Reduced f32 qwen3-1.7b (dense) and
qwen2-moe-a2.7b at capacity factor 0.5 (pairs drop on every rank, whose
capacity is per rank's rows as in the reference's GSPMD step), params
drawn with numpy (``_mesh_inputs``), batch 8 × 32, lr 3e-3 peak over
300 steps; every step clips (grad norms above 1).  The port's steps
remat each layer (its gathers re-run in backward); the reference's run
without remat, which changes no value and compiles faster.

Tolerances (``_torch_train_inputs.TOL["float32"]``): losses, xent and
aux loss rtol 1e-5, grad norms 1e-3, lr 1e-6, and the update ``p_3 -
p_0`` within 1e-3 of its norm.  The output weight (the tied ``embed``,
or ``lm_head``) is the exception: the chunked cross-entropy rounds its
gradient to bf16 (as the reference's does, even in f32 configs), and
over ranks each rank rounds its own rows' part before the ranks' sum,
so its gradient parts from one device's by up to a bf16 rounding
(1e-3 of its largest element at step 0): its update within 2^-8 (one
bf16 rounding) of its norm.  No per-element param limit: at this init a
few elements' gradients are rounding noise (the same JAX run with
another thread count moves them by 3e-4), and AdamW's first steps turn
any such noise into a step of about the lr.  The compressed step
against JAX: each step's error feedback within one quantization step
(the leaf's scale) per element, since the gradients may part by ulps
(the output weight's by a bf16 rounding, which is added to its limit)
and flip a code at a rounding boundary; against the plain int8
composition on the ranks' own gradients, bit for bit.  ``train()`` on
the reduced config computes in bf16: 2 ranks against 1 by
``TOL["bfloat16"]``.
"""
import os

import numpy as np
import pytest
import torch
from _torch_train_inputs import TOL

import _mesh_inputs as MI
from _mesh_inputs import HERE, finish, free_port, start
from repro_torch.tree import tree_flatten_with_paths

F32 = TOL["float32"]
METRICS = ("loss", "xent", "aux_loss", "grad_norm", "lr")
RTOL = dict(loss=F32["loss"], xent=F32["loss"], aux_loss=F32["loss"],
            grad_norm=F32["grad_norm"], lr=1e-6)
HEADS = ("embed", "lm_head")         # the output weight's leaf
BF16_STEP = 2.0 ** -8


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dp"))
    ref = os.path.join(out, "jax.npz")
    procs = [start([os.path.join(HERE, "_jax_mesh_ref.py"), "train", ref],
                   out),
             start([os.path.join(HERE, "_torch_dist.py"), "sharded",
                    os.path.join(out, "sharded")], out),
             start([os.path.join(HERE, "_torch_dist.py"), "train",
                    os.path.join(out, "train"), str(free_port())], out)]
    finish(procs)
    load = lambda case, n: [torch.load(  # noqa: E731
        os.path.join(out, case, f"{case}.rank{r}.pt"), weights_only=False)
        for r in range(n)]
    return {"jax": dict(np.load(ref)), "sharded": load("sharded", 4),
            "train": load("train", 2), "dir": out}


def jax_metrics(ref, tag):
    return np.stack([ref[f"{tag}/metrics/{s}"] for s in range(MI.STEPS)])


def assert_metrics(got, want, what):
    got = np.asarray(got)
    for i, key in enumerate(METRICS):
        np.testing.assert_allclose(got[:, i], want[:, i], rtol=RTOL[key],
                                   atol=1e-30, err_msg=f"{what} {key}")


def assert_update(got: dict, want: dict, name: str):
    """Every leaf's update ``p_3 - p_0`` within ``F32["update"]`` of its
    norm; ``got``, ``want``: leaf name -> whole array."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import model as M
    cfg = MI.config(name, get_config, reduced_config)
    start_ = dict(tree_flatten_with_paths(MI.np_params(M.param_specs(cfg),
                                                       name)))
    assert set(got) == set(want) == set(start_)
    for k, p0 in start_.items():
        a, t = np.asarray(want[k]), np.asarray(got[k])
        err = np.linalg.norm(a - t) / np.linalg.norm(a - p0)
        assert err < (BF16_STEP if k in HEADS else F32["update"]), (k, err)


def jax_params(ref, tag):
    n = len(tag) + len("/params/")
    return {k[n:]: v for k, v in ref.items()
            if k.startswith(f"{tag}/params/")}


@pytest.mark.parametrize("name,jtag", [("dense", "dense/single"),
                                       ("moe", "moe/mesh")])
def test_auto_matches_jax(runs, name, jtag):
    """Three ``"auto"`` steps on 4 ranks against the reference's: the
    dense config's single-device steps (the contract of
    ``tests/subproc/check_sharded_train.py``), the MoE config's steps on
    the (2, 2, 1) mesh, whose capacity and drops are per data shard and
    whose aux loss is the global batch's: losses first, then params."""
    r0 = runs["sharded"][0]
    assert_metrics(r0[f"{name}/auto/metrics"], jax_metrics(runs["jax"], jtag),
                   name)
    assert_update(r0[f"{name}/auto/params"], jax_params(runs["jax"], jtag),
                  name)


def test_every_rank_reports_the_same_step(runs):
    for r in runs["sharded"][1:]:
        for name in ("dense", "moe"):
            assert torch.equal(r[f"{name}/auto/metrics"],
                               runs["sharded"][0][f"{name}/auto/metrics"])


def test_auto_matches_the_meshless_port(runs):
    r0 = runs["sharded"][0]
    assert_metrics(r0["dense/auto/metrics"],
                   np.asarray(r0["dense/meshless/metrics"]), "meshless")
    assert_update(r0["dense/auto/params"],
                  dict(tree_flatten_with_paths(r0["dense/meshless/params"])),
                  "dense")


def test_auto_accumulates_microbatches(runs):
    """Two microbatches of each rank's rows, accumulated: the same steps
    as one batch, by the f32 tolerance (the loss is a mean either way)."""
    r0 = runs["sharded"][0]
    assert_metrics(r0["dense/micro/metrics"],
                   np.asarray(r0["dense/auto/metrics"]), "microbatches")
    assert_update(r0["dense/micro/params"], r0["dense/auto/params"],
                  "dense")


def test_compressed_sync_is_the_plain_int8_composition(runs):
    """On every rank and step: the synced leaves equal, bit for bit, the
    plain per-tensor int8 quantize-dequantize of ``g / npods + ef`` of
    each pod summed over the pods."""
    for r in runs["sharded"]:
        assert r["dense/compressed/plain_sync"].all()


def test_compressed_matches_jax(runs):
    """The compressed cell against the reference's on the (2, 2, 1) mesh:
    losses and grad norms as above, and after each step the error
    feedback (pod 0's) within one quantization step of the leaf, whose
    scale is the largest magnitude of ``g / npods + ef`` over 127."""
    r0, ref = runs["sharded"][0], runs["jax"]
    assert_metrics(r0["dense/compressed/metrics"],
                   jax_metrics(ref, "dense/compressed"), "compressed")
    for step in range(MI.STEPS):
        ef_prev = (r0[f"dense/compressed/ef/{step - 1}"] if step
                   else None)
        for k, ef in r0[f"dense/compressed/ef/{step}"].items():
            x = r0[f"dense/compressed/grad/{step}"][k] / 2
            if ef_prev is not None:
                x = x + ef_prev[k]
            scale = (float(x.abs().max()) + 1e-12) / 127
            lim = scale * (1 + 1e-3) + (BF16_STEP * x.abs().numpy()
                                        if k in HEADS else 0)
            err = np.abs(ef.numpy() - ref[f"dense/compressed/ef/{step}/{k}"])
            assert (err <= lim).all(), (step, k, err.max(), scale)


def test_elastic_restore_4_to_1_and_back(runs):
    """Saved on 4 ranks after 2 steps, restored onto 1 rank (whole
    leaves), step 3 equals the 4-rank run's step 3; saved on 1 rank,
    restored onto 4, step 3 equals the meshless run's."""
    r0 = runs["sharded"][0]
    assert_metrics(r0["elastic/4to1/metrics"],
                   np.asarray(r0["dense/auto/metrics"])[2:], "4 -> 1")
    assert int(r0["elastic/4to1/count"]) == 3
    for r in runs["sharded"]:
        assert_metrics(r["elastic/1to4/metrics"],
                       np.asarray(r0["dense/meshless/metrics"])[2:],
                       "1 -> 4")
        assert int(r["elastic/1to4/count"]) == 3


def test_token_pipeline_rank_slices_are_the_global_batch():
    """Each rank's rows, in (pod, data) order, concatenated: JAX's global
    batch bit for bit (the ranks' own batches are read in the next test)."""
    from repro.data.pipeline import TokenPipeline as JPipeline
    from repro_torch.data.pipeline import TokenPipeline

    class Fake:                      # a mesh's names, sizes, coordinates
        axis_names = ("pod", "data", "model")
        shape = {"pod": 2, "data": 2, "model": 1}

        def __init__(self, pod, data):
            self.coords = {"pod": pod, "data": data, "model": 0}

        def coordinate(self, axis):
            return self.coords[axis]

    jp = JPipeline(256, MI.SEQ, MI.BATCH)
    for step in range(MI.STEPS):
        parts = [TokenPipeline(256, MI.SEQ, MI.BATCH, device="cpu",
                               mesh=Fake(p, d),
                               batch_spec=(("pod", "data"), None)
                               ).get_batch(step)
                 for p in range(2) for d in range(2)]
        want = jp.get_batch(step)
        for key in ("tokens", "labels"):
            got = torch.cat([b[key] for b in parts]).numpy()
            np.testing.assert_array_equal(got, np.asarray(want[key]))


def test_ranks_batches_concatenate_to_the_global_batch(runs):
    from repro.data.pipeline import TokenPipeline as JPipeline
    jp = JPipeline(256, MI.SEQ, MI.BATCH)
    ranks = runs["sharded"]
    assert [tuple(r["pipeline/rows"].tolist()) for r in ranks] == \
        [(0, 2), (2, 4), (4, 6), (6, 8)]
    for step in range(MI.STEPS):
        want = jp.get_batch(step)
        for key in ("tokens", "labels"):
            got = torch.cat([r[f"pipeline/{step}"][key] for r in ranks])
            np.testing.assert_array_equal(got.numpy(), np.asarray(want[key]))


def test_train_over_two_ranks_equals_one_rank(runs, tmp_path):
    """``train()`` under torchrun's variables on 2 ranks (the (2, 1)
    host mesh, checkpoints every 2 steps) against ``train()`` in this
    process (no process group): losses by the f32 tolerance, and the
    2-rank run's last checkpoint restored onto one rank."""
    from _torch_dist import TRAIN_KW
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.launch import train as T
    two = runs["train"]
    assert two[0]["losses"] == two[1]["losses"]
    assert not two[0]["initialized_after"]
    one_ck = str(tmp_path / "one")
    one = T.train("qwen3-1.7b", ckpt_dir=one_ck, ckpt_every=2, **TRAIN_KW)
    np.testing.assert_allclose(two[0]["losses"], one,
                               rtol=TOL["bfloat16"]["loss"])
    mgr = CheckpointManager(os.path.join(runs["dir"], "train", "train_ck"))
    assert mgr.steps() == [2, 4]
    cfg = reduced_config(get_config("qwen3-1.7b"))
    p0, o0 = T.make_train_state(cfg, torch.Generator().manual_seed(0), "cpu")
    _, two_state = mgr.restore({"params": p0, "opt": o0}, 4)
    _, one_state = CheckpointManager(one_ck).restore(
        {"params": p0, "opt": o0}, 4)
    assert int(two_state["opt"]["count"]) == 4
    for (k, a), (_, b), (_, start_) in zip(
            tree_flatten_with_paths(two_state["params"]),
            tree_flatten_with_paths(one_state["params"]),
            tree_flatten_with_paths(p0)):
        assert a.shape == b.shape == start_.shape, k
        err = float(torch.linalg.vector_norm(a - b)
                    / torch.linalg.vector_norm(b - start_))
        assert err < TOL["bfloat16"]["update"], (k, err)


def test_train_init_builds_the_optimizer_state_on_the_shards(runs):
    """``train()``'s init over ranks (``make_train_state(cell=)``) on the
    (1, 2, 2) mesh: params, AdamW moments, count and the compressed
    sync's error feedback bit-equal to the whole state cut by
    ``Cell.shard_state`` (the old init), and ``init_opt_state`` given
    this rank's slices only: a leaf the placement splits never reaches
    it whole."""
    for r in runs["sharded"]:
        assert r["init/equal"] and r["init/leaves"] > 0
        assert r["init/seen"] == r["init/local"]
        split = [a != b for a, b in zip(r["init/local"], r["init/whole"])]
        assert len(split) == len(r["init/whole"]) and any(split)


def test_world_of_one_is_the_meshless_step_bit_for_bit(runs):
    """On one rank (the (1, 1, 1) mesh, every collective a copy) three
    ``"auto"`` steps of the MoE config equal three meshless steps bit
    for bit (losses, grad norms, every param), and the compressed sync
    equals the plain int8 composition of ``g + ef``, bit for bit, and
    the new error feedback ``g + ef - deq`` exactly: the checks that
    ``chip_smoke.py``'s phase ``dist`` makes on the card."""
    r0 = runs["train"][0]
    assert r0["world1/auto_equals_meshless"]
    assert r0["world1/compressed_plain"]
