"""The port's train step with a "model" axis: tensor parallelism over gloo
ranks on the CPU, held to the JAX package on a virtual 8-device mesh.

One fixture per module runs, side by side, ``tests/_jax_mesh_ref.py
tp`` (the reference's ``build_cell`` on the (pod 2, data 2, model 2)
mesh) and ``tests/_torch_dist.py tp`` (8 ranks on that mesh); each
subprocess has its own timeout.  Reduced f32 configs with params drawn
with numpy (``_mesh_inputs``), batch 8 × 32, lr 3e-3 peak over 300
steps: qwen3-1.7b (qk-norm, tied head; heads, KV heads, ff and the
vocabulary split), qwen2-moe-a2.7b at capacity factor 0.5 (router and
shared experts; the expert ff split, drops per data shard), mamba2-130m
(the SSM block gathered and run whole on each model rank), qwen3-1.7b
with one KV head (the KV fallback: every model rank reads it) and with 3
heads padded to 4 by ``build_cell(pad_heads=4)`` (rank 1's slice holds
the masked head).

Tolerances are ``test_torch_sharded_train.py``'s: losses, xent and aux
loss rtol 1e-5, grad norms 1e-3, the update ``p_3 - p_0`` within 1e-3
of its norm, the output weight's within 2^-8 (its gradient is rounded to
bf16 per chunk, and the ranks round their own rows' parts).  The step-1
gradient of every leaf within 1e-3 of its norm (the output weight's
within 2^-8): JAX's is read from its first moment after step 1, ``mu_1
= (1 - b1)·c·g`` with ``c = min(1, 1 / grad_norm)`` the clip factor; a
partial gradient left unsummed over "model" would part by a half.
"""
import os

import numpy as np
import pytest
import torch

import _mesh_inputs as MI
from _mesh_inputs import HERE, finish, start
from repro_torch.tree import tree_flatten_with_paths
from test_torch_sharded_train import (BF16_STEP, F32, HEADS, assert_metrics,
                                      jax_metrics)

WORLD = 8


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("tp"))
    ref = os.path.join(out, "jax.npz")
    procs = [start([os.path.join(HERE, "_jax_mesh_ref.py"), "tp", ref], out),
             start([os.path.join(HERE, "_torch_dist.py"), "tp",
                    os.path.join(out, "tp")], out)]
    finish(procs, timeout=150)
    ranks = [torch.load(os.path.join(out, "tp", f"tp.rank{r}.pt"),
                        weights_only=False) for r in range(WORLD)]
    return {"jax": dict(np.load(ref)), "ranks": ranks}


def _start(name):
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import model as M
    cfg = MI.config(name, get_config, reduced_config)
    return dict(tree_flatten_with_paths(MI.np_params(M.param_specs(cfg),
                                                     name)))


def _under(ref, prefix):
    n = len(prefix)
    return {k[n:]: v for k, v in ref.items() if k.startswith(prefix)}


def _within(got, want, lim, what):
    """Every leaf ``got[k]`` within ``lim`` (``HEADS``: ``BF16_STEP``) of
    the norm of ``want[k]``; an all-zero ``want[k]`` exactly."""
    assert set(got) == set(want), what
    for k, w in want.items():
        err = np.linalg.norm(np.asarray(got[k]) - w)
        scale = np.linalg.norm(w)
        assert err <= (BF16_STEP if k in HEADS else lim) * scale, \
            (what, k, err, scale)


@pytest.mark.parametrize("name", MI.TP_CONFIGS)
def test_auto_matches_jax(runs, name):
    """Three ``"auto"`` steps on the (2, 2, 2) mesh against the
    reference's cell on the same mesh: losses and metrics first, then
    every param's update."""
    r0, ref = runs["ranks"][0], runs["jax"]
    assert_metrics(r0[f"{name}/metrics"], jax_metrics(ref, name), name)
    p0 = _start(name)
    want = _under(ref, f"{name}/params/")
    _within({k: v.numpy() - p0[k] for k, v in r0[f"{name}/params"].items()},
            {k: v - p0[k] for k, v in want.items()}, F32["update"], name)


@pytest.mark.parametrize("name", MI.TP_CONFIGS)
def test_step1_gradients_match_jax(runs, name):
    """Every gradient leaf of step 1 (the synced gradient of the global
    batch's mean loss, whole) against JAX's."""
    r0, ref = runs["ranks"][0], runs["jax"]
    clip = min(1.0, 1.0 / float(ref[f"{name}/metrics/0"][3]))
    want = {k: v / np.float32(0.1 * clip)
            for k, v in _under(ref, f"{name}/mu1/").items()}
    _within({k: v.numpy() for k, v in r0[f"{name}/grad1"].items()}, want,
            F32["grad_norm"], name)


@pytest.mark.parametrize("name", MI.TP_CONFIGS)
def test_each_rank_holds_the_rules_slice(runs, name):
    """Each rank's slice of every initial leaf, over "data" and "model",
    is bit for bit the shard that the reference's placement gives the
    device at the same (pod, data, model) coordinate."""
    ref = runs["jax"]
    for r in runs["ranks"]:
        at = "".join(map(str, r["coords"]))
        want = _under(ref, f"{name}/shard/{at}/")
        got = r[f"{name}/shard"]
        assert set(got) == set(want)
        for k, w in want.items():
            np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)


def test_ranks_sit_on_the_mesh_in_order(runs):
    assert [r["coords"] for r in runs["ranks"]] == [
        (p, d, m) for p in range(2) for d in range(2) for m in range(2)]


def test_every_rank_reports_the_same_step(runs):
    r0 = runs["ranks"][0]
    for r in runs["ranks"][1:]:
        for name in MI.TP_CONFIGS + MI.TP_FAMILIES:
            assert torch.equal(r[f"{name}/metrics"], r0[f"{name}/metrics"])
        assert torch.equal(r["compressed/metrics"], r0["compressed/metrics"])


def test_the_step_runs_the_split_layers(runs):
    """The step-1 forward went through the tensor-parallel functions: a
    ``copy`` and a ``reduce`` per split block, the vocab-parallel
    logsumexp per chunk, and the SSM's leaves gathered."""
    r0 = runs["ranks"][0]
    for name in MI.TP_CONFIGS:
        calls = r0[f"{name}/calls"]
        assert calls["copy"] > 0 and calls["reduce"] > 0 and \
            calls["lse"] > 0, (name, calls)
    assert r0["ssm/calls"]["gather"] > 0


def test_compressed_sync_is_the_plain_int8_composition(runs):
    """The compressed dense step on the (2, 2, 2) mesh, each step's sync
    on every rank equal bit for bit to the plain per-tensor int8
    composition of the whole tensors (one scale over "data" and
    "model"); its first loss is the "auto" step's (the reference's
    compressed cell does not compile on this mesh)."""
    for r in runs["ranks"]:
        assert r["compressed/plain_sync"].all()
    r0 = runs["ranks"][0]
    np.testing.assert_allclose(r0["compressed/metrics"][0, :2],
                               r0["dense/metrics"][0, :2], rtol=1e-6)


@pytest.mark.parametrize("name", MI.TP_FAMILIES)
def test_families_match_the_meshless_step(runs, name):
    """whisper-base (the encoder whole on each rank, the decoder's self-
    and cross-attention split), phi-3-vision-4.2b (patch rows over the
    vocab-parallel embedding), jamba-v0.1-52b (attention, SSM and MoE
    layers) and minicpm-2b at an odd vocabulary of 251 (the embedding
    and the tied head whole on every rank, the cross-entropy too): one
    step on the mesh against the port's meshless step."""
    r0 = runs["ranks"][0]
    assert_metrics(r0[f"{name}/metrics"],
                   np.asarray(r0[f"{name}/meshless/metrics"]), name)
    p0 = _start(name)
    want = r0[f"{name}/meshless/params"]
    _within({k: v.numpy() - p0[k] for k, v in r0[f"{name}/params"].items()},
            {k: v.numpy() - p0[k] for k, v in want.items()},
            F32["update"], name)


def test_elastic_round_trip_8_to_1_to_8(runs):
    """The dense config saved on the (2, 2, 2) mesh after 2 steps: restored
    onto one rank, step 3 equals the mesh's step 3 by the f32
    tolerance; that rank's state saved again and restored onto the mesh,
    step 3 equals the uninterrupted mesh's bit for bit."""
    r0 = runs["ranks"][0]
    mesh = np.asarray(r0["elastic/mesh/metrics"])
    assert_metrics(r0["elastic/8to1/metrics"], mesh[2:], "8 -> 1")
    for r in runs["ranks"]:
        assert torch.equal(r["elastic/1to8/metrics"],
                           r0["elastic/mesh/metrics"][2:])
        assert int(r["elastic/1to8/count"]) == 3


class _FakeTP:
    """A model group's size and rank; ``copy`` the identity."""

    def __init__(self, n, rank):
        from repro_torch.parallel.tensor import TensorParallel
        self.n, self.rank = n, rank
        self.split = TensorParallel.split.__get__(self)
        self.offset = TensorParallel.offset.__get__(self)

    def copy(self, t):
        return t


@pytest.mark.parametrize("heads,kv,n", [(8, 1, 2), (8, 2, 4), (8, 2, 8),
                                        (12, 4, 2), (6, 2, 2), (8, 8, 2)])
def test_split_heads_read_the_kv_heads_of_their_group(heads, kv, n):
    """Under the KV fallback (KV heads whole), each rank's q head h reads
    KV head h // group, whether its slice spans whole groups, part of
    one, or parts of two; where "model" divides the KV heads the slices
    are the rank's own."""
    import dataclasses
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models.attention import _split_heads
    cfg = dataclasses.replace(reduced_config(get_config("qwen3-1.7b")),
                              num_heads=heads, num_kv_heads=kv)
    group = heads // kv
    split_kv = kv % n == 0
    wk = torch.arange(kv, dtype=torch.float32)[None, :, None].expand(
        2, kv, 1)
    for rank in range(n):
        hl = heads // n
        local = {"wq": torch.zeros(2, hl, 1),
                 "wk": wk.chunk(n, 1)[rank] if split_kv else wk,
                 "wv": wk.chunk(n, 1)[rank] if split_kv else wk}
        p, first = _split_heads(local, cfg, _FakeTP(n, rank))
        assert first == rank * hl
        read = p["wk"][0, :, 0].long().tolist()
        g = hl // len(read)
        assert [read[j // g] for j in range(hl)] == \
            [(first + j) // group for j in range(hl)], (rank, read)
