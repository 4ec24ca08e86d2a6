"""The port's serving cells (``launch.steps.build_cell`` at prefill and
decode shapes) over a mesh of gloo ranks on the CPU, held to the JAX
package's cells on a virtual 8-device mesh; and the merge of a split
sequence's partial attention states (``parallel.sequence``) against
attention over the whole sequence.

One fixture per module runs, side by side, ``tests/_jax_mesh_ref.py
serve`` (the reference's ``build_cell`` on the (pod 2, data 2, model 2)
mesh) and ``tests/_torch_dist.py serve`` (8 ranks on that mesh); each
subprocess has its own timeout.  Reduced f32 configs with params, prompts
and caches drawn with numpy (``_mesh_inputs.serve_inputs``), the cases
of ``_mesh_inputs.SERVE_CASES``: qwen3-1.7b's prefill at 8 × 16, its
decode at 8 × 32 with ``decode_kv_seq_axis`` off (KV heads over "model")
and on (the sequence over "model"), and at batch 1 (the sequence over
"data", and over "data" × "model" with the flag); gemma3-12b at 64 rows
(window 32) with a full-length cache and with the ring, its sequence
over "model"; qwen2-moe-a2.7b at capacity factor 0.5 and mamba2-130m
(states split by batch and by "model", no sequence axis).  Seat
positions cross the slices' edges over the steps, and some leave a
rank's slice empty.  The other families (``_mesh_inputs.SERVE_FAMILIES``)
are held to the port's own meshless cells on the same mesh.

Tolerances: each step's logits within 1e-5 of the largest |logit|, the
greedy tokens equal, every cache leaf, assembled from the ranks' slices
(every copy of a slice equal), within 1e-5 of its norm.  mamba2-130m's
prefill logits are held to JAX within ``tests/test_torch_ssm.py``'s 1e-4
of the largest (the port sums the SSD's inter-chunk recurrence chunk by
chunk where JAX runs an associative scan; its meshless prefill parts from
JAX's by as much), and the dense and SSM prefill cells to the port's
meshless prefill within 1e-6 of the largest logit and of each cache
leaf's norm.
"""
import os

import numpy as np
import pytest
import torch

import _mesh_inputs as MI
from _mesh_inputs import HERE, finish, start

WORLD = 8
LOGIT_TOL = 1e-5
CACHE_TOL = 1e-5
#: the SSM family's logit tolerance against JAX (``tests/test_torch_ssm.py``)
SSM_LOGIT_TOL = 1e-4
MESHLESS_TOL = 1e-6
DECODE = [c for c in MI.SERVE_CASES if c[2] == "decode"]
PREFILL = [c for c in MI.SERVE_CASES if c[2] == "prefill"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("serve"))
    ref = os.path.join(out, "jax.npz")
    procs = [start([os.path.join(HERE, "_jax_mesh_ref.py"), "serve", ref],
                   out),
             start([os.path.join(HERE, "_torch_dist.py"), "serve",
                    os.path.join(out, "serve")], out)]
    finish(procs, timeout=150)
    ranks = [torch.load(os.path.join(out, "serve", f"serve.rank{r}.pt"),
                        weights_only=False) for r in range(WORLD)]
    return {"jax": dict(np.load(ref)), "ranks": ranks}


def _rows(ranks, key, tag, batch):
    """The global rows of ``key`` (per rank: its rows ``tag/rows``),
    every copy of a row equal across ranks."""
    out = [None] * batch
    for r in ranks:
        lo, hi = r[f"{tag}/rows"]
        for i, row in zip(range(lo, hi), r[key].numpy()):
            if out[i] is None:
                out[i] = row
            else:
                np.testing.assert_array_equal(out[i], row, err_msg=key)
    assert all(x is not None for x in out), key
    return np.stack(out)


def _assembled(ranks, tag):
    """Every cache leaf whole, from the ranks' slices (each copy of a
    slice equal)."""
    parts = {}
    for r in ranks:
        for name, (t, idx) in r[f"{tag}/cache"].items():
            seen = parts.setdefault(name, {})
            if idx in seen:
                np.testing.assert_array_equal(seen[idx], t.numpy(),
                                              err_msg=name)
            seen[idx] = t.numpy()
    result = {}
    for name, seen in parts.items():
        shape = tuple(max(idx[d][1] for idx in seen)
                      for d in range(len(next(iter(seen)))))
        a = np.full(shape, np.nan, np.float32)
        for idx, t in seen.items():
            a[tuple(slice(lo, hi) for lo, hi in idx)] = t
        assert not np.isnan(a).any(), name
        result[name] = a
    return result


def _close_logits(got, want, what, tol=LOGIT_TOL):
    lim = tol * np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= lim, (what, err, lim)


def _close_cache(ranks, want, tag, tol=CACHE_TOL):
    """The cache assembled from the ranks against ``want`` (leaf name ->
    whole array), each leaf within ``tol`` of its norm."""
    got = _assembled(ranks, tag)
    assert set(got) == set(want), (tag, sorted(got), sorted(want))
    for k, w in want.items():
        assert got[k].shape == w.shape, (tag, k, got[k].shape, w.shape)
        err = np.linalg.norm(got[k] - w)
        assert err <= tol * np.linalg.norm(w), (tag, k, err)


def _jax_cache(ref, tag):
    return {k[len(f"{tag}/cache/"):]: v for k, v in ref.items()
            if k.startswith(f"{tag}/cache/")}


@pytest.mark.parametrize("case", PREFILL, ids=[c[0] for c in PREFILL])
def test_prefill_cell_matches_jax(runs, case):
    """The prefill cell's last-position logits of every row, each rank
    giving its rows whole over the vocabulary, and its cache assembled
    from the ranks' slices, against the reference's cell."""
    tag, name, _, batch, _, _, _ = case
    ranks, ref = runs["ranks"], runs["jax"]
    _close_logits(_rows(ranks, f"{tag}/logits", tag, batch),
                  ref[f"{tag}/logits"], tag,
                  SSM_LOGIT_TOL if name == "ssm" else LOGIT_TOL)
    _close_cache(ranks, _jax_cache(ref, tag), tag)


#: the MoE config's capacity is per rank's rows over a mesh (as in the
#: reference's cell) and per batch without one: at capacity factor 0.5 the
#: two drop other pairs, so it is held to JAX's cell alone
NO_MOE = [c for c in PREFILL if c[1] != "moe"]


@pytest.mark.parametrize("case", NO_MOE, ids=[c[0] for c in NO_MOE])
def test_prefill_cell_matches_the_meshless_prefill(runs, case):
    """The prefill cell over the mesh against the port's meshless prefill
    cell on the whole batch (rank 0): the mesh moves the logits and the
    cache by sums in another order only."""
    tag, _, _, batch, _, _, _ = case
    ranks, r0 = runs["ranks"], runs["ranks"][0]
    _close_logits(_rows(ranks, f"{tag}/logits", tag, batch),
                  r0[f"{tag}/meshless/logits"].numpy(), tag, MESHLESS_TOL)
    _close_cache(ranks, {f"{p}/{k}": t.numpy() for p, ent in
                         r0[f"{tag}/meshless/cache"].items()
                         for k, t in ent.items()}, tag, MESHLESS_TOL)


@pytest.mark.parametrize("case", DECODE, ids=[c[0] for c in DECODE])
def test_decode_cell_matches_jax(runs, case):
    """``SERVE_STEPS`` greedy decode steps from the same drawn cache:
    each step's logits and tokens, then the cache after them, assembled
    from the ranks' slices, against the reference's cell."""
    tag, _, _, batch, _, _, _ = case
    ranks, ref = runs["ranks"], runs["jax"]
    for step in range(MI.SERVE_STEPS):
        _close_logits(_rows(ranks, f"{tag}/logits/{step}", tag, batch),
                      ref[f"{tag}/logits/{step}"], (tag, step))
        np.testing.assert_array_equal(
            _rows(ranks, f"{tag}/tokens/{step}", tag, batch),
            ref[f"{tag}/tokens/{step}"], err_msg=f"{tag} step {step}")
    _close_cache(ranks, _jax_cache(ref, tag), tag)


FAMILIES = [(name, kind, batch) for name in MI.SERVE_FAMILIES
            for kind, batch, _, _ in MI.FAMILY_CELLS]


@pytest.mark.parametrize("name,kind,batch", FAMILIES)
def test_families_match_the_meshless_cells(runs, name, kind, batch):
    """whisper-base (the encoder whole on each rank, its cross-attention
    over the cached encoder K/V split by heads), phi-3-vision-4.2b (patch
    rows), jamba-v0.1-52b (attention, SSM and MoE layers), minicpm-2b's
    odd vocabulary of 251 (the head whole on every rank), one KV head and
    3 heads padded to 4 (q gathered over "model" where the cache holds
    every KV head): one prefill or decode step on the (2, 2, 2) mesh
    against the port's meshless cell, within 1e-5 of the largest
    logit."""
    tag = f"family/{name}/{kind}/{batch}"
    ranks = runs["ranks"]
    _close_logits(_rows(ranks, f"{tag}/logits", tag, batch),
                  ranks[0][f"{tag}/meshless"].numpy(), tag)


@pytest.mark.parametrize("case", DECODE, ids=[c[0] for c in DECODE])
def test_zero_cache_has_each_ranks_shape(runs, case):
    for r in runs["ranks"]:
        assert r[f"{case[0]}/init_cache"], case[0]


def test_placements_follow_the_rules(runs):
    """Where the rules put the decode cache's sequence: over "model" with
    the flag at batch 8 (each model rank half the rows, KV heads whole),
    not at all without it (KV heads over "model"); at batch 1 over
    "data", and over "data" × "model" with the flag, every rank on the
    same row."""
    r = runs["ranks"][0]
    idx = lambda tag: r[f"{tag}/cache"]["pos0/k"][1]  # noqa: E731
    assert idx("dense/decode") == ((0, 2), (0, 2), (0, 32), (0, 2), (0, 16))
    assert idx("dense/decode_seq") == ((0, 2), (0, 2), (0, 16), (0, 4),
                                       (0, 16))
    assert idx("dense/b1") == ((0, 2), (0, 1), (0, 16), (0, 2), (0, 16))
    assert idx("dense/b1_seq") == ((0, 2), (0, 1), (0, 8), (0, 4), (0, 16))
    for r in runs["ranks"]:
        assert r["dense/b1/rows"] == (0, 1)


def test_decode_runs_the_split_heads(runs):
    """The first decode step went through the tensor-parallel functions:
    the heads' outputs summed over "model", and q gathered over it where
    the sequence holds "model"."""
    r0 = runs["ranks"][0]
    for tag, *_ in DECODE:
        if tag.startswith("ssm"):
            assert r0[f"{tag}/calls"]["gather"] > 0, tag
            continue
        assert r0[f"{tag}/calls"]["reduce"] > 0, tag
    assert r0["dense/decode_seq/calls"]["gather"] > 0


# -- the merge of a split sequence alone ---------------------------------------

def _split_merge(q, k, v, lengths, parts: int, window=None):
    """Plain K4 over ``parts`` slices of the cache's rows, each with
    ``lse=`` at the local bounds of ``parallel.sequence``, and the
    states merged; the slices' lse values too."""
    from repro_torch.kernels import ops
    from repro_torch.parallel import sequence as S
    T = k.shape[1]
    n = T // parts
    outs, lses = [], []
    for r in range(parts):
        lo = r * n
        lens, starts = S.local_bounds(lengths - 1, lo, n, window)
        lse = torch.empty(q.shape[0], q.shape[2])
        outs.append(ops.decode_attention(q, k[:, lo:lo + n], v[:, lo:lo + n],
                                         lens, starts=starts, lse=lse,
                                         impl="plain")[:, 0])
        lses.append(lse)
    out, _ = S.merge(torch.stack(outs), torch.stack(lses))
    return out, torch.stack(lses)


@pytest.mark.parametrize("window", [None, 5, 20])
@pytest.mark.parametrize("parts", [1, 2, 4])
def test_split_and_merge_equals_whole(window, parts):
    """Plain K4 over slices with ``lse=`` and ``starts=``, merged, against
    plain K4 over the whole cache (with the window), in f32 within 2e-6;
    seats whose keys lie in one slice leave the others empty (``lse =
    -inf``, output 0)."""
    from repro_torch.kernels import ops
    g = torch.Generator().manual_seed(3)
    B, T, H, KVH, d = 6, 64, 8, 2, 16
    q = torch.randn((B, 1, H, d), generator=g)
    k = torch.randn((B, T, KVH, d), generator=g)
    v = torch.randn((B, T, KVH, d), generator=g)
    lengths = torch.tensor([1, 15, 16, 17, 40, 64], dtype=torch.int32)
    want = ops.decode_attention(q, k, v, lengths, window=window,
                                impl="plain")[:, 0]
    got, lses = _split_merge(q, k, v, lengths, parts, window)
    assert float((got - want).abs().max()) < 2e-6
    if parts == 4:
        assert torch.isinf(lses[1:, 0]).all() and \
            (lses[1:, 0] < 0).all()


def test_lse_is_the_log_sum_exp_of_the_scaled_scores():
    from repro_torch.kernels import ops
    g = torch.Generator().manual_seed(4)
    B, T, H, d = 2, 10, 2, 8
    q = torch.randn((B, 1, H, d), generator=g)
    k = torch.randn((B, T, H, d), generator=g)
    v = torch.randn((B, T, H, d), generator=g)
    lengths = torch.tensor([0, 7], dtype=torch.int32)
    starts = torch.tensor([0, 2], dtype=torch.int32)
    lse = torch.empty(B, H)
    out = ops.decode_attention(q, k, v, lengths, starts=starts, lse=lse,
                               impl="plain")
    s = torch.einsum("hd,thd->ht", q[1, 0], k[1, 2:7]) * d ** -0.5
    assert torch.allclose(lse[1], torch.logsumexp(s, -1), atol=1e-6)
    assert torch.isneginf(lse[0]).all() and not out[0].any()
    assert out.dtype == torch.float32


def test_merge_of_all_empty_states_is_zero_not_nan():
    from repro_torch.parallel import sequence as S
    o = torch.zeros(3, 2, 4, 8)
    lse = torch.full((3, 2, 4), -torch.inf)
    out, total = S.merge(o, lse)
    assert not out.isnan().any() and not out.any()
    assert torch.isneginf(total).all()


def test_owner_writes_only_its_rows():
    """``write_owned`` writes a seat's row on the rank whose slice holds
    it and leaves every other rank's slice as it was."""
    from repro_torch.parallel import sequence as S
    cache = torch.zeros(4, 8, 2)
    pos = torch.tensor([0, 7, 8, 15])
    local, mine = S.owner_rows(pos, 8, 8)
    S.write_owned(cache, local, mine, torch.ones(4, 2))
    assert mine.tolist() == [False, False, True, True]
    assert cache[2, 0].eq(1).all() and cache[3, 7].eq(1).all()
    assert int(cache.sum()) == 4
