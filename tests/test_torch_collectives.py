"""The port's hierarchical and int8-compressed collectives
(``repro_torch.core.collectives``) on 8 gloo ranks, the (pod 2, data 2,
model 2) mesh, against the reference's on an 8-device virtual mesh: the
cases of ``tests/subproc/check_collectives.py`` items 1-5, on ``x =
arange(24) / 7`` given on every rank.

One fixture runs ``tests/_jax_mesh_ref.py collectives`` and
``tests/_torch_dist.py collectives`` side by side, each with its own
timeout.  Limits: the full-precision sums rtol 1e-6 (the reference's);
the compressed sum within one quantization step of the reference's per
pod (a code may flip at a rounding boundary), and within 2% of the flat
sum; the error feedback bounded by one quantization step, as the
reference checks it.
"""
import os

import numpy as np
import pytest
import torch
from _mesh_inputs import HERE, finish, start


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("coll"))
    ref = os.path.join(out, "jax.npz")
    finish([start([os.path.join(HERE, "_jax_mesh_ref.py"), "collectives",
                   ref], out),
            start([os.path.join(HERE, "_torch_dist.py"), "collectives",
                   out], out)], timeout=180)
    ranks = [torch.load(os.path.join(out, f"collectives.rank{r}.pt"))
             for r in range(8)]
    return dict(np.load(ref)), ranks


@pytest.mark.parametrize("key", ["flat", "hier", "wrapper", "fallback",
                                 "flat2"])
def test_full_precision_sums_match_jax(runs, key):
    ref, ranks = runs
    for r in ranks:
        np.testing.assert_allclose(r[key].numpy(), ref[key], rtol=1e-6)


def test_hierarchical_equals_flat(runs):
    _, ranks = runs
    for r in ranks:
        np.testing.assert_allclose(r["hier"].numpy(), r["flat"].numpy(),
                                   rtol=1e-6)
        np.testing.assert_allclose(r["fallback"].numpy(),
                                   r["flat2"].numpy(), rtol=1e-6)


def test_compressed_matches_jax_within_one_step(runs):
    ref, ranks = runs
    x = ref["x"]
    # each pod's shard is the in-pod sum of 2 copies: its scale is at most
    # max|2x| / 127, and the pods' codes add
    step = 2 * np.abs(x).max() / 127 * 1.0001
    for r in ranks:
        comp = r["comp"].numpy()
        assert np.abs(comp - ref["comp"]).max() <= 2 * step
        rel = np.abs(comp - ref["flat"]).max() / np.abs(ref["flat"]).max()
        assert rel < 0.02, rel
    # rank 0 (pod 0, data 0) holds the shard of the reference's device 0
    np.testing.assert_allclose(ranks[0]["err"].numpy(), ref["err"],
                               atol=step)


def test_error_feedback_is_bounded_by_one_step(runs):
    ref, ranks = runs
    lim = float(np.abs(ref["x"]).max()) * 2 / 127 + 1e-6
    for r in ranks:
        assert r["err"].shape == (12,)
        assert 0 < float(r["err"].abs().max()) <= lim
