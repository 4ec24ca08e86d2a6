"""The port's checkpoint store: the reference's cases (atomic commit,
striping, async, GC, crash recovery) on ``repro_torch.checkpoint``, and
the on-disk format shared with ``repro.checkpoint``: each package
restores what the other saved, bit for bit, a bf16 leaf included."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JManager
from repro_torch.checkpoint.manager import MANIFEST, CheckpointManager
from repro_torch.tree import tree_leaves


@pytest.fixture
def tree():
    g = torch.Generator().manual_seed(0)
    return {
        "params": {"w": torch.randn(33, 17, generator=g),
                   "b": torch.randn(17, generator=g).to(torch.bfloat16)},
        "opt": {"mu": {"w": torch.ones(33, 17)},
                "count": torch.tensor(7, dtype=torch.int32)},
    }


def _bits(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def trees_equal(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and np.array_equal(_bits(x), _bits(y)) for x, y in zip(la, lb))


def test_save_restore_roundtrip(tmp_path, tree):
    mgr = CheckpointManager(str(tmp_path), stripes=3)
    mgr.save(5, tree)
    step, got = mgr.restore(tree)
    assert step == 5 and trees_equal(tree, got)
    assert got["params"]["b"].dtype == torch.bfloat16
    assert got["opt"]["count"].dtype == torch.int32
    m = json.load(open(os.path.join(str(tmp_path), "step_5", MANIFEST)))
    dtypes = {r["name"]: r["dtype"] for r in m["leaves"]}
    assert dtypes == {"params/b": "bfloat16", "params/w": "float32",
                      "opt/mu/w": "float32", "opt/count": "int32"}
    mgr.close()


def test_striping_layout(tmp_path, tree):
    mgr = CheckpointManager(str(tmp_path), stripes=4)
    d = mgr.save(1, tree)
    m = json.load(open(os.path.join(d, MANIFEST)))
    big = next(r for r in m["leaves"] if r["name"] == "params/w")
    assert len(big["files"]) == 4                      # striped across 4 OSTs
    osts = {f.split(os.sep)[0] for f in big["files"]}
    assert len(osts) == 4
    assert [r["name"] for r in m["leaves"]] == [
        "opt/count", "opt/mu/w", "params/b", "params/w"]


def test_async_save_copies_before_returning(tmp_path, tree):
    mgr = CheckpointManager(str(tmp_path))
    w0 = tree["params"]["w"].clone()
    fut = mgr.save_async(3, tree)
    tree["params"]["w"].add_(1.0)               # training moves on at once
    tree["opt"]["count"].add_(1)
    fut.result()
    step, got = mgr.restore(tree)
    assert step == 3
    assert torch.equal(got["params"]["w"], w0)
    assert int(got["opt"]["count"]) == 7
    mgr.close()


def test_crash_mid_save_leaves_previous_intact(tmp_path, tree):
    """A stale .tmp dir (simulated crash) must be invisible to restore."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, tree)
    stage = os.path.join(str(tmp_path), "step_2.tmp")
    os.makedirs(os.path.join(stage, "ost0"))
    with open(os.path.join(stage, "ost0", "params.w.stripe0"), "wb") as f:
        f.write(b"garbage")
    assert mgr.latest_step() == 1
    step, got = mgr.restore(tree)
    assert step == 1 and trees_equal(tree, got)


def test_gc_keeps_last_k(tmp_path, tree):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, tree)
    assert mgr.steps() == [3, 4]


def test_restore_places_leaves_and_refuses_an_empty_root(tmp_path, tree):
    mgr = CheckpointManager(str(tmp_path / "a"))
    with pytest.raises(FileNotFoundError):
        mgr.restore(tree)
    mgr.save(2, tree)
    like = {"params": {k: torch.empty(0, device="meta")
                       for k in ("w", "b")},
            "opt": {"mu": {"w": torch.empty(0)}, "count": torch.empty(0)}}
    _, got = mgr.restore(like, device="cpu")
    assert trees_equal(tree, got)
    assert all(t.device.type == "cpu" for t in tree_leaves(got))


def _jax_tree():
    kw, kb = jax.random.split(jax.random.PRNGKey(0))
    return {
        "params": {"w": jax.random.normal(kw, (33, 17)),
                   "b": jax.random.normal(kb, (17,)).astype(jnp.bfloat16)},
        "opt": {"mu": {"w": jnp.ones((33, 17))}, "count": jnp.int32(7)},
    }


def _as_torch(jtree):
    def conv(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.uint16).view(np.int16).copy()
                                    ).view(torch.bfloat16)
        return torch.from_numpy(a.copy())
    return jax.tree.map(conv, jtree)


def test_jax_saves_port_restores(tmp_path):
    jtree = _jax_tree()
    JManager(str(tmp_path), stripes=3).save(11, jtree)
    step, got = CheckpointManager(str(tmp_path)).restore(_as_torch(jtree))
    assert step == 11 and trees_equal(_as_torch(jtree), got)
    assert got["params"]["b"].dtype == torch.bfloat16


def test_port_saves_jax_restores(tmp_path):
    jtree = _jax_tree()
    ttree = _as_torch(jtree)
    CheckpointManager(str(tmp_path), stripes=3).save(12, ttree)
    step, got = JManager(str(tmp_path)).restore(jtree)
    assert step == 12
    for a, b in zip(jax.tree.leaves(jtree), jax.tree.leaves(got)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    assert str(got["params"]["b"].dtype) == "bfloat16"
