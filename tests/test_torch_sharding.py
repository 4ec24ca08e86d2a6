"""The port's logical sharding rules (``repro_torch.parallel.sharding``)
against the reference's (``repro.parallel.sharding``), and the FSDP
placement of the port's train step.

Both sides read the same fake meshes: JAX ``Mesh``es of one CPU device
repeated, built as ``tests/test_sharding.py`` builds them (the port's
functions read only ``axis_names`` and ``shape``).  The port's spec, a
tuple with one entry per dimension, must equal the reference's
``PartitionSpec`` entry for entry; property cases are derandomized.
Pure host code: no process group.
"""
import itertools

import jax
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st
from jax.sharding import Mesh

from repro.configs import get_config as jget
from repro.configs import reduced_config as jreduced
from repro.launch import steps as jsteps
from repro.models import model as JM
from repro.parallel import sharding as J
from repro_torch.configs import get_config, reduced_config
from repro_torch.models import model as M
from repro_torch.parallel import sharding as T
from repro_torch.parallel.fsdp import Fsdp, local_rows
from repro_torch.tree import tree_flatten_with_paths, tree_leaves, tree_map

MESHES = [((2, 2), ("data", "model")), ((4,), ("data",)),
          ((2, 2, 1), ("pod", "data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((16, 16), ("data", "model")), ((2, 4, 2), ("pod", "data", "model"))]
LOGICAL = ["batch", "seq", "seq_shard", "embed", "vocab", "heads",
           "kv_heads", "head_dim", "ff", "expert", "expert_ff", "ssm_inner",
           "ssm_heads", None]


def fake_mesh(shape, names):
    devs = np.array(jax.devices() * int(np.prod(shape)))[:int(np.prod(shape))]
    return Mesh(devs.reshape(shape), names)


def port_rules(jrules):
    return T.LogicalRules(jrules.rules)


def test_rule_tables_equal():
    assert T.DEFAULT_RULES.rules == J.DEFAULT_RULES.rules
    assert T.SINGLE_DEVICE_RULES.rules == J.SINGLE_DEVICE_RULES.rules
    r = T.DEFAULT_RULES.with_overrides(batch="data", seq_shard=None)
    assert r.rules == J.DEFAULT_RULES.with_overrides(
        batch="data", seq_shard=None).rules
    assert r.mesh_axes(None) is None


@pytest.mark.parametrize("shape,names", MESHES)
def test_rules_for_mesh_and_spec_for(shape, names):
    mesh = fake_mesh(shape, names)
    for base in (J.DEFAULT_RULES, J.SINGLE_DEVICE_RULES,
                 J.LogicalRules({"embed": ("data", "model"), "ff": "pod",
                                 "batch": ("data", "pod")})):
        jr = J.rules_for_mesh(mesh, base)
        tr = T.rules_for_mesh(mesh, port_rules(base))
        assert tr.rules == jr.rules
        for axes in itertools.product(LOGICAL, repeat=2):
            assert T.spec_for(axes, tr) == tuple(J.spec_for(axes, jr)), axes


@pytest.mark.parametrize("shape,names", MESHES)
def test_spec_for_shape(shape, names):
    mesh = fake_mesh(shape, names)
    rules = J.rules_for_mesh(mesh, J.DEFAULT_RULES.with_overrides(
        embed=("data", "model")))
    tr = port_rules(rules)
    for axes in itertools.product(LOGICAL[:8], repeat=2):
        for dims in ((8, 4), (3, 16), (32, 2), (512, 48), (6, 7)):
            assert T.spec_for_shape(axes, dims, tr, mesh) == tuple(
                J.spec_for_shape(axes, dims, rules, mesh)), (axes, dims)


@settings(max_examples=80, deadline=None, derandomize=True)
@given(dims=st.lists(st.integers(1, 64), min_size=1, max_size=4),
       axes=st.lists(st.sampled_from(LOGICAL), min_size=1, max_size=4),
       m=st.integers(0, len(MESHES) - 1))
def test_spec_for_shape_matches_and_divides(dims, axes, m):
    n = min(len(dims), len(axes))
    dims, axes = tuple(dims[:n]), tuple(axes[:n])
    mesh = fake_mesh(*MESHES[m])
    rules = J.rules_for_mesh(mesh, J.DEFAULT_RULES)
    spec = T.spec_for_shape(axes, dims, port_rules(rules), mesh)
    assert spec == tuple(J.spec_for_shape(axes, dims, rules, mesh))
    for dim, s in zip(dims, spec):
        ax = () if s is None else (s,) if isinstance(s, str) else s
        assert dim % int(np.prod([mesh.shape[a] for a in ax])) == 0


@settings(max_examples=60, deadline=None, derandomize=True)
@given(gb=st.integers(1, 512), m=st.integers(0, len(MESHES) - 1))
def test_activation_rules_and_batch_spec(gb, m):
    mesh = fake_mesh(*MESHES[m])
    rules = J.rules_for_mesh(mesh, J.DEFAULT_RULES)
    jout, jseq = J.activation_rules(rules, gb, mesh)
    tout, tseq = T.activation_rules(port_rules(rules), gb, mesh)
    assert (tout.rules, tseq) == (jout.rules, jseq)
    for seq in (False, True):
        assert T.batch_spec(tout, seq_sharded=seq) == tuple(
            J.batch_spec(jout, seq_sharded=seq))


def test_shardings_for_tree_are_the_reference_specs():
    """Placements against the reference's ``NamedSharding`` specs: by
    ``spec_for`` (``shardings_for_tree``) and, given shapes, by
    ``spec_for_shape`` (the train cell's ``_tree_shardings``), for every
    leaf of reduced qwen3-1.7b and qwen2-moe-a2.7b on a (2, 2, 2) mesh."""
    mesh = fake_mesh((2, 2, 2), ("pod", "data", "model"))
    rules = J.rules_for_mesh(mesh, J.DEFAULT_RULES)
    tr = port_rules(rules)
    for arch in ("qwen3-1.7b", "qwen2-moe-a2.7b"):
        jspecs = JM.param_specs(jreduced(jget(arch)))
        tspecs = M.param_specs(reduced_config(get_config(arch)))
        jaxes = JM.axes_tree(jspecs)
        axes, shapes = T.axes_and_shapes(tspecs)
        jplain = jax.tree.leaves(J.shardings_for_tree(jaxes, mesh, rules))
        jshape = jax.tree.leaves(jsteps._tree_shardings(
            mesh, jaxes, JM.abstract_params(jspecs), rules))
        for got, want in ((T.shardings_for_tree(axes, mesh, tr), jplain),
                          (T.shardings_for_tree(axes, mesh, tr, shapes),
                           jshape)):
            got = tree_leaves(got)
            assert len(got) == len(want)
            for g, w in zip(got, want):
                assert g == T.placement(tuple(w.spec)), (arch, g, w.spec)


def test_placement_names_each_split():
    assert T.placement((None, ("pod", "data"), "model")) == T.Placement(
        (("pod", 1), ("data", 1), ("model", 2)))
    assert T.placement((None, None)).get("data") is None


class _RankMesh:
    """A mesh's names, sizes and this rank's coordinates (no process
    group: ``Fsdp`` reads the "data" group only to gather)."""

    def __init__(self, shape, names, coords):
        self.axis_names = names
        self.shape = dict(zip(names, shape))
        self.coords = dict(zip(names, coords))

    def group(self, axis):
        return None

    def coordinate(self, axis):
        return self.coords[axis]


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "qwen2-moe-a2.7b",
                                  "whisper-base"])
def test_fsdp_shards_are_slices_of_the_whole_init(arch):
    """Every leaf split along the dimension that ``spec_for_shape`` gives
    "data" (the "embed" dimension), whole where "data" does not divide
    it; the ranks' slices, concatenated, are the single-device init bit
    for bit."""
    cfg = reduced_config(get_config(arch))
    specs = M.param_specs(cfg)
    whole = M.init_params(specs, torch.Generator().manual_seed(0))
    names = ("pod", "data", "model")
    parts = []
    for data in range(2):
        mesh = _RankMesh((1, 2, 1), names, (0, data, 0))
        rules = T.rules_for_mesh(mesh)
        fsdp = Fsdp.for_specs(specs, mesh, rules)
        parts.append(fsdp.shard(whole))
    for (name, w), spec, d, a, b in zip(
            tree_flatten_with_paths(whole), tree_leaves(specs),
            tree_leaves(fsdp.dims), tree_leaves(parts[0]),
            tree_leaves(parts[1])):
        if d is None:
            assert "embed" not in spec.axes or spec.shape[
                spec.axes.index("embed")] % 2, name
            assert torch.equal(a, w) and torch.equal(b, w)
        else:
            assert spec.axes[d] == "embed", name
            assert torch.equal(torch.cat([a, b], d), w), name
    assert fsdp.sharded() == [d is not None for d in tree_leaves(fsdp.dims)]
    assert tree_map(lambda t: t.shape, parts[0]).keys() == whole.keys()


def test_local_rows_follow_the_batch_spec():
    names = ("pod", "data", "model")
    rows = [local_rows(_RankMesh((2, 2, 1), names, (p, d, 0)),
                       ("pod", "data"), 8)
            for p in range(2) for d in range(2)]
    assert rows == [(0, 2), (2, 4), (4, 6), (6, 8)]
    assert local_rows(_RankMesh((2, 2, 1), names, (1, 0, 0)), ("data",),
                      8) == (0, 4)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "minicpm-2b", "mamba2-130m",
                                  "whisper-base", "qwen2-moe-a2.7b"])
def test_fsdp_places_leaves_over_data_and_model(arch):
    """On the (1, 2, 2) mesh each leaf is split along the dimensions that
    the reference's ``spec_for_shape`` gives "data" and "model" (an axis
    that does not divide a dimension leaves it whole: minicpm-2b's odd
    vocabulary of 251), its "model" slice kept local only where a
    tensor-parallel layer of the decoder, the embedding or the head
    reads it (not the SSM's, not an encoder's); the four ranks' slices,
    put back together, are the single-device init bit for bit."""
    odd = {"vocab_size": 251} if arch == "minicpm-2b" else {}
    cfg = reduced_config(get_config(arch), **odd)
    jcfg = jreduced(jget(arch), **odd)
    specs = M.param_specs(cfg)
    whole = M.init_params(specs, torch.Generator().manual_seed(0))
    names = ("pod", "data", "model")
    jmesh = fake_mesh((1, 2, 2), names)
    jrules = J.rules_for_mesh(jmesh, J.DEFAULT_RULES)
    parts = {}
    for d, m in itertools.product(range(2), range(2)):
        mesh = _RankMesh((1, 2, 2), names, (0, d, m))
        fsdp = Fsdp.for_specs(specs, mesh, T.rules_for_mesh(mesh))
        parts[d, m] = tree_leaves(fsdp.shard(whole))
    jspecs = jax.tree.leaves(JM.param_specs(jcfg),
                             is_leaf=lambda s: hasattr(s, "axes"))
    for i, ((name, w), spec, jspec, d, m, loc) in enumerate(zip(
            tree_flatten_with_paths(whole), tree_leaves(specs), jspecs,
            tree_leaves(fsdp.dims), tree_leaves(fsdp.mdims),
            tree_leaves(fsdp.local))):
        want = tuple(J.spec_for_shape(jspec.axes, jspec.shape, jrules,
                                      jmesh))
        want += (None,) * (len(spec.shape) - len(want))
        got = [None] * len(spec.shape)
        for axis, dim in (("data", d), ("model", m)):
            if dim is not None:
                got[dim] = axis
        assert tuple(got) == want, name
        assert loc == (m is not None and name.split("/")[0] in (
            "blocks", "embed", "lm_head") and spec.axes[m] in (
            "heads", "kv_heads", "ff", "expert_ff", "vocab")), name
        rows = [torch.cat([parts[dd, mm][i] for mm in range(2)],
                          m) if m is not None else parts[dd, 0][i]
                for dd in range(2)]
        back = torch.cat(rows, d) if d is not None else rows[0]
        assert torch.equal(back, w), name
    if arch == "minicpm-2b":
        assert fsdp.mdims["embed"] is None and not fsdp.local["embed"]
