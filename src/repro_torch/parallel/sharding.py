"""Logical-axis sharding rules (counterpart of
``repro.parallel.sharding``), pure host code.

Every parameter and activation is annotated with a tuple of *logical*
axis names ("vocab", "embed", "heads", "ff", "expert", "batch", "seq",
...).  A :class:`LogicalRules` table maps them to the axes of the
production mesh ``(pod, data, model)``, so data, tensor, expert and
sequence parallelism are rule tables and the model code stays
mesh-agnostic.

A spec is the port's stand-in for ``PartitionSpec``: a tuple with one
entry per dimension, each None (replicated), a mesh-axis name, or a
tuple of names (the dimension split over several axes, outermost
first), entry for entry what the reference's ``PartitionSpec`` holds.
The functions read only a mesh's ``axis_names`` and its ``shape`` (axis
name -> size): the port's ``launch.mesh.Mesh``, or any object that has
those two.

``shardings_for_tree`` returns a tree of :class:`Placement`s in place
of the reference's ``NamedSharding``s: per leaf, each mesh axis that
splits the leaf with the dimension it splits.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence, Tuple, Union

from repro_torch.tree import tree_map

MeshAxes = Union[None, str, Tuple[str, ...]]
Spec = Tuple[MeshAxes, ...]


class LogicalRules:
    def __init__(self, rules: Mapping[str, MeshAxes]):
        self.rules = dict(rules)

    def mesh_axes(self, logical: Optional[str]) -> MeshAxes:
        if logical is None:
            return None
        return self.rules.get(logical)

    def with_overrides(self, **overrides: MeshAxes) -> "LogicalRules":
        new = dict(self.rules)
        new.update(overrides)
        return LogicalRules(new)


# Production rules for the (pod, data, model) mesh, the reference's table:
#  - "batch" shards over both data-parallel axes, "pod" outermost (the
#    thin cross-pod hop);
#  - tensor-parallel dims ("heads", "ff", "vocab", "expert_ff") on "model";
#  - "embed" (the d_model dim of weights) over "data": FSDP, parameters
#    and optimizer moments divided by the data-parallel size;
#  - "seq_shard" carries sequence parallelism on long-context cells.
DEFAULT_RULES = LogicalRules({
    "batch": ("pod", "data"),
    "seq": None,
    "seq_shard": "data",
    "embed": "data",
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "ff": "model",
    "expert": None,
    "expert_ff": "model",
    "ssm_inner": "model",
    "ssm_state": None,
    "ssm_heads": "model",
    "conv_width": None,
})

SINGLE_DEVICE_RULES = LogicalRules({k: None for k in DEFAULT_RULES.rules})


def rules_for_mesh(mesh, base: Optional[LogicalRules] = None
                   ) -> LogicalRules:
    """Restrict a rule table to the axes that exist on ``mesh`` (no
    "pod" on the single-pod mesh)."""
    base = base or DEFAULT_RULES
    names = set(mesh.axis_names)
    out = {}
    for k, v in base.rules.items():
        if v is None:
            out[k] = None
        elif isinstance(v, str):
            out[k] = v if v in names else None
        else:
            kept = tuple(a for a in v if a in names)
            out[k] = kept if kept else None
    return LogicalRules(out)


def _entry(axes) -> MeshAxes:
    """One spec entry: None, a name, or a tuple of two or more names."""
    return tuple(axes) if len(axes) > 1 else (axes[0] if axes else None)


def spec_for(logical_axes: Sequence[Optional[str]],
             rules: LogicalRules) -> Spec:
    """The spec of one array annotated with logical axis names; a mesh
    axis already used by an earlier dimension is not used again."""
    used = set()
    out = []
    for name in logical_axes:
        axes = rules.mesh_axes(name)
        if axes is None:
            out.append(None)
            continue
        if isinstance(axes, str):
            axes = (axes,)
        free = tuple(a for a in axes if a not in used)
        used.update(free)
        out.append(_entry(free))
    return tuple(out)


def spec_for_shape(logical_axes: Sequence[Optional[str]],
                   shape: Sequence[int], rules: LogicalRules,
                   mesh) -> Spec:
    """Like ``spec_for``, but drops the mesh axes that do not divide the
    dimension (8 KV heads on a 16-wide model axis stay replicated)."""
    used = set()
    out = []
    for name, dim in zip(logical_axes, shape):
        axes = rules.mesh_axes(name)
        if axes is None:
            out.append(None)
            continue
        if isinstance(axes, str):
            axes = (axes,)
        kept = []
        rem = dim
        for a in axes:
            if a in used:
                continue
            if rem % mesh.shape[a] == 0:
                kept.append(a)
                rem //= mesh.shape[a]
        used.update(kept)
        out.append(_entry(kept))
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where a leaf lies on the mesh: ``(axis, dim)`` for each mesh axis
    that splits it (a leaf of a tree, not a dict, so trees of placements
    map like trees of tensors)."""
    splits: Tuple[Tuple[str, int], ...] = ()

    def get(self, axis: str) -> Optional[int]:
        """The dimension ``axis`` splits, or None."""
        return dict(self.splits).get(axis)


def placement(spec: Spec) -> Placement:
    """The placement of a spec: each mesh axis that splits the array,
    with the dimension it splits."""
    out = []
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        out += [(a, dim) for a in ((entry,) if isinstance(entry, str)
                                   else entry)]
    return Placement(tuple(out))


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def shardings_for_tree(axes_tree, mesh, rules: LogicalRules, shapes=None):
    """A tree of placements (``placement``) for a tree of logical-axes
    tuples: by ``spec_for``, or, given ``shapes`` (a tree of shapes of the
    same structure), by ``spec_for_shape``, as the reference's train
    cell lays out its params."""
    if shapes is None:
        return _map_axes(lambda axes: placement(spec_for(axes, rules)),
                         axes_tree)
    if _is_axes(axes_tree):
        return placement(spec_for_shape(axes_tree, shapes, rules, mesh))
    return {k: shardings_for_tree(v, mesh, rules, shapes[k])
            for k, v in axes_tree.items()}


def _map_axes(fn, tree):
    if _is_axes(tree):
        return fn(tree)
    return {k: _map_axes(fn, v) for k, v in tree.items()}


def axes_and_shapes(specs):
    """The logical-axes tree and the shapes tree of a ParamSpec tree."""
    return (tree_map(lambda s: s.axes, specs),
            tree_map(lambda s: tuple(s.shape), specs))


def batch_spec(rules: LogicalRules, *, seq_sharded: bool = False) -> Spec:
    """The (batch, seq) spec of token arrays."""
    b = rules.mesh_axes("batch")
    s = rules.mesh_axes("seq_shard") if seq_sharded else None
    # no mesh axis on both batch and seq
    if s is not None and b is not None:
        baxes = (b,) if isinstance(b, str) else b
        saxes = (s,) if isinstance(s, str) else s
        if set(baxes) & set(saxes):
            s = None
    return (_norm(b), _norm(s))


def _norm(entry: MeshAxes) -> MeshAxes:
    """A spec entry as ``PartitionSpec`` holds it: a lone axis by name."""
    return entry[0] if isinstance(entry, tuple) and len(entry) == 1 else entry


def activation_rules(rules: LogicalRules, global_batch: int, mesh
                     ) -> Tuple[LogicalRules, bool]:
    """Whether to switch on sequence parallelism for small batches: when
    the global batch does not divide over the data-parallel axes, keep
    the batch on the axes that divide it (never "data") and give "data"
    to the sequence.  Returns ``(rules, seq_sharded)``."""
    dp = 1
    b = rules.mesh_axes("batch")
    baxes = (b,) if isinstance(b, str) else (b or ())
    for a in baxes:
        dp *= mesh.shape[a]
    if global_batch % dp == 0:
        return rules, False
    keep = []
    rem = global_batch
    for a in baxes:
        if rem % mesh.shape[a] == 0 and a != "data":
            keep.append(a)
            rem //= mesh.shape[a]
    new = rules.with_overrides(batch=tuple(keep) or None, seq_shard="data")
    return new, True
