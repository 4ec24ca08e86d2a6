"""The port's side of the data-parallel tests: ranks over gloo on the CPU.

  python tests/_torch_dist.py CASE OUTDIR [PORT]

starts the case's ranks with ``torch.multiprocessing`` spawn.  They meet
on a ``FileStore`` in OUTDIR (``launcher`` and ``train``, which go
through ``runtime.launcher.bootstrap``, on torchrun's variables with
the port the caller picked), each with its own collective timeout, and
each writes its results to ``OUTDIR/CASE.rank<r>.pt``.  A rank that
raises ends the run with a non-zero exit.  numpy and the port only.

- ``collectives`` (8 ranks, the (2, 2, 2) mesh): the cases of
  ``tests/subproc/check_collectives.py`` items 1-5;
- ``sharded`` (4 ranks, the (2, 2, 1) mesh): three steps of the
  ``"auto"`` cell (dense and MoE; dense with 2 microbatches too), of
  the meshless cell (rank 0) and of
  the ``"compressed"`` cell (with its sync against the plain int8
  composition, bit for bit), elastic restores 4 -> 1 and 1 -> 4 ranks,
  the token pipeline's rows; on the (1, 2, 2) mesh ``train()``'s init
  (``make_train_state(cell=)``) against the whole state sharded;
- ``tp`` (8 ranks, the (2, 2, 2) mesh): ``tp``'s docstring;
- ``moe`` (2 ranks): ``moe``'s docstring;
- ``serve`` (8 ranks, the (2, 2, 2) mesh): ``serve``'s docstring;
- ``launcher`` (2 ranks): ``bootstrap(device="cpu")`` under torchrun's
  variables, the ``require_chips`` guard;
- ``train`` (2 ranks): ``train()`` under torchrun's variables with
  checkpoints; then rank 0 alone on a world of 1: the sharded cell
  against the meshless one bit for bit.
"""
import datetime
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "src"))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

import _mesh_inputs as MI  # noqa: E402
from repro_torch.tree import tree_flatten_with_paths  # noqa: E402

TIMEOUT = datetime.timedelta(seconds=90)


def _init(rank: int, world: int, outdir: str, name: str = "store") -> None:
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(outdir, name), world),
        rank=rank, world_size=world, timeout=TIMEOUT)


def _mesh(spec):
    from repro_torch.launch.mesh import make_mesh
    return make_mesh(*spec)


# -- collectives -------------------------------------------------------------

def collectives(rank, world, outdir) -> dict:
    from repro_torch.core import collectives as C
    _init(rank, world, outdir)
    mesh = _mesh(MI.COLLECTIVES_MESH)
    x = torch.arange(24.0).reshape(2, 12) / 7.0
    flat = x.clone()
    dist.all_reduce(flat)
    flat /= mesh.shape["model"]          # the model replicas add copies
    comp, err = C.compressed_cross_pod_psum_local(
        x, torch.zeros(x.numel() // 2), mesh)
    out = {"flat": flat, "hier": C.hierarchical_psum_local(x, mesh),
           "wrapper": C.hierarchical_psum(x, mesh), "comp": comp,
           "err": err}
    dist.barrier()
    mesh2 = _mesh(MI.SINGLE_POD_MESH)
    out["fallback"] = C.hierarchical_psum(x, mesh2)
    out["flat2"] = x * mesh2.shape["data"]
    dist.destroy_process_group()
    return out


# -- sharded train step --------------------------------------------------------

def _setup(name):
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import init_opt_state
    from repro_torch.tree import tree_map
    cfg = MI.config(name, get_config, reduced_config)
    params = tree_map(torch.from_numpy, MI.np_params(M.param_specs(cfg), name))
    return cfg, params, init_opt_state(params)


def _cell(cfg, mesh=None, pad_heads=None, **kw):
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import model as M
    return build_cell(cfg, ShapeConfig("t", MI.SEQ, MI.BATCH, "train"),
                      M.RunOptions(**MI.run_options_kw(**kw)), mesh=mesh,
                      lr_peak=MI.LR, total_steps=MI.TOTAL,
                      pad_heads=pad_heads)


def _pipe(cfg, cell=None):
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.parallel.sharding import batch_spec
    if cell is None:
        return TokenPipeline(cfg.vocab_size, MI.SEQ, MI.BATCH, device="cpu")
    return TokenPipeline(cfg.vocab_size, MI.SEQ, MI.BATCH, device="cpu",
                         mesh=cell.mesh, batch_spec=batch_spec(cell.rules))


def _metrics(m) -> torch.Tensor:
    return torch.tensor([float(m[k]) for k in ("loss", "xent", "aux_loss",
                                               "grad_norm", "lr")])


def _whole(cell, tree):
    """The whole leaves of a sharded tree like the params, by path."""
    from repro_torch.tree import tree_flatten_with_paths, tree_leaves
    return {name: t if s is None else s.gather(t) for (name, t), s in
            zip(tree_flatten_with_paths(tree),
                tree_leaves(cell.fsdp.splits()))}


def _full(split, t):
    return t if split is None else split.gather(t)


def _run(cell, params, opt, pipe, steps, start=0):
    out = []
    for step in range(start, start + steps):
        params, opt, m = cell.fn(params, opt, pipe.get_batch(step))
        out.append(_metrics(m))
    return params, opt, torch.stack(out)


def _plain_sync(cell, g, ef, synced) -> bool:
    """Whether every leaf of the compressed sync equals the plain
    composition on whole tensors, bit for bit: ``x = g / npods + ef``
    quantized with one scale per tensor on each pod, every pod's codes
    dequantized and summed in pod order; and the new error feedback
    ``x - deq``."""
    from repro_torch.core.collectives import all_gather
    from repro_torch.tree import tree_leaves
    mesh, pod = cell.mesh, cell.mesh.group("pod")
    npods = cell.mesh.shape["pod"]
    ok = True
    for gl, el, sl, sp in zip(tree_leaves(g), tree_leaves(ef),
                              tree_leaves(synced),
                              tree_leaves(cell.fsdp.splits())):
        x = _full(sp, gl).float() / npods + _full(sp, el)
        amax = torch.max(torch.abs(x)) + 1e-12
        s = amax / 127.0
        q = torch.clamp(torch.round(x / s), -127, 127).to(torch.int8)
        qs, ss = all_gather(q, pod), all_gather(s, pod)
        total = qs[0].float() * ss[0]
        for p in range(1, npods):
            total += qs[p].float() * ss[p]
        ok &= torch.equal(total.to(gl.dtype), _full(sp, sl))
    return bool(ok) and mesh.size > 1


def sharded(rank, world, outdir) -> dict:
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.tree import tree_map
    _init(rank, world, outdir)
    mesh = _mesh(MI.TRAIN_MESH)
    out = {}
    for name in ("dense", "moe"):
        cfg, p0, o0 = _setup(name)
        cell = _cell(cfg, mesh)
        params, opt = cell.shard_state(p0, o0)
        params, opt, out[f"{name}/auto/metrics"] = _run(
            cell, params, opt, _pipe(cfg, cell), MI.STEPS)
        out[f"{name}/auto/params"] = _whole(cell, params)
    cfg, p0, o0 = _setup("dense")
    # gradient accumulation over 2 microbatches of each rank's rows
    cell = _cell(cfg, mesh, microbatches=2)
    params, opt = cell.shard_state(p0, o0)
    params, opt, out["dense/micro/metrics"] = _run(
        cell, params, opt, _pipe(cfg, cell), MI.STEPS)
    out["dense/micro/params"] = _whole(cell, params)
    if rank == 0:
        cell = _cell(cfg)
        params, opt, out["dense/meshless/metrics"] = _run(
            cell, *_setup("dense")[1:], _pipe(cfg), MI.STEPS)
        out["dense/meshless/params"] = params
    # compressed: each step's sync against the plain composition
    cell = _cell(cfg, mesh, grad_sync="compressed")
    params, opt = cell.shard_state(p0, o0)
    pipe = _pipe(cfg, cell)
    rows, ok = [], []
    for step in range(MI.STEPS):
        batch = pipe.get_batch(step)
        _, _, extra = cell.grads(params, opt, batch, keep=True)
        ok.append(_plain_sync(cell, extra["grad"], opt["ef"],
                              extra["synced"]))
        params, opt, m = cell.fn(params, opt, batch)
        rows.append(_metrics(m))
        out[f"dense/compressed/ef/{step}"] = _whole(cell, opt["ef"])
        out[f"dense/compressed/grad/{step}"] = _whole(cell, extra["grad"])
    out["dense/compressed/metrics"] = torch.stack(rows)
    out["dense/compressed/plain_sync"] = torch.tensor(ok)
    # elastic: 4 ranks save after 2 steps, 1 rank restores and steps
    ck = os.path.join(outdir, "ck4")
    cell = _cell(cfg, mesh)
    params, opt = cell.shard_state(p0, o0)
    params, opt, _ = _run(cell, params, opt, _pipe(cfg, cell), 2)
    CheckpointManager(ck).save(2, {"params": params, "opt": opt},
                               shardings=cell.state_shardings())
    ck1 = os.path.join(outdir, "ck1")
    if rank == 0:
        _, p1, o1 = _setup("dense")
        step, state = CheckpointManager(ck).restore({"params": p1,
                                                     "opt": o1})
        one = _cell(cfg)
        params1, opt1, out["elastic/4to1/metrics"] = _run(
            one, state["params"], state["opt"], _pipe(cfg), 1, start=step)
        out["elastic/4to1/count"] = opt1["count"].clone()
        # and the reverse: one rank saves after 2 steps
        params1, opt1, _ = _run(one, *_setup("dense")[1:], _pipe(cfg), 2)
        CheckpointManager(ck1).save(2, {"params": params1, "opt": opt1})
    dist.barrier()
    like = cell.shard_state(*_setup("dense")[1:])
    step, state = CheckpointManager(ck1).restore(
        {"params": like[0], "opt": like[1]},
        shardings=cell.state_shardings())
    params, opt, out["elastic/1to4/metrics"] = _run(
        cell, state["params"], state["opt"], _pipe(cfg, cell), 1, start=step)
    out["elastic/1to4/count"] = opt["count"].clone()
    # the token pipeline's rows of the global batch
    pipe = _pipe(cfg, cell)
    out["pipeline/rows"] = torch.tensor(pipe.rows)
    for step in range(MI.STEPS):
        out[f"pipeline/{step}"] = tree_map(lambda t: t, pipe.get_batch(step))
    out.update(_init_on_shards())
    dist.destroy_process_group()
    return out


def _init_on_shards() -> dict:
    """On the (1, 2, 2) mesh, reduced qwen3-1.7b (the bf16 config
    ``train()`` runs) with the compressed sync (so the error feedback is
    built too): ``make_train_state(cell=)``, ``train()``'s init, against
    ``cell.shard_state`` of the whole state, bit for bit; and the shapes
    of the leaves ``init_opt_state`` was given against this rank's
    slices."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.launch import steps
    from repro_torch.launch.train import make_train_state
    from repro_torch.models import model as M
    from repro_torch.tree import tree_leaves
    mesh = _mesh(((1, 2, 2), ("pod", "data", "model")))
    cfg = reduced_config(get_config("qwen3-1.7b"))
    cell = _cell(cfg, mesh, grad_sync="compressed")
    old = cell.shard_state(*make_train_state(
        cfg, torch.Generator().manual_seed(0), "cpu"))
    seen = []
    real = steps.init_opt_state

    def spy(params):
        seen.extend(tuple(t.shape) for t in tree_leaves(params))
        return real(params)
    steps.init_opt_state = spy
    try:
        new = make_train_state(cfg, torch.Generator().manual_seed(0), "cpu",
                               cell=cell)
    finally:
        steps.init_opt_state = real
    pairs = list(zip(tree_leaves(dict(zip("po", old))),
                     tree_leaves(dict(zip("po", new)))))
    local = [tuple(t.shape) for t in tree_leaves(new[0])]
    whole = [tuple(s.shape) for s in tree_leaves(M.param_specs(cfg))]
    return {"init/equal": all(a.dtype == b.dtype and torch.equal(a, b)
                              for a, b in pairs),
            "init/leaves": len(pairs), "init/seen": seen,
            "init/local": local, "init/whole": whole}



# -- tensor parallelism -------------------------------------------------------

def _batch(pipe, cfg, step):
    """The pipeline's batch of ``step`` with the frontend's input (this
    rank's rows of it on a mesh)."""
    b = pipe.get_batch(step)
    lo, hi = getattr(pipe, "rows", (0, MI.BATCH))
    return {**b, **{k: torch.from_numpy(v[lo:hi])
                    for k, v in MI.np_frontend(cfg).items()}}


def _unpadded(cfg):
    import dataclasses
    return dataclasses.replace(cfg, pad_heads_to=None)


def tp(rank, world, outdir) -> dict:
    """On the (2, 2, 2) mesh: for each config of ``TP_CONFIGS`` this
    rank's slices of the initial params, the step-1 gradients (whole),
    three ``"auto"`` steps' metrics and the final params (whole); the
    dense config's compressed steps against the plain int8 composition;
    one step of each of ``TP_FAMILIES`` against the meshless step (rank
    0); the elastic round trip (2, 2, 2) -> 1 -> (2, 2, 2)."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.parallel import tensor
    _init(rank, world, outdir)
    mesh = _mesh(MI.TP_MESH)
    out = {"coords": tuple(mesh.coordinate(a) for a in mesh.axis_names)}
    for name in MI.TP_CONFIGS:
        cfg, p0, o0 = _setup(name)
        cell = _cell(_unpadded(cfg), mesh, pad_heads=MI.PAD_HEADS.get(name))
        assert cell.cfg == cfg
        params, opt = cell.shard_state(p0, o0)
        out[f"{name}/shard"] = {k: v.clone() for k, v in
                                tree_flatten_with_paths(params)}
        pipe = _pipe(cfg, cell)
        tensor.reset_calls()
        _, grads, _ = cell.grads(params, opt, _batch(pipe, cfg, 0))
        out[f"{name}/calls"] = dict(tensor.calls)
        out[f"{name}/grad1"] = _whole(cell, grads)
        del grads
        rows = []
        for step in range(MI.STEPS):
            params, opt, m = cell.fn(params, opt, _batch(pipe, cfg, step))
            rows.append(_metrics(m))
        out[f"{name}/metrics"] = torch.stack(rows)
        out[f"{name}/params"] = _whole(cell, params)
    # compressed: each step's sync against the plain composition
    cfg, p0, o0 = _setup("dense")
    cell = _cell(cfg, mesh, grad_sync="compressed")
    params, opt = cell.shard_state(p0, o0)
    pipe = _pipe(cfg, cell)
    rows, ok = [], []
    for step in range(MI.STEPS):
        batch = pipe.get_batch(step)
        _, _, extra = cell.grads(params, opt, batch, keep=True)
        ok.append(_plain_sync(cell, extra["grad"], opt["ef"],
                              extra["synced"]))
        params, opt, m = cell.fn(params, opt, batch)
        rows.append(_metrics(m))
    out["compressed/metrics"] = torch.stack(rows)
    out["compressed/plain_sync"] = torch.tensor(ok)
    # the families' first step, on the mesh and (rank 0) meshless
    for name in MI.TP_FAMILIES:
        cfg, p0, o0 = _setup(name)
        cell = _cell(cfg, mesh)
        params, opt = cell.shard_state(p0, o0)
        params, opt, m = cell.fn(params, opt, _batch(_pipe(cfg, cell), cfg,
                                                     0))
        out[f"{name}/metrics"] = _metrics(m)[None]
        out[f"{name}/params"] = _whole(cell, params)
        if rank == 0:
            one = _cell(cfg)
            params, opt, m = one.fn(p0, o0, _batch(_pipe(cfg), cfg, 0))
            out[f"{name}/meshless/metrics"] = _metrics(m)[None]
            out[f"{name}/meshless/params"] = dict(
                tree_flatten_with_paths(params))
    # elastic: (2, 2, 2) saves after 2 steps; 1 rank restores it, takes
    # step 3 and saves its state again; (2, 2, 2) restores that
    cfg, p0, o0 = _setup("dense")
    cell = _cell(cfg, mesh)
    params, opt = cell.shard_state(p0, o0)
    params, opt, m = _run(cell, params, opt, _pipe(cfg, cell), 3)
    out["elastic/mesh/metrics"] = m
    params, opt = cell.shard_state(*_setup("dense")[1:])
    params, opt, _ = _run(cell, params, opt, _pipe(cfg, cell), 2)
    ck, ck1 = (os.path.join(outdir, d) for d in ("ck8", "ck1"))
    CheckpointManager(ck).save(2, {"params": params, "opt": opt},
                               shardings=cell.state_shardings())
    if rank == 0:
        _, p1, o1 = _setup("dense")
        step, state = CheckpointManager(ck).restore({"params": p1,
                                                     "opt": o1})
        CheckpointManager(ck1).save(step, state)
        _, _, out["elastic/8to1/metrics"] = _run(
            _cell(cfg), state["params"], state["opt"], _pipe(cfg), 1,
            start=step)
    dist.barrier()
    like = cell.shard_state(*_setup("dense")[1:])
    step, state = CheckpointManager(ck1).restore(
        {"params": like[0], "opt": like[1]},
        shardings=cell.state_shardings())
    _, opt, out["elastic/1to8/metrics"] = _run(
        cell, state["params"], state["opt"], _pipe(cfg, cell), 1, start=step)
    out["elastic/1to8/count"] = opt["count"].clone()
    dist.destroy_process_group()
    return out


# -- the MoE block's sharded body ----------------------------------------------

def moe(rank, world, outdir) -> dict:
    """``moe_block(mesh=)`` on the (1, 2) data × model mesh, this rank
    holding its ``expert_ff`` and shared ``ff`` slices, and ``_moe_local``
    on the whole params, on the same input (4 experts top-2, 2 shared,
    capacity factor 0.5: pairs drop): outputs, and the gradients of a
    fixed projection of them (the input's, the router's, the gate's and
    this rank's slices of the expert weights, whole)."""
    import numpy as np
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import moe as tmoe
    from repro_torch.tree import tree_map
    _init(rank, world, outdir)
    mesh = _mesh(((1, 2), ("data", "model")))
    cfg = reduced_config(get_config("qwen2-moe-a2.7b"),
                         compute_dtype="float32")
    cfg = dict_replace(cfg, moe=dict_replace(cfg.moe, capacity_factor=0.5))
    whole = tree_map(torch.from_numpy, MI.np_params(tmoe.moe_specs(cfg),
                                                    "moe"))
    rng = np.random.default_rng(1)
    x = torch.from_numpy((rng.standard_normal((4, 16, cfg.d_model)) + 0.3)
                         .astype(np.float32))
    proj = torch.from_numpy(rng.standard_normal((4, 16, cfg.d_model))
                            .astype(np.float32))
    cut = {"wg": 2, "wu": 2, "wd": 1, "shared/wg": 1, "shared/wu": 1,
           "shared/wd": 0}

    def local(path, t):
        return (t.chunk(2, cut[path])[rank] if path in cut else t).clone()

    def grads(fn, params):
        leaves = {k: v.clone().requires_grad_(True)
                  for k, v in tree_flatten_with_paths(params)}
        xx = x.clone().requires_grad_(True)
        tree = {k: v for k, v in leaves.items() if "/" not in k}
        tree["shared"] = {k[7:]: v for k, v in leaves.items()
                          if k.startswith("shared/")}
        out = fn(tree, xx)
        gs = torch.autograd.grad((out * proj).sum(),
                                 [xx, *leaves.values()])
        return out.detach(), dict(zip(["x", *leaves], gs))

    mine = {k: local(k, v) for k, v in tree_flatten_with_paths(whole)}
    out, g = grads(lambda p, xx: tmoe.moe_block(p, cfg, xx, mesh=mesh),
                   mine)
    out1, g1 = grads(lambda p, xx: tmoe._moe_local(p, cfg, xx), dict(
        tree_flatten_with_paths(whole)))
    dist.destroy_process_group()
    return {"out": out, "grads": g, "out1": out1,
            "grads1": {k: (local(k, v) if k in cut else v)
                       for k, v in g1.items()}}


def dict_replace(obj, **kw):
    import dataclasses
    return dataclasses.replace(obj, **kw)


# -- launcher and train() over ranks -----------------------------------------

def _torchrun_env(rank, world, port):
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank))
    for k in [k for k in os.environ if k.startswith("SLURM_")]:
        del os.environ[k]


def launcher(rank, world, outdir, port) -> dict:
    from repro_torch.runtime.launcher import bootstrap, detect_cluster
    torch.set_num_threads(1)
    _torchrun_env(rank, world, port)
    cluster = detect_cluster()
    mesh, got = bootstrap(device="cpu")
    t = torch.tensor([float(rank + 1)])
    dist.all_reduce(t, group=mesh.group("data"))
    try:
        bootstrap(device="cpu", require_chips=world + 1)
        guard = ""
    except RuntimeError as e:
        guard = str(e)
    out = {"cluster": (cluster.coordinator, cluster.num_processes,
                       cluster.process_id, cluster.local_rank),
           "same": got == cluster, "backend": dist.get_backend(),
           "mesh": (mesh.axis_names, mesh.shape, mesh.device_type,
                    mesh.coordinate("data")),
           "sum": float(t), "guard": guard}
    dist.destroy_process_group()
    return out


TRAIN_KW = dict(steps=4, batch=8, seq=32, reduced=True, log_every=1000,
                lr_peak=3e-3, total_steps=300, device="cpu")


def train(rank, world, outdir, port) -> dict:
    from repro_torch.launch import train as T
    _torchrun_env(rank, world, port)
    torch.set_num_threads(1)
    out = {"losses": T.train("qwen3-1.7b", ckpt_dir=os.path.join(
        outdir, "train_ck"), ckpt_every=2, **TRAIN_KW),
        "initialized_after": dist.is_initialized()}
    if rank == 0:
        out.update(world1(outdir))
    return out


def world1(outdir) -> dict:
    """On a world of one rank, the (1, 1, 1) mesh: three ``"auto"`` steps
    against three meshless steps, and the ``"compressed"`` sync against
    the plain composition, bit for bit (every collective a copy)."""
    from repro_torch.tree import tree_leaves
    _init(0, 1, outdir, name="store1")
    mesh = _mesh(((1, 1, 1), ("pod", "data", "model")))
    cfg, p0, o0 = _setup("moe")
    sharded_cell = _cell(cfg, mesh)
    params, opt = sharded_cell.shard_state(p0, o0)
    params, opt, m_mesh = _run(sharded_cell, params, opt,
                               _pipe(cfg, sharded_cell), MI.STEPS)
    ref, oref, m_ref = _run(_cell(cfg), *_setup("moe")[1:], _pipe(cfg),
                            MI.STEPS)
    same = torch.equal(m_mesh, m_ref) and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(params),
                                          tree_leaves(ref)))
    cell = _cell(cfg, mesh, grad_sync="compressed")
    params, opt = cell.shard_state(*_setup("moe")[1:])
    pipe = _pipe(cfg, cell)
    ok = True
    for step in range(2):
        batch = pipe.get_batch(step)
        _, _, extra = cell.grads(params, opt, batch, keep=True)
        for g, e, s, new in zip(*(tree_leaves(t) for t in (
                extra["grad"], opt["ef"], extra["synced"], extra["ef"]))):
            x = g.float() / 1 + e
            amax = torch.max(torch.abs(x)) + 1e-12
            q = torch.clamp(torch.round(x / (amax / 127.0)), -127, 127)
            deq = q.to(torch.int8).float() * (amax / 127.0)
            ok &= torch.equal(s, deq.to(g.dtype)) and torch.equal(new,
                                                                   x - deq)
        params, opt, _ = cell.fn(params, opt, batch)
    dist.destroy_process_group()
    return {"world1/auto_equals_meshless": same,
            "world1/compressed_plain": bool(ok)}


# -- serving cells -------------------------------------------------------------

def _slice_index(whole, split):
    """``((lo, hi), ...)`` per dimension: where this rank's slice of a
    leaf of shape ``whole`` lies in it."""
    idx = [(0, n) for n in whole]
    for dim, n, rank, _ in (split.parts if split is not None else ()):
        lo, hi = idx[dim]
        size = (hi - lo) // n
        idx[dim] = (lo + rank * size, lo + (rank + 1) * size)
    return tuple(idx)


def _cache_out(cell, cache) -> dict:
    """Each leaf of this rank's cache with where it lies in the whole."""
    wholes = cell.cache_shapes()
    return {f"{p}/{k}": (t.clone(), _slice_index(wholes[p][k],
                                                 cell.cache_splits[p][k]))
            for p, ent in cache.items() for k, t in ent.items()}


def serve(rank, world, outdir) -> dict:
    """On the (2, 2, 2) mesh, each case of ``SERVE_CASES``: the prefill
    cell's logits of this rank's rows and its cache slice; the decode
    cell over ``SERVE_STEPS`` greedy steps from the whole drawn cache
    (``Cell.shard_cache``), each step's logits and tokens of this rank's
    rows and its cache slice after them; each cache leaf with where it
    lies in the whole; and (rank 0) the meshless prefill cell's.  Then
    ``SERVE_FAMILIES``' cells (``_family_cells``).  Also ``Cell.init_cache``'s shapes against the
    slices, and the tensor-parallel calls of the first decode step."""
    from repro_torch.configs import ShapeConfig, get_config, reduced_config
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import model as M
    from repro_torch.parallel import tensor
    from repro_torch.tree import tree_map
    _init(rank, world, outdir)
    mesh = _mesh(MI.TP_MESH)
    out = {"coords": tuple(mesh.coordinate(a) for a in mesh.axis_names)}
    for tag, name, kind, batch, seq, seq_axis, ring in MI.SERVE_CASES:
        cfg = MI.config(name, get_config, reduced_config)
        opts = M.RunOptions(**MI.run_options_kw(
            decode_kv_seq_axis=seq_axis, ring_local_cache=ring))
        cell = build_cell(cfg, ShapeConfig(tag, seq, batch, kind), opts,
                          mesh=mesh)
        whole = tree_map(torch.from_numpy,
                         MI.np_params(M.param_specs(cfg), name))
        params = cell.shard_params(whole)
        lo, hi = cell.rows
        out[f"{tag}/rows"] = (lo, hi)
        if kind == "prefill":
            inp = MI.serve_inputs(tag, cfg, batch, seq)
            logits, cache = cell.fn(params, {"tokens": torch.from_numpy(
                inp["tokens"][lo:hi])})
            out[f"{tag}/logits"] = logits
            out[f"{tag}/cache"] = _cache_out(cell, cache)
            if rank == 0:
                one = build_cell(cfg, ShapeConfig(tag, seq, batch, kind),
                                 opts)
                logits, cache = one.fn(whole, {"tokens": torch.from_numpy(
                    inp["tokens"])})
                out[f"{tag}/meshless/logits"] = logits
                out[f"{tag}/meshless/cache"] = cache
            continue
        inp = MI.serve_inputs(tag, cfg, batch, seq, cell.cache_shapes())
        whole = {p: {k: torch.from_numpy(inp[f"cache/{p}/{k}"]) for k in ent}
                 for p, ent in cell.cache_shapes().items()}
        cache = cell.shard_cache(whole)
        zero = cell.init_cache()
        out[f"{tag}/init_cache"] = all(
            zero[p][k].shape == t.shape and zero[p][k].dtype == t.dtype
            and not zero[p][k].any() for p, ent in cache.items()
            for k, t in ent.items())
        tok = torch.from_numpy(inp["tokens"][lo:hi])
        pos = torch.from_numpy(inp["pos"][lo:hi])
        for step in range(MI.SERVE_STEPS):
            tensor.reset_calls()
            logits, cache = cell.fn(params, cache, tok, pos)
            if step == 0:
                out[f"{tag}/calls"] = dict(tensor.calls)
            tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
            out[f"{tag}/logits/{step}"] = logits
            out[f"{tag}/tokens/{step}"] = tok
            pos = pos + 1
        out[f"{tag}/cache"] = _cache_out(cell, cache)
    for name in MI.SERVE_FAMILIES:
        out.update(_family_cells(name, mesh, rank))
    dist.destroy_process_group()
    return out


def _family_cells(name, mesh, rank) -> dict:
    """``FAMILY_CELLS`` of config ``name`` on the mesh, one step each from
    numpy-drawn inputs: this rank's rows of the logits; on rank 0 the
    meshless cell's logits of every row."""
    import numpy as np
    from repro_torch.configs import ShapeConfig, get_config, reduced_config
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import model as M
    from repro_torch.tree import tree_map
    cfg = MI.config(name, get_config, reduced_config)
    whole = tree_map(torch.from_numpy, MI.np_params(M.param_specs(cfg), name))
    out = {}
    for kind, batch, seq, seq_axis in MI.FAMILY_CELLS:
        tag = f"family/{name}/{kind}/{batch}"
        opts = M.RunOptions(**MI.run_options_kw(decode_kv_seq_axis=seq_axis))
        shape = ShapeConfig(tag, seq, batch, kind)
        cell = build_cell(cfg, shape, opts, mesh=mesh)
        lo, hi = cell.rows
        rng = np.random.default_rng(MI.SEED + 11)
        tokens = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (batch, seq if kind == "prefill" else 1))
            .astype(np.int32))
        if kind == "prefill":
            args = {"tokens": tokens, **{
                k: torch.from_numpy(v[:batch])
                for k, v in MI.np_frontend(cfg).items()}}
            mine = ({k: v[lo:hi] for k, v in args.items()},)
            args = (args,)
        else:
            cache = {p: {k: torch.from_numpy(rng.standard_normal(s).astype(
                np.float32)) for k, s in ent.items()}
                for p, ent in cell.cache_shapes().items()}
            pos = torch.tensor(MI.FAMILY_POS[:batch], dtype=torch.int32)
            mine = (cell.shard_cache(cache), tokens[lo:hi], pos[lo:hi])
            args = (cache, tokens, pos)
        out[f"{tag}/rows"] = (lo, hi)
        out[f"{tag}/logits"] = cell.fn(cell.shard_params(whole), *mine)[0]
        if rank == 0:
            out[f"{tag}/meshless"] = build_cell(cfg, shape, opts).fn(
                whole, *args)[0]
    return out


CASES = {"collectives": (8, collectives), "sharded": (4, sharded),
         "tp": (8, tp), "moe": (2, moe), "serve": (8, serve),
         "launcher": (2, launcher), "train": (2, train)}


def _rank(rank, name, outdir, port):
    world, fn = CASES[name]
    args = (rank, world, outdir) + ((port,) if name in ("launcher", "train")
                                    else ())
    torch.save(fn(*args), os.path.join(outdir, f"{name}.rank{rank}.pt"))


if __name__ == "__main__":
    name, outdir = sys.argv[1], sys.argv[2]
    port = int(sys.argv[3]) if len(sys.argv) > 3 else 0
    os.makedirs(outdir, exist_ok=True)
    mp.spawn(_rank, args=(name, outdir, port), nprocs=CASES[name][0],
             join=True)
    print("ALL_OK", name)
