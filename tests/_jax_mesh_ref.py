"""The JAX package's side of the data-parallel tests, on a virtual
multi-device CPU mesh (the method of ``tests/subproc/``):

  python tests/_jax_mesh_ref.py collectives OUT.npz   # 8 devices
  python tests/_jax_mesh_ref.py train OUT.npz         # 4 devices
  python tests/_jax_mesh_ref.py tp OUT.npz            # 8 devices
  python tests/_jax_mesh_ref.py serve OUT.npz         # 8 devices

``collectives``: the cases of ``tests/subproc/check_collectives.py``
items 1-5 on ``x = arange(24) / 7``.  ``train``: from the params of
``_mesh_inputs.np_params``, three f32 steps of the single-device train
cell (the dense config), of the compressed cell on the (2, 2, 1) mesh
(the dense config) and of the sharded cell on that mesh (the MoE config,
whose capacity is per data shard); each step's metrics, the error
feedback after each compressed step and the final params.  ``tp``: on
the (2, 2, 2) pod × data × model mesh, three f32 steps of the sharded
cell for each config of ``_mesh_inputs.TP_CONFIGS``: the metrics, the first moment after step 1
(``mu_1 = (1 - b1)·c·g``, ``c`` the clip factor: the step-1 gradient),
the final params, and each device's shard of the initial params with
its mesh coordinate.  ``serve``: on the (2, 2, 2) mesh, the prefill and
decode cells of ``_mesh_inputs.SERVE_CASES`` from the same params and
inputs (``serve_inputs``): a prefill's logits and cache, and a decode's
logits and greedy tokens at each of ``SERVE_STEPS`` steps (each step fed
the last one's argmax) and its cache after them.
"""
import os
import sys

CASE, OUT = sys.argv[1], sys.argv[2]
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count="
                           + ("4" if CASE == "train" else "8"))
os.environ["JAX_PLATFORMS"] = "cpu"
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "src"))

from functools import partial  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import _mesh_inputs as MI  # noqa: E402
from repro.compat import shard_map  # noqa: E402
from repro.launch.mesh import _make_mesh  # noqa: E402


def collectives() -> dict:
    from repro.core.collectives import (compressed_cross_pod_psum_local,
                                        hierarchical_psum,
                                        hierarchical_psum_local)
    mesh = _make_mesh(*MI.COLLECTIVES_MESH)
    x = jnp.arange(24.0).reshape(2, 12) / 7.0
    rep = dict(mesh=mesh, in_specs=P(None, None), out_specs=P(None, None),
               check_vma=False)
    flat = shard_map(lambda v: jax.lax.psum(v, ("data", "pod")), **rep)(x)
    hier = shard_map(partial(hierarchical_psum_local, in_axis="data",
                             cross_axis="pod"), **rep)(x)
    comp, err = shard_map(
        partial(compressed_cross_pod_psum_local, in_axis="data",
                cross_axis="pod"),
        mesh=mesh, in_specs=(P(None, None), P(None)),
        out_specs=(P(None, None), P(None)), check_vma=False)(
        x, jnp.zeros((x.size // 2,), jnp.float32))
    mesh2 = _make_mesh(*MI.SINGLE_POD_MESH)
    flat2 = shard_map(lambda v: jax.lax.psum(v, "data"), mesh=mesh2,
                      in_specs=P(None, None), out_specs=P(None, None),
                      check_vma=False)(x)
    return {"x": x, "flat": flat, "hier": hier,
            "wrapper": hierarchical_psum(x, mesh), "comp": comp,
            "err": err, "flat2": flat2,
            "fallback": hierarchical_psum(x, mesh2)}


def _key(path) -> str:
    return "/".join(str(p.key) for p in path)


def _steps(cfg, name, mesh, opts, *, compressed=False,
           tp=False) -> dict:
    from repro.configs.base import ShapeConfig
    from repro.data.pipeline import TokenPipeline
    from repro.launch.steps import build_cell
    from repro.models import model as M
    from repro.optim.adamw import init_opt_state
    cell = build_cell(cfg, ShapeConfig("t", MI.SEQ, MI.BATCH, "train"), mesh,
                      opts=opts, lr_peak=MI.LR, total_steps=MI.TOTAL,
                      pad_heads=MI.PAD_HEADS.get(name))
    fn = jax.jit(cell.fn, in_shardings=cell.in_shardings)
    pipe = TokenPipeline(cfg.vocab_size, MI.SEQ, MI.BATCH)
    out = {}
    with mesh:
        params = jax.tree.map(jnp.asarray,
                              MI.np_params(M.param_specs(cfg), name))
        opt = init_opt_state(params)
        if compressed:
            opt["ef"] = jax.tree.map(jnp.zeros_like, params)
        params = jax.device_put(params, cell.in_shardings[0])
        opt = jax.device_put(opt, cell.in_shardings[1])
        if tp:
            devices = cell.in_shardings[0]["embed"].mesh.devices
            for path, p in jax.tree_util.tree_flatten_with_path(params)[0]:
                for shard in p.addressable_shards:
                    at = "".join(map(str, np.argwhere(
                        devices == shard.device)[0]))
                    out[f"shard/{at}/{_key(path)}"] = np.asarray(shard.data)
        for step in range(MI.STEPS):
            params, opt, m = fn(params, opt, pipe.get_batch(step))
            out[f"metrics/{step}"] = np.array(
                [float(m[k]) for k in ("loss", "xent", "aux_loss",
                                       "grad_norm", "lr")])
            if compressed:
                for path, e in jax.tree_util.tree_flatten_with_path(
                        opt["ef"])[0]:
                    out[f"ef/{step}/{_key(path)}"] = np.asarray(e)
            if tp and step == 0:
                for path, mu in jax.tree_util.tree_flatten_with_path(
                        opt["mu"])[0]:
                    out[f"mu1/{_key(path)}"] = np.asarray(mu)
    for path, p in jax.tree_util.tree_flatten_with_path(params)[0]:
        out["params/" + _key(path)] = np.asarray(p)
    return out


def train() -> dict:
    from repro.configs import get_config, reduced_config
    from repro.models import model as M
    out = {}
    mesh = _make_mesh(*MI.TRAIN_MESH)
    single = _make_mesh((1, 1), ("data", "model"))
    dense = MI.config("dense", get_config, reduced_config)
    moe = MI.config("moe", get_config, reduced_config)
    for tag, cfg, name, m, sync in (
            ("dense/single", dense, "dense", single, "auto"),
            ("dense/compressed", dense, "dense", mesh, "compressed"),
            ("moe/mesh", moe, "moe", mesh, "auto")):
        # remat changes no value (the port's remat on and off are
        # bit-equal); off, the reference's cells compile faster
        opts = M.RunOptions(**MI.run_options_kw(grad_sync=sync, remat=False))
        res = _steps(cfg, name, m, opts, compressed=sync == "compressed")
        out.update({f"{tag}/{k}": v for k, v in res.items()})
    return out


def tp() -> dict:
    """The (2, 2, 2) cells of ``TP_CONFIGS`` by ``"auto"``.  (The
    compressed cell does not compile on this mesh: XLA's SPMD
    partitioner aborts on a failed check.)"""
    from repro.configs import get_config, reduced_config
    from repro.models import model as M
    out = {}
    mesh = _make_mesh(*MI.TP_MESH)
    for name in MI.TP_CONFIGS:
        cfg = MI.config(name, get_config, reduced_config)
        opts = M.RunOptions(**MI.run_options_kw(remat=False))
        res = _steps(cfg, name, mesh, opts, tp=True)
        out.update({f"{name}/{k}": v for k, v in res.items()})
    return out


def serve() -> dict:
    from repro.configs import get_config, reduced_config
    from repro.configs.base import ShapeConfig
    from repro.launch.steps import build_cell
    from repro.models import model as M
    out = {}
    mesh = _make_mesh(*MI.TP_MESH)
    for tag, name, kind, batch, seq, seq_axis, ring in MI.SERVE_CASES:
        cfg = MI.config(name, get_config, reduced_config)
        opts = M.RunOptions(**MI.run_options_kw(
            remat=False, decode_kv_seq_axis=seq_axis,
            ring_local_cache=ring))
        cell = build_cell(cfg, ShapeConfig(tag, seq, batch, kind), mesh,
                          opts=opts)
        fn = jax.jit(cell.fn, in_shardings=cell.in_shardings)
        with mesh:
            params = jax.device_put(
                jax.tree.map(jnp.asarray,
                             MI.np_params(M.param_specs(cfg), name)),
                cell.in_shardings[0])
            if kind == "prefill":
                inp = MI.serve_inputs(tag, cfg, batch, seq)
                logits, cache = fn(params, {"tokens": jnp.asarray(
                    inp["tokens"])})
                out[f"{tag}/logits"] = np.asarray(logits)
            else:
                abstract = cell.abstract_args[1]
                inp = MI.serve_inputs(tag, cfg, batch, seq, {
                    p: {k: a.shape for k, a in ent.items()}
                    for p, ent in abstract.items()})
                cache = jax.device_put(
                    {p: {k: jnp.asarray(inp[f"cache/{p}/{k}"])
                         for k in ent} for p, ent in abstract.items()},
                    cell.in_shardings[1])
                tok, pos = jnp.asarray(inp["tokens"]), jnp.asarray(inp["pos"])
                for step in range(MI.SERVE_STEPS):
                    logits, cache = fn(params, cache, tok, pos)
                    tok = jnp.argmax(logits[:, -1], axis=-1).astype(
                        jnp.int32)[:, None]
                    out[f"{tag}/logits/{step}"] = np.asarray(logits)
                    out[f"{tag}/tokens/{step}"] = np.asarray(tok)
                    pos = pos + 1
        for path, c in jax.tree_util.tree_flatten_with_path(cache)[0]:
            out[f"{tag}/cache/{_key(path)}"] = np.asarray(c)
    return out


if __name__ == "__main__":
    res = {"collectives": collectives, "train": train, "tp": tp,
           "serve": serve}[CASE]()
    np.savez(OUT, **{k: np.asarray(v) for k, v in res.items()})
    print("ALL_OK", len(res))
