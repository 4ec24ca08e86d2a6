"""Inputs shared by the data-parallel tests and their subprocess
scripts (``tests/_torch_dist.py`` runs the port's ranks over gloo,
``tests/_jax_mesh_ref.py`` the JAX package on a virtual mesh): the
configs, the sizes and numpy-drawn params, so that both sides start from
the same weights without either importing the other's package; and
the tests' way of running those scripts.  numpy and the standard
library only.
"""
import dataclasses
import os
import socket
import subprocess
import sys

import numpy as np

#: The mesh of the sharded train tests: 2 pods × 2 data × model 1 (4
#: ranks), and of the collectives and tensor-parallel tests: 2 × 2 × 2
#: (8 ranks).
TRAIN_MESH = ((2, 2, 1), ("pod", "data", "model"))
COLLECTIVES_MESH = ((2, 2, 2), ("pod", "data", "model"))
TP_MESH = COLLECTIVES_MESH
SINGLE_POD_MESH = ((4, 2), ("data", "model"))

#: Reduced f32 configs: (arch, MoE capacity factor or None).  The MoE
#: config at capacity factor 0.5, so that (token, expert) pairs drop on
#: every rank (capacity is per rank's rows, as in the reference, whose
#: GSPMD step keeps the batch sharded inside the MoE block).
CONFIGS = {"dense": ("qwen3-1.7b", None), "moe": ("qwen2-moe-a2.7b", 0.5),
           "ssm": ("mamba2-130m", None), "kv1": ("qwen3-1.7b", None),
           "pad": ("qwen3-1.7b", None), "whisper": ("whisper-base", None),
           "vision": ("phi-3-vision-4.2b", None),
           "jamba": ("jamba-v0.1-52b", None), "odd": ("minicpm-2b", None),
           "gemma": ("gemma3-12b", None)}
#: Fields set over the reduced config: one KV head (every rank of a
#: model axis of 2 reads it: the KV fallback), and 3 heads padded to 4
#: (``PAD_HEADS``) so that they split over the model axis; minicpm-2b's
#: odd vocabulary (tied head), which no axis divides.
OVERRIDES = {"kv1": dict(num_kv_heads=1),
             "pad": dict(num_heads=3, num_kv_heads=3),
             "odd": dict(vocab_size=251),
             "gemma": dict(num_layers=6, num_kv_heads=2)}
PAD_HEADS = {"pad": 4}
#: The configs held to JAX's (2, 2, 2) cell, and those held to the
#: port's own meshless step on that mesh (jamba-v0.1-52b at its reduced
#: capacity factor, 4 = E: no drops, so that capacity per data shard
#: and per batch agree).
TP_CONFIGS = ("dense", "moe", "ssm", "kv1", "pad")
TP_FAMILIES = ("whisper", "vision", "jamba", "odd")
#: Leaves drawn at their true fan-in (``tests/_torch_train_inputs.py``'s
#: ``TRUE_FAN_IN`` says why).
FAN_IN = {"moe": ("wq", "wk"), "whisper": ("wq", "wk"),
          "vision": ("wq", "wk"), "jamba": ("wq", "wk", "in_proj"),
          "odd": ("wq", "wk")}
BATCH, SEQ, STEPS, LR, TOTAL = 8, 32, 3, 3e-3, 300
SEED = 0

#: The serving cells held to JAX's on the (2, 2, 2) mesh: (tag, config,
#: kind, global batch, seq_len, decode_kv_seq_axis, ring_local_cache).
#: Batch 8 puts the batch over "pod" × "data"; without the flag the KV
#: heads split over "model", with it the sequence does.  Batch 1 puts the
#: sequence on "data" (and "data" × "model" with the flag).  gemma3-12b
#: at 64 rows so that its window of 32 bites, with a full-length cache and
#: with the ring of 32 slots, each split over "model".
SERVE_CASES = (
    ("dense/prefill", "dense", "prefill", 8, 16, False, False),
    ("dense/decode", "dense", "decode", 8, 32, False, False),
    ("dense/decode_seq", "dense", "decode", 8, 32, True, False),
    ("dense/b1", "dense", "decode", 1, 32, False, False),
    ("dense/b1_seq", "dense", "decode", 1, 32, True, False),
    ("gemma/decode_seq", "gemma", "decode", 8, 64, True, False),
    ("gemma/ring_seq", "gemma", "decode", 8, 64, True, True),
    ("moe/prefill", "moe", "prefill", 8, 16, False, False),
    ("moe/decode_seq", "moe", "decode", 8, 32, True, False),
    ("ssm/prefill", "ssm", "prefill", 8, 16, False, False),
    ("ssm/decode", "ssm", "decode", 8, 32, False, False),
)
SERVE_STEPS = 3
#: The serving cells held to the port's own meshless cells on the (2, 2,
#: 2) mesh (one step): an encoder-decoder and a vision model, the hybrid,
#: the odd vocabulary, one KV head, padded heads; each a prefill of 8 ×
#: 32, a decode of 8 × 48 with ``decode_kv_seq_axis`` and of 1 × 48
#: without.
SERVE_FAMILIES = ("whisper", "vision", "jamba", "odd", "kv1", "pad")
FAMILY_CELLS = (("prefill", 8, 32, False), ("decode", 8, 48, True),
                ("decode", 1, 48, False))
FAMILY_POS = (3, 20, 23, 24, 25, 30, 40, 47)
#: Each seat's first decode position, by cache length: over 3 steps
#: they cross the edges of the slices (16 of 32 rows; 8 of 32 for batch
#: 1 over 4 ranks; 32 of 64, where gemma3-12b's window also crosses), and
#: some seats leave a rank's slice empty.
SERVE_POS = {32: (0, 5, 13, 14, 15, 16, 27, 29),
             64: (0, 20, 30, 31, 33, 40, 50, 60)}
SERVE_POS_B1 = (14,)


def serve_inputs(tag: str, cfg, batch: int, seq: int,
                 cache_shapes=None) -> dict:
    """A serving case's inputs, f32/int32 numpy from one seed: the
    prefill's ``tokens`` (batch, seq); or the decode's first ``tokens``
    (batch, 1), ``pos`` (batch,) and ``cache/<posN>/<leaf>`` for each
    leaf of ``cache_shapes`` (``{posN: {leaf: shape}}``, the whole
    cache's shapes), drawn in sorted order."""
    rng = np.random.default_rng(SEED + 7 + sum(map(ord, tag)))
    if cache_shapes is None:
        return {"tokens": rng.integers(0, cfg.vocab_size, (batch, seq))
                .astype(np.int32)}
    pos = SERVE_POS_B1 if batch == 1 else SERVE_POS[seq]
    out = {"tokens": rng.integers(0, cfg.vocab_size, (batch, 1))
           .astype(np.int32), "pos": np.asarray(pos, np.int32)}
    for p in sorted(cache_shapes):
        for key in sorted(cache_shapes[p]):
            out[f"cache/{p}/{key}"] = rng.standard_normal(
                cache_shapes[p][key]).astype(np.float32)
    return out


def config(name: str, get_config, reduced_config):
    """The reduced f32 config ``name`` of ``CONFIGS`` through a package's
    own ``get_config``/``reduced_config``."""
    arch, cf = CONFIGS[name]
    cfg = reduced_config(get_config(arch), compute_dtype="float32",
                         **OVERRIDES.get(name, {}))
    if name in PAD_HEADS:
        cfg = dataclasses.replace(cfg, pad_heads_to=PAD_HEADS[name])
    if cf is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cf))
    return cfg


def run_options_kw(**kw) -> dict:
    return dict(q_chunk=32, xent_chunk=32, **kw)


def np_frontend(cfg, seed: int = SEED) -> dict:
    """A vision model's ``patches`` (BATCH, frontend_len, frontend_dim) or
    an encoder-decoder model's ``audio`` (BATCH, encoder_len,
    frontend_dim), f32 from numpy; {} for a text model."""
    rng = np.random.default_rng(seed + 1)
    if cfg.frontend == "vision":
        return {"patches": rng.standard_normal(
            (BATCH, cfg.frontend_len, cfg.frontend_dim)).astype(np.float32)}
    if cfg.encoder_decoder:
        return {"audio": rng.standard_normal(
            (BATCH, cfg.encoder_len, cfg.frontend_dim)).astype(np.float32)}
    return {}


def np_params(specs, name: str, seed: int = SEED) -> dict:
    """A params tree drawn with numpy from a ParamSpec tree of either
    package, in sorted-key order: ``normal`` leaves N(0, (scale /
    sqrt(shape[0]))²) as both packages' ``init_params`` scale them, the
    leaves of ``FAN_IN[name]`` at their true fan-in, ``zeros`` and
    ``ones`` as named.  f32 arrays."""
    rng = np.random.default_rng(seed)
    fan_in = FAN_IN.get(name, ())

    def draw(tree, key=None):
        if isinstance(tree, dict):
            return {k: draw(tree[k], k) for k in sorted(tree)}
        shape = tuple(tree.shape)
        if tree.init == "zeros":
            return np.zeros(shape, np.float32)
        if tree.init == "ones":
            return np.ones(shape, np.float32)
        std = tree.scale / np.sqrt(max(shape[0] if shape else 1, 1))
        a = (rng.standard_normal(shape) * std).astype(np.float32)
        if key in fan_in:
            a *= np.float32(np.sqrt(shape[0] / shape[1]))
        return a

    return draw(specs)


# -- subprocesses of the tests -------------------------------------------------

HERE = os.path.dirname(os.path.abspath(__file__))


def free_port() -> int:
    """A TCP port on 127.0.0.1 that the OS picked (for torchrun's
    ``MASTER_PORT``: no fixed port collides between test workers)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start(args, out_dir):
    """Start ``python *args`` with its output to a log in ``out_dir``,
    one thread per rank, the port's sources on the path."""
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.path.join(HERE, "..", "src")}
    env.pop("XLA_FLAGS", None)
    log = open(os.path.join(out_dir, os.path.basename(args[0]) + "."
                            + args[1] + ".log"), "w")
    return subprocess.Popen([sys.executable, *args], stdout=log,
                            stderr=subprocess.STDOUT, env=env), log


def finish(procs, timeout: float = 240) -> None:
    """Wait for every subprocess of ``start`` (killing them all when one
    outlives ``timeout``) and raise with a log's tail if one failed."""
    try:
        for proc, _ in procs:
            proc.wait(timeout=timeout)
    finally:
        for proc, log in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    for proc, log in procs:
        if proc.returncode != 0:
            with open(log.name) as f:
                raise AssertionError(f"{log.name}: exit {proc.returncode}\n"
                                     + f.read()[-4000:])
