"""Copy of ``repro.core.io500`` for the port (the reference module is
jax-free; the port imports nothing of the reference package).

IO500-like storage benchmark (paper Table 10) over the local filesystem.

Mirrors IO500's phase structure against the local filesystem:

  ior-easy   — large sequential striped writes/reads (bandwidth, GiB/s)
  ior-hard   — small unaligned interleaved writes (worst-case bandwidth)
  mdtest     — many tiny files create/stat/delete (metadata kIOPS)
  find       — tree traversal rate

Scores combine exactly like IO500: bandwidth score = geometric mean of the
ior phases, IOPS score = geometric mean of the mdtest/find phases, total =
sqrt(bw · iops).  The paper's 10-node-vs-96-node observation (bandwidth
saturates, metadata scales) is reproduced by sweeping `nproc` workers.
"""
from __future__ import annotations

import math
import os
import shutil
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict

import numpy as np


def _gib(nbytes: float) -> float:
    return nbytes / (1 << 30)


def ior_easy(root: str, *, nproc: int = 4, mb_per_proc: int = 64,
             stripe_mb: int = 8) -> Dict[str, float]:
    """Sequential striped I/O, one file per process (IOR easy mode)."""
    data = np.random.default_rng(0).bytes(stripe_mb << 20)
    stripes = mb_per_proc // stripe_mb

    def write_one(i):
        with open(os.path.join(root, f"ior_easy_{i}"), "wb") as f:
            for _ in range(stripes):
                f.write(data)
            f.flush()
            os.fsync(f.fileno())

    def read_one(i):
        total = 0
        with open(os.path.join(root, f"ior_easy_{i}"), "rb") as f:
            while True:
                buf = f.read(stripe_mb << 20)
                if not buf:
                    return total
                total += len(buf)

    with ThreadPoolExecutor(nproc) as ex:
        t0 = time.perf_counter()
        list(ex.map(write_one, range(nproc)))
        t_w = time.perf_counter() - t0
        t0 = time.perf_counter()
        list(ex.map(read_one, range(nproc)))
        t_r = time.perf_counter() - t0
    total = nproc * mb_per_proc << 20
    return {"write_gibs": _gib(total) / t_w, "read_gibs": _gib(total) / t_r}


def ior_hard(root: str, *, nproc: int = 4, blocks: int = 512,
             block_size: int = 47_008) -> Dict[str, float]:
    """Small unaligned interleaved records into a shared file (IOR hard)."""
    payload = np.random.default_rng(1).bytes(block_size)
    path = os.path.join(root, "ior_hard")
    with open(path, "wb") as f:
        f.truncate(nproc * blocks * block_size)

    def write_one(rank):
        with open(path, "r+b") as f:
            for i in range(blocks):
                f.seek((i * nproc + rank) * block_size)
                f.write(payload)
            f.flush()
            os.fsync(f.fileno())

    def read_one(rank):
        with open(path, "rb") as f:
            for i in range(blocks):
                f.seek((i * nproc + rank) * block_size)
                f.read(block_size)

    with ThreadPoolExecutor(nproc) as ex:
        t0 = time.perf_counter()
        list(ex.map(write_one, range(nproc)))
        t_w = time.perf_counter() - t0
        t0 = time.perf_counter()
        list(ex.map(read_one, range(nproc)))
        t_r = time.perf_counter() - t0
    total = nproc * blocks * block_size
    return {"write_gibs": _gib(total) / t_w, "read_gibs": _gib(total) / t_r}


def mdtest(root: str, *, nproc: int = 4, files_per_proc: int = 500) -> Dict[str, float]:
    """Create/stat/delete many tiny files (metadata kIOPS)."""
    def create(rank):
        d = os.path.join(root, f"md{rank}")
        os.makedirs(d, exist_ok=True)
        for i in range(files_per_proc):
            with open(os.path.join(d, f"f{i}"), "wb") as f:
                f.write(b"x")

    def stat(rank):
        d = os.path.join(root, f"md{rank}")
        for i in range(files_per_proc):
            os.stat(os.path.join(d, f"f{i}"))

    def delete(rank):
        d = os.path.join(root, f"md{rank}")
        for i in range(files_per_proc):
            os.unlink(os.path.join(d, f"f{i}"))

    out = {}
    total = nproc * files_per_proc
    with ThreadPoolExecutor(nproc) as ex:
        for name, fn in (("create", create), ("stat", stat), ("delete", delete)):
            t0 = time.perf_counter()
            list(ex.map(fn, range(nproc)))
            out[f"{name}_kiops"] = total / (time.perf_counter() - t0) / 1e3
    return out


def find_phase(root: str) -> Dict[str, float]:
    t0 = time.perf_counter()
    count = sum(len(files) for _, _, files in os.walk(root))
    dt = time.perf_counter() - t0
    return {"found": count, "find_kiops": count / max(dt, 1e-9) / 1e3}


def run_io500(*, nproc: int = 4, mb_per_proc: int = 32, files_per_proc: int = 300,
              workdir: str | None = None) -> dict:
    root = workdir or tempfile.mkdtemp(prefix="io500_")
    os.makedirs(root, exist_ok=True)
    try:
        easy = ior_easy(root, nproc=nproc, mb_per_proc=mb_per_proc,
                        stripe_mb=min(8, mb_per_proc))
        hard = ior_hard(root, nproc=nproc)
        md = mdtest(root, nproc=nproc, files_per_proc=files_per_proc)
        fnd = find_phase(root)
        bw_phases = [easy["write_gibs"], easy["read_gibs"],
                     hard["write_gibs"], hard["read_gibs"]]
        iops_phases = [md["create_kiops"], md["stat_kiops"], md["delete_kiops"],
                       fnd["find_kiops"]]
        bw_score = math.exp(sum(math.log(max(p, 1e-9)) for p in bw_phases) / len(bw_phases))
        iops_score = math.exp(sum(math.log(max(p, 1e-9)) for p in iops_phases) / len(iops_phases))
        return {
            "nproc": nproc,
            "ior_easy": easy, "ior_hard": hard, "mdtest": md, "find": fnd,
            "bandwidth_score_gibs": bw_score,
            "iops_score_kiops": iops_score,
            "total_score": math.sqrt(bw_score * iops_score),
        }
    finally:
        if workdir is None:
            shutil.rmtree(root, ignore_errors=True)
