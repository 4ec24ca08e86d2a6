"""Striped, async checkpointing (counterpart of
``repro.checkpoint.manager``).  The on-disk format is the reference's, so
either package restores what the other saved:

    <root>/step_<N>.tmp/          # staged writes
        ost0/<leaf>.stripe0
        ost1/<leaf>.stripe1 ...
    <root>/step_<N>/              # committed by atomic os.replace
        ...
        MANIFEST.json             # written + fsync'd LAST

Commit protocol: write all stripes -> fsync -> write manifest -> fsync ->
atomic directory rename.  A crash at any point leaves either the previous
complete checkpoint or a .tmp that restore ignores — no torn states.

Leaves are named by their path in the nested dict (``params/blocks/pos0/
mixer/wq``, keys sorted as ``jax.tree_util.tree_flatten_with_path`` sorts
them) and carry numpy's dtype name.  A bfloat16 leaf is written and read
as its 16-bit patterns under the label ``"bfloat16"`` (the reference's
``ml_dtypes`` name), so the port needs no ``ml_dtypes``.

Sharded trees (a train step over a mesh, ``launch.steps.Cell``) pass
their placement as ``shardings``, a tree like the state whose leaves are
``parallel.fsdp.Split``s (None for a whole leaf; a leaf may be split
over "data" and "model" at once): ``save`` gathers each
split leaf on every rank and global rank 0 writes the same manifest and
files as a single device; ``restore`` reads the whole leaf and keeps
this rank's slice.  So a checkpoint saved on 4 or 8 ranks restores onto
1 and the reverse (elastic restore, the reference's recovery contract).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.tree import (tree_flatten_with_paths, tree_leaves,
                              tree_unflatten)

MANIFEST = "MANIFEST.json"
BF16 = "bfloat16"


def _to_host(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A copy of a tensor as a host numpy array, and the dtype name to
    record."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), BF16
    a = t.numpy()
    return a, str(a.dtype)


def _from_host(data: bytes, dtype: str, shape) -> torch.Tensor:
    if dtype == BF16:
        a = np.frombuffer(data, dtype=np.uint16).reshape(shape)
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    a = np.frombuffer(data, dtype=np.dtype(dtype)).reshape(shape)
    return torch.from_numpy(a.copy())


class CheckpointManager:
    def __init__(self, root: str, *, stripes: int = 4, keep: int = 3):
        self.root = root
        self.stripes = stripes
        self.keep = keep
        os.makedirs(root, exist_ok=True)
        self._pool = ThreadPoolExecutor(max_workers=stripes)
        self._writer = ThreadPoolExecutor(max_workers=1)
        self._pending: Optional[Future] = None
        self._lock = threading.Lock()

    # -- save ---------------------------------------------------------------

    def _write_leaf(self, stage: str, name: str, arr: np.ndarray,
                    dtype: str) -> Dict:
        data = arr.tobytes()
        n = max(1, min(self.stripes, len(data) or 1))
        chunk = (len(data) + n - 1) // n if data else 0
        files = []
        for i in range(n):
            ost = os.path.join(stage, f"ost{i}")
            os.makedirs(ost, exist_ok=True)
            fname = os.path.join(ost, f"{name.replace('/', '.')}.stripe{i}")
            with open(fname, "wb") as f:
                f.write(data[i * chunk:(i + 1) * chunk])
                f.flush()
                os.fsync(f.fileno())
            files.append(os.path.relpath(fname, stage))
        return {"name": name, "shape": list(arr.shape), "dtype": dtype,
                "files": files}

    def _commit(self, step: int, host, extra: Optional[Dict]) -> str:
        stage = os.path.join(self.root, f"step_{step}.tmp")
        final = os.path.join(self.root, f"step_{step}")
        shutil.rmtree(stage, ignore_errors=True)
        os.makedirs(stage)
        records = list(self._pool.map(
            lambda leaf: self._write_leaf(stage, *leaf), host))
        manifest = {"step": step, "leaves": records, "extra": extra or {}}
        mpath = os.path.join(stage, MANIFEST)
        with open(mpath, "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        shutil.rmtree(final, ignore_errors=True)
        os.replace(stage, final)                     # atomic commit
        self._gc()
        return final

    @staticmethod
    def _host_leaves(tree, shardings=None):
        """Host copies of the whole leaves; with ``shardings``, None on
        every rank but global rank 0, which writes (every rank gathers)."""
        items = tree_flatten_with_paths(tree)
        if shardings is None:
            return [(name, *_to_host(t)) for name, t in items]
        splits = _split_leaves(shardings, len(items))
        whole = [(name, t if s is None else s.gather(t))
                 for (name, t), s in zip(items, splits)]
        if dist.get_rank() != 0:
            return None
        return [(name, *_to_host(t)) for name, t in whole]

    def save(self, step: int, tree, *, extra: Optional[Dict] = None,
             shardings=None) -> Optional[str]:
        """Blocking save. Returns the committed directory (with
        ``shardings``: on rank 0, and every rank returns once it is
        committed; None on the others)."""
        host = self._host_leaves(tree, shardings)
        out = None if host is None else self._commit(step, host, extra)
        if shardings is not None:
            dist.barrier()
        return out

    def save_async(self, step: int, tree, *, extra: Optional[Dict] = None,
                   shardings=None) -> Optional[Future]:
        """Non-blocking save: the device -> host copy (with ``shardings``,
        the gathers) happens before returning, so training can update the
        tensors in place at once.  With ``shardings`` only rank 0 writes;
        the others get None."""
        host = self._host_leaves(tree, shardings)
        if host is None:
            return None
        with self._lock:
            self.wait()
            self._pending = self._writer.submit(self._commit, step, host,
                                                extra)
        return self._pending

    def wait(self):
        if self._pending is not None:
            self._pending.result()
            self._pending = None

    def close(self):
        """Finish the pending save and stop the writer threads."""
        try:
            self.wait()
        finally:
            self._writer.shutdown()
            self._pool.shutdown()

    # -- restore ------------------------------------------------------------

    def steps(self) -> List[int]:
        out = []
        for d in os.listdir(self.root):
            if d.startswith("step_") and not d.endswith(".tmp"):
                if os.path.exists(os.path.join(self.root, d, MANIFEST)):
                    out.append(int(d.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, tree_like, step: Optional[int] = None, *,
                shardings=None, device=None) -> Tuple[int, Any]:
        """Restore the leaves named by ``tree_like``'s paths from ``step``
        (default: the latest), with the dtypes and shapes the manifest
        records; with ``shardings`` (see the module's docstring) each
        split leaf's slice for this rank.  Each leaf goes to ``device``,
        or, when that is None, to the device of its counterpart in
        ``tree_like``."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.root}")
        cdir = os.path.join(self.root, f"step_{step}")
        with open(os.path.join(cdir, MANIFEST)) as f:
            manifest = json.load(f)
        by_name = {r["name"]: r for r in manifest["leaves"]}

        def load(item) -> torch.Tensor:
            (name, ref), split = item
            rec = by_name[name]
            data = b"".join(_read(os.path.join(cdir, f))
                            for f in rec["files"])
            t = _from_host(data, rec["dtype"], rec["shape"])
            if split is not None:
                t = split.slice(t)
            return t.to(ref.device if device is None else device)

        items = tree_flatten_with_paths(tree_like)
        splits = (_split_leaves(shardings, len(items)) if shardings
                  is not None else [None] * len(items))
        leaves = self._pool.map(load, zip(items, splits))
        return step, tree_unflatten(tree_like, leaves)

    # -- gc -----------------------------------------------------------------

    def _gc(self):
        steps = self.steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.root, f"step_{s}"),
                          ignore_errors=True)


def _split_leaves(shardings, n: int) -> list:
    """The leaves of a shardings tree (Splits or None) in leaf order."""
    out = tree_leaves(shardings)
    if len(out) != n:
        raise ValueError(f"shardings hold {len(out)} leaves, the tree {n}")
    return out


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()
