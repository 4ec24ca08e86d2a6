"""Deterministic synthetic token pipeline (counterpart of
``repro.data.pipeline``), shard-aware and restart-safe.

Tokens are keyed by (step, row) through numpy's Philox, so a restarted
job resumes the exact stream and the port's batches are bit-equal to the
reference's for the same step.  Over a mesh each rank builds only its
rows of the global batch (the reference's ``make_array_from_callback``
branch builds each host's slice the same way), so the ranks' batches
concatenated are the global batch, bit for bit.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.parallel.fsdp import local_rows


def _tokens_for_slice(step: int, lo: int, hi: int, seq: int, vocab: int,
                      salt: int = 0, noise: float = 0.15) -> np.ndarray:
    """Deterministic tokens for global batch rows [lo, hi).

    The stream is a noisy affine-recurrence Markov chain
    (``next = (a·prev + c) mod V``, flipped to uniform noise w.p. `noise`)
    — deterministic AND learnable, so end-to-end training demos show real
    loss movement instead of fitting unigram statistics of pure noise.
    """
    rows = []
    a, c = 31, 17
    for r in range(lo, hi):
        rng = np.random.Generator(
            np.random.Philox(key=[(step << 32) | (salt & 0xFFFFFFFF), r]))
        toks = np.empty(seq + 1, dtype=np.int64)
        toks[0] = rng.integers(0, vocab)
        flips = rng.random(seq) < noise
        rand = rng.integers(0, vocab, size=seq)
        for t in range(seq):
            toks[t + 1] = rand[t] if flips[t] else (a * toks[t] + c) % vocab
        rows.append(toks)
    arr = np.stack(rows)
    return arr


class TokenPipeline:
    """``get_batch(step)`` -> ``{"tokens", "labels"}``: (rows, seq) int32
    tensors on ``device``, the labels the tokens shifted by one; the rows
    the whole global batch, or over ``mesh`` this rank's rows of it by
    ``batch_spec`` (a spec whose first entry names the mesh axes the
    batch is split over, ``parallel.sharding.batch_spec``)."""

    def __init__(self, vocab_size: int, seq_len: int, global_batch: int, *,
                 device, mesh=None, batch_spec=()):
        self.vocab = vocab_size
        self.seq = seq_len
        self.batch = global_batch
        self.device = torch.device(device)
        self.mesh = mesh
        self.spec = tuple(batch_spec)
        self.rows = (0, global_batch)
        if mesh is not None and self.spec and self.spec[0] is not None:
            axes = self.spec[0]
            self.rows = local_rows(mesh, (axes,) if isinstance(axes, str)
                                   else axes, global_batch)

    def get_batch(self, step: int) -> Dict[str, torch.Tensor]:
        lo, hi = self.rows
        arr = torch.from_numpy(_tokens_for_slice(
            step, lo, hi, self.seq, self.vocab).astype(np.int32))
        cuda = self.device.type == "cuda"
        if cuda:
            arr = arr.pin_memory()      # the copy below then needs no sync
        arr = arr.to(self.device, non_blocking=cuda)
        return {"tokens": arr[:, :-1].contiguous(),
                "labels": arr[:, 1:].contiguous()}
