"""Deterministic synthetic token pipeline (counterpart of
``repro.data.pipeline``), on one device.

Tokens are keyed by (step, row) through numpy's Philox, so a restarted
job resumes the exact stream and the port's batches are bit-equal to the
reference's for the same step.  The reference's sharded branch (each host
builds only its slice through ``jax.make_array_from_callback``) belongs
to the parallelism slice; here the whole batch is built on the host and
copied to the device.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


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
    """``get_batch(step)`` -> ``{"tokens", "labels"}``: (batch, seq) int32
    tensors on ``device``, the labels the tokens shifted by one."""

    def __init__(self, vocab_size: int, seq_len: int, global_batch: int, *,
                 device):
        self.vocab = vocab_size
        self.seq = seq_len
        self.batch = global_batch
        self.device = torch.device(device)

    def _global(self, step: int) -> np.ndarray:
        return _tokens_for_slice(step, 0, self.batch, self.seq, self.vocab)

    def get_batch(self, step: int) -> Dict[str, torch.Tensor]:
        arr = torch.from_numpy(self._global(step).astype(np.int32))
        cuda = self.device.type == "cuda"
        if cuda:
            arr = arr.pin_memory()      # the copy below then needs no sync
        arr = arr.to(self.device, non_blocking=cuda)
        return {"tokens": arr[:, :-1].contiguous(),
                "labels": arr[:, 1:].contiguous()}
