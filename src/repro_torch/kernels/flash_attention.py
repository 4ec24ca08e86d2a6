"""Flash attention: the Hopper CUDA kernel and its plain version.

``flash_attention_cuda`` launches ``csrc/flash_attention.cu``, which
replaces ``repro/kernels/flash_attention.py :: flash_attention_pallas``:
tiled online-softmax attention with causal and sliding-window masks, on
the fixed-slot path's prefill.  It reads q ``(B, Sq, H, d)`` and k/v
``(B, Skv, KVH, d)`` where they lie, kv head ``h // G`` for query head
``h``, and masks the ragged tails itself, so nothing is repeated, padded
or copied (see the note in the source for what bounds it).

``flash_attention_plain`` is the same function in plain PyTorch: the JAX
wrapper's GQA repeat and ``(B·H, S, d)`` flattening (``repro/kernels/
ops.py :: flash_attention``) followed by ``ref.attention_ref``.  The TPU
wrapper also pads Sq and Skv to its tiles and masks keys past ``kv_len``;
padded keys add exactly zero to every real row and padded rows are cut
off again, so the plain version leaves the padding out.  It serves CPU
tensors and the checks on the card.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build, ref

#: Storage-type codes of the C entry point (q, k, v and out share one).
CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          window: Optional[int] = None):
    """q: (B, Sq, H, d); k/v: (B, Skv, KVH, d).  Returns (B, Sq, H, d)."""
    B, Sq, H, d = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    rep = H // KVH
    qf = q.transpose(1, 2).reshape(B * H, Sq, d)
    kf = k.repeat_interleave(rep, dim=2).transpose(1, 2).reshape(B * H, Skv, d)
    vf = v.repeat_interleave(rep, dim=2).transpose(1, 2).reshape(B * H, Skv, d)
    out = ref.attention_ref(qf, kf, vf, causal=causal, window=window)
    return out.reshape(B, H, Sq, d).transpose(1, 2)


def flash_attention_cuda(q, k, v, out: torch.Tensor, *, causal: bool,
                         window: Optional[int]) -> None:
    """Launch the kernel on the current stream, writing ``out``
    (B, Sq, H, d).  The caller (``kernels.ops``) has checked devices,
    dtypes, shapes and strides.

    Raises:
      RuntimeError: the launch was refused (the CUDA error code)."""
    B, Sq, H, d = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    lib = _build.library("flash_attention")
    err = lib.flash_attention(
        CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), B, Sq, Skv, H, KVH, d, int(causal), window or 0,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        out.stride(0), out.stride(1), out.stride(2),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"CUDA error {err}")
