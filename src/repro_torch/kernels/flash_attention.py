"""Flash attention: the Hopper CUDA kernel and its plain version.

``flash_attention_cuda`` launches ``csrc/flash_attention.cu``, which
replaces ``repro/kernels/flash_attention.py :: flash_attention_pallas``:
tiled online-softmax attention with causal and sliding-window masks, on
the fixed-slot path's prefill.  It reads q ``(B, Sq, H, d)`` and k/v
``(B, Skv, KVH, d)`` where they lie, kv head ``h // G`` for query head
``h``, and masks the ragged tails itself, so nothing is repeated, padded
or copied.  Two routes, by dtype and head dim (``route``): bf16 at d in
``TC_HEAD_DIMS`` runs on the tensor cores (TMA loads, ``wgmma``, P
rounded to bf16 for the P·V product); f32, and bf16 at any other d, on
the CUDA cores in f32 (see the note in the source for what bounds each).

``flash_attention_plain`` is the same function in plain PyTorch: the JAX
wrapper's GQA repeat and ``(B·H, S, d)`` flattening (``repro/kernels/
ops.py :: flash_attention``) followed by ``ref.attention_ref``.  The TPU
wrapper also pads Sq and Skv to its tiles and masks keys past ``kv_len``;
padded keys add exactly zero to every real row and padded rows are cut
off again, so the plain version leaves the padding out.  It serves CPU
tensors and the checks on the card.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build, ref

#: Storage-type codes of the C entry point (q, k, v and out share one).
CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
#: Head dims of the tensor-core route (bf16 only).
TC_HEAD_DIMS = (32, 64, 96, 128, 256)


def route(dtype: torch.dtype, d: int) -> str:
    """``"tensor cores"`` for bf16 at a head dim of ``TC_HEAD_DIMS``, else
    ``"cuda cores"``: a choice by dtype and shape, never a fallback."""
    if dtype == torch.bfloat16 and d in TC_HEAD_DIMS:
        return "tensor cores"
    return "cuda cores"


def tma_strides(x: torch.Tensor) -> Tuple[int, int, int]:
    """The (batch, sequence, head) strides of a (B, S, heads, d) tensor
    as the tensor-core route's tensor maps take them.  A dimension of size
    1 is never stepped, so its stride is replaced by d (which TMA's
    16-byte rule admits whenever the real strides pass it)."""
    return tuple(st if n > 1 else x.shape[3]
                 for st, n in zip(x.stride()[:3], x.shape[:3]))


def tma_problem(q, k, v) -> Optional[str]:
    """Why the tensor-core route cannot read q, k and v (TMA's rules: the
    base 16-byte aligned, every stride a multiple of 16 bytes), or None."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            return f"{name} is not 16-byte aligned"
        if any(st % 8 for st in tma_strides(t)):
            return (f"{name} strides {tuple(t.stride())} are not multiples "
                    "of 16 bytes")
    return None


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
    """Launch the kernel of ``route(q.dtype, d)`` on the current stream,
    writing ``out`` (B, Sq, H, d).  The caller (``kernels.ops``) has
    checked devices, dtypes, shapes and strides, and for the tensor-core
    route ``tma_problem``.

    Raises:
      RuntimeError: the launch was refused (the CUDA error code)."""
    B, Sq, H, d = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    lib = _build.library("flash_attention")
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq,
            Skv, H, KVH, d, int(causal), window or 0)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if route(q.dtype, d) == "tensor cores":
        err = lib.flash_attention_tc(*args, *tma_strides(q),
                                     *tma_strides(k), *out.stride()[:3],
                                     stream)
    else:
        err = lib.flash_attention(CODES[q.dtype], *args, *q.stride()[:3],
                                  *k.stride()[:3], *out.stride()[:3], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed "
                           f"({route(q.dtype, d)}): CUDA error {err}")
