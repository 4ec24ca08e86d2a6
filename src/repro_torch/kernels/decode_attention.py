"""Paged decode attention: the Hopper CUDA kernel and its plain version.

``paged_decode_attention_cuda`` launches ``csrc/paged_decode_attention.cu``,
which replaces ``repro/kernels/decode_attention.py ::
paged_decode_attention_pallas`` (bf16/f32 pools) and
``quantized_paged_decode_attention_pallas`` (fp8/int8 pools with
per-(token, head) scales).  The kernel is bound by memory: it reads each
valid token's K and V once (see the note in the source).

``paged_decode_attention_plain`` is the same function in plain PyTorch:
the JAX wrapper's GQA expansion on the page table
(``repro/kernels/ops.py :: paged_decode_attention``) followed by the
oracles of ``kernels/ref.py``.  The CPU path and the checks on the card
use it; nothing on the serving path calls it for CUDA tensors.

Both take the port's layout: q ``(A, H, d)``, one layer's pools
``(P, page, KVH, d)``, scales ``(P, page, KVH)`` (quantized pools only),
``page_table (A, n)`` int32 and ``lengths (A,)`` int32.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build, ref

#: Storage-type codes of the C entry point.
Q_CODES = {torch.float32: 0, torch.bfloat16: 1}
KV_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.uint8: 2,
            torch.int8: 3}
MAX_GROUP = 8          # query heads per kv head one block serves
MAX_HEAD_DIM = 256


def paged_decode_attention_plain(q, k_pages, v_pages, page_table, lengths,
                                 k_scale: Optional[torch.Tensor] = None,
                                 v_scale: Optional[torch.Tensor] = None):
    """Plain version: expand GQA on the page table (head h of seat a reads
    pages ``kvh(h) * P + page_table[a]`` of the pool flattened to
    ``(KVH*P, page, d)``), then the dense oracle.  Returns (A, H, d)."""
    A, H, d = q.shape
    P, page, KVH, _ = k_pages.shape
    n = page_table.shape[1]
    kf = k_pages.permute(2, 0, 1, 3).reshape(KVH * P, page, d)
    vf = v_pages.permute(2, 0, 1, 3).reshape(KVH * P, page, d)
    head_base = (torch.arange(H, device=q.device) // (H // KVH)) * P
    pt = (head_base[None, :, None] + page_table[:, None, :]).reshape(A * H, n)
    qf = q.reshape(A * H, d)
    lens = lengths.repeat_interleave(H)
    if k_scale is not None:
        ksf = k_scale.permute(2, 0, 1).reshape(KVH * P, page)
        vsf = v_scale.permute(2, 0, 1).reshape(KVH * P, page)
        out = ref.quantized_paged_decode_attention_ref(qf, kf, vf, ksf, vsf,
                                                       pt, lens)
    else:
        out = ref.paged_decode_attention_ref(qf, kf, vf, pt, lens)
    return out.reshape(A, H, d)


def paged_decode_attention_cuda(q, k_pages, v_pages, page_table, lengths,
                                k_scale: Optional[torch.Tensor],
                                v_scale: Optional[torch.Tensor],
                                out: torch.Tensor) -> None:
    """Launch the kernel on the current stream, writing ``out`` (A, H, d).
    The caller (``kernels.ops``) has checked devices, dtypes, shapes and
    strides.

    Raises:
      RuntimeError: the launch was refused (the CUDA error code)."""
    A, H, d = q.shape
    _, page, KVH, _ = k_pages.shape
    quantized = k_scale is not None
    sc = k_scale.stride() if quantized else (0, 0, 0)
    lib = _build.library("paged_decode_attention")
    err = lib.paged_decode_attention(
        Q_CODES[q.dtype], KV_CODES[k_pages.dtype], q.data_ptr(),
        k_pages.data_ptr(), v_pages.data_ptr(),
        k_scale.data_ptr() if quantized else None,
        v_scale.data_ptr() if quantized else None,
        page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        A, H, KVH, d, page, page_table.shape[1],
        k_pages.stride(0), k_pages.stride(1), k_pages.stride(2),
        sc[0], sc[1], sc[2],
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_decode_attention kernel launch failed: "
                           f"CUDA error {err}")
