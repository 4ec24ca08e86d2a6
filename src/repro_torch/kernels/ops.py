"""Public wrappers of the port's kernels (counterparts of
``repro.kernels.ops``).

Each wrapper takes ``impl``:

- ``"auto"`` (default): the Hopper kernel for CUDA tensors, the plain
  PyTorch version for CPU tensors — the counterpart of
  ``RunOptions.paged_attn_impl="auto"`` in the JAX model;
- ``"kernel"``: the kernel, for CUDA tensors only;
- ``"plain"``: the plain version on any device.

On a CUDA tensor a wrapper launches its kernel or raises: it checks
device, dtype, shape and contiguity first, and nothing falls back to the
plain version.  Each launch adds one to its variant's entry in
:data:`launches` (``paged_decode_attention[bf16]``,
``quantized_paged_decode_attention[fp8]``, ``rmsnorm[D=2048]``, ...), so a
run can show which kernels it went through, and at which pool type or
width.
The kernels are built at their first launch (``kernels._build``,
``kernels.rmsnorm``).
"""
from __future__ import annotations

from collections import Counter
from typing import Optional

import torch

from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import rmsnorm as rn

IMPLS = ("auto", "kernel", "plain")

#: Kernel launches per variant since the last :func:`reset_launches`;
#: a variant never launched reads 0.
launches: Counter = Counter()

#: Pool dtype -> the tag of its kernel variant in :data:`launches`.
_POOL_TAGS = {torch.bfloat16: "bf16", torch.float32: "f32",
              torch.uint8: "fp8", torch.int8: "int8"}


def reset_launches() -> None:
    launches.clear()


def use_kernel(impl: str, x: torch.Tensor) -> bool:
    """Whether a wrapper called with ``impl`` on ``x`` launches its kernel.

    Raises:
      ValueError: unknown ``impl``, or ``impl="kernel"`` on a CPU tensor."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; expected one of {IMPLS}")
    if impl == "plain":
        return False
    if x.is_cuda:
        return True
    if impl == "kernel":
        raise ValueError(f"impl='kernel' needs CUDA tensors, got one on "
                         f"{x.device}")
    return False


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6,
            impl: str = "auto") -> torch.Tensor:
    """RMSNorm over the last axis of ``x`` (..., D) with weight ``w`` (D,)
    applied as ``1 + w``; the result is in ``x.dtype``."""
    if not use_kernel(impl, x):
        return rn.rmsnorm_plain(x, w, eps=eps)
    d = x.shape[-1]
    _check(w.device == x.device, f"rmsnorm: w on {w.device}, x on {x.device}")
    _check(x.dtype in (torch.float32, torch.bfloat16, torch.float16),
           f"rmsnorm: x dtype {x.dtype} not f32/bf16/f16")
    _check(w.dtype.is_floating_point, f"rmsnorm: w dtype {w.dtype}")
    _check(w.shape == (d,), f"rmsnorm: w shape {tuple(w.shape)} != ({d},)")
    _check(x.is_contiguous() and w.is_contiguous(),
           "rmsnorm: x and w must be contiguous")
    x2 = x.view(-1, d)
    out = torch.empty_like(x2)
    if x2.shape[0]:
        with torch.cuda.device(x.device):
            rn.rmsnorm_triton(x2, w, out, eps)
        launches[f"rmsnorm[D={d}]"] += 1
    return out.view(x.shape)


def paged_decode_attention(q, k_pages, v_pages, page_table, lengths, *,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None,
                           impl: str = "auto") -> torch.Tensor:
    """Single-token decode attention over a paged KV pool.

    q: (B, 1, H, d); k_pages/v_pages: (P, page, KVH, d) one layer's
    shared pool; page_table: (B, n) int32 logical->physical page map;
    lengths: (B,) int32 valid-key counts.  Returns (B, 1, H, d) in
    q.dtype.  A quantized pool (uint8 e4m3 bits or int8) passes
    ``k_scale``/``v_scale`` (P, page, KVH) f32 — both or neither.
    """
    if (k_scale is None) != (v_scale is None):
        raise ValueError("paged_decode_attention: pass k_scale and v_scale "
                         "together (quantized pool) or neither")
    B, C, H, d = q.shape
    if not use_kernel(impl, q):
        out = da.paged_decode_attention_plain(q[:, 0], k_pages, v_pages,
                                              page_table, lengths,
                                              k_scale, v_scale)
        return out[:, None]
    P, page, KVH, dk = k_pages.shape
    quantized = k_scale is not None
    name = ("quantized_paged_decode_attention" if quantized
            else "paged_decode_attention")
    _check(C == 1, f"{name}: one query token per seat, got C={C}")
    _check(dk == d and v_pages.shape == k_pages.shape,
           f"{name}: pools {tuple(k_pages.shape)}/{tuple(v_pages.shape)} "
           f"do not match q {tuple(q.shape)}")
    _check(q.dtype in da.Q_CODES, f"{name}: q dtype {q.dtype} not f32/bf16")
    _check(k_pages.dtype in da.KV_CODES and v_pages.dtype == k_pages.dtype,
           f"{name}: pool dtype {k_pages.dtype}/{v_pages.dtype}")
    _check(quantized == (k_pages.dtype in (torch.uint8, torch.int8)),
           f"{name}: a {k_pages.dtype} pool "
           + ("needs" if not quantized else "takes no") + " scales")
    _check(H % KVH == 0 and H // KVH <= da.MAX_GROUP,
           f"{name}: H={H}, KVH={KVH}: needs H % KVH == 0 and "
           f"H / KVH <= {da.MAX_GROUP}")
    _check(d <= da.MAX_HEAD_DIM, f"{name}: head dim {d} > {da.MAX_HEAD_DIM}")
    _check(page_table.dtype == torch.int32 and lengths.dtype == torch.int32,
           f"{name}: page_table/lengths must be int32")
    _check(page_table.dim() == 2 and page_table.shape[0] == B
           and lengths.shape == (B,),
           f"{name}: page_table {tuple(page_table.shape)} / lengths "
           f"{tuple(lengths.shape)} do not match {B} seats")
    tensors = [q, k_pages, v_pages, page_table, lengths]
    if quantized:
        _check(k_scale.dtype == torch.float32
               and v_scale.dtype == torch.float32
               and k_scale.shape == (P, page, KVH)
               and v_scale.shape == (P, page, KVH)
               and k_scale.stride() == v_scale.stride(),
               f"{name}: scales must be f32 (P, page, KVH) with equal "
               "strides")
        tensors += [k_scale, v_scale]
    _check(all(t.device == q.device for t in tensors),
           f"{name}: tensors on {sorted({str(t.device) for t in tensors})}")
    _check(q.is_contiguous() and page_table.is_contiguous()
           and lengths.is_contiguous(),
           f"{name}: q, page_table and lengths must be contiguous")
    _check(k_pages.stride(3) == 1 and k_pages.stride() == v_pages.stride(),
           f"{name}: pools need unit stride in d and equal strides")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        da.paged_decode_attention_cuda(q[:, 0], k_pages, v_pages, page_table,
                                       lengths, k_scale, v_scale, out[:, 0])
    launches[f"{name}[{_POOL_TAGS[k_pages.dtype]}]"] += 1
    return out
