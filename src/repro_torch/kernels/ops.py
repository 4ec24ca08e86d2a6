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
run can show which kernels it went through, and at which pool type, mask
or width (``decode_attention[bf16]``, ``flash_attention[causal]``,
``add_rmsnorm[D=2048]``, ``rmsnorm_qk[D=128]``, ``fp8_matmul[e4m3]``); a
decode launch over a sliding window counts apart from a global one
(``paged_decode_attention[bf16,window]``, ``decode_attention[bf16,window]``).
The kernels are built at their first launch (``kernels._build``,
``kernels.rmsnorm``).
"""
from __future__ import annotations

from collections import Counter
from typing import Optional

import torch

from repro_torch.core.mixed_precision import F8, F8_MAX
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fp8_matmul as fm
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


_NORM_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def _check_norm(name: str, x: torch.Tensor, w: torch.Tensor) -> None:
    """The RMSNorm kernels' contract for rows ``x`` (..., D) and weight
    ``w`` (D,): one device, f32/bf16/f16 rows, contiguous."""
    d = x.shape[-1]
    _check(w.device == x.device, f"{name}: w on {w.device}, x on {x.device}")
    _check(x.dtype in _NORM_DTYPES, f"{name}: x dtype {x.dtype} not "
           "f32/bf16/f16")
    _check(w.dtype.is_floating_point, f"{name}: w dtype {w.dtype}")
    _check(w.shape == (d,), f"{name}: w shape {tuple(w.shape)} != ({d},)")
    _check(x.is_contiguous() and w.is_contiguous(),
           f"{name}: x and w must be contiguous")


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6,
            impl: str = "auto") -> torch.Tensor:
    """RMSNorm over the last axis of ``x`` (..., D) with weight ``w`` (D,)
    applied as ``1 + w``; the result is in ``x.dtype``."""
    if not use_kernel(impl, x):
        return rn.rmsnorm_plain(x, w, eps=eps)
    _check_norm("rmsnorm", x, w)
    d = x.shape[-1]
    x2 = x.view(-1, d)
    out = torch.empty_like(x2)
    if x2.shape[0]:
        with torch.cuda.device(x.device):
            rn.rmsnorm_triton(x2, w, out, eps)
        launches[f"rmsnorm[D={d}]"] += 1
    return out.view(x.shape)


def add_rmsnorm(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor, *,
                eps: float = 1e-6, impl: str = "auto"):
    """A residual add and the RMSNorm that reads its result: returns
    ``(s, n)`` with ``s = x + y`` (x and y of one shape (..., D) and
    dtype, so ``s`` rounds as the add alone would) and ``n = rmsnorm(s,
    w)``, the norm of the rounded ``s``, in ``x.dtype``."""
    if not use_kernel(impl, x):
        return rn.add_rmsnorm_plain(x, y, w, eps=eps)
    _check_norm("add_rmsnorm", x, w)
    _check(y.shape == x.shape and y.dtype == x.dtype
           and y.device == x.device and y.is_contiguous(),
           f"add_rmsnorm: y {tuple(y.shape)} {y.dtype} on {y.device} must "
           f"be contiguous and match x {tuple(x.shape)} {x.dtype}")
    d = x.shape[-1]
    x2, y2 = x.view(-1, d), y.view(-1, d)
    s, n = torch.empty_like(x2), torch.empty_like(x2)
    if x2.shape[0]:
        with torch.cuda.device(x.device):
            rn.add_rmsnorm_triton(x2, y2, w, s, n, eps)
        launches[f"add_rmsnorm[D={d}]"] += 1
    return s.view(x.shape), n.view(x.shape)


def rmsnorm_qk(q: torch.Tensor, k: torch.Tensor, wq: torch.Tensor,
               wk: torch.Tensor, *, eps: float = 1e-6, impl: str = "auto"):
    """Attention's q-norm and k-norm in one launch: returns
    ``(rmsnorm(q, wq), rmsnorm(k, wk))`` for q (..., D) and k (..., D) of
    one dtype, each row normed with its own tensor's weight."""
    if not use_kernel(impl, q):
        return rn.rmsnorm_qk_plain(q, k, wq, wk, eps=eps)
    _check_norm("rmsnorm_qk", q, wq)
    _check_norm("rmsnorm_qk", k, wk)
    d = q.shape[-1]
    _check(k.shape[-1] == d and k.dtype == q.dtype and k.device == q.device
           and wk.dtype == wq.dtype,
           f"rmsnorm_qk: k {tuple(k.shape)} {k.dtype} (weight {wk.dtype}) "
           f"does not match q {tuple(q.shape)} {q.dtype} (weight "
           f"{wq.dtype})")
    q2, k2 = q.view(-1, d), k.view(-1, d)
    qn, kn = torch.empty_like(q2), torch.empty_like(k2)
    if q2.shape[0] + k2.shape[0]:
        with torch.cuda.device(q.device):
            rn.rmsnorm_qk_triton(q2, k2, wq, wk, qn, kn, eps)
        launches[f"rmsnorm_qk[D={d}]"] += 1
    return qn.view(q.shape), kn.view(k.shape)


def _window_tag(window: Optional[int]) -> str:
    return "" if window is None else ",window"


def paged_decode_attention(q, k_pages, v_pages, page_table, lengths, *,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None,
                           window: Optional[int] = None,
                           impl: str = "auto") -> torch.Tensor:
    """Single-token decode attention over a paged KV pool.

    q: (B, 1, H, d); k_pages/v_pages: (P, page, KVH, d) one layer's
    shared pool; page_table: (B, n) int32 logical->physical page map;
    lengths: (B,) int32 valid-key counts; ``window``: a sliding window,
    keeping only each seat's last ``window`` keys (``t >= lengths -
    window``).  Returns (B, 1, H, d) in q.dtype.  A quantized pool (uint8
    e4m3 bits or int8) passes ``k_scale``/``v_scale`` (P, page, KVH) f32
    — both or neither.
    """
    if (k_scale is None) != (v_scale is None):
        raise ValueError("paged_decode_attention: pass k_scale and v_scale "
                         "together (quantized pool) or neither")
    _check(window is None or window >= 1,
           f"paged_decode_attention: window {window} < 1")
    B, C, H, d = q.shape
    if not use_kernel(impl, q):
        out = da.paged_decode_attention_plain(q[:, 0], k_pages, v_pages,
                                              page_table, lengths,
                                              k_scale, v_scale, window)
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
    _check(da.one_load_per_lane(k_pages) and da.one_load_per_lane(v_pages),
           f"{name}: head dim {d}, pool strides {k_pages.stride()} and "
           f"addresses must allow {da.lane_elems(d)} elements per load")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        da.paged_decode_attention_cuda(q[:, 0], k_pages, v_pages, page_table,
                                       lengths, k_scale, v_scale, out[:, 0],
                                       window=window)
    launches[f"{name}[{_POOL_TAGS[k_pages.dtype]}{_window_tag(window)}]"] += 1
    return out


def decode_attention(q, k, v, lengths, *, window: Optional[int] = None,
                     starts: Optional[torch.Tensor] = None,
                     lse: Optional[torch.Tensor] = None,
                     impl: str = "auto") -> torch.Tensor:
    """Single-token decode attention against a dense KV cache (the
    fixed-slot layout).

    q: (B, 1, H, d); k/v: (B, T, KVH, d) one layer's cache; lengths: (B,)
    int32 valid-key counts (keys ``t < lengths[b]`` attend, and with a
    ``window`` only ``t >= lengths[b] - window``, with ``starts`` (B,)
    int32 only ``t >= starts[b]``).  Returns (B, 1, H, d) in q.dtype.

    ``lse``, a (B, H) f32 buffer, makes it one rank's part of attention
    over a sequence split over ranks (``parallel.sequence``): ``lse``
    receives each (seat, head)'s natural-log log-sum-exp of its scaled
    scores (``-inf`` with no key in range) and the output, normalized
    over these keys, is f32 (0 with no key).  The launch counts as
    ``decode_attention[<cache>,lse]`` (``,starts`` where given)."""
    _check(window is None or window >= 1,
           f"decode_attention: window {window} < 1")
    _check(window is None or starts is None,
           "decode_attention: a window or starts, not both")
    B, C, H, d = q.shape
    _check(lse is None or (lse.dtype == torch.float32
                           and lse.shape == (B, H) and lse.is_contiguous()
                           and lse.device == q.device),
           f"decode_attention: lse must be a contiguous f32 ({B}, {H}) "
           f"buffer on {q.device}")
    _check(starts is None or (starts.dtype == torch.int32
                              and starts.shape == (B,)
                              and starts.is_contiguous()
                              and starts.device == q.device),
           f"decode_attention: starts must be contiguous int32 ({B},) on "
           f"{q.device}")
    if not use_kernel(impl, q):
        return da.decode_attention_plain(q[:, 0], k, v, lengths, window,
                                         starts=starts, lse=lse)[:, None]
    name = "decode_attention"
    _, T, KVH, dk = k.shape
    _check(C == 1, f"{name}: one query token per seat, got C={C}")
    _check(dk == d and v.shape == k.shape and k.shape[0] == B,
           f"{name}: cache {tuple(k.shape)}/{tuple(v.shape)} does not match "
           f"q {tuple(q.shape)}")
    _check(q.dtype in da.Q_CODES, f"{name}: q dtype {q.dtype} not f32/bf16")
    _check(k.dtype in (torch.float32, torch.bfloat16) and v.dtype == k.dtype,
           f"{name}: cache dtype {k.dtype}/{v.dtype} not f32/bf16")
    _check(H % KVH == 0 and H // KVH <= da.MAX_GROUP,
           f"{name}: H={H}, KVH={KVH}: needs H % KVH == 0 and "
           f"H / KVH <= {da.MAX_GROUP}")
    _check(d <= da.MAX_HEAD_DIM, f"{name}: head dim {d} > {da.MAX_HEAD_DIM}")
    _check(lengths.dtype == torch.int32 and lengths.shape == (B,),
           f"{name}: lengths must be int32 ({B},), got {lengths.dtype} "
           f"{tuple(lengths.shape)}")
    tensors = [q, k, v, lengths]
    _check(all(t.device == q.device for t in tensors),
           f"{name}: tensors on {sorted({str(t.device) for t in tensors})}")
    _check(q.is_contiguous() and lengths.is_contiguous(),
           f"{name}: q and lengths must be contiguous")
    _check(k.stride(3) == 1 and k.stride() == v.stride(),
           f"{name}: the cache needs unit stride in d and equal K/V strides")
    _check(da.one_load_per_lane(k) and da.one_load_per_lane(v),
           f"{name}: head dim {d}, cache strides {k.stride()} and "
           f"addresses must allow {da.lane_elems(d)} elements per load")
    out = torch.empty(q.shape, device=q.device,
                      dtype=q.dtype if lse is None else torch.float32)
    split = {key: t for key, t in (("starts", starts), ("lse", lse))
             if t is not None}
    with torch.cuda.device(q.device):
        da.decode_attention_cuda(q[:, 0], k, v, lengths, out[:, 0],
                                 window=window, **split)
    tags = "".join(f",{key}" for key in ("lse", "starts") if key in split)
    launches[f"{name}[{_POOL_TAGS[k.dtype]}{_window_tag(window)}{tags}]"] += 1
    return out


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    impl: str = "auto") -> torch.Tensor:
    """Full-sequence attention, the query and key positions both counted
    from 0: query i keeps keys j <= i when ``causal`` and j > i - window
    when ``window`` is set.

    q: (B, Sq, H, d); k/v: (B, Skv, KVH, d) (GQA: query head h reads kv
    head h // (H / KVH)).  Returns (B, Sq, H, d) in q.dtype.  The launch
    is counted as ``flash_attention[window]`` when a window is set, else
    ``[causal]`` or ``[full]``, whichever route ``flash_attention.route``
    takes (bf16 at d 32/64/96/128/256 on the tensor cores, the rest on
    the CUDA cores)."""
    if not use_kernel(impl, q):
        return fa.flash_attention_plain(q, k, v, causal=causal,
                                        window=window)
    name = "flash_attention"
    B, Sq, H, d = q.shape
    _, Skv, KVH, dk = k.shape
    _check(dk == d and v.shape == k.shape and k.shape[0] == B,
           f"{name}: k/v {tuple(k.shape)}/{tuple(v.shape)} do not match "
           f"q {tuple(q.shape)}")
    _check(q.dtype in fa.CODES and k.dtype == q.dtype and v.dtype == q.dtype,
           f"{name}: q/k/v dtypes {q.dtype}/{k.dtype}/{v.dtype}; needs one "
           "of f32/bf16 for all three")
    _check(KVH > 0 and H % KVH == 0, f"{name}: H={H} not a multiple of "
           f"KVH={KVH}")
    _check(d <= fa.MAX_HEAD_DIM, f"{name}: head dim {d} > {fa.MAX_HEAD_DIM}")
    _check(Skv > 0, f"{name}: no keys")
    _check(window is None or window >= 1, f"{name}: window {window} < 1")
    _check(k.device == q.device and v.device == q.device,
           f"{name}: q/k/v on {q.device}/{k.device}/{v.device}")
    _check(q.stride(3) == 1 and k.stride(3) == 1
           and k.stride() == v.stride(),
           f"{name}: needs unit stride in d and equal K/V strides")
    if fa.route(q.dtype, d) == "tensor cores":
        problem = fa.tma_problem(q, k, v)
        _check(problem is None, f"{name}: the tensor-core route (bf16, d "
               f"{d}) reads through TMA, but {problem}")
    out = torch.empty((B, Sq, H, d), dtype=q.dtype, device=q.device)
    if Sq:
        with torch.cuda.device(q.device):
            fa.flash_attention_cuda(q, k, v, out, causal=causal,
                                    window=window)
        tag = ("window" if window is not None
               else "causal" if causal else "full")
        launches[f"{name}[{tag}]"] += 1
    return out


def scaled_fp8_matmul(a_q: torch.Tensor, b_q: torch.Tensor,
                      a_scale: torch.Tensor, b_scale: torch.Tensor, *,
                      bm: int = 128, bn: int = 128, bk: int = 128,
                      impl: str = "auto") -> torch.Tensor:
    """The fp8 GEMM on quantized operands (the counterpart of
    ``fp8_matmul_pallas``): a_q (M, K) @ b_q (K, N), both
    ``torch.float8_e4m3fn``, with a_scale (M/bm,) and b_scale (N/bn,) f32;
    returns (M, N) f32 ``acc · (a_scale[i/bm] · b_scale[j/bn])``.  On
    CUDA the operands may have any layout: ``fp8_matmul.kernel_operands``
    copies them K-major where they are not (a column-major b_q already
    is).

    Raises:
      ValueError: a ragged dimension or a contraction mismatch (the TPU
          kernel's contract, ``fp8_matmul.check_shapes``), or, on CUDA,
          a dtype, scale shape, device or layout the kernel does not take."""
    if not use_kernel(impl, a_q):
        return fm.fp8_matmul_plain(a_q, b_q, a_scale, b_scale, bm=bm, bn=bn,
                                   bk=bk)
    fm.check_shapes(a_q, b_q, bm, bn, bk)
    name = "fp8_matmul"
    m, n = a_q.shape[0], b_q.shape[1]
    _check(a_q.dtype == F8 and b_q.dtype == F8,
           f"{name}: operands {a_q.dtype}/{b_q.dtype}, needs {F8}")
    _check(a_scale.dtype == torch.float32 and b_scale.dtype == torch.float32
           and a_scale.shape == (m // bm,) and b_scale.shape == (n // bn,),
           f"{name}: scales must be f32 ({m // bm},) and ({n // bn},), got "
           f"{a_scale.dtype} {tuple(a_scale.shape)} and {b_scale.dtype} "
           f"{tuple(b_scale.shape)}")
    tensors = [a_q, b_q, a_scale, b_scale]
    _check(all(t.device == a_q.device for t in tensors),
           f"{name}: tensors on {sorted({str(t.device) for t in tensors})}")
    _check(a_scale.is_contiguous() and b_scale.is_contiguous(),
           f"{name}: the scales must be contiguous")
    _check(max(m, n, a_q.shape[1]) < 2 ** 31,
           f"{name}: a dimension of {tuple(a_q.shape)}/{tuple(b_q.shape)} "
           "does not fit the kernel's int")
    out = torch.empty((m, n), dtype=torch.float32, device=a_q.device)
    with torch.cuda.device(a_q.device):
        fm.fp8_matmul_cuda(a_q, b_q, a_scale, b_scale, out, bm=bm, bn=bn)
    launches[f"{name}[e4m3]"] += 1
    return out


def _pad_to(x: torch.Tensor, mult: int, axis: int):
    pad = (-x.shape[axis]) % mult
    if pad == 0:
        return x, 0
    widths = [0, 0] * x.dim()
    widths[2 * (x.dim() - 1 - axis) + 1] = pad
    return torch.nn.functional.pad(x, widths), pad


def quantize_blocks(a: torch.Tensor, b: torch.Tensor, *, bm: int = 128,
                    bn: int = 128, bk: int = 128):
    """The per-block quantization of the JAX ``ops.fp8_matmul``: pads
    ``a`` (M, K) and ``b`` (K, N) with zeros to block multiples, takes one
    scale per bm-row block of ``a`` and per bn-column block of ``b``
    (amax / 448) and casts to e4m3.  Returns ``(a_q, b_q, a_scale,
    b_scale)`` with f32 scales, bit-identical to the JAX wrapper's."""
    a, _ = _pad_to(a, bm, 0)
    a, _ = _pad_to(a, bk, 1)
    b, _ = _pad_to(b, bk, 0)
    b, _ = _pad_to(b, bn, 1)
    m, k = a.shape
    n = b.shape[1]
    am = a.reshape(m // bm, bm, k).abs().amax(dim=(1, 2))
    bmax = b.reshape(k, n // bn, bn).abs().amax(dim=(0, 2))
    sa = am.clamp_min(1e-12) / F8_MAX
    sb = bmax.clamp_min(1e-12) / F8_MAX
    a_q = (a / sa.repeat_interleave(bm)[:, None]).to(F8).contiguous()
    b_q = (b / sb.repeat_interleave(bn)[None, :]).to(F8).contiguous()
    return a_q, b_q, sa.float(), sb.float()


def fp8_matmul(a: torch.Tensor, b: torch.Tensor, *, bm: int = 128,
               bn: int = 128, bk: int = 128,
               impl: str = "auto") -> torch.Tensor:
    """f32/bf16 (M, K) @ (K, N) through the fp8 GEMM with one scale per
    bm-row block of ``a`` and per bn-column block of ``b``, as the JAX
    ``ops.fp8_matmul`` does: pads, quantizes (``quantize_blocks``),
    multiplies and crops.  Returns (M, N) f32."""
    a_q, b_q, sa, sb = quantize_blocks(a, b, bm=bm, bn=bn, bk=bk)
    out = scaled_fp8_matmul(a_q, b_q, sa, sb, bm=bm, bn=bn, bk=bk,
                            impl=impl)
    return out[:a.shape[0], :b.shape[1]]
