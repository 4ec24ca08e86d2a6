"""Decode attention: the Hopper CUDA kernels and their plain versions.

Paged (K1/K2): ``paged_decode_attention_cuda`` launches
``csrc/paged_decode_attention.cu``, which replaces ``repro/kernels/
decode_attention.py :: paged_decode_attention_pallas`` (bf16/f32 pools)
and ``quantized_paged_decode_attention_pallas`` (fp8/int8 pools with
per-(token, head) scales).  ``paged_decode_attention_plain`` is the JAX
wrapper's GQA expansion on the page table (``repro/kernels/ops.py ::
paged_decode_attention``) followed by the oracles of ``kernels/ref.py``.
Layout: q ``(A, H, d)``, one layer's pools ``(P, page, KVH, d)``, scales
``(P, page, KVH)`` (quantized pools only), ``page_table (A, n)`` int32 and
``lengths (A,)`` int32.

Dense (K4): ``decode_attention_cuda`` launches ``csrc/decode_attention.cu``,
which replaces ``decode_attention_pallas`` for the fixed-slot engine's
``(B, T, KVH, d)`` cache.  ``decode_attention_plain`` is the JAX wrapper's
GQA repeat (``repro/kernels/ops.py :: decode_attention``) followed by
``ref.decode_attention_ref``.  Layout: q ``(B, H, d)``, k/v
``(B, T, KVH, d)``, ``lengths (B,)`` int32.

Both kernels take an optional sliding window W: a seat keeps only its
last W tokens (``t >= lengths - W``), the mask of the JAX model's local
layers, which it computes with jnp on every backend.  The dense kernel
also serves one rank's slice of a cache whose sequence is split over
ranks (``parallel.sequence``): ``starts`` (B,) int32 keeps keys ``t >=
starts[b]`` in place of the window, and ``lse`` (B, H) f32 receives each
(seat, head)'s natural-log log-sum-exp of its scaled scores, the output
then normalized over the slice's keys in f32, for the ranks' merge.

Both kernels share one per-token loop (``csrc/decode_attention.cuh``) and
are bound by memory: they read each valid token's K and V once.  Both
split each seat's sequence over ``split_plan``'s blocks and merge their
partial softmax states in the same launch (split-K), with per-call
scratch and one per-device ticket buffer that the two kernels share.
The plain versions serve CPU tensors and the checks on the card; nothing
on the serving path calls them for CUDA tensors.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build, ref

#: Storage-type codes of the C entry point.
Q_CODES = {torch.float32: 0, torch.bfloat16: 1}
KV_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.uint8: 2,
            torch.int8: 3}
MAX_GROUP = 8          # query heads per kv head one block serves
MAX_HEAD_DIM = 256
#: Split-K plan of both kernels: blocks per SM aimed at, the token step
#: of one block's loop (8 warps x 4 tokens: a chunk is a multiple of it)
#: and the least chunk worth a block.
BLOCKS_PER_SM = 4
SPLIT_ALIGN = 32
MIN_CHUNK = 64


def lane_elems(d: int) -> int:
    """E, the head-dim elements one lane of the decode kernels holds and
    reads as one load (``csrc/decode_attention.cuh``)."""
    return 1 if d <= 32 else 2 if d <= 64 else 4 if d <= 128 else 8


def one_load_per_lane(kv: torch.Tensor) -> bool:
    """Whether the kernels can read a K or V tensor ``(..., d)`` (unit
    stride in d) as they do, each lane's E elements of a row in one load:
    d and every other stride a multiple of E, and the first element
    aligned to the load's word (E elements, at most 16 bytes)."""
    e = lane_elems(kv.shape[-1])
    word = min(16, e * kv.element_size())
    return (kv.shape[-1] % e == 0
            and all(s % e == 0 for s in kv.stride()[:-1])
            and kv.data_ptr() % word == 0)


def split_plan(seats: int, kv_heads: int, width: int,
               sms: int) -> Tuple[int, int]:
    """``(splits, chunk)`` of the decode kernels' split-K: block ``s`` of
    a (seat, kv head) walks tokens ``[s·chunk, (s+1)·chunk)`` cut at the
    seat's length.  From host-known shapes only (seats, kv heads, the page
    table's or the dense cache's width in tokens and the card's SM
    count), never the lengths,
    which live on the card: ``BLOCKS_PER_SM`` blocks per SM if every seat
    filled its table, chunks a multiple of ``SPLIT_ALIGN`` and at least
    ``MIN_CHUNK`` tokens."""
    per_row = -(-BLOCKS_PER_SM * sms // max(1, seats * kv_heads))
    chunk = -(-max(1, width) // per_row)
    chunk = max(MIN_CHUNK, -(-chunk // SPLIT_ALIGN) * SPLIT_ALIGN)
    return max(1, -(-width // chunk)), chunk


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


#: One zeroed int32 ticket per (seat, kv head), per device, shared by the
#: paged and the dense kernel: the last split of each pair resets its
#: ticket, so it stays zero between launches.  Launches on one stream, as
#: the port makes them, never use them at the same time; launches on two
#: streams at once would.
_tickets: Dict[torch.device, torch.Tensor] = {}


def reserve_tickets(device: torch.device, n: int) -> torch.Tensor:
    """The device's ticket buffer, grown to at least ``n`` tickets.  A
    caller that captures the decode kernels in a CUDA graph reserves its
    largest ``seats × kv heads`` first and keeps the returned buffer: the
    graph holds its address, and a later growth for a wider caller
    replaces only the eager launches' buffer.

    Raises:
      RuntimeError: the buffer would grow during a stream capture, where
          it would live in the graph's private memory."""
    if device.index is None:              # the key of "cuda" is "cuda:i"
        device = torch.device(device.type, torch.cuda.current_device())
    buf = _tickets.get(device)
    if buf is None or buf.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"the decode kernels' ticket buffer on {device} holds "
                f"{0 if buf is None else buf.numel()} tickets and would "
                f"grow to {n} during a CUDA graph capture; call "
                "reserve_tickets before capturing")
        buf = torch.zeros(max(n, 256), dtype=torch.int32, device=device)
        _tickets[device] = buf
    return buf


def paged_decode_attention_plain(q, k_pages, v_pages, page_table, lengths,
                                 k_scale: Optional[torch.Tensor] = None,
                                 v_scale: Optional[torch.Tensor] = None,
                                 window: Optional[int] = None):
    """Plain version: expand GQA on the page table (head h of seat a reads
    pages ``kvh(h) * P + page_table[a]`` of the pool flattened to
    ``(KVH*P, page, d)``), then the dense oracle, keeping each seat's
    last ``window`` tokens when a window is given.  Returns (A, H, d)."""
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
                                                       pt, lens, window)
    else:
        out = ref.paged_decode_attention_ref(qf, kf, vf, pt, lens, window)
    return out.reshape(A, H, d)


def _split_scratch(q: torch.Tensor, kv_heads: int, width: int):
    """``(splits, chunk, part, tickets)`` of one split-K launch: the
    plan for ``width`` tokens, the partial states' scratch (allocated
    here, per call) and the per-device tickets."""
    A, H, d = q.shape
    splits, chunk = split_plan(A, kv_heads, width, _sm_count(q.device.index))
    part = torch.empty(A * kv_heads * splits * (H // kv_heads) * (d + 2),
                       dtype=torch.float32, device=q.device)
    return splits, chunk, part, reserve_tickets(q.device, A * kv_heads)


def paged_decode_attention_cuda(q, k_pages, v_pages, page_table, lengths,
                                k_scale: Optional[torch.Tensor],
                                v_scale: Optional[torch.Tensor],
                                out: torch.Tensor,
                                window: Optional[int] = None) -> None:
    """Launch the kernel on the current stream, writing ``out`` (A, H, d),
    split over the sequence as ``split_plan`` says (the whole table's
    width, a window or not), with the partial states in scratch allocated
    here and the per-device tickets; ``window`` keeps each seat's last
    ``window`` tokens.  The caller (``kernels.ops``) has checked devices,
    dtypes, shapes, strides and ``one_load_per_lane``.

    Raises:
      RuntimeError: the launch was refused (the CUDA error code)."""
    A, H, d = q.shape
    _, page, KVH, _ = k_pages.shape
    n_table = page_table.shape[1]
    quantized = k_scale is not None
    sc = k_scale.stride() if quantized else (0, 0, 0)
    splits, chunk, part, tickets = _split_scratch(q, KVH, n_table * page)
    lib = _build.library("paged_decode_attention")
    err = lib.paged_decode_attention(
        Q_CODES[q.dtype], KV_CODES[k_pages.dtype], q.data_ptr(),
        k_pages.data_ptr(), v_pages.data_ptr(),
        k_scale.data_ptr() if quantized else None,
        v_scale.data_ptr() if quantized else None,
        page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        A, H, KVH, d, page, n_table,
        k_pages.stride(0), k_pages.stride(1), k_pages.stride(2),
        sc[0], sc[1], sc[2], part.data_ptr(), tickets.data_ptr(), splits,
        chunk, window or 0, torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_decode_attention kernel launch failed: "
                           f"CUDA error {err}")


def decode_attention_plain(q, k, v, lengths, window: Optional[int] = None,
                           starts: Optional[torch.Tensor] = None,
                           lse: Optional[torch.Tensor] = None):
    """Plain version: repeat each kv head G times, flatten to
    ``(B·H, T, d)``, then the dense oracle, keeping each slot's last
    ``window`` keys when a window is given, or its keys from
    ``starts[b]`` on.  Returns (B, H, d); with ``lse`` (a (B, H) f32
    buffer, filled with each (slot, head)'s log-sum-exp) the output in
    f32 (``ref.decode_attention_lse_ref``).  (The TPU wrapper also pads T
    to its key tile; the oracle masks by length, so the padding changes
    nothing and is left out.)"""
    B, H, d = q.shape
    T, KVH = k.shape[1], k.shape[2]
    rep = H // KVH
    kf = k.repeat_interleave(rep, dim=2).transpose(1, 2).reshape(B * H, T, d)
    vf = v.repeat_interleave(rep, dim=2).transpose(1, 2).reshape(B * H, T, d)
    lens = lengths.repeat_interleave(H)
    sts = None if starts is None else starts.repeat_interleave(H)
    if lse is not None:
        out, s = ref.decode_attention_lse_ref(q.reshape(B * H, d), kf, vf,
                                              lens, sts)
        lse.copy_(s.reshape(B, H))
        return out.reshape(B, H, d)
    out = ref.decode_attention_ref(q.reshape(B * H, d), kf, vf, lens, window,
                                   starts=sts)
    return out.reshape(B, H, d)


def decode_attention_cuda(q, k, v, lengths, out: torch.Tensor,
                          window: Optional[int] = None,
                          starts: Optional[torch.Tensor] = None,
                          lse: Optional[torch.Tensor] = None) -> None:
    """Launch the dense kernel on the current stream, writing ``out``
    (B, H, d), split over the sequence as ``split_plan`` says for the
    cache width T (known here, so the lengths stay on the card), with
    the partial states in scratch allocated here and the per-device
    tickets it shares with the paged kernel (safe on one stream: see
    ``_tickets``); ``window`` keeps each slot's last ``window`` keys,
    ``starts`` (B,) int32 its keys from ``starts[b]`` on instead; with
    ``lse`` (B, H) f32, ``out`` is f32 and ``lse`` receives each (slot,
    head)'s log-sum-exp.
    The caller (``kernels.ops``) has checked devices, dtypes, shapes,
    strides and ``one_load_per_lane``.

    Raises:
      RuntimeError: the launch was refused (the CUDA error code)."""
    B, H, d = q.shape
    T, KVH = k.shape[1], k.shape[2]
    splits, chunk, part, tickets = _split_scratch(q, KVH, T)
    lib = _build.library("decode_attention")
    err = lib.decode_attention(
        Q_CODES[q.dtype], KV_CODES[k.dtype], q.data_ptr(), k.data_ptr(),
        v.data_ptr(), lengths.data_ptr(),
        None if lse is not None else out.data_ptr(), B, H, KVH, d,
        k.stride(0), k.stride(1), k.stride(2), part.data_ptr(),
        tickets.data_ptr(), splits, chunk, window or 0,
        None if starts is None else starts.data_ptr(),
        None if lse is None else lse.data_ptr(),
        None if lse is None else out.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: "
                           f"CUDA error {err}")
