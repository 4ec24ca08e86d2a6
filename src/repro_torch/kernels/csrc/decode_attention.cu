// Dense single-query decode attention for Hopper (sm_90a): the fixed-slot
// engine's decode over a (B, T, KVH, d) cache.
//
// Replaces the Pallas TPU kernel of the JAX package
//   repro/kernels/decode_attention.py :: decode_attention_pallas
// for bf16 and f32 caches.  The TPU wrapper (repro/kernels/ops.py ::
// decode_attention) repeated every kv head G times into a (B·H, T, d)
// copy and padded T to the key tile; this kernel reads the cache where it
// lies, through its strides, one block per (kv head, seat, split) for all
// G query heads, so each valid key and value is read once and nothing is
// copied or padded.
//
// Bound: memory — the K+V bytes of the valid lengths over 3.35 TB/s.  The
// token loop stops at lengths[b].  An idle fixed-slot seat parks its
// write position on the scratch index max_len, so its length is
// T = max_len + 1 and it walks its whole cache for a row the engine
// throws away; that is the reference's mask, kept as it is, and split-K
// spreads that walk over the seat's splits.
//
// The loop, the online softmax, the warp merge and the split-K merge are
// shared with the paged kernel (decode_attention.cuh); the cache width T,
// known on the host, sets the split plan (kernels/decode_attention.py ::
// split_plan): one block per (seat, kv head) left 64 blocks on 132 SMs at
// the serving shape and the longest seat walking its whole cache alone.

#include "decode_attention.cuh"

namespace {

using repro_decode::launch;

struct DenseAddr {
  long long kv_seat, kv_tok, kv_head;   // cache strides, in elements

  __device__ __forceinline__ void locate(int a, int t, int kvh,
                                         long long& kv,
                                         long long& sc) const {
    kv = a * kv_seat + static_cast<long long>(t) * kv_tok + kvh * kv_head;
    sc = 0;
  }

  bool strides_divisible_by(int e) const {
    return kv_seat % e == 0 && kv_tok % e == 0 && kv_head % e == 0;
  }
};

template <typename QT>
cudaError_t dispatch_kv(int kv_dtype, const void* q, const void* k,
                        const void* v, const void* lengths, void* out,
                        int B, int H, int KVH, int d, const DenseAddr& addr,
                        float* part, int* tickets, int splits, int chunk,
                        int window, const int* starts, float* out32,
                        float* lse, cudaStream_t stream) {
#define REPRO_KV(KT_)                                                        \
  return launch<QT, KT_, DenseAddr>(q, k, v, nullptr, nullptr, lengths,     \
                                    out, B, H, KVH, d, addr, part, tickets, \
                                    splits, chunk, window, starts, out32,   \
                                    lse, stream)
  switch (kv_dtype) {
    case 0: REPRO_KV(float);
    case 1: REPRO_KV(__nv_bfloat16);
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_KV
}

}  // namespace

// Plain C entry point, bound with ctypes.  Codes: 0 = f32, 1 = bf16 for
// q (and out) and for the cache.  q and out are (B, H, d) contiguous;
// k/v are (B, T, KVH, d) with unit stride in d and the given strides
// (in elements); lengths (B,) int32.  Split-K: `splits` blocks of
// `chunk` tokens per (seat, kv head), partial states in `part`
// (B·KVH·splits·(H/KVH)·(d + 2) f32) and one ticket per (seat, kv head)
// in `tickets` (B·KVH int32, zero before the launch and after it;
// launches that share them must not overlap).  window > 0 keeps only each
// slot's last `window` keys (a sliding-window layer), 0 all of them;
// `starts` (B,) int32, where not null, keeps keys t >= starts[b] instead
// (a rank's slice of a split cache).  `lse` (B, H) f32 and `out32`
// (B, H, d) f32, both null or both given: with them the output is written
// to out32 in f32 (out is not written) and each (slot, head)'s natural-log
// log-sum-exp of its scaled scores to lse (-inf, and an output of 0, for
// a slot with no key in range).  d,
// the strides and the k/v addresses must allow one load per lane
// (decode_attention.cuh :: launch_e).  Returns the launch's
// cudaGetLastError() (0 = success), or cudaErrorInvalidValue for a
// combination the kernel does not take.
extern "C" int decode_attention(int q_dtype, int kv_dtype, const void* q,
                                const void* k, const void* v,
                                const void* lengths, void* out, int B, int H,
                                int KVH, int d, long long kv_seat,
                                long long kv_tok, long long kv_head,
                                void* part, void* tickets, int splits,
                                int chunk, int window, const void* starts,
                                void* lse, void* out32, void* stream) {
  const DenseAddr addr{kv_seat, kv_tok, kv_head};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  int* t = static_cast<int*>(tickets);
  const int* st = static_cast<const int*>(starts);
  float* o32 = static_cast<float*>(out32);
  float* ls = static_cast<float*>(lse);
  cudaError_t err;
  if (q_dtype == 0) {
    err = dispatch_kv<float>(kv_dtype, q, k, v, lengths, out, B, H, KVH, d,
                             addr, p, t, splits, chunk, window, st, o32, ls,
                             s);
  } else if (q_dtype == 1) {
    err = dispatch_kv<__nv_bfloat16>(kv_dtype, q, k, v, lengths, out, B, H,
                                     KVH, d, addr, p, t, splits, chunk,
                                     window, st, o32, ls, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
