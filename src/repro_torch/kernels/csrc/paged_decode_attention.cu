// Paged single-query decode attention for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of the JAX package:
//   repro/kernels/decode_attention.py :: paged_decode_attention_pallas
//   repro/kernels/decode_attention.py :: quantized_paged_decode_attention_pallas
// with one source templated on the KV storage type (f32, bf16, fp8 e4m3
// stored as uint8 bit patterns, int8; quantized pools carry one f32 scale
// per stored (token, head) vector).
//
// Token t of seat a lives in physical page page_table[a, t / page] at
// slot t % page of the shared pool.  The kernel itself, its bound (the
// K+V bytes of the valid lengths) and its design, split-K over the
// sequence with the merge in the same launch, are in decode_attention.cuh,
// which it shares with the dense fixed-slot kernel.

#include "decode_attention.cuh"

namespace {

using repro_decode::launch;

struct PagedAddr {
  const int* page_table;
  int page_size, n_table;
  long long kv_page, kv_tok, kv_head;   // pool strides, in elements
  long long sc_page, sc_tok, sc_head;   // scale strides (quantized pools)

  __device__ __forceinline__ void locate(int a, int t, int kvh,
                                         long long& kv,
                                         long long& sc) const {
    const long long page =
        page_table[static_cast<long long>(a) * n_table + t / page_size];
    const long long slot = t % page_size;
    kv = page * kv_page + slot * kv_tok + kvh * kv_head;
    sc = page * sc_page + slot * sc_tok + kvh * sc_head;
  }

  bool strides_divisible_by(int e) const {
    return kv_page % e == 0 && kv_tok % e == 0 && kv_head % e == 0;
  }
};

template <typename QT>
cudaError_t dispatch_kv(int kv_dtype, const void* q, const void* k,
                        const void* v, const void* ks, const void* vs,
                        const void* lengths, void* out, int A, int H,
                        int KVH, int d, const PagedAddr& addr,
                        float* part, int* tickets, int splits, int chunk,
                        int window, cudaStream_t stream) {
#define REPRO_KV(KT_)                                                        \
  return launch<QT, KT_, PagedAddr>(q, k, v, ks, vs, lengths, out, A, H,    \
                                    KVH, d, addr, part, tickets, splits,    \
                                    chunk, window, nullptr, nullptr,        \
                                    nullptr, stream)
  switch (kv_dtype) {
    case 0: REPRO_KV(float);
    case 1: REPRO_KV(__nv_bfloat16);
    case 2: REPRO_KV(uint8_t);
    case 3: REPRO_KV(int8_t);
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_KV
}

}  // namespace

// Plain C entry point, bound with ctypes.  Codes: q_dtype 0 = f32,
// 1 = bf16; kv_dtype 0 = f32, 1 = bf16, 2 = fp8 e4m3 bits (uint8),
// 3 = int8.  ks/vs are null for unquantized pools.  Strides are in
// elements.  Split-K: `splits` blocks of `chunk` tokens per (seat, kv
// head), partial states in `part` (A·KVH·splits·(H/KVH)·(d + 2) f32) and
// one ticket per (seat, kv head) in `tickets` (A·KVH int32, zero before
// the launch and after it; launches that share them must not overlap).
// window > 0 keeps only each seat's last `window` tokens (a sliding-window
// layer), 0 all of them.  d, the strides and the k/v addresses must allow
// one load per lane (decode_attention.cuh :: launch_e).
// Returns the launch's cudaGetLastError() (0 = success), or
// cudaErrorInvalidValue for a combination the kernel does not take.
extern "C" int paged_decode_attention(
    int q_dtype, int kv_dtype, const void* q, const void* k, const void* v,
    const void* ks, const void* vs, const void* page_table,
    const void* lengths, void* out, int A, int H, int KVH, int d,
    int page_size, int n_table, long long pool_page, long long pool_tok,
    long long pool_head, long long sc_page, long long sc_tok,
    long long sc_head, void* part, void* tickets, int splits, int chunk,
    int window, void* stream) {
  const PagedAddr addr{static_cast<const int*>(page_table), page_size,
                       n_table, pool_page, pool_tok, pool_head,
                       sc_page, sc_tok, sc_head};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (q_dtype == 0) {
    err = dispatch_kv<float>(kv_dtype, q, k, v, ks, vs, lengths, out, A, H,
                             KVH, d, addr, static_cast<float*>(part),
                             static_cast<int*>(tickets), splits, chunk,
                             window, s);
  } else if (q_dtype == 1) {
    err = dispatch_kv<__nv_bfloat16>(kv_dtype, q, k, v, ks, vs, lengths,
                                     out, A, H, KVH, d, addr,
                                     static_cast<float*>(part),
                                     static_cast<int*>(tickets), splits,
                                     chunk, window, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
