// Paged single-query decode attention for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of the JAX package:
//   repro/kernels/decode_attention.py :: paged_decode_attention_pallas
//   repro/kernels/decode_attention.py :: quantized_paged_decode_attention_pallas
// with one source templated on the KV storage type (f32, bf16, fp8 e4m3
// stored as uint8 bit patterns, int8; quantized pools carry one f32 scale
// per stored (token, head) vector).
//
// What it computes, per seat a and query head h (kv head h / G):
//   out[a, h] = softmax_t(q[a, h] . k_t * d^-0.5) . v_t   over t < lengths[a]
// where token t lives in physical page page_table[a, t / page] at slot
// t % page, an f32 online softmax (m, l, acc) as in the Pallas kernels,
// and out = acc / max(l, 1e-30) in q's dtype.
//
// Bound: memory.  Each valid token's K and V vectors are read once; the
// arithmetic is 4·d flops per (token, query head), far below the card's
// rate, so the least time is the K+V bytes of the valid lengths over
// 3.35 TB/s.
//
// Design (simple and right first):
//   * one block per (kv head, seat) serves all G = H/KVH query heads of
//     the group, so each page is read once (the TPU wrapper expanded GQA
//     on the page table and re-streamed every page G times);
//   * the token loop is bounded by the seat's length, not by the width of
//     the page table: dead pages are never touched;
//   * each warp takes a slice of kUnroll consecutive tokens per step, with
//     all their K and V loads issued before the arithmetic so several
//     loads are in flight per warp; a lane holds E consecutive elements of
//     the head dimension, and the dot product is a warp shuffle reduction;
//   * each warp keeps its own (m, l, acc) per query head; the warps merge
//     in shared memory at the end.
// Split-K over the sequence, TMA and wgmma are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kUnroll = 4;
constexpr int kMaxG = 8;
constexpr float kNegInf = -1e30f;

template <typename T>
__device__ __forceinline__ float to_f32(T x);

template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }

template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// uint8 pools hold e4m3 bit patterns
template <>
__device__ __forceinline__ float to_f32<uint8_t>(uint8_t x) {
  __half_raw h = __nv_cvt_fp8_to_halfraw(
      static_cast<__nv_fp8_storage_t>(x), __NV_E4M3);
  return __half2float(__half(h));
}

template <>
__device__ __forceinline__ float to_f32<int8_t>(int8_t x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);

template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }

template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, off);
  }
  return x;
}

// E: elements of the head dimension held by one lane (d <= 32 * E).
template <typename QT, typename KT, int E>
__global__ void __launch_bounds__(kWarps * 32)
paged_decode_kernel(const QT* __restrict__ q, const KT* __restrict__ k,
                    const KT* __restrict__ v, const float* __restrict__ ks,
                    const float* __restrict__ vs,
                    const int* __restrict__ page_table,
                    const int* __restrict__ lengths, QT* __restrict__ out,
                    int H, int KVH, int d, int page_size, int n_table,
                    long long pool_page, long long pool_tok,
                    long long pool_head, long long sc_page, long long sc_tok,
                    long long sc_head, float scale) {
  const int kvh = blockIdx.x;
  const int a = blockIdx.y;
  const int G = H / KVH;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int length = lengths[a];
  const int* pt = page_table + static_cast<long long>(a) * n_table;
  const bool quantized = ks != nullptr;

  // q of the group's heads, pre-scaled by d^-0.5
  float qr[kMaxG][E];
  float m[kMaxG], l[kMaxG], acc[kMaxG][E];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int idx = lane * E + e;
      acc[g][e] = 0.f;
      qr[g][e] = (g < G && idx < d)
          ? to_f32(q[(static_cast<long long>(a) * H + kvh * G + g) * d + idx])
                * scale
          : 0.f;
    }
  }

  for (int t0 = warp * kUnroll; t0 < length; t0 += kWarps * kUnroll) {
    float kf[kUnroll][E], vf[kUnroll][E];
    bool live[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u;
      live[u] = t < length;
      float ksc = 1.f, vsc = 1.f;
      long long base = 0;
      if (live[u]) {
        const long long page = pt[t / page_size];
        const long long slot = t % page_size;
        base = page * pool_page + slot * pool_tok + kvh * pool_head;
        if (quantized) {
          const long long s = page * sc_page + slot * sc_tok + kvh * sc_head;
          ksc = ks[s];
          vsc = vs[s];
        }
      }
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int idx = lane * E + e;
        const bool ok = live[u] && idx < d;
        kf[u][e] = ok ? to_f32(k[base + idx]) * ksc : 0.f;
        vf[u][e] = ok ? to_f32(v[base + idx]) * vsc : 0.f;
      }
    }
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < G) {
        float s[kUnroll];
        float mx = m[g];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          float part = 0.f;
#pragma unroll
          for (int e = 0; e < E; ++e) part += qr[g][e] * kf[u][e];
          part = warp_sum(part);
          s[u] = live[u] ? part : kNegInf;
          mx = fmaxf(mx, s[u]);
        }
        const float alpha = expf(m[g] - mx);
        l[g] *= alpha;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] *= alpha;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const float p = expf(s[u] - mx);
          l[g] += p;
#pragma unroll
          for (int e = 0; e < E; ++e) acc[g][e] += p * vf[u][e];
        }
        m[g] = mx;
      }
    }
  }

  // merge the warps' partial softmax states in shared memory
  extern __shared__ float smem[];
  const int dp = 32 * E;
  float* sm_m = smem;                       // [kWarps][G]
  float* sm_l = sm_m + kWarps * G;          // [kWarps][G]
  float* sm_acc = sm_l + kWarps * G;        // [kWarps][G][dp]
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g < G) {
      if (lane == 0) {
        sm_m[warp * G + g] = m[g];
        sm_l[warp * G + g] = l[g];
      }
#pragma unroll
      for (int e = 0; e < E; ++e) {
        sm_acc[(warp * G + g) * dp + lane * E + e] = acc[g][e];
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * d; i += blockDim.x) {
    const int g = i / d;
    const int idx = i % d;
    float mx = kNegInf;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w * G + g]);
    float lsum = 0.f, o = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(sm_m[w * G + g] - mx);
      lsum += sm_l[w * G + g] * c;
      o += sm_acc[(w * G + g) * dp + idx] * c;
    }
    out[(static_cast<long long>(a) * H + kvh * G + g) * d + idx] =
        from_f32<QT>(o / fmaxf(lsum, 1e-30f));
  }
}

template <typename QT, typename KT, int E>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* ks, const void* vs, const void* page_table,
                   const void* lengths, void* out, int A, int H, int KVH,
                   int d, int page_size, int n_table, long long pool_page,
                   long long pool_tok, long long pool_head, long long sc_page,
                   long long sc_tok, long long sc_head, cudaStream_t stream) {
  const int G = H / KVH;
  const size_t smem =
      sizeof(float) * static_cast<size_t>(kWarps) * G * (2 + 32 * E);
  auto kernel = paged_decode_kernel<QT, KT, E>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(KVH, A);
  kernel<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k),
      static_cast<const KT*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(page_table),
      static_cast<const int*>(lengths), static_cast<QT*>(out), H, KVH, d,
      page_size, n_table, pool_page, pool_tok, pool_head, sc_page, sc_tok,
      sc_head, 1.0f / sqrtf(static_cast<float>(d)));
  return cudaGetLastError();
}

template <typename QT, typename KT>
cudaError_t dispatch_e(const void* q, const void* k, const void* v,
                       const void* ks, const void* vs, const void* page_table,
                       const void* lengths, void* out, int A, int H, int KVH,
                       int d, int page_size, int n_table, long long pool_page,
                       long long pool_tok, long long pool_head,
                       long long sc_page, long long sc_tok, long long sc_head,
                       cudaStream_t stream) {
#define REPRO_LAUNCH(E_)                                                     \
  return launch<QT, KT, E_>(q, k, v, ks, vs, page_table, lengths, out, A, H, \
                            KVH, d, page_size, n_table, pool_page, pool_tok, \
                            pool_head, sc_page, sc_tok, sc_head, stream)
  if (d <= 32) REPRO_LAUNCH(1);
  if (d <= 64) REPRO_LAUNCH(2);
  if (d <= 128) REPRO_LAUNCH(4);
  if (d <= 256) REPRO_LAUNCH(8);
#undef REPRO_LAUNCH
  return cudaErrorInvalidValue;
}

template <typename QT>
cudaError_t dispatch_kv(int kv_dtype, const void* q, const void* k,
                        const void* v, const void* ks, const void* vs,
                        const void* page_table, const void* lengths,
                        void* out, int A, int H, int KVH, int d,
                        int page_size, int n_table, long long pool_page,
                        long long pool_tok, long long pool_head,
                        long long sc_page, long long sc_tok,
                        long long sc_head, cudaStream_t stream) {
#define REPRO_KV(KT_)                                                        \
  return dispatch_e<QT, KT_>(q, k, v, ks, vs, page_table, lengths, out, A,   \
                             H, KVH, d, page_size, n_table, pool_page,       \
                             pool_tok, pool_head, sc_page, sc_tok, sc_head,  \
                             stream)
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
// elements.  Returns the launch's cudaGetLastError() (0 = success), or
// cudaErrorInvalidValue for a combination the kernel does not take.
extern "C" int paged_decode_attention(
    int q_dtype, int kv_dtype, const void* q, const void* k, const void* v,
    const void* ks, const void* vs, const void* page_table,
    const void* lengths, void* out, int A, int H, int KVH, int d,
    int page_size, int n_table, long long pool_page, long long pool_tok,
    long long pool_head, long long sc_page, long long sc_tok,
    long long sc_head, void* stream) {
  if (KVH <= 0 || H % KVH != 0 || H / KVH > kMaxG || A <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (q_dtype == 0) {
    err = dispatch_kv<float>(kv_dtype, q, k, v, ks, vs, page_table, lengths,
                             out, A, H, KVH, d, page_size, n_table, pool_page,
                             pool_tok, pool_head, sc_page, sc_tok, sc_head, s);
  } else if (q_dtype == 1) {
    err = dispatch_kv<__nv_bfloat16>(kv_dtype, q, k, v, ks, vs, page_table,
                                     lengths, out, A, H, KVH, d, page_size,
                                     n_table, pool_page, pool_tok, pool_head,
                                     sc_page, sc_tok, sc_head, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
