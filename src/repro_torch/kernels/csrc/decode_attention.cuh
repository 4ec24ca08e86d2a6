// Single-query decode attention for Hopper (sm_90a): the per-token loop
// shared by the paged kernel (paged_decode_attention.cu, K1/K2) and the
// dense fixed-slot kernel (decode_attention.cu, K4).
//
// What it computes, per seat a and query head h (kv head h / G):
//   out[a, h] = softmax_t(q[a, h] . k_t * d^-0.5) . v_t   over t < lengths[a]
// with an f32 online softmax (m, l, acc) as in the Pallas kernels, and
// out = acc / max(l, 1e-30) in q's dtype.  Where token t of seat a lives
// is the one thing the two layouts disagree on; an address policy
// (`Addr::locate`) answers it:
//   * PagedAddr (paged_decode_attention.cu): physical page
//     page_table[a, t / page] at slot t % page of a shared pool, plus the
//     index of its f32 scale for quantized pools;
//   * DenseAddr (decode_attention.cu): row t of seat a's own (T, KVH, d)
//     cache, through the strides.
//
// Bound: memory.  Each valid token's K and V vectors are read once; the
// arithmetic is 4·d flops per (token, query head), far below the card's
// rate, so the least time is the K+V bytes of the valid lengths over
// 3.35 TB/s.
//
// Design (simple and right first):
//   * one block per (kv head, seat) serves all G = H/KVH query heads of
//     the group, so each K/V vector is read once (the TPU wrappers
//     expanded GQA and re-streamed every vector G times);
//   * the token loop is bounded by the seat's length, never by the width
//     of the cache or page table: dead tokens are never touched;
//   * each warp takes a slice of kUnroll consecutive tokens per step, with
//     all their K and V loads started before the arithmetic so several
//     loads are in flight per warp; a lane holds E consecutive elements of
//     the head dimension, and the dot product is a warp shuffle reduction;
//   * each warp keeps its own (m, l, acc) per query head; the warps merge
//     in shared memory at the end.
// Split-K over the sequence, TMA and wgmma are later work.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <stdint.h>

namespace repro_decode {

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
// ks/vs are null for unquantized storage.  q and out are (A, H, d)
// contiguous.
template <typename QT, typename KT, int E, typename Addr>
__global__ void __launch_bounds__(kWarps * 32)
decode_kernel(const QT* __restrict__ q, const KT* __restrict__ k,
              const KT* __restrict__ v, const float* __restrict__ ks,
              const float* __restrict__ vs, const int* __restrict__ lengths,
              QT* __restrict__ out, int H, int KVH, int d, Addr addr,
              float scale) {
  const int kvh = blockIdx.x;
  const int a = blockIdx.y;
  const int G = H / KVH;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int length = lengths[a];
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
      long long base = 0, sbase = 0;
      if (live[u]) {
        addr.locate(a, t, kvh, base, sbase);
        if (quantized) {
          ksc = ks[sbase];
          vsc = vs[sbase];
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

template <typename QT, typename KT, int E, typename Addr>
cudaError_t launch_e(const void* q, const void* k, const void* v,
                     const void* ks, const void* vs, const void* lengths,
                     void* out, int A, int H, int KVH, int d, Addr addr,
                     cudaStream_t stream) {
  const int G = H / KVH;
  const size_t smem =
      sizeof(float) * static_cast<size_t>(kWarps) * G * (2 + 32 * E);
  auto kernel = decode_kernel<QT, KT, E, Addr>;
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
      static_cast<const float*>(vs), static_cast<const int*>(lengths),
      static_cast<QT*>(out), H, KVH, d, addr,
      1.0f / sqrtf(static_cast<float>(d)));
  return cudaGetLastError();
}

// Launches the instantiation for head dim d (up to 256) on `stream`;
// returns the launch's cudaGetLastError(), or cudaErrorInvalidValue for a
// shape the kernel does not take.
template <typename QT, typename KT, typename Addr>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* ks, const void* vs, const void* lengths,
                   void* out, int A, int H, int KVH, int d, Addr addr,
                   cudaStream_t stream) {
  if (KVH <= 0 || H % KVH != 0 || H / KVH > kMaxG || A <= 0) {
    return cudaErrorInvalidValue;
  }
#define REPRO_LAUNCH(E_)                                                    \
  return launch_e<QT, KT, E_, Addr>(q, k, v, ks, vs, lengths, out, A, H,    \
                                    KVH, d, addr, stream)
  if (d <= 32) REPRO_LAUNCH(1);
  if (d <= 64) REPRO_LAUNCH(2);
  if (d <= 128) REPRO_LAUNCH(4);
  if (d <= 256) REPRO_LAUNCH(8);
#undef REPRO_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace repro_decode
