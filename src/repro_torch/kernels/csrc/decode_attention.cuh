// Single-query decode attention for Hopper (sm_90a): the per-token loop
// shared by the paged kernel (paged_decode_attention.cu, K1/K2) and the
// dense fixed-slot kernel (decode_attention.cu, K4).
//
// What it computes, per seat a and query head h (kv head h / G):
//   out[a, h] = softmax_t(q[a, h] . k_t * d^-0.5) . v_t   over t < lengths[a]
// and, with a sliding window W > 0 (the local layers of gemma3), only over
// t >= lengths[a] - W: the query at position lengths[a] - 1 keeps the W
// keys kv_pos > qpos - W, the reference's mask for those layers
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
// 3.35 TB/s.  What keeps a kernel from it is too few loads in flight: one
// block per (kv head, seat) gives 64 blocks on 132 SMs at the serving
// shapes (8 seats, 8 kv heads), and the longest seat walks its tokens
// alone.
//
// Design:
//   * each block serves all G = H/KVH query heads of its kv head, so each
//     K/V vector is read once (the TPU wrappers expanded GQA and
//     re-streamed every vector G times);
//   * the token loop is bounded by the seat's length, never by the width
//     of the cache or page table: dead tokens are never touched;
//   * each warp takes a slice of kUnroll consecutive tokens per step (half
//     as many where a lane's E elements of a row pass 16 bytes, E = 8 over
//     f32, so that a lane holds at most 64 bytes of K and 64 of V per
//     step: with four tokens that instantiation spilled), with
//     all their K and V loads started before the arithmetic so several
//     loads are in flight per warp; a lane holds E consecutive elements of
//     the head dimension, and the dot product is a warp shuffle reduction;
//     a lane reads its E elements of a K or V row as one load of
//     E·sizeof(KT) bytes (in 16-byte words above 16), not E loads of one
//     element (at d = 128 on an H100 that cut K1 from 0.038 to 0.030
//     ms: the load instructions, not the bytes, were the limit).  It needs
//     d a multiple of E and the rows aligned to the load's word, which the
//     wrappers check and launch_e refuses otherwise;
//   * each warp keeps its own (m, l, acc) per query head; the warps merge
//     in shared memory at the end.
// Split-K over the sequence: the grid is (KVH, seats, splits) and block s
// walks tokens [s·chunk, (s+1)·chunk) of its seat, cut at the length and,
// with a window, started no earlier than lengths[a] - W.  The split plan
// does not know the window, so a windowed seat's splits below it write
// the empty state like those past its length, and a split the window
// starts inside walks only its tail.
// splits and chunk come from host-known shapes only (seats, kv heads,
// table or cache width: kernels/decode_attention.py :: split_plan), so the
// host never reads the lengths, which live on the card.  Each block
// writes its partial (m, l, acc) per query head to a scratch buffer; a
// block whose range starts at or past the length writes the empty state
// (m = -1e30, l = 0, acc = 0) without walking.  The last block of each
// (seat, kv head) to finish, found by a __threadfence + atomicAdd ticket,
// merges the partials in split order (so the result does not depend on
// which block came last), writes out and resets its ticket for the next
// launch: one launch per call.  -1e30 and not -inf keeps a seat whose
// every split is empty at out = 0 (all weights exp(0) = 1 times l = 0)
// where exp(-inf - -inf) would be NaN.
// Two optional arguments serve a cache whose sequence is split over ranks
// (parallel/sequence.py): `starts` (B,) int32, a lower bound per seat that
// replaces lengths[a] - window (a rank's slice of a window that ends past
// the slice cannot be told with one scalar), and `lse` (A, H) f32 with an
// f32 output `out32`: the merge then writes each (seat, head)'s output
// normalized over its keys in f32, and the natural-log log-sum-exp of its
// scaled scores, mx + log(l), or -inf where the seat has no key in range
// (whose output is 0), for the ranks' merge.  The output address is
// formed only
// in the merge: a pointer held across the token walk cost the dense
// kernel registers and a tenth of its time.  The register arrays are
// sized for the real group G (one instantiation each for G <= 1, 2, 4,
// 8): sized for 8 they held the kernel to one 256-thread block per SM.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <stdint.h>
#include <string.h>

namespace repro_decode {

constexpr int kWarps = 8;
constexpr int kUnroll = 4;

// Tokens per warp and step of an instantiation (see the design above).
template <typename KT, int E>
__host__ __device__ constexpr int unroll() {
  return E * sizeof(KT) > 16 ? kUnroll / 2 : kUnroll;
}
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

// The unsigned word of N bytes, N = 1, 2, 4, 8 or 16.
template <int N> struct Word;
template <> struct Word<1> { using T = uint8_t; };
template <> struct Word<2> { using T = uint16_t; };
template <> struct Word<4> { using T = uint32_t; };
template <> struct Word<8> { using T = uint2; };
template <> struct Word<16> { using T = uint4; };

// The E elements [idx0, idx0 + E) of one K or V row at p, times sc, in
// f32; zeros where the token is not live or past d (a zero word is 0 in
// every storage type).  One load of E·sizeof(KT) bytes (in 16-byte words
// above 16), which needs p + idx0 aligned to it and d a multiple of E
// (launch_e checks both).  The loads are predicated, with no branch, so
// the loads of every token of a step issue before the first conversion.
template <typename KT, int E>
__device__ __forceinline__ void load_lane(const KT* p, int idx0, int d,
                                          bool live, float sc,
                                          float (&out)[E]) {
  constexpr int kBytes = E * static_cast<int>(sizeof(KT));
  constexpr int kWord = kBytes < 16 ? kBytes : 16;
  using W = typename Word<kWord>::T;
  const bool ok = live && idx0 < d;
  W w[kBytes / kWord];
#pragma unroll
  for (int c = 0; c < kBytes / kWord; ++c)
    w[c] = ok ? reinterpret_cast<const W*>(p + idx0)[c] : W{};
  KT x[E];
  memcpy(x, w, kBytes);
#pragma unroll
  for (int e = 0; e < E; ++e) out[e] = to_f32(x[e]) * sc;
}

// Merges the splits' partial states of one (seat, kv head) in split order
// and writes out, or, where out32 is given, the f32 output to out32 and
// each head's log-sum-exp to lse; run by the last block to finish.
// `part` holds, per split, G·d accumulators, then G maxima, then G sums.
template <typename QT>
__device__ __forceinline__ void merge_splits(const float* part, int splits,
                                             int G, int d, QT* out,
                                             float* out32, float* lse) {
  const int stride = G * (d + 2);
  for (int i = threadIdx.x; i < G * d; i += blockDim.x) {
    const int g = i / d;
    float mx = kNegInf;
    for (int s = 0; s < splits; ++s)
      mx = fmaxf(mx, __ldcg(part + s * stride + G * d + g));
    float lsum = 0.f, o = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float* p = part + s * stride;
      const float c = expf(__ldcg(p + G * d + g) - mx);
      lsum += __ldcg(p + G * d + G + g) * c;
      o += __ldcg(p + i) * c;
    }
    const float r = o / fmaxf(lsum, 1e-30f);
    if (out32 == nullptr) {
      out[i] = from_f32<QT>(r);
    } else {
      out32[i] = r;
      if (i % d == 0)
        lse[g] = lsum > 0.f ? mx + logf(lsum) : -__int_as_float(0x7f800000);
    }
  }
}

// E: elements of the head dimension held by one lane (d <= 32 * E).
// MG: the largest group size G the instantiation serves (its register
// arrays hold MG query heads).  ks/vs are null for unquantized storage.
// q and out are (A, H, d) contiguous.  Block (kvh, a, s) walks tokens
// [s·chunk, (s+1)·chunk) of seat a, writes its partial state to `part`
// and counts itself on the ticket of (a, kvh) in `tickets` (zero between
// launches); the last of the gridDim.z splits merges.  window > 0 keeps
// only the last `window` tokens of each seat (0: every token); `starts`,
// where given, keeps tokens t >= starts[a] instead.  `out32` and `lse`,
// both given or both null, take the f32 output and the log-sum-exp.
template <typename QT, typename KT, int E, typename Addr, int MG>
__global__ void __launch_bounds__(kWarps * 32)
decode_kernel(const QT* __restrict__ q, const KT* __restrict__ k,
              const KT* __restrict__ v, const float* __restrict__ ks,
              const float* __restrict__ vs, const int* __restrict__ lengths,
              QT* __restrict__ out, int H, int KVH, int d, Addr addr,
              float scale, float* __restrict__ part, int* tickets,
              int chunk, int window, const int* __restrict__ starts,
              float* __restrict__ out32, float* __restrict__ lse) {
  const int kvh = blockIdx.x;
  const int a = blockIdx.y;
  const int G = H / KVH;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const bool quantized = ks != nullptr;
  // this block's tokens [start, end); its partial state `mine` is
  // addressed only after the walk, so no pointer is held across it
  const int len = lengths[a];
  const int split0 = blockIdx.z * chunk;
  const int start = starts != nullptr ? max(split0, starts[a])
                    : window > 0 ? max(split0, len - window) : split0;
  const int end = min(split0 + chunk, len);
  auto partial = [&]() {
    return part + (static_cast<long long>(a * KVH + kvh) * gridDim.z +
                   blockIdx.z) * (G * (d + 2));
  };
  if (start < end) {
    // q of the group's heads, pre-scaled by d^-0.5
    float qr[MG][E];
    float m[MG], l[MG], acc[MG][E];
#pragma unroll
    for (int g = 0; g < MG; ++g) {
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

    constexpr int kU = unroll<KT, E>();
    for (int t0 = start + warp * kU; t0 < end;
         t0 += kWarps * kU) {
      float kf[kU][E], vf[kU][E];
      bool live[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int t = t0 + u;
        live[u] = t < end;
        float ksc = 1.f, vsc = 1.f;
        long long base = 0, sbase = 0;
        if (live[u]) {
          addr.locate(a, t, kvh, base, sbase);
          if (quantized) {
            ksc = ks[sbase];
            vsc = vs[sbase];
          }
        }
        load_lane<KT, E>(k + base, lane * E, d, live[u], ksc, kf[u]);
        load_lane<KT, E>(v + base, lane * E, d, live[u], vsc, vf[u]);
      }
#pragma unroll
      for (int g = 0; g < MG; ++g) {
        if (g < G) {
          float s[kU];
          float mx = m[g];
#pragma unroll
          for (int u = 0; u < kU; ++u) {
            float dot = 0.f;
#pragma unroll
            for (int e = 0; e < E; ++e) dot += qr[g][e] * kf[u][e];
            dot = warp_sum(dot);
            s[u] = live[u] ? dot : kNegInf;
            mx = fmaxf(mx, s[u]);
          }
          const float alpha = expf(m[g] - mx);
          l[g] *= alpha;
#pragma unroll
          for (int e = 0; e < E; ++e) acc[g][e] *= alpha;
#pragma unroll
          for (int u = 0; u < kU; ++u) {
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
    for (int g = 0; g < MG; ++g) {
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
    float* mine = partial();
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
      mine[i] = o;
      if (idx == 0) {
        mine[G * d + g] = mx;
        mine[G * d + G + g] = lsum;
      }
    }
  } else {
    // past the seat's length, or below its window: the empty state
    float* mine = partial();
    for (int i = threadIdx.x; i < G * (d + 2); i += blockDim.x)
      mine[i] = i < G * d ? 0.f : i < G * d + G ? kNegInf : 0.f;
  }

  __shared__ int last;
  __threadfence();                          // the partial is visible ...
  __syncthreads();
  if (threadIdx.x == 0) {                   // ... before the ticket counts it
    int* ticket = tickets + a * KVH + kvh;
    last = atomicAdd(ticket, 1) == static_cast<int>(gridDim.z) - 1;
    if (last) *ticket = 0;                  // every split has arrived
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const long long head0 = static_cast<long long>(a) * H + kvh * G;
  merge_splits(part + static_cast<long long>(a * KVH + kvh) * gridDim.z *
                          (G * (d + 2)),
               gridDim.z, G, d, out + head0 * d,
               out32 == nullptr ? nullptr : out32 + head0 * d,
               lse == nullptr ? nullptr : lse + head0);
}

// Launches the instantiation for E lanes' elements and the group G =
// H/KVH (register arrays for MG = 1, 2, 4 or 8) over gridDim.z = splits
// blocks of `chunk` tokens, with the scratch `part` (A·KVH·splits·G·(d + 2)
// f32) and `tickets` (A·KVH int32, zero), keeping the last `window`
// tokens of each seat (0: all), or those from starts[a] where `starts` is
// given; with out32 and lse, the f32 output and the log-sum-exp.  The
// layout must allow one load per lane
// (load_lane): d a multiple of E, every K/V stride of `addr` a multiple
// of E, and k and v aligned to the load's word; otherwise
// cudaErrorInvalidValue.
template <typename QT, typename KT, int E, typename Addr>
cudaError_t launch_e(const void* q, const void* k, const void* v,
                     const void* ks, const void* vs, const void* lengths,
                     void* out, int A, int H, int KVH, int d, Addr addr,
                     float* part, int* tickets, int splits, int chunk,
                     int window, const int* starts, float* out32,
                     float* lse, cudaStream_t stream) {
  const int G = H / KVH;
  const size_t smem =
      sizeof(float) * static_cast<size_t>(kWarps) * G * (2 + 32 * E);
  const float scale = 1.0f / sqrtf(static_cast<float>(d));
  constexpr size_t kBytes = E * sizeof(KT);
  constexpr size_t kWord = kBytes < 16 ? kBytes : 16;
  if (d % E != 0 || !addr.strides_divisible_by(E) ||
      reinterpret_cast<uintptr_t>(k) % kWord != 0 ||
      reinterpret_cast<uintptr_t>(v) % kWord != 0) {
    return cudaErrorInvalidValue;
  }
  auto run = [&](auto kernel) {
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return err;
    }
    kernel<<<dim3(KVH, A, splits), kWarps * 32, smem, stream>>>(
        static_cast<const QT*>(q), static_cast<const KT*>(k),
        static_cast<const KT*>(v), static_cast<const float*>(ks),
        static_cast<const float*>(vs), static_cast<const int*>(lengths),
        static_cast<QT*>(out), H, KVH, d, addr, scale, part, tickets,
        chunk, window, starts, out32, lse);
    return cudaGetLastError();
  };
  if (G <= 1) return run(decode_kernel<QT, KT, E, Addr, 1>);
  if (G <= 2) return run(decode_kernel<QT, KT, E, Addr, 2>);
  if (G <= 4) return run(decode_kernel<QT, KT, E, Addr, 4>);
  return run(decode_kernel<QT, KT, E, Addr, kMaxG>);
}

// Launches the instantiation for head dim d (up to 256) on `stream` (see
// launch_e); returns the launch's cudaGetLastError(), or
// cudaErrorInvalidValue for a shape the kernel does not take.
template <typename QT, typename KT, typename Addr>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* ks, const void* vs, const void* lengths,
                   void* out, int A, int H, int KVH, int d, Addr addr,
                   float* part, int* tickets, int splits, int chunk,
                   int window, const int* starts, float* out32, float* lse,
                   cudaStream_t stream) {
  if (KVH <= 0 || H % KVH != 0 || H / KVH > kMaxG || A <= 0 ||
      part == nullptr || tickets == nullptr || chunk <= 0 || splits <= 0 ||
      splits > 65535 || window < 0 || (out32 == nullptr) != (lse == nullptr)) {
    return cudaErrorInvalidValue;
  }
#define REPRO_LAUNCH(E_)                                                    \
  return launch_e<QT, KT, E_, Addr>(q, k, v, ks, vs, lengths, out, A, H,    \
                                    KVH, d, addr, part, tickets, splits,    \
                                    chunk, window, starts, out32, lse,      \
                                    stream)
  if (d <= 32) REPRO_LAUNCH(1);
  if (d <= 64) REPRO_LAUNCH(2);
  if (d <= 128) REPRO_LAUNCH(4);
  if (d <= 256) REPRO_LAUNCH(8);
#undef REPRO_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace repro_decode
