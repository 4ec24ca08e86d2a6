// Tiled online-softmax (flash) attention for Hopper (sm_90a): the prefill
// attention of the fixed-slot path.
//
// Replaces the Pallas TPU kernel of the JAX package
//   repro/kernels/flash_attention.py :: flash_attention_pallas
// with the same function: for query row i of head h,
//   out[i] = softmax_j(q[i] . k_j * d^-0.5) . v_j
// over the keys j < Skv kept by the causal mask (j <= i) and the sliding
// window (j > i - window), positions counted from 0 on both sides; masked
// scores are -1e30, the softmax is an f32 online softmax (m, l, acc), and
// out = acc / max(l, 1e-30) in the input dtype.
//
// Bound: at the serving shapes (S = 511, H 16, KVH 8, d 128, bf16) the
// operations, 4·d·H·sum_i(keys kept), over the bf16 tensor-core rate
// (989 TFLOP/s) and the bytes of q, k, v and out over 3.35 TB/s are both
// about a microsecond or two.  This first kernel is far off either: it
// multiplies with scalar f32 FMAs out of shared memory, no tensor cores.
//
// Design (simple and right first):
//   * one block per (query tile of kBQ rows, query head, batch row); the
//     TPU's sequential key-tile grid axis becomes a loop inside the block;
//   * GQA without a copy: the block reads kv head h / G straight from the
//     (B, Skv, KVH, d) cache through its strides (the TPU wrapper repeated
//     every kv head G times first);
//   * the loop runs only over the key tiles the tile's rows can see: up to
//     the causal diagonal, and from the first tile inside the window — the
//     TPU kernel's skip of fully masked tiles;
//   * the ragged tails of Sq and Skv are masked in the kernel (rows past Sq
//     load zeros and are not stored, keys past Skv score -1e30), so the
//     wrapper pads and copies nothing;
//   * q, k and v tiles are converted to f32 into shared memory; each of the
//     256 threads owns a 2 x 4 patch of the score tile and 2 rows x d/16
//     columns of the output accumulator in registers; row max and row sum
//     are 16-lane shuffle reductions.
// Tensor cores (mma.sync or wgmma), TMA and a pipelined key loop are
// later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 32;                  // query rows per block
constexpr int kBK = 64;                  // keys per tile
constexpr int kThreads = 256;            // 16 x 16 threads
constexpr int kRows = kBQ / 16;          // query rows per thread
constexpr int kCols = kBK / 16;          // score columns per thread
constexpr float kNegInf = -1e30f;

template <typename T>
__device__ __forceinline__ float to_f32(T x);

template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }

template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);

template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }

template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// reduction over the 16 lanes of a half-warp (the threads of one row)
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  }
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, off);
  }
  return x;
}

struct Strides {
  long long b, s, h;                     // batch, sequence, head (elements)
};

// DP: largest head dim of the instantiation (d <= DP, DP a multiple of 16)
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int Sq, int Skv,
             int H, int KVH, int d, int causal, int window, Strides qs,
             Strides kvs, Strides os, float scale) {
  constexpr int kAcc = DP / 16;          // output columns per thread
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int tid = threadIdx.x;
  const int tx = tid & 15;               // column group
  const int ty = tid >> 4;               // row pair: rows ty*kRows + i

  extern __shared__ float smem[];
  const int ld = d + 1;                  // padded: conflict-free column reads
  float* Qs = smem;                      // [kBQ][ld]
  float* Ks = Qs + kBQ * ld;             // [kBK][ld]
  float* Vs = Ks + kBK * ld;             // [kBK][d]
  float* Ps = Vs + kBK * d;              // [kBQ][kBK]

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * kvs.b + kvh * kvs.h;
  const T* vb = v + b * kvs.b + kvh * kvs.h;
  for (int i = tid; i < kBQ * d; i += kThreads) {
    const int r = i / d, c = i % d;
    const int qp = q0 + r;
    Qs[r * ld + c] = qp < Sq ? to_f32(qb[qp * qs.s + c]) : 0.f;
  }

  // the key tiles some row of this tile keeps
  int kt_end = (Skv + kBK - 1) / kBK;
  if (causal) kt_end = min(kt_end, (q0 + kBQ - 1) / kBK + 1);
  const int kt_begin = window > 0 ? max(0, q0 - window + 1) / kBK : 0;

  float m[kRows], l[kRows], acc[kRows][kAcc];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < kAcc; ++e) acc[i][e] = 0.f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();                     // the last tile's reads are done
    for (int i = tid; i < kBK * d; i += kThreads) {
      const int r = i / d, c = i % d;
      const int kp = k0 + r;
      const bool ok = kp < Skv;
      Ks[r * ld + c] = ok ? to_f32(kb[kp * kvs.s + c]) : 0.f;
      Vs[r * d + c] = ok ? to_f32(vb[kp * kvs.s + c]) : 0.f;
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
    for (int c = 0; c < d; ++c) {
      float qv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = Qs[(ty * kRows + i) * ld + c];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float kv = Ks[(tx + 16 * j) * ld + c];
#pragma unroll
        for (int i = 0; i < kRows; ++i) s[i][j] += qv[i] * kv;
      }
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty * kRows + i;
      const int qp = q0 + r;
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kp = k0 + tx + 16 * j;
        bool keep = kp < Skv;
        if (causal) keep = keep && kp <= qp;
        if (window > 0) keep = keep && kp > qp - window;
        s[i][j] = keep ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = row_max(mx);
      const float alpha = expf(m[i] - mx);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(s[i][j] - mx);
        Ps[r * kBK + tx + 16 * j] = p;
        psum += p;
      }
      l[i] = l[i] * alpha + row_sum(psum);
#pragma unroll
      for (int e = 0; e < kAcc; ++e) acc[i][e] *= alpha;
      m[i] = mx;
    }
    __syncthreads();                     // Ps complete

    for (int kk = 0; kk < kBK; ++kk) {
      float p[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) p[i] = Ps[(ty * kRows + i) * kBK + kk];
#pragma unroll
      for (int e = 0; e < kAcc; ++e) {
        const int c = tx + 16 * e;
        if (c < d) {
          const float vv = Vs[kk * d + c];
#pragma unroll
          for (int i = 0; i < kRows; ++i) acc[i][e] += p[i] * vv;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qp = q0 + ty * kRows + i;
    if (qp >= Sq) continue;
    T* ob = out + b * os.b + qp * os.s + h * os.h;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int e = 0; e < kAcc; ++e) {
      const int c = tx + 16 * e;
      if (c < d) ob[c] = from_f32<T>(acc[i][e] / denom);
    }
  }
}

template <typename T, int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int Sq, int Skv, int H, int KVH, int d, int causal,
                   int window, Strides qs, Strides kvs, Strides os,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(kBQ + kBK) * (d + 1) + kBK * d + kBQ * kBK);
  auto kernel = flash_kernel<T, DP>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Skv, H, KVH, d,
      causal, window, qs, kvs, os, 1.0f / sqrtf(static_cast<float>(d)));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v,
                       void* out, int B, int Sq, int Skv, int H, int KVH,
                       int d, int causal, int window, Strides qs,
                       Strides kvs, Strides os, cudaStream_t stream) {
#define REPRO_LAUNCH(DP_)                                                   \
  return launch<T, DP_>(q, k, v, out, B, Sq, Skv, H, KVH, d, causal,        \
                        window, qs, kvs, os, stream)
  if (d <= 32) REPRO_LAUNCH(32);
  if (d <= 64) REPRO_LAUNCH(64);
  if (d <= 128) REPRO_LAUNCH(128);
  if (d <= 256) REPRO_LAUNCH(256);
#undef REPRO_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point, bound with ctypes.  dtype 0 = f32, 1 = bf16, the
// same for q, k, v and out.  q (B, Sq, H, d), k/v (B, Skv, KVH, d) and
// out (B, Sq, H, d) have unit stride in d and the given batch, sequence
// and head strides (in elements; k and v share theirs).  causal 0/1;
// window 0 = none, else keys j > i - window.  Returns the launch's
// cudaGetLastError() (0 = success), or cudaErrorInvalidValue for a
// combination the kernel does not take.
extern "C" int flash_attention(int dtype, const void* q, const void* k,
                               const void* v, void* out, int B, int Sq,
                               int Skv, int H, int KVH, int d, int causal,
                               int window, long long q_b, long long q_s,
                               long long q_h, long long kv_b, long long kv_s,
                               long long kv_h, long long o_b, long long o_s,
                               long long o_h, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || KVH <= 0 || H % KVH != 0 ||
      window < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Strides qs{q_b, q_s, q_h}, kvs{kv_b, kv_s, kv_h}, os{o_b, o_s, o_h};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch_d<float>(q, k, v, out, B, Sq, Skv, H, KVH, d, causal,
                            window, qs, kvs, os, s);
  } else if (dtype == 1) {
    err = dispatch_d<__nv_bfloat16>(q, k, v, out, B, Sq, Skv, H, KVH, d,
                                    causal, window, qs, kvs, os, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
