// Tiled online-softmax (flash) attention for Hopper (sm_90a): the prefill
// attention of the fixed-slot path.
//
// Replaces the Pallas TPU kernel of the JAX package
//   repro/kernels/flash_attention.py :: flash_attention_pallas
// with the same function: for query row i of head h (kv head h / G),
//   out[i] = softmax_j(q[i] . k_j * d^-0.5) . v_j
// over the keys j < Skv kept by the causal mask (j <= i) and the sliding
// window (j > i - window), positions counted from 0 on both sides; masked
// scores are -1e30, the softmax is an f32 online softmax (m, l, acc), and
// out = acc / max(l, 1e-30) in the input dtype.
//
// Bound.  At the serving shape (one prompt of S = 511, H 16, KVH 8,
// d 128, bf16) the work is 4·d·H·S(S+1)/2 = 1.07 GFLOP, about 1.1 us at
// the bf16 tensor-core rate (989 TFLOP/s); the bytes of q, k, v and out
// take about 1.9 us at 3.35 TB/s.  So the kernel must run its products on
// the tensor cores, and the grid is small: 8 query tiles of 64 rows x 16
// heads = 128 blocks on 132 SMs, the causal ones 1 to 8 key tiles deep.
//
// Two routes, chosen by dtype and head dim (kernels/ops.py):
//
// bf16, d in {32, 64, 96, 128, 256}: flash_attention_tc, the tensor cores.
//   * one block per (64 query rows, query head, batch row): one consumer
//     warpgroup and one producer warp;
//   * the producer issues TMA loads through 4-D tensor maps (d, S, heads,
//     batch) that read q, k and v in place through their strides (kv head
//     h / G: no GQA repeat, no padding, no copy): the q tile once, then
//     the key tiles of 64 keys into a 2-stage ring, K and V on their own
//     mbarriers so that S = Q·K^T starts before V has landed; rows of d are
//     cut into swizzle-wide chunks (128 bytes where 2·d is a multiple of
//     128, else 64: d = 32, and d = 96 as three chunks of 32, its 192-byte
//     row being no whole number of 128-byte chunks); TMA fills
//     rows past Sq and keys past Skv with zeros, and those keys are still
//     masked to -1e30 here;
//   * S = Q·K^T is wgmma m64n64k16 bf16 x bf16 -> f32 with both operands
//     K-major in shared memory (k as stored, (keys, d), is K-major for
//     K^T); the online softmax runs on the accumulator fragment in
//     registers, in base 2 (scores scaled by d^-0.5·log2(e)), with the row
//     max reduced over the quad of lanes that share a row: no score tile
//     in shared memory;
//   * P stays in registers, where the accumulator layout is already
//     wgmma's A-operand layout, as two bf16 terms hi = bf16(p) and
//     lo = bf16(p - hi), and O += P·V is two wgmma m64n{d}k16 per 16 keys
//     (hi·V + lo·V) with A from registers and V read MN-major from shared
//     memory (bf16 wgmma has the transpose bit, so V needs no transposed
//     copy; its d chunks are the descriptor's MN atoms, kKeys·SW bytes
//     apart: three of 32 columns at d = 96, m64n96k16);
//   * only the key tiles the 64 rows can see are walked: up to the causal
//     diagonal, and from the first tile inside the window; the grid runs
//     the query tiles last-first, so the deepest causal tiles of every head
//     start in the first wave;
//   * out = acc / max(l, 1e-30) is stored from registers, masked at Sq.
//   P in bf16 is a change from the TPU kernel, which keeps p in f32 for its
//   P·V dot.  One bf16 term errs by up to 2^-9 per weight, and over the
//   few weights of a short causal row that broke the port's bf16 check
//   (1e-3 + 2^-7·|plain|) on the card, at S = 511, 64 and 37 alike (and
//   in tests/test_torch_attention_split.py's emulation); hi + lo carries
//   16 significant bits (2^-17 per weight) for twice the P·V products,
//   which the tensor cores have to spare at this size.  l is summed from
//   the same hi + lo that enters the product, so out is still a convex
//   combination of v rows (|out| <= max |v|).
//
// f32 (any d up to 256), or bf16 at another d: flash_attention, the CUDA
//   cores.  TF32 would cut f32's precision, which the port refuses.  One
//   block per (32 query rows, head, batch row); q, k and v tiles converted
//   to f32 in shared memory, each of 256 threads owning a 2 x 4 patch of
//   the score tile and 2 rows x d/16 columns of the output accumulator,
//   the same tile skip and masks.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

// ---- the CUDA-core route (f32, or bf16 at another d) ------------------

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


// ---- the tensor-core route (bf16) -------------------------------------

namespace tc {

using namespace repro_hopper;

constexpr int kRows = 64;                // query rows: one warpgroup's wgmma M
constexpr int kKeys = 64;                // keys per tile
constexpr int kStages = 2;               // K/V ring depth
constexpr int kThreads = 128 + 32;       // consumer warpgroup + producer warp
constexpr float kLog2e = 1.4426950408889634f;

// D: head dim.  Rows of d are cut into chunks of SW bytes, the TMA box
// width and the swizzle: 128 bytes where a row is a whole number of them,
// else 64 (d = 32: one chunk; d = 96: three, where 128-byte chunks would
// leave half of one over).
template <int D>
struct Tile {
  static constexpr int SW = (D * 2) % 128 == 0 ? 128 : 64;
  static constexpr int CH = SW / 2;      // elements per chunk
  static constexpr int NC = D / CH;      // chunks per row
  static_assert(D % CH == 0, "a row is a whole number of chunks");
  static constexpr int Q_BYTES = kRows * D * 2;
  static constexpr int KV_BYTES = kKeys * D * 2;
  // 1024-byte alignment of every tile (the swizzle atom), then q, the K
  // ring, the V ring and the barriers
  static constexpr int SMEM =
      1024 + Q_BYTES + 2 * kStages * KV_BYTES + (1 + 3 * kStages) * 8;
  static_assert(SMEM <= 232448, "shared memory of one block");
};

// d(64x64, f32) (+)= a(64x16) * b(16x64), bf16, both K-major from shared
// memory; scale_d = 0 starts the sum from zero
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, "
      "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "
      "%31}, %32, %33, p, 1, 1, 0, 0;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d(64x32, f32) (+)= a(64x16, bf16, registers) * b(16x32, bf16, MN-major
// in shared memory: the transpose bit set)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, "
      "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, "
      "%17, %18, %19}, %20, p, 1, 1, 1;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d(64x64, f32) (+)= a(64x16, bf16, registers) * b(16x64, bf16, MN-major
// in shared memory: the transpose bit set)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, "
      "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "
      "%31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d(64x96, f32) (+)= a(64x16, bf16, registers) * b(16x96, bf16, MN-major
// in shared memory: the transpose bit set; three 64-byte swizzle atoms
// along N, the descriptor's leading byte offset apart)
__device__ __forceinline__ void wgmma_rs_n96(float (&d)[48],
                                          const uint32_t (&a)[4],
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {%0, %1, %2, "
      "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "
      "%31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d(64x128, f32) (+)= a(64x16, bf16, registers) * b(16x128, bf16, MN-major
// in shared memory: the transpose bit set)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, "
      "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "
      "%31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, "
      "1, 1, 1;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d(64x256, f32) (+)= a(64x16, bf16, registers) * b(16x256, bf16, MN-major
// in shared memory: the transpose bit set)
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {%0, %1, %2, "
      "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "
      "%31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, "
      "%83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, "
      "%119, %120, %121, %122, %123, %124, %125, %126, %127}, {%128, %129, "
      "%130, %131}, %132, p, 1, 1, 1;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  if constexpr (N == 32) wgmma_rs_n32(d, a, db, scale_d);
  else if constexpr (N == 64) wgmma_rs_n64(d, a, db, scale_d);
  else if constexpr (N == 96) wgmma_rs_n96(d, a, db, scale_d);
  else if constexpr (N == 128) wgmma_rs_n128(d, a, db, scale_d);
  else wgmma_rs_n256(d, a, db, scale_d);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// exp2 of two scores against their row max, carried as two bf16 terms
// hi + lo (hi = bf16(p), lo = bf16(p - hi): 16 significant bits) and
// packed as wgmma's A operand takes them (lower column in the low half);
// `l` gains hi + lo, the weights that enter the product
__device__ __forceinline__ void p_pack(float s0, float s1, float m, float& l,
                                       uint32_t& hi, uint32_t& lo) {
  const float p0 = exp2f(s0 - m), p1 = exp2f(s1 - m);
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  const float h0 = __low2float(h), h1 = __high2float(h);
  const __nv_bfloat162 r = __floats2bfloat162_rn(p0 - h0, p1 - h1);
  l += (h0 + __low2float(r)) + (h1 + __high2float(r));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&r);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_tc_kernel(const __grid_constant__ CUtensorMap map_q,
                const __grid_constant__ CUtensorMap map_k,
                const __grid_constant__ CUtensorMap map_v,
                __nv_bfloat16* __restrict__ out, int Sq, int Skv, int H,
                int KVH, int causal, int window, Strides os,
                float scale_log2) {
  using T = Tile<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sq = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  uint8_t* sk = sq + T::Q_BYTES;
  uint8_t* sv = sk + kStages * T::KV_BYTES;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sv + kStages * T::KV_BYTES);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* empty = v_full + kStages;

  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;   // deepest first
  const int h = blockIdx.x % H;
  const int b = blockIdx.x / H;
  const int kvh = h / (H / KVH);

  // the key tiles some row of this tile keeps
  int kt_end = (Skv + kKeys - 1) / kKeys;
  if (causal) kt_end = min(kt_end, (q0 + kRows - 1) / kKeys + 1);
  const int kt_begin = window > 0 ? max(0, q0 - window + 1) / kKeys : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // ---- producer: one thread issues every load ----------------------
    if (threadIdx.x == 128) {
      prefetch_tensormap(&map_q);
      prefetch_tensormap(&map_k);
      prefetch_tensormap(&map_v);
      mbar_expect_tx(q_full, T::Q_BYTES);
      for (int c = 0; c < T::NC; ++c)
        tma_load_4d(sq + c * kRows * T::SW, &map_q, q_full, c * T::CH, q0, h,
                    b);
      int stage = 0;
      uint32_t phase = 0;
      for (int kt = kt_begin; kt < kt_end; ++kt) {
        mbar_wait(&empty[stage], phase ^ 1);
        uint8_t* kd = sk + stage * T::KV_BYTES;
        uint8_t* vd = sv + stage * T::KV_BYTES;
        mbar_expect_tx(&k_full[stage], T::KV_BYTES);
        for (int c = 0; c < T::NC; ++c)
          tma_load_4d(kd + c * kKeys * T::SW, &map_k, &k_full[stage],
                      c * T::CH, kt * kKeys, kvh, b);
        mbar_expect_tx(&v_full[stage], T::KV_BYTES);
        for (int c = 0; c < T::NC; ++c)
          tma_load_4d(vd + c * kKeys * T::SW, &map_v, &v_full[stage],
                      c * T::CH, kt * kKeys, kvh, b);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // ---- consumer warpgroup: 64 query rows -------------------------------
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  // accumulator fragments: register 4j + 2r + e holds row
  // warp·16 + lane/4 + 8r, column 8j + 2(lane % 4) + e
  const int row = warp * 16 + lane / 4;
  const int col = 2 * (lane % 4);
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  mbar_wait(q_full, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kKeys;
    float s[kKeys / 2];
#pragma unroll
    for (int i = 0; i < kKeys / 2; ++i) s[i] = 0.f;
    mbar_wait(&k_full[stage], phase);
    const uint8_t* kb = sk + stage * T::KV_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk * 16 / T::CH, off = (kk * 16 % T::CH) * 2;
      wgmma_ss_n64(s, sw_desc(sq + c * kRows * T::SW + off, T::SW),
                   sw_desc(kb + c * kKeys * T::SW + off, T::SW), kk);
    }
    wgmma_commit();
    wgmma_wait_all();

    // scale, mask, row max
    const bool edge = k0 + kKeys > Skv ||
                      (causal && k0 + kKeys - 1 > q0) ||
                      (window > 0 && k0 <= q0 + kRows - 1 - window);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e / 2;
        float x = s[4 * j + e] * scale_log2;
        if (edge) {
          const int kp = k0 + 8 * j + col + (e & 1);
          const int qp = q0 + row + 8 * r;
          bool keep = kp < Skv;
          if (causal) keep = keep && kp <= qp;
          if (window > 0) keep = keep && kp > qp - window;
          x = keep ? x : kNegInf;
        }
        s[4 * j + e] = x;
        mx[r] = fmaxf(mx[r], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      alpha[r] = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
    // P as the A operand of 4 k-steps of 16 keys, in two bf16 terms:
    // registers 8kk..8kk+7 of S hold keys 16kk..16kk+15 of rows row and
    // row + 8
    uint32_t ph[kKeys / 16][4], pl[kKeys / 16][4];
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p_pack(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1], m[i % 2], l[i % 2],
               ph[kk][i], pl[kk][i]);
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i / 2) % 2];

    mbar_wait(&v_full[stage], phase);
    const uint8_t* vb = sv + stage * T::KV_BYTES;
    wgmma_fence();
    // V (keys, d) is MN-major for B: 8-key groups SW·8 bytes apart, the
    // d chunks kKeys·SW bytes apart
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      const uint64_t dv = sw_desc(vb + kk * 16 * T::SW, T::SW, kKeys * T::SW);
      wgmma_rs<D>(o, ph[kk], dv, 1);
      wgmma_rs<D>(o, pl[kk], dv, 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    if (tid == 0) mbar_arrive(&empty[stage]);
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }

  const int bh = blockIdx.x;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float denom = fmaxf(quad_sum(l[r]), 1e-30f);
    const int qp = q0 + row + 8 * r;
    if (qp >= Sq) continue;
    __nv_bfloat16* ob = out + (bh / H) * os.b + qp * os.s + h * os.h;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(ob + 8 * j + col) =
          __floats2bfloat162_rn(o[4 * j + 2 * r] / denom,
                                o[4 * j + 2 * r + 1] / denom);
  }
}

// (d, S, heads, batch) bf16 view of a (B, S, heads, d) tensor with unit
// stride in d, boxes of CH x rows, SW-byte swizzle, zeros past the edges
bool make_map(CUtensorMap* map, const void* base, int d, int S, int heads,
              int B, const Strides& st, int rows, int sw) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st.s) * 2,
                                 static_cast<cuuint64_t>(st.h) * 2,
                                 static_cast<cuuint64_t>(st.b) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(sw / 2),
                             static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swz = sw == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                           : CU_TENSOR_MAP_SWIZZLE_64B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int Sq, int Skv, int H, int KVH, int causal,
                   int window, Strides qs, Strides kvs, Strides os,
                   cudaStream_t stream) {
  using T = Tile<D>;
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, D, Sq, H, B, qs, kRows, T::SW) ||
      !make_map(&mk, k, D, Skv, KVH, B, kvs, kKeys, T::SW) ||
      !make_map(&mv, v, D, Skv, KVH, B, kvs, kKeys, T::SW))
    return cudaErrorInvalidValue;
  auto kernel = flash_tc_kernel<D>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(H * B, (Sq + kRows - 1) / kRows);
  kernel<<<grid, kThreads, T::SMEM, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(out), Sq, Skv, H, KVH, causal,
      window, os, kLog2e / sqrtf(static_cast<float>(D)));
  return cudaGetLastError();
}

}  // namespace tc

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

// Plain C entry point of the tensor-core route, bound with ctypes: bf16
// q (B, Sq, H, d), k/v (B, Skv, KVH, d) and out (B, Sq, H, d), d one of
// 32, 64, 96, 128, 256, unit stride in d, the other strides (in elements) as
// flash_attention takes them.  TMA's rules: q, k and v 16-byte aligned,
// every stride a multiple of 8 elements (16 bytes; the stride of a
// dimension of size 1 is never read but must obey it too).  Returns the
// launch's cudaGetLastError() (0 = success), or cudaErrorInvalidValue for
// a combination the kernel does not take or a tensor map
// cuTensorMapEncodeTiled refuses.
extern "C" int flash_attention_tc(const void* q, const void* k,
                                  const void* v, void* out, int B, int Sq,
                                  int Skv, int H, int KVH, int d, int causal,
                                  int window, long long q_b, long long q_s,
                                  long long q_h, long long kv_b,
                                  long long kv_s, long long kv_h,
                                  long long o_b, long long o_s, long long o_h,
                                  void* stream) {
  const long long strides[6] = {q_b, q_s, q_h, kv_b, kv_s, kv_h};
  bool ok = B > 0 && Sq > 0 && Skv > 0 && KVH > 0 && H % KVH == 0 &&
            window >= 0 && (Sq + tc::kRows - 1) / tc::kRows <= 65535 &&
            static_cast<long long>(H) * B < (1LL << 31);
  const void* ptrs[3] = {q, k, v};
  for (const void* p : ptrs)
    ok = ok && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  for (long long s : strides) ok = ok && s > 0 && s % 8 == 0;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{q_b, q_s, q_h}, kvs{kv_b, kv_s, kv_h}, os{o_b, o_s, o_h};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (d) {
    case 32: err = tc::launch<32>(q, k, v, out, B, Sq, Skv, H, KVH, causal,
                                  window, qs, kvs, os, s); break;
    case 64: err = tc::launch<64>(q, k, v, out, B, Sq, Skv, H, KVH, causal,
                                  window, qs, kvs, os, s); break;
    case 96: err = tc::launch<96>(q, k, v, out, B, Sq, Skv, H, KVH, causal,
                                  window, qs, kvs, os, s); break;
    case 128: err = tc::launch<128>(q, k, v, out, B, Sq, Skv, H, KVH, causal,
                                    window, qs, kvs, os, s); break;
    case 256: err = tc::launch<256>(q, k, v, out, B, Sq, Skv, H, KVH, causal,
                                    window, qs, kvs, os, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
