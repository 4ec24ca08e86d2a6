// Blocked e4m3 x e4m3 GEMM with f32 accumulation for Hopper (sm_90a):
// the HPL-MxP trailing update.
//
// Replaces the Pallas TPU kernel of the JAX package
//   repro/kernels/fp8_matmul.py :: fp8_matmul_pallas
// out[i, j] = (sum_k a_q[i, k] * b_q[k, j]) * (a_scale[i / bm] * b_scale[j / bn])
// with a_q (M, K) and b_q (K, N) row-major e4m3 bit patterns, one f32
// scale per bm-row block of a and per bn-column block of b, and an f32
// (M, N) row-major result.  bm and bn are the scale blocks only: the
// tiling below is this kernel's own, and ragged edges are masked, so any
// M, N, K run (the wrapper enforces the reference's block-multiple
// contract).  With bm = M and bn = N both scale vectors hold one scale,
// which is the per-tensor fp8_matmul of repro/core/mixed_precision.py.
//
// Design (simple and right first): one block of 256 threads per 128x128
// output tile; e4m3 tiles of 128x32 (A) and 32x128 (B) are converted to
// f32 once, as they are staged into shared memory; each thread keeps an
// 8x8 register micro-tile and accumulates with scalar f32 FMAs in k
// order.  An e4m3 product has 8 significant bits, so every FMA's product
// is exact and only the f32 sum rounds, as in the reference's f32 dot.
// The epilogue multiplies by (a_scale * b_scale) in the reference's order.
//
// Bound: at the HPL trailing shapes (K = NB = 1024) the f32 output
// dominates the bytes (4 MN bytes against MK + KN), and 2MNK operations at
// the fp8 tensor-core rate take less time than writing it.  This kernel
// runs on the f32 CUDA cores instead (67 TFLOP/s peak), so it is bound by
// operations here; fp8 mma/wgmma with TMA is the later step (tensor-core
// fp8 accumulation keeps fewer bits than f32 and needs its own tolerance).

#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128, BN = 128, BK = 32, THREADS = 256;

__device__ __forceinline__ float e4m3_to_f32(uint8_t x) {
  __half_raw h = __nv_cvt_fp8_to_halfraw(
      static_cast<__nv_fp8_storage_t>(x), __NV_E4M3);
  return __half2float(__half(h));
}

// 16 consecutive bytes from row-major storage, zero past the edges; one
// 16-byte load where the whole run is inside and aligned.
__device__ __forceinline__ uint4 load16(const uint8_t* __restrict__ p,
                                        int row, int col, int rows, int cols,
                                        bool vec) {
  uint4 raw = make_uint4(0, 0, 0, 0);
  if (row >= rows) return raw;
  const uint8_t* src = p + static_cast<size_t>(row) * cols + col;
  if (vec && col + 16 <= cols) return *reinterpret_cast<const uint4*>(src);
  uint8_t* dst = reinterpret_cast<uint8_t*>(&raw);
#pragma unroll
  for (int j = 0; j < 16; ++j) dst[j] = col + j < cols ? src[j] : 0;
  return raw;
}

__global__ void __launch_bounds__(THREADS)
fp8_matmul_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
                  const float* __restrict__ sa, const float* __restrict__ sb,
                  float* __restrict__ out, int M, int N, int K, int bm,
                  int bn, bool vec_a, bool vec_b, bool vec_out) {
  __shared__ __align__(16) float As[BK][BM];   // A tile, k-major
  __shared__ __align__(16) float Bs[BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int a_row = tid / 2, a_k = (tid % 2) * 16;   // 2 threads per A row
  const int b_k = tid / 8, b_n = (tid % 8) * 16;     // 8 threads per B row

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    uint4 ra = load16(a, m0 + a_row, k0 + a_k, M, K, vec_a);
    uint4 rb = load16(b, k0 + b_k, n0 + b_n, K, N, vec_b);
    const uint8_t* va = reinterpret_cast<const uint8_t*>(&ra);
    const uint8_t* vb = reinterpret_cast<const uint8_t*>(&rb);
#pragma unroll
    for (int j = 0; j < 16; ++j) As[a_k + j][a_row] = e4m3_to_f32(va[j]);
#pragma unroll
    for (int j = 0; j < 16; j += 4)
      *reinterpret_cast<float4*>(&Bs[b_k][b_n + j]) = make_float4(
          e4m3_to_f32(vb[j]), e4m3_to_f32(vb[j + 1]),
          e4m3_to_f32(vb[j + 2]), e4m3_to_f32(vb[j + 3]));
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      // rows ty*4.. and 64+ty*4.., columns tx*4.. and 64+tx*4..: each
      // warp reads consecutive float4s, free of bank conflicts
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
      const float ar[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float br[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (r >= M) continue;
    const float s_a = sa[r / bm];
    float* row = out + static_cast<size_t>(r) * N;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = n0 + h * 64 + tx * 4;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = c + j < N ? acc[i][h * 4 + j] * (s_a * sb[(c + j) / bn]) : 0.f;
      if (vec_out && c + 4 <= N) {
        *reinterpret_cast<float4*>(row + c) = make_float4(v[0], v[1], v[2],
                                                          v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c + j < N) row[c + j] = v[j];
      }
    }
  }
}

}  // namespace

// Plain C entry point, bound with ctypes.  a, b: e4m3 bits, row-major and
// contiguous; sa: (ceil(M / bm),) and sb: (ceil(N / bn),) f32; out: (M, N)
// f32 row-major.  Launches on `stream` without synchronising and returns
// the launch's cudaError_t (0 on success).
extern "C" int fp8_matmul(const void* a, const void* b, const void* sa,
                          const void* sb, void* out, int M, int N, int K,
                          int bm, int bn, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (K < 0 || bm <= 0 || bn <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec_a = K % 16 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
  const bool vec_b = N % 16 == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0;
  const bool vec_out = N % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  fp8_matmul_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(b),
      static_cast<const float*>(sa), static_cast<const float*>(sb),
      static_cast<float*>(out), M, N, K, bm, bn, vec_a, vec_b, vec_out);
  return static_cast<int>(cudaGetLastError());
}
