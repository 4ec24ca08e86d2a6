// Blocked e4m3 x e4m3 GEMM with f32 accumulation on Hopper's tensor cores
// (sm_90a): the HPL-MxP trailing update.
//
// Replaces the Pallas TPU kernel of the JAX package
//   repro/kernels/fp8_matmul.py :: fp8_matmul_pallas
// out[i, j] = (sum_k a_q[i, k] * b_q[k, j]) * (a_scale[i / bm] * b_scale[j / bn])
// with one f32 scale per bm-row block of a and per bn-column block of b and
// an f32 (M, N) row-major result.  bm and bn are the scale blocks only: the
// tiling below is this kernel's own, so any M and N run.  With bm = M and
// bn = N both scale vectors hold one scale, which is the per-tensor
// fp8_matmul of repro/core/mixed_precision.py.
//
// Operands.  fp8 wgmma reads both operands K-major (the transpose bits
// exist only for 16-bit types), so the kernel takes a (M, K) and bt = b^T
// (N, K), both row-major with K a multiple of 16 (TMA's 16-byte row
// stride); the wrapper (kernels/fp8_matmul.py) transposes b, which is free
// for the column-major panel a triangular solve returns, and zero-pads K.
//
// Bound.  At the HPL trailing shapes (K = NB = 1024) the 4·MN-byte f32
// output and the 2·MNK operations at the fp8 tensor-core rate take about
// the same time (512 operations per output byte, against the card's ridge
// of ~590).  What limits this kernel is the L2: every tile streams its A
// and B panels from L2 through TMA (the operand bytes per operation fall
// as the tile grows) while the output stream goes out through it to
// device memory.  So the tile is as large as the registers allow:
//
// - a persistent grid, one 512-thread block per SM, walks 192x128 output
//   tiles in groups of GROUP_M tile rows (the group's A panels stay in L2
//   while its columns sweep past);
// - one producer thread (warpgroup 3, registers cut to 24 by setmaxnreg)
//   issues TMA loads of the 192x128-byte A and 128x128-byte B chunks,
//   128-byte swizzled, into a ring of STAGES stages, each completed on an
//   mbarrier; it runs ahead into the next tile while the consumers store
//   this one;
// - three consumer warpgroups (registers raised to 160) each own 64 rows
//   of the tile and run wgmma.m64n128k32 e4m3 x e4m3 with an f32
//   accumulator straight from shared memory; the epilogue scales and
//   stores from registers, 16 bytes a thread (a shuffle pairs
//   neighbouring columns), masked at the ragged edge, with 64-bit
//   offsets; TMA fills rows and columns past the edge, and K past its
//   end, with zeros.
//
// Promotion every 128 of K.  The fp8 tensor cores do not keep f32 sums:
// they align and truncate the products of each k-step and the running sum
// to about 14 significant bits.  So the wgmma accumulator is started from
// zero for each chunk of BK = 128 (4 k-steps of 32, one ring stage) and
// then added into a second, full-f32 register accumulator on the CUDA
// cores.  128 is the TPU kernel's own f32 step (bk = 128: one f32 dot per
// grid step added into its f32 scratch) and DeepSeek-V3's interval; it
// keeps each truncated sum to 128 products, and the error bound
// (kernels/fp8_matmul.py :: error_bound) follows from it.  The 64 + 64
// accumulator registers per consumer thread are what bound the tile: a
// 64x256 warpgroup tile would need 256, and a fourth consumer warpgroup
// would leave each fewer than 128.
//
// The epilogue multiplies the promoted sum by (a_scale * b_scale) in the
// reference's order.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace repro_hopper;

constexpr int CONSUMERS = 3;                    // warpgroups of 64 rows
constexpr int BM = 64 * CONSUMERS, BN = 128, BK = 128;   // tile, K chunk
constexpr int NREG = BN / 2;                    // accumulator registers
constexpr int STAGES = 4;                       // TMA ring depth
constexpr int GROUP_M = 16;                     // tile rows per raster group
constexpr int THREADS = 128 * (CONSUMERS + 1);
// registers: the launch gives every thread the same share; setmaxnreg
// moves the producer warpgroup's to the consumers
constexpr int LAUNCH_REGS = 65536 / THREADS / 8 * 8;
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS =
    (LAUNCH_REGS * THREADS - 128 * PRODUCER_REGS) / (128 * CONSUMERS) / 8 * 8;
constexpr int TILE_A = BM * BK, TILE_B = BN * BK;   // bytes per stage
constexpr int STAGE_BYTES = TILE_A + TILE_B;
// 1024-byte alignment of every tile (the 128-byte swizzle's atom) and
// the barriers after the ring
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024 + 2 * STAGES * 8;
static_assert(SMEM_BYTES <= 232448, "shared memory of one block");

// d(64x128, f32) (+)= a(64x32, e4m3) * b(32x128, e4m3), both from shared
// memory; scale_d = 0 starts the sum from zero
__device__ __forceinline__ void wgmma_e4m3(float (&d)[64], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.f32.e4m3.e4m3 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, "
      "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}"
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
      : "l"(da), "l"(db), "r"(scale_d));
}

// tile t of the persistent walk -> (tile row, tile column), in groups of
// GROUP_M tile rows walked column by column
__device__ __forceinline__ void tile_coords(int t, int tiles_m, int tiles_n,
                                            int& tm, int& tn) {
  const int per_group = GROUP_M * tiles_n;
  const int g = t / per_group;
  const int first = g * GROUP_M;
  const int rows = min(GROUP_M, tiles_m - first);
  const int r = t - g * per_group;
  tm = first + r % rows;
  tn = r / rows;
}

__global__ void __launch_bounds__(THREADS, 1)
fp8_matmul_kernel(const __grid_constant__ CUtensorMap map_a,
                  const __grid_constant__ CUtensorMap map_b,
                  const float* __restrict__ sa, const float* __restrict__ sb,
                  float* __restrict__ out, int M, int N, int K, int bm, int bn,
                  bool vec_out, bool bn4) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;

  const int tiles_m = (M + BM - 1) / BM, tiles_n = (N + BN - 1) / BN;
  const int tiles = tiles_m * tiles_n;
  const int chunks = (K + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // ---- producer: one thread keeps the ring full --------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == CONSUMERS * 128) {
      prefetch_tensormap(&map_a);
      prefetch_tensormap(&map_b);
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        int tm, tn;
        tile_coords(t, tiles_m, tiles_n, tm, tn);
        for (int c = 0; c < chunks; ++c) {
          mbar_wait(&empty[stage], phase ^ 1);
          uint8_t* tile = smem + stage * STAGE_BYTES;
          mbar_expect_tx(&full[stage], STAGE_BYTES);
          tma_load(tile, &map_a, &full[stage], c * BK, tm * BM);
          tma_load(tile + TILE_A, &map_b, &full[stage], c * BK, tn * BN);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumers: 64 rows of the tile each -------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
    const int tid = threadIdx.x % 128, lane = tid % 32, warp = tid / 32;
    const int q = lane % 4;
    int stage = 0;
    uint32_t phase = 0;
    float acc[NREG], part[NREG];
#pragma unroll
    for (int i = 0; i < NREG; ++i) part[i] = 0.f;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int tm, tn;
      tile_coords(t, tiles_m, tiles_n, tm, tn);
#pragma unroll
      for (int i = 0; i < NREG; ++i) acc[i] = 0.f;
      for (int c = 0; c < chunks; ++c) {
        mbar_wait(&full[stage], phase);
        const uint8_t* tile = smem + stage * STAGE_BYTES;
        const uint64_t da = sw_desc(tile + wg * 64 * BK, 128);
        const uint64_t db = sw_desc(tile + TILE_A, 128);
        wgmma_fence();
        // 4 k-steps of 32 bytes along the swizzled 128-byte rows
#pragma unroll
        for (int kk = 0; kk < BK / 32; ++kk)
          wgmma_e4m3(part, da + 2 * kk, db + 2 * kk, kk);
        wgmma_commit();
        wgmma_wait_all();
        if (tid == 0) mbar_arrive(&empty[stage]);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
        // promote the chunk's tensor-core sum into the f32 accumulator
#pragma unroll
        for (int i = 0; i < NREG; ++i) acc[i] += part[i];
      }

      // epilogue: acc[4j..4j+3] hold rows r and r + 8, columns 8j + 2q
      // and 8j + 2q + 1; lanes q and q ^ 1 swap halves so that each holds
      // four neighbouring columns for one 16-byte store
      const bool even = (q & 1) == 0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = tm * BM + wg * 64 + warp * 16 + lane / 4 + 8 * h;
        const bool row_ok = r < M;
        const float s_a = row_ok ? __ldg(&sa[r / bm]) : 0.f;
        float* row = out + static_cast<size_t>(r) * static_cast<size_t>(N);
#pragma unroll
        for (int j = 0; j < BN / 8; j += 2) {
          const float x0 = acc[4 * j + 2 * h], x1 = acc[4 * j + 2 * h + 1];
          const float y0 = acc[4 * (j + 1) + 2 * h];
          const float y1 = acc[4 * (j + 1) + 2 * h + 1];
          // even lanes send their column group j + 1, odd lanes group j
          const float p0 = __shfl_xor_sync(0xffffffffu, even ? y0 : x0, 1);
          const float p1 = __shfl_xor_sync(0xffffffffu, even ? y1 : x1, 1);
          float v[4];
          int col;
          if (even) {
            col = tn * BN + 8 * j + 2 * q;
            v[0] = x0; v[1] = x1; v[2] = p0; v[3] = p1;
          } else {
            col = tn * BN + 8 * (j + 1) + 2 * (q - 1);
            v[0] = p0; v[1] = p1; v[2] = y0; v[3] = y1;
          }
          if (!row_ok || col >= N) continue;
          if (bn4) {              // the four columns share one scale
            const float s = s_a * __ldg(&sb[col / bn]);
#pragma unroll
            for (int e = 0; e < 4; ++e) v[e] *= s;
            if (vec_out) {
              *reinterpret_cast<float4*>(row + col) =
                  make_float4(v[0], v[1], v[2], v[3]);
              continue;
            }
          }
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (col + e < N)
              row[col + e] = bn4 ? v[e] : v[e] * (s_a * __ldg(&sb[(col + e) / bn]));
        }
      }
    }
  }
}

// (rows, K) row-major e4m3 bytes, boxes of box_rows x BK, 128-byte
// swizzle, zeros past the edges
bool make_map(CUtensorMap* map, const void* base, int rows, int K,
              int box_rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K)};
  const cuuint32_t box[2] = {BK, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base),
                dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// Plain C entry point, bound with ctypes.  a: (M, K) and bt: (N, K) e4m3
// bits, row-major (K-major), K a multiple of 16 and both 16-byte aligned;
// sa: (ceil(M / bm),) and sb: (ceil(N / bn),) f32; out: (M, N) f32
// row-major.  Launches on `stream` without synchronising and returns the
// launch's cudaError_t (0 on success; cudaErrorInvalidValue for arguments
// the kernel does not take or a tensor map cuTensorMapEncodeTiled
// refuses).
extern "C" int fp8_matmul(const void* a, const void* bt, const void* sa,
                          const void* sb, void* out, int M, int N, int K,
                          int bm, int bn, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (K <= 0 || K % 16 != 0 || bm <= 0 || bn <= 0 ||
      reinterpret_cast<uintptr_t>(a) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(bt) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_a, map_b;
  if (!make_map(&map_a, a, M, K, BM) || !make_map(&map_b, bt, N, K, BN))
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fp8_matmul_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = static_cast<long long>((M + BM - 1) / BM) *
                          ((N + BN - 1) / BN);
  if (tiles >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  const bool vec_out = N % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  // with bn and N multiples of 4 a thread's four columns share one scale
  const bool bn4 = bn % 4 == 0 && N % 4 == 0;
  fp8_matmul_kernel<<<grid, THREADS, SMEM_BYTES,
                      static_cast<cudaStream_t>(stream)>>>(
      map_a, map_b, static_cast<const float*>(sa),
      static_cast<const float*>(sb), static_cast<float*>(out), M, N, K, bm, bn,
      vec_out, bn4);
  return static_cast<int>(cudaGetLastError());
}
