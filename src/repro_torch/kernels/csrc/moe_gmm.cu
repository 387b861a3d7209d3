// K3: the grouped (per-expert) matmul, forward and backward, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/moe_gmm.py (_gmm_kernel /
// moe_gmm_pallas): y[e] = x[e] @ w[e] for every expert e, fp32
// accumulation, cast to the output's type.  The TPU kernel has no
// backward.  Here one kernel per dtype, templated on the layout of its two
// operands, computes for E independent experts
//
//   forward  C[e] = x[e]   . w[e]     x (E, M, K), w (E, K, N)  -> y  (E, M, N)
//   dx       C[e] = dy[e]  . w[e]^T   dy (E, M, N), w (E, K, N) -> dx (E, M, K)
//   dw       C[e] = x[e]^T . dy[e]    x (E, M, K), dy (E, M, N) -> dw (E, K, N)
//
// Bound on the H100.  At the DeepSeek-MoE-16B training shape (E = 64
// experts, M = 448 dispatched rows, K = 2048, N = 1408, bf16) a call does
// 165 GFLOP and moves 567 MB: 0.167 ms at 989 TFLOP/s of bf16 tensor
// cores and 0.169 ms at 3.35 TB/s, so it sits at the ridge of the roofline.
//
// bf16: tensor cores fed by TMA (moe_gmm_wgmma_kernel).  A block of 288
// threads owns one 128 x 128 tile of C of one expert (grid: N/128, M/128,
// E).  One producer thread keeps TMA loads of 64-deep slabs of A and B in
// flight through a ring of 4 stages (32 KB each) guarded by full and empty
// mbarriers; two consumer warpgroups each issue wgmma.m64n128k16 over
// their 64 rows of the tile, with fp32 accumulators in registers, and
// release a stage once the wgmma group after it has been issued.  The
// three layouts differ only in the descriptors' transpose bits and in the
// boxes TMA cuts (hopper.cuh): forward A K-major and B MN-major, dx both
// K-major, dw both MN-major; no operand is transposed by a copy.  Each
// operand is read through a 3-D tensor map over (E, rows, cols), so TMA
// zero-fills past every expert's ragged edge (M = 448 is 3.5 tiles, K may
// be below 64) and the epilogue masks its stores.  TMA needs 16-byte rows:
// every operand's contiguous extent (K or N) is a multiple of 8; the
// wrapper pads any other K or N with zeros to the next one (one copy of
// each operand, and the output cut back).  A product of two bf16 values
// is exact in fp32, so the kernel
// computes the TPU kernel's function; only the order of the sum differs.
//
// fp32 runs on the CUDA cores in moe_gmm_fp32.cu (moe_gmm_fp32), which
// the entry point below calls for dtype 0: tensor cores take fp32 only as
// TF32, which would break the fp32 tolerance.
//
// Offsets are 64-bit (E*K*N passes 2^31 bytes at DBRX's widths).  Experts
// and row tiles past gridDim.z's and gridDim.y's limit of 65,535 are
// walked in further launches (e0, mt0: the first expert and row tile of a
// launch), so a call takes any E and M, and reports the launches it made.
// Folding them into gridDim.z in one launch, as K2 folds its query
// blocks, made a block's expert and row tile computed values; at the
// register cap that spilled two fp32 tile kernels and slowed the fp32
// training shape by 4-6% (PERF.md).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

extern "C" int moe_gmm_fp32(const void* a, const void* b, void* c, int E, int M, int N, int K,
                            int trans_a, int trans_b, void* stream);

namespace {

// ---- bf16 on the tensor cores

constexpr int kTcTile = 128;                  // rows and columns of C per block
constexpr int kTcDepth = 64;                  // contraction per stage: one 128-byte row
constexpr int kTcStages = 4;
constexpr int kTcThreads = 288;               // warps 0-7: two consumer warpgroups; 8: producer
constexpr int kTcOperandBytes = kTcTile * kTcDepth * 2;               // 16 KB
constexpr int kTcSmem = kTcStages * 2 * kTcOperandBytes + 1024;      // + alignment slack
constexpr int kMaxGrid = 65535;               // gridDim.y's and gridDim.z's limit

// C (E, M, N) = A . B per expert.  kMnA: A is stored (E, K, M) (MN-major),
// else (E, M, K); kMnB: B is stored (E, K, N), else (E, N, K).  A stage
// holds A then B; a K-major operand as [128 rows][64 k], an MN-major one
// as [2 blocks of 64][64 k][64].
template <int kMnA, int kMnB>
__global__ void __launch_bounds__(kTcThreads, 1)
moe_gmm_wgmma_kernel(const __grid_constant__ CUtensorMap amap,
                     const __grid_constant__ CUtensorMap bmap, __nv_bfloat16* __restrict__ c,
                     int M, int N, int K, int e0, int mt0) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kTcStages], empty[kTcStages];
  uint8_t* smem = align1024(smem_raw);
  const int e = e0 + blockIdx.z, m0 = (mt0 + blockIdx.y) * kTcTile, n0 = blockIdx.x * kTcTile;
  const int nk = (K + kTcDepth - 1) / kTcDepth;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);              // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 8) {                          // producer
    if (lane == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % kTcStages, k0 = kt * kTcDepth;
        if (kt >= kTcStages) mbar_wait(&empty[s], (kt / kTcStages - 1) & 1);
        uint8_t* as = smem + s * 2 * kTcOperandBytes;
        uint8_t* bs = as + kTcOperandBytes;
        mbar_expect_tx(&full[s], 2 * kTcOperandBytes);
        if (kMnA) {
          tma_load_3d(as, &amap, &full[s], m0, k0, e);
          tma_load_3d(as + kTcOperandBytes / 2, &amap, &full[s], m0 + 64, k0, e);
        } else {
          tma_load_3d(as, &amap, &full[s], k0, m0, e);
        }
        if (kMnB) {
          tma_load_3d(bs, &bmap, &full[s], n0, k0, e);
          tma_load_3d(bs + kTcOperandBytes / 2, &bmap, &full[s], n0 + 64, k0, e);
        } else {
          tma_load_3d(bs, &bmap, &full[s], k0, n0, e);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of the tile
  const int wg = warp / 4;
  float acc[64];
#pragma unroll
  for (int j = 0; j < 64; ++j) acc[j] = 0.f;
  const uint32_t base = smem_u32(smem);
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % kTcStages;
    mbar_wait(&full[s], (kt / kTcStages) & 1);
    // A: this warpgroup's 64 rows are the wg-th 8 KB of either layout
    const uint32_t as = base + s * 2 * kTcOperandBytes + wg * (kTcOperandBytes / 2);
    const uint32_t bs = base + s * 2 * kTcOperandBytes + kTcOperandBytes;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTcDepth / 16; ++kk) {
      const uint64_t da = kMnA ? sw128_desc(as + kk * 2048, kTcOperandBytes / 2, 1024)
                               : sw128_desc(as + kk * 32, 16, 1024);
      const uint64_t db = kMnB ? sw128_desc(bs + kk * 2048, kTcOperandBytes / 2, 1024)
                               : sw128_desc(bs + kk * 32, 16, 1024);
      wgmma_ss_n128<kMnA, kMnB>(acc, da, db, 1);
    }
    wgmma_commit();
    fence_regs(acc);
    wgmma_wait<1>();                        // the previous stage's products are done
    if (kt > 0 && lane == 0) mbar_arrive(&empty[(kt - 1) % kTcStages]);
  }
  wgmma_wait<0>();
  fence_regs(acc);

  const int row0 = m0 + wg * 64 + (warp % 4) * 16 + lane / 4;
  const int col0 = n0 + 2 * (lane % 4);
  __nv_bfloat16* ce = c + static_cast<int64_t>(e) * M * N;
#pragma unroll
  for (int j = 0; j < 64; j += 2) {
    const int row = row0 + 8 * ((j >> 1) & 1), col = col0 + 8 * (j >> 2);
    if (row < M && col < N)
      *reinterpret_cast<__nv_bfloat162*>(ce + static_cast<int64_t>(row) * N + col) =
          __floats2bfloat162_rn(acc[j], acc[j + 1]);
  }
}

template <int kMnA, int kMnB>
int launch_wgmma(const void* a, const void* b, void* c, int E, int M, int N, int K,
                 cudaStream_t s) {
  if (K == 0) {    // no contraction: C is zero (a tensor map needs every extent > 0); no launch
    const cudaError_t e =
        cudaMemsetAsync(c, 0, static_cast<size_t>(E) * M * N * sizeof(__nv_bfloat16), s);
    return -static_cast<int>(e);
  }
  CUtensorMap amap, bmap;
  int rc = kMnA ? encode_bf16_3d(&amap, a, M, K, E, 64, 64)
                : encode_bf16_3d(&amap, a, K, M, E, 64, kTcTile);
  if (!rc)
    rc = kMnB ? encode_bf16_3d(&bmap, b, N, K, E, 64, 64)
              : encode_bf16_3d(&bmap, b, K, N, E, 64, kTcTile);
  if (rc) return -rc;
  const cudaError_t attr = cudaFuncSetAttribute(
      moe_gmm_wgmma_kernel<kMnA, kMnB>, cudaFuncAttributeMaxDynamicSharedMemorySize, kTcSmem);
  if (attr != cudaSuccess) return -static_cast<int>(attr);
  const int nm = (M + kTcTile - 1) / kTcTile;
  int made = 0;
  for (int e0 = 0; e0 < E; e0 += kMaxGrid)
    for (int mt0 = 0; mt0 < nm; mt0 += kMaxGrid) {
      const dim3 grid((N + kTcTile - 1) / kTcTile, nm - mt0 < kMaxGrid ? nm - mt0 : kMaxGrid,
                      E - e0 < kMaxGrid ? E - e0 : kMaxGrid);
      moe_gmm_wgmma_kernel<kMnA, kMnB><<<grid, kTcThreads, kTcSmem, s>>>(
          amap, bmap, static_cast<__nv_bfloat16*>(c), M, N, K, e0, mt0);
      const int rc = static_cast<int>(cudaGetLastError());
      if (rc) return -rc;
      ++made;
    }
  return made;
}

int launch_bf16(const void* a, const void* b, void* c, int E, int M, int N, int K, int trans_a,
                int trans_b, cudaStream_t s) {
  // TMA: 16-byte aligned bases and rows of a multiple of 8 elements
  const int a_cols = trans_a ? M : K, b_cols = trans_b ? K : N;
  if (a_cols % 8 || b_cols % 8 || N % 8 ||
      (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
       reinterpret_cast<uintptr_t>(c)) % 16)
    return -static_cast<int>(cudaErrorInvalidValue);
  // an operand stored with k contiguous is K-major for wgmma, else MN-major
  if (!trans_a && !trans_b) return launch_wgmma<0, 1>(a, b, c, E, M, N, K, s);
  if (!trans_a && trans_b) return launch_wgmma<0, 0>(a, b, c, E, M, N, K, s);
  if (trans_a && !trans_b) return launch_wgmma<1, 1>(a, b, c, E, M, N, K, s);
  return -static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// c (E, M, N) = op(a) . op(b) per expert, in one dtype (0 = float32 on the
// CUDA cores, 1 = bfloat16 on the tensor cores) for a, b and c.  trans_a:
// a is stored (E, K, M), else (E, M, K); trans_b: b is stored (E, N, K),
// else (E, K, N); not both.  bf16 needs 16-byte aligned pointers and rows
// (a's, b's and c's contiguous extents) of a multiple of 8 elements.
// Any E and M.  Returns the number of launches made (one unless E or the
// row tiles pass 65,535; none at K = 0, where c is zeroed), or minus a CUDA
// error: the call's refusal, or cudaGetLastError() after the launch that
// failed.
extern "C" int moe_gmm(const void* a, const void* b, void* c, int E, int M, int N, int K,
                       int trans_a, int trans_b, int dtype, void* stream) {
  if (dtype == 0) return moe_gmm_fp32(a, b, c, E, M, N, K, trans_a, trans_b, stream);
  if (E <= 0 || M <= 0 || N <= 0 || K < 0) return -static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_bf16(a, b, c, E, M, N, K, trans_a, trans_b, s);
  return -static_cast<int>(cudaErrorInvalidValue);
}
