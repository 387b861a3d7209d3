// K3 in fp32: the grouped (per-expert) matmul on the H100's CUDA cores,
// forward and both backward layouts (sm_90a).
//
// Replaces, for fp32 operands, the Pallas TPU kernel
// repro/kernels/moe_gmm.py (_gmm_kernel): y[e] = x[e] @ w[e] with fp32
// accumulation.  moe_gmm.cu's C entry point sends dtype 0 here; the bf16
// tensor-core kernel stays there.  Tensor cores take fp32 only as TF32,
// which would break the fp32 tolerance, so every product is an FFMA.  For
// E experts, C[e] = op(A)[e] . op(B)[e] in one of three layouts:
//
//   forward  x (E, M, K) . w (E, K, N)        A k-contiguous, B n-contiguous
//   dx       dy (E, M, N) . w (E, K, N)^T     A and B k-contiguous
//   dw       x (E, M, K)^T . dy (E, M, N)     A m-contiguous, B n-contiguous
//
// (M, N, K below are the product's own: dx has K = the layer's N.)
//
// Bounds on the H100 (3.35 TB/s, 67 TFLOP/s of fp32 FFMA).  DeepSeek-MoE-16B
// decodes with M = 4 rows an expert: (64, 4, 2048) . (64, 2048, 1408) moves
// 742 MB, almost all of it w, so 221 us by bytes; its FFMAs take 1.1 us.
// Its training shape (64, 448, 2048) . (64, 2048, 1408) does 165 GFLOP,
// 2.47 ms by operations (the 1.13 GB take 0.34 ms).  Two kernels follow
// from the two bounds; the launcher takes the first for M <= 32.
//
// Few rows (gmm_few_rows_kernel, M <= 32): a block of 8 warps owns all M
// rows of 128 columns of one expert, a row tile MT of M rounded up to 8
// (8, 16, 24 or 32), and streams w's 128 columns once, K in slabs of 32
// through a 3-stage cp.async ring of 16-byte copies (x's slab, MT x 32,
// rides along by 4-byte copies, stored k-major so every row's value is one
// broadcast read).  The 8 warps split each slab's contraction: warp w takes
// depths w, w + 8, ... (or, with B k-contiguous, depths 4w..4w+3), each
// lane 4 columns, MT x 4 sums in registers.  At the end the warps' partial
// sums go to shared memory and are added in warp order 0..7, a fixed order,
// so two runs give the same bits.  The grid is (N / 128) x E blocks (704 at
// the decode shape), enough to keep every SM's copies in flight.
//
// Many rows (gmm_tile_kernel): a block of 2 BM threads owns a BM x 128
// tile of C of one expert, BM = 64 where 128-row tiles would leave more
// rows empty (M = 448: 7 tiles of 64, not 3.5 of 128), else 128, and walks
// K in slabs of 16 through a 3-stage cp.async ring; 2 blocks of 256 or 4
// of 128 threads an SM (128 registers a thread).  Each thread keeps an
// 8 x 8 tile of C in registers and, per depth, reads its 8 rows of A and 8
// columns of B from [16][R] slabs by 16-byte shared loads: 64 FFMAs per 4
// loads.  An operand stored with rows contiguous lands in that layout; one
// stored with k contiguous lands as the copies' 16-byte chunks, and each
// thread moves the chunks it copied itself (its own copies need no
// barrier) into a double-buffered [16][R] slab, columns XOR-swizzled by
// depth so those writes hit 32 distinct banks: one barrier a slab.
//
// Both kernels load with 16-byte cp.async when the operand's base is
// 16-byte aligned and its contiguous extent a multiple of 4 floats, and
// with 4-byte ones otherwise; past a ragged edge the copies zero-fill, and
// nothing is stored past one, so any M, N and K is taken (K = 0 gives
// zeros).  Offsets are 64-bit (E*K*N passes 2^31 at DBRX's widths).
#include <cuda_runtime.h>

#include <cstdint>

#include "async_copy.cuh"

namespace {

using cuda_core::copies_commit;
using cuda_core::copies_wait;
using cuda_core::copy16;
using cuda_core::copy4;

constexpr int kThreads = 256;
constexpr int kMaxGrid = 65535;    // gridDim.y's and gridDim.z's limit: walked past in launches
constexpr int kFewStages = 3;

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// ---- few rows

constexpr int kFewCols = 128;      // columns of C a block
constexpr int kFewDepth = 32;      // contraction a slab
constexpr int kWarps = kThreads / 32;

template <int MT, bool kTransB>
struct FewShape {
  static constexpr int kA = kFewDepth * MT;                      // A slab, [k][MT]
  static constexpr int kBLd = kTransB ? kFewDepth + 4 : kFewCols;
  static constexpr int kB = kTransB ? kFewCols * kBLd : kFewDepth * kFewCols;
  static constexpr int kStage = kA + kB;
  static constexpr int kRed = kWarps * MT * kFewCols;          // the warps' partial sums
  static constexpr int kSmem =
      4 * (kFewStages * kStage > kRed ? kFewStages * kStage : kRed);
};

// Slab [k0, k0 + 32) of A (all M rows, as [k][MT]) and of B (columns
// [n0, n0 + 128)) into stage `st`.
template <int MT, bool kTransA, bool kTransB>
__device__ __forceinline__ void few_load(float* st, const float* a, const float* b,
                                         int64_t lda, int64_t ldb, int M, int N, int K, int n0,
                                         int k0, bool vec_b) {
  using F = FewShape<MT, kTransB>;
  float* as = st;
  float* bs = st + F::kA;
  for (int i = threadIdx.x; i < kFewDepth * MT; i += kThreads) {
    int m, k;
    if (kTransA) {
      k = i / MT;
      m = i % MT;
    } else {            // neighbouring threads on neighbouring k of a row
      m = i / kFewDepth;
      k = i % kFewDepth;
    }
    const bool in = m < M && k0 + k < K;
    const int64_t at = kTransA ? int64_t(k0 + k) * lda + m : int64_t(m) * lda + k0 + k;
    copy4(as + k * MT + m, in ? a + at : a, in ? 4 : 0);
  }
  if (vec_b) {
    for (int i = threadIdx.x; i < kFewDepth * kFewCols / 4; i += kThreads) {
      int n, k, left;
      if (kTransB) {
        n = i / (kFewDepth / 4);
        k = (i % (kFewDepth / 4)) * 4;
        left = n0 + n < N ? K - (k0 + k) : 0;
      } else {
        k = i / (kFewCols / 4);
        n = (i % (kFewCols / 4)) * 4;
        left = k0 + k < K ? N - (n0 + n) : 0;
      }
      const int cnt = min(4, max(0, left));
      const int64_t at = kTransB ? int64_t(n0 + n) * ldb + k0 + k : int64_t(k0 + k) * ldb + n0 + n;
      copy16(bs + (kTransB ? n * F::kBLd + k : k * kFewCols + n), cnt ? b + at : b, 4 * cnt);
    }
  } else {
    for (int i = threadIdx.x; i < kFewDepth * kFewCols; i += kThreads) {
      int n, k;
      if (kTransB) {
        n = i / kFewDepth;
        k = i % kFewDepth;
      } else {
        k = i / kFewCols;
        n = i % kFewCols;
      }
      const bool in = n0 + n < N && k0 + k < K;
      const int64_t at = kTransB ? int64_t(n0 + n) * ldb + k0 + k : int64_t(k0 + k) * ldb + n0 + n;
      copy4(bs + (kTransB ? n * F::kBLd + k : k * kFewCols + n), in ? b + at : b, in ? 4 : 0);
    }
  }
}

// kTransA: A is stored (E, K, M), else (E, M, K).  kTransB: B is stored
// (E, N, K), else (E, K, N).  M <= MT.
template <int MT, bool kTransA, bool kTransB>
__global__ void __launch_bounds__(kThreads)
gmm_few_rows_kernel(const float* __restrict__ a, const float* __restrict__ b,
                    float* __restrict__ c, int M, int N, int K, int vec_b) {
  using F = FewShape<MT, kTransB>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);
  const int64_t e = blockIdx.z;
  a += e * M * K;
  b += e * K * N;
  c += e * M * N;
  const int n0 = blockIdx.x * kFewCols;
  const int64_t lda = kTransA ? M : K, ldb = kTransB ? K : N;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nslab = (K + kFewDepth - 1) / kFewDepth;

  for (int s = 0; s < kFewStages - 1; ++s) {
    if (s < nslab)
      few_load<MT, kTransA, kTransB>(sm + s * F::kStage, a, b, lda, ldb, M, N, K, n0,
                                     s * kFewDepth, vec_b);
    copies_commit();
  }
  float acc[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0.f;

  for (int t = 0; t < nslab; ++t) {
    copies_wait<kFewStages - 2>();     // slab t has landed (this thread's copies)
    __syncthreads();                // everyone's, and slab t - 1 is consumed
    const int tn = t + kFewStages - 1;
    if (tn < nslab)
      few_load<MT, kTransA, kTransB>(sm + (tn % kFewStages) * F::kStage, a, b, lda, ldb, M, N,
                                     K, n0, tn * kFewDepth, vec_b);
    copies_commit();
    const float* as = sm + (t % kFewStages) * F::kStage;
    const float* bs = as + F::kA;
    if (!kTransB) {
#pragma unroll
      for (int u = 0; u < kFewDepth / kWarps; ++u) {
        const int kk = warp + kWarps * u;
        const float4 bv = *reinterpret_cast<const float4*>(bs + kk * kFewCols + 4 * lane);
#pragma unroll
        for (int m4 = 0; m4 < MT; m4 += 4) {
          const float4 av = *reinterpret_cast<const float4*>(as + kk * MT + m4);
          const float ar[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            acc[m4 + r][0] = fmaf(ar[r], bv.x, acc[m4 + r][0]);
            acc[m4 + r][1] = fmaf(ar[r], bv.y, acc[m4 + r][1]);
            acc[m4 + r][2] = fmaf(ar[r], bv.z, acc[m4 + r][2]);
            acc[m4 + r][3] = fmaf(ar[r], bv.w, acc[m4 + r][3]);
          }
        }
      }
    } else {
      const int kk0 = 4 * warp;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 bv =
            *reinterpret_cast<const float4*>(bs + (lane + 32 * j) * F::kBLd + kk0);
        const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int m4 = 0; m4 < MT; m4 += 4) {
            const float4 av = *reinterpret_cast<const float4*>(as + (kk0 + u) * MT + m4);
            acc[m4][j] = fmaf(av.x, br[u], acc[m4][j]);
            acc[m4 + 1][j] = fmaf(av.y, br[u], acc[m4 + 1][j]);
            acc[m4 + 2][j] = fmaf(av.z, br[u], acc[m4 + 2][j]);
            acc[m4 + 3][j] = fmaf(av.w, br[u], acc[m4 + 3][j]);
          }
      }
    }
  }

  // the warps' partial sums, added in warp order (the ring is free now)
  copies_wait<0>();
  __syncthreads();
  float* red = sm;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    float* row = red + (warp * MT + m) * kFewCols;
    if (!kTransB) {
      *reinterpret_cast<float4*>(row + 4 * lane) =
          make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) row[lane + 32 * j] = acc[m][j];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < MT * kFewCols; i += kThreads) {
    const int m = i / kFewCols, col = i % kFewCols;
    float sum = red[i];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) sum += red[w * MT * kFewCols + i];
    if (m < M && n0 + col < N) c[int64_t(m) * N + n0 + col] = sum;
  }
}

template <int MT, bool kTransA, bool kTransB>
int launch_few(const float* a, const float* b, float* c, int E, int M, int N, int K,
               bool vec_b, cudaStream_t s) {
  using F = FewShape<MT, kTransB>;
  const cudaError_t attr =
      cudaFuncSetAttribute(gmm_few_rows_kernel<MT, kTransA, kTransB>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, F::kSmem);
  if (attr != cudaSuccess) return -static_cast<int>(attr);
  int made = 0;
  for (int e0 = 0; e0 < E; e0 += kMaxGrid, ++made) {   // experts past the limit: pointers advanced
    const dim3 grid((N + kFewCols - 1) / kFewCols, 1, E - e0 < kMaxGrid ? E - e0 : kMaxGrid);
    const int64_t e = e0;
    gmm_few_rows_kernel<MT, kTransA, kTransB><<<grid, kThreads, F::kSmem, s>>>(
        a + e * M * K, b + e * K * N, c + e * M * N, M, N, K, vec_b);
    const int rc = static_cast<int>(cudaGetLastError());
    if (rc) return -rc;
  }
  return made;
}

// ---- many rows

constexpr int kSlab = 16;       // contraction a slab
constexpr int kTileStages = 3;

// BM rows of C a block (64 or 128) by 128 columns, 2 BM threads.
template <int BM, bool kTransA, bool kTransB>
struct TileShape {
  static constexpr int kThreads = 2 * BM;
  static constexpr int kA = kSlab * BM, kB = kSlab * 128;     // a slab of each operand
  static constexpr int kStage = kA + kB;
  // the k-contiguous operands' slabs transposed to [16][R], two of each
  static constexpr int kTA = kTransA ? 0 : 2 * kA;
  static constexpr int kTB = kTransB ? 2 * kB : 0;
  static constexpr int kSmem = 4 * (kTileStages * kStage + kTA + kTB);
};

// Chunk j of the thread's share of a slab (see tile_load).
template <int R, int NT, bool kContigK, bool kVec>
__device__ __forceinline__ void tile_chunk(float* s, const float* p, int64_t ld, int r0, int nr,
                                           int k0, int nk, int j) {
  const int c = threadIdx.x + NT * j;
  int r, k;
  float* dst;
  if (kContigK) {
    r = c / (kSlab / 4);
    k = 4 * (c % (kSlab / 4));
    dst = s + 4 * c;
  } else {
    k = c / (R / 4);
    r = 4 * (c % (R / 4));
    dst = s + k * R + r;
  }
  const int gr = r0 + r, gk = k0 + k;
  const int64_t at = kContigK ? int64_t(gr) * ld + gk : int64_t(gk) * ld + gr;
  if (kVec) {
    const int cnt = kContigK ? (gr < nr ? min(4, max(0, nk - gk)) : 0)
                             : (gk < nk ? min(4, max(0, nr - gr)) : 0);
    copy16(dst, cnt ? p + at : p, 4 * cnt);
  } else {
    for (int u = 0; u < 4; ++u) {
      const bool in = kContigK ? gr < nr && gk + u < nk : gk < nk && gr + u < nr;
      copy4(dst + u, in ? p + at + u : p, in ? 4 : 0);
    }
  }
}

// The thread's share of slab op[r][k], r in [r0, r0 + R), k in [k0, k0 +
// 16), of an operand stored p[r * ld + k] (kContigK) or p[k * ld + r]:
// chunks of 4 floats along the contiguous dimension, chunk c =
// threadIdx.x + NT j.  With k contiguous, chunk c holds row c / 4's depths
// 4 (c % 4) .. + 3 and lands at s + 4 c (tile_transpose then moves it);
// else depth c / (R / 4)'s rows 4 (c % (R / 4)) .. + 3, landing in place
// in [16][R].  kVec: one 16-byte copy a chunk, else four 4-byte ones.
template <int R, int NT, bool kContigK, bool kVec>
__device__ __forceinline__ void tile_load(float* s, const float* p, int64_t ld, int r0, int nr,
                                          int k0, int nk) {
  constexpr int kChunks = R * kSlab / 4 / NT;
  if (kVec) {
#pragma unroll
    for (int j = 0; j < kChunks; ++j)
      tile_chunk<R, NT, kContigK, true>(s, p, ld, r0, nr, k0, nk, j);
  } else {
#pragma unroll 1     // the rare unaligned call, rolled to keep within the registers
    for (int j = 0; j < kChunks; ++j)
      tile_chunk<R, NT, kContigK, false>(s, p, ld, r0, nr, k0, nk, j);
  }
}

// Row k of a transposed slab holds column r at r ^ tsw(k): the 4 lanes
// that copied one row's 16 depths (and the 8 rows of a warp's copies)
// then write 32 distinct banks, and groups of 4 columns stay whole.
__device__ __forceinline__ int tsw(int k) { return 8 * ((k >> 2) & 3); }

// The chunks this thread copied of a k-contiguous slab (landed at raw +
// 4 c), moved to [16][R]: its own copies need no barrier to be read.
template <int R, int NT>
__device__ __forceinline__ void tile_transpose(float* dst, const float* raw) {
#pragma unroll
  for (int j = 0; j < R * kSlab / 4 / NT; ++j) {
    const int c = threadIdx.x + NT * j;
    const int r = c / (kSlab / 4), k = 4 * (c % (kSlab / 4));
    const float4 x = *reinterpret_cast<const float4*>(raw + 4 * c);
    dst[k * R + (r ^ tsw(k))] = x.x;
    dst[(k + 1) * R + (r ^ tsw(k + 1))] = x.y;
    dst[(k + 2) * R + (r ^ tsw(k + 2))] = x.z;
    dst[(k + 3) * R + (r ^ tsw(k + 3))] = x.w;
  }
}

// kVec: 16-byte copies of both operands (else 4-byte ones).  A thread (tx,
// ty) owns rows 4 ty + {0..3} and BM/2 + 4 ty + {0..3} and columns 4 tx +
// {0..3} and 64 + 4 tx + {0..3} of the tile.
template <int BM, bool kTransA, bool kTransB, bool kVec>
__global__ void __launch_bounds__(2 * BM, 256 / BM)
gmm_tile_kernel(const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ c,
                int M, int N, int K, int mt0) {
  using T = TileShape<BM, kTransA, kTransB>;
  constexpr int NT = T::kThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);
  float* ta = sm + kTileStages * T::kStage;     // two transposed slabs of A
  float* tb = ta + T::kTA;                      // and of B
  const int64_t e = blockIdx.z;
  a += e * M * K;
  b += e * K * N;
  c += e * M * N;
  const int m0 = (mt0 + blockIdx.y) * BM, n0 = blockIdx.x * 128;
  const int64_t lda = kTransA ? M : K, ldb = kTransB ? K : N;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int nslab = (K + kSlab - 1) / kSlab;

  for (int s = 0; s < kTileStages - 1; ++s) {
    if (s < nslab) {
      tile_load<BM, NT, !kTransA, kVec>(sm + s * T::kStage, a, lda, m0, M, s * kSlab, K);
      tile_load<128, NT, kTransB, kVec>(sm + s * T::kStage + T::kA, b, ldb, n0, N, s * kSlab,
                                        K);
    }
    copies_commit();
  }
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int t = 0; t < nslab; ++t) {
    copies_wait<kTileStages - 2>();  // this thread's copies of slab t landed
    const float* as = sm + (t % kTileStages) * T::kStage;
    const float* bs = as + T::kA;
    if (!kTransA) {
      tile_transpose<BM, NT>(ta + (t & 1) * T::kA, as);
      as = ta + (t & 1) * T::kA;
    }
    if (kTransB) {
      tile_transpose<128, NT>(tb + (t & 1) * T::kB, bs);
      bs = tb + (t & 1) * T::kB;
    }
    __syncthreads();                // slab t complete for all; slab t - 1 consumed
    const int tn = t + kTileStages - 1;
    if (tn < nslab) {
      float* st = sm + (tn % kTileStages) * T::kStage;
      tile_load<BM, NT, !kTransA, kVec>(st, a, lda, m0, M, tn * kSlab, K);
      tile_load<128, NT, kTransB, kVec>(st + T::kA, b, ldb, n0, N, tn * kSlab, K);
    }
    copies_commit();
#pragma unroll
    for (int kk = 0; kk < kSlab; ++kk) {
      const int sa = kTransA ? 0 : tsw(kk), sb = kTransB ? tsw(kk) : 0;   // transposed slabs
      const float4 a0 = *reinterpret_cast<const float4*>(as + kk * BM + ((4 * ty) ^ sa));
      const float4 a1 =
          *reinterpret_cast<const float4*>(as + kk * BM + ((BM / 2 + 4 * ty) ^ sa));
      const float4 b0 = *reinterpret_cast<const float4*>(bs + kk * 128 + ((4 * tx) ^ sb));
      const float4 b1 = *reinterpret_cast<const float4*>(bs + kk * 128 + ((64 + 4 * tx) ^ sb));
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
  copies_wait<0>();

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + 4 * ty + (i & 3) + BM / 2 * (i >> 2);
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + 4 * tx + (j & 3) + 64 * (j >> 2);
      if (n < N) c[int64_t(m) * N + n] = acc[i][j];
    }
  }
}

template <int BM, bool kTransA, bool kTransB, bool kVec>
int launch_tile(const float* a, const float* b, float* c, int E, int M, int N, int K,
                cudaStream_t s) {
  using T = TileShape<BM, kTransA, kTransB>;
  const cudaError_t attr = cudaFuncSetAttribute(
      gmm_tile_kernel<BM, kTransA, kTransB, kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::kSmem);
  if (attr != cudaSuccess) return -static_cast<int>(attr);
  const int nm = (M + BM - 1) / BM;
  int made = 0;
  for (int e0 = 0; e0 < E; e0 += kMaxGrid)
    for (int mt0 = 0; mt0 < nm; mt0 += kMaxGrid) {   // row tiles past the limit: mt0 on
      const dim3 grid((N + 127) / 128, nm - mt0 < kMaxGrid ? nm - mt0 : kMaxGrid,
                      E - e0 < kMaxGrid ? E - e0 : kMaxGrid);
      const int64_t e = e0;
      gmm_tile_kernel<BM, kTransA, kTransB, kVec><<<grid, T::kThreads, T::kSmem, s>>>(
          a + e * M * K, b + e * K * N, c + e * M * N, M, N, K, mt0);
      const int rc = static_cast<int>(cudaGetLastError());
      if (rc) return -rc;
      ++made;
    }
  return made;
}

template <int BM, bool kTransA, bool kTransB>
int launch_tile_vec(const float* a, const float* b, float* c, int E, int M, int N, int K,
                    bool vec, cudaStream_t s) {
  return vec ? launch_tile<BM, kTransA, kTransB, true>(a, b, c, E, M, N, K, s)
             : launch_tile<BM, kTransA, kTransB, false>(a, b, c, E, M, N, K, s);
}

template <bool kTransA, bool kTransB>
int launch_layout(const float* a, const float* b, float* c, int E, int M, int N, int K,
                  cudaStream_t s) {
  const int64_t lda = kTransA ? M : K, ldb = kTransB ? K : N;
  const int vec = (aligned16(a) && lda % 4 == 0 ? 1 : 0) | (aligned16(b) && ldb % 4 == 0 ? 2 : 0);
  if (M <= 8) return launch_few<8, kTransA, kTransB>(a, b, c, E, M, N, K, vec & 2, s);
  if (M <= 16) return launch_few<16, kTransA, kTransB>(a, b, c, E, M, N, K, vec & 2, s);
  if (M <= 24) return launch_few<24, kTransA, kTransB>(a, b, c, E, M, N, K, vec & 2, s);
  if (M <= 32) return launch_few<32, kTransA, kTransB>(a, b, c, E, M, N, K, vec & 2, s);
  // 64-row tiles where 128-row ones would leave more rows empty (M = 448:
  // 7 tiles of 64, not 3.5 of 128)
  if (M % 128 != 0 && M % 128 <= 64)
    return launch_tile_vec<64, kTransA, kTransB>(a, b, c, E, M, N, K, vec == 3, s);
  return launch_tile_vec<128, kTransA, kTransB>(a, b, c, E, M, N, K, vec == 3, s);
}

}  // namespace

// c (E, M, N) = op(a) . op(b) per expert in fp32; trans_a: a is stored
// (E, K, M), else (E, M, K); trans_b: b is stored (E, N, K), else (E, K,
// N); not both; any E and M.  Returns the number of launches made (one
// unless E or the row tiles pass 65,535), or minus a CUDA error: the
// call's refusal, or cudaGetLastError() after the launch that failed.
extern "C" int moe_gmm_fp32(const void* a, const void* b, void* c, int E, int M, int N, int K,
                            int trans_a, int trans_b, void* stream) {
  if (E <= 0 || M <= 0 || N <= 0 || K < 0) return -static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ap = static_cast<const float*>(a);
  const float* bp = static_cast<const float*>(b);
  float* cp = static_cast<float*>(c);
  if (!trans_a && !trans_b) return launch_layout<false, false>(ap, bp, cp, E, M, N, K, s);
  if (!trans_a && trans_b) return launch_layout<false, true>(ap, bp, cp, E, M, N, K, s);
  if (trans_a && !trans_b) return launch_layout<true, false>(ap, bp, cp, E, M, N, K, s);
  return -static_cast<int>(cudaErrorInvalidValue);
}
