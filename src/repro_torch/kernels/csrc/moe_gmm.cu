// K3: the grouped (per-expert) matmul, forward and backward, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/moe_gmm.py (_gmm_kernel /
// moe_gmm_pallas): y[e] = x[e] @ w[e] for every expert e, fp32
// accumulation, cast to the output's type.  The TPU kernel has no
// backward.  Here one kernel, templated on the layout of its two operands,
// computes for E independent experts
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
// Design.  This first version is plain and computes in fp32 on the CUDA
// cores (67 TFLOP/s at most), so it cannot come near that bound; a
// tensor-core version (mma / wgmma fed by TMA) is later work.  A block of
// 256 threads owns one 128 x 128 tile of C of one expert (grid: N/128,
// M/128, E) and walks the contraction in slabs of 16.  Each slab of both
// operands is converted to fp32 and stored k-major in shared memory
// (As[k][m], Bs[k][n]): an operand stored with k contiguous is transposed
// on its way in, so the inner loop reads both tiles with 16-byte loads
// whatever the layout.  The slabs are double-buffered and the next one is
// read from device memory into registers while the block computes on the
// current one, so one barrier per slab suffices.  Each thread keeps an
// 8 x 8 tile of C in fp32 registers (rows ty*4 + {0..3} and 64 + ty*4 +
// {0..3}, columns likewise from tx, so a warp's reads of Bs are
// contiguous).  Ragged M, N and K are handled by bounds checks (zeros are
// loaded past an edge, nothing is stored past one), so any shape is
// taken, and offsets are 64-bit (E*K*N passes 2^31 bytes at DBRX's widths).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 128;      // rows and columns of C per block
constexpr int kSlab = 16;       // contraction steps per shared-memory slab
constexpr int kThreads = 256;
constexpr int kPad = 4;         // keeps rows of the tiles 16-byte aligned
constexpr int kPerThread = kTile * kSlab / kThreads;   // 8 loads a slab

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

using Tile = float[kSlab][kTile + kPad];

// One slab of an operand, op[k][r] for k in [k0, k0+16) and r in the
// block's 128 rows of C (operand A) or columns (operand B), held in 8
// registers a thread.  kContigK: the operand is stored r-major with k
// contiguous (p[r * ld + k]); else k-major with r contiguous (p[k * ld +
// r]).  Neighbouring threads take neighbouring addresses either way.
template <typename T, bool kContigK>
struct Slab {
  float v[kPerThread];

  __device__ __forceinline__ static void coords(int i, int& r, int& k) {
    if (kContigK) {
      k = threadIdx.x % kSlab;
      r = threadIdx.x / kSlab + (kThreads / kSlab) * i;
    } else {
      r = threadIdx.x % kTile;
      k = threadIdx.x / kTile + (kThreads / kTile) * i;
    }
  }

  __device__ __forceinline__ void load(const T* __restrict__ p, int64_t ld, int r0, int nr,
                                       int k0, int nk) {
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      int r, k;
      coords(i, r, k);
      const int gr = r0 + r, gk = k0 + k;
      const int64_t at = kContigK ? static_cast<int64_t>(gr) * ld + gk
                                  : static_cast<int64_t>(gk) * ld + gr;
      v[i] = (gr < nr && gk < nk) ? to_f(p[at]) : 0.f;
    }
  }

  __device__ __forceinline__ void store(Tile& s) const {
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      int r, k;
      coords(i, r, k);
      s[k][r] = v[i];
    }
  }
};

// C (E, M, N) = op(A) (E, M, K) . op(B) (E, K, N) with fp32 accumulation.
// kTransA: A is stored (E, K, M), else (E, M, K).  kTransB: B is stored
// (E, N, K), else (E, K, N).
template <typename T, bool kTransA, bool kTransB>
__global__ void __launch_bounds__(kThreads, 2)
moe_gmm_kernel(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ c, int M,
               int N, int K) {
  __shared__ __align__(16) Tile As[2];
  __shared__ __align__(16) Tile Bs[2];
  const int64_t e = blockIdx.z;
  a += e * M * K;
  b += e * K * N;
  c += e * M * N;
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  const int64_t lda = kTransA ? M : K, ldb = kTransB ? K : N;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  Slab<T, !kTransA> sa;
  Slab<T, kTransB> sb;
  sa.load(a, lda, m0, M, 0, K);
  sb.load(b, ldb, n0, N, 0, K);

  float acc[8][8] = {};
  int buf = 0;
  for (int k0 = 0; k0 < K; k0 += kSlab) {
    sa.store(As[buf]);
    sb.store(Bs[buf]);
    __syncthreads();
    if (k0 + kSlab < K) {       // the next slab's loads overlap this slab's math
      sa.load(a, lda, m0, M, k0 + kSlab, K);
      sb.load(b, ldb, n0, N, k0 + kSlab, K);
    }
#pragma unroll
    for (int kk = 0; kk < kSlab; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[buf][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[buf][kk][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    buf ^= 1;
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (n < N) c[static_cast<int64_t>(m) * N + n] = from_f<T>(acc[i][j]);
    }
  }
}

template <typename T>
int launch(const void* a, const void* b, void* c, int E, int M, int N, int K, int trans_a,
           int trans_b, cudaStream_t s) {
  const dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile, E), block(kThreads);
  const T* ap = static_cast<const T*>(a);
  const T* bp = static_cast<const T*>(b);
  T* cp = static_cast<T*>(c);
  if (!trans_a && !trans_b)
    moe_gmm_kernel<T, false, false><<<grid, block, 0, s>>>(ap, bp, cp, M, N, K);
  else if (!trans_a && trans_b)
    moe_gmm_kernel<T, false, true><<<grid, block, 0, s>>>(ap, bp, cp, M, N, K);
  else if (trans_a && !trans_b)
    moe_gmm_kernel<T, true, false><<<grid, block, 0, s>>>(ap, bp, cp, M, N, K);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// c (E, M, N) = op(a) . op(b) per expert, in one dtype (0 = float32,
// 1 = bfloat16) for a, b and c.  trans_a: a is stored (E, K, M), else
// (E, M, K); trans_b: b is stored (E, N, K), else (E, K, N); not both.
// Returns cudaGetLastError() after the launch (0 on success); a refused
// launch is reported here.
extern "C" int moe_gmm(const void* a, const void* b, void* c, int E, int M, int N, int K,
                       int trans_a, int trans_b, int dtype, void* stream) {
  if (E <= 0 || M <= 0 || N <= 0 || K < 0 || E > 65535 ||
      (M + kTile - 1) / kTile > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, b, c, E, M, N, K, trans_a, trans_b, s);
  if (dtype == 1) return launch<__nv_bfloat16>(a, b, c, E, M, N, K, trans_a, trans_b, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
