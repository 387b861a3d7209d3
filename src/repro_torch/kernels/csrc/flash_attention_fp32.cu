// K2 in fp32: the FlashAttention-2 forward, fp32 products on the H100's
// tensor cores by split TF32 (sm_90a).
//
// Replaces, for fp32 inputs, the Pallas TPU kernel
// repro/kernels/flash_attention.py (_flash_fwd_kernel): an online softmax
// in fp32 over KV tiles, q scaled after its fp32 cast.  flash_attention.cu's
// C entry point sends dtype 0 here; the bf16 kernel stays there, and its
// note holds the contract both kernels keep: out (B, Hq, Sq, D) and lse =
// m + log(max(l, 1e-30)) (B, Hq, Sq); GQA/MQA through KV head
// h / (Hq / Hkv); keys masked by kpos < Skv, when causal by kpos <= qpos,
// with a window W > 0 by kpos > qpos - W (qpos = row + q_offset), masked
// scores at -1e30; KV tiles wholly above the diagonal or below every row's
// window skipped; every D % 8 == 0 up to 256 run on DPAD = 64, 128 or 256
// with the columns past D read as zeros.
//
// Bound on the H100.  A causal (4, 16, 1024, 128) call does 4 D FLOPs per
// visible (query, key) pair, 17.2 GFLOP: 257 us at the 67 TFLOP/s of fp32
// FFMA (its 34 MB take 10 us).  TF32 alone (495 TFLOP/s) would break the
// fp32 tolerance, so every fp32 product a * b is three TF32 products: with
// a = ah + al, where ah is a's value on its top 19 bits (sign, exponent and
// the 10 mantissa bits a TF32 operand keeps; the tensor cores ignore an
// operand's low 13 bits) and al = a - ah exactly, a * b = ah bh + ah bl +
// al bh + al bl, and the last term (2^-20 of the product) and al's and
// bl's own low bits (2^-21) are what is dropped.  Three mma.sync a product
// put the bound of the work this kernel issues at 104 us (chip_smoke.py's
// bound_ms); the split costs a mask and a subtract an operand, no
// conversion instruction.
//
// A block of 2 BQ threads owns BQ = 128 query rows of one (b, h) (64 when
// B Hq blocks of 128 would not fill the 132 SMs): a warp 16 rows.  At
// DPAD = 256 two blocks share a (b, h) and its query rows, each computing
// S = q k^T over all 256 columns and O for 128 of them: a warp's 16 x 256
// tile of O alone would take 128 registers a thread.  The two compute the
// same S, m and l (the same instructions on the same values), the first
// writes lse, and S's products are done twice (1.5x the MMA work of one
// block); their blocks are neighbours, so the second reads K from L2.
// There BQ is 64 and the tiles hold 32 keys: q (256 wide) and two stages
// of K (256 wide) and V (128) fill 164 KB of shared memory.  q stays
// in shared memory, scaled once; K and V tiles of 64 keys stream through a
// 2-stage cp.async ring of 16-byte copies, the next tile's loads in flight
// behind the current tile's math.  Rows are padded (q and K by 4 floats, V
// by 8) so each fragment load of a warp hits 32 distinct banks.  Per tile
// a warp computes S = q k^T for its 16 rows and 64 keys as
// mma.m16n8k8 tiles (the accumulators' fragments in registers), runs the
// online softmax on them (a row's keys sit in a quad of threads: two
// shuffles for the max), moves P from the accumulators' layout to the A
// operand's by shuffles (P never goes through shared memory), and for each
// half of the columns of its 16 x DPAD tile of O in registers sums the
// tile's P v from zero and folds it in by FFMA, O = O corr + P v: the
// tensor cores' fp32 sums, whose rounding is not round-to-nearest, never
// run past one tile, and O's sum over all the keys rounds to nearest (on
// the H100 one sum over 32,768 keys on the cores drifts by 5e-4 when v's
// mean is 1).  A half's accumulators, not all of O's, take the 32
// registers that D = 128 leaves: a whole tile's spilled.  A warp
// skips a tile that masks all 16 of its rows (past its diagonal or below
// its window); l is summed per thread over its own keys and over the quad
// at the end.  A window can leave a row's first tile wholly masked while
// other rows of the block see keys there: that row's m stays at -1e30, its
// p is 1 on those keys, and the first tile where it sees a key sets a
// finite m whose corr = exp(-1e30 - m) is exactly 0, clearing them; the
// wrapper refuses a window under which the last row sees no key.  Blocks
// are ordered so that the query blocks with the most KV tiles start first.
#include <cuda_runtime.h>

#include <cstdint>

#include "async_copy.cuh"

namespace {

using cuda_core::copies_commit;
using cuda_core::copies_wait;
using cuda_core::copy16;

constexpr int kSms = 132;          // the H100 SXM's SMs: below that many blocks, BQ = 64
constexpr float kNegInf = -1e30f;

template <int D, int BQ>
struct FaShape {
  static constexpr int kThreads = 2 * BQ;       // a warp a group of 16 rows
  static constexpr int kBK = D > 128 ? 32 : 64;              // keys a tile
  static constexpr int kDO = D > 128 ? 128 : D;              // O's columns a block
  static constexpr int kHalves = D / kDO;                    // blocks a query block
  static constexpr int kLdQ = D + 4, kLdK = D + 4, kLdV = kDO + 8;   // row strides
  static constexpr int kQ = BQ * kLdQ;
  static constexpr int kK = kBK * kLdK, kV = kBK * kLdV;
  static constexpr int kSmem = 4 * (kQ + 2 * (kK + kV));
};

// x = hi + lo exactly, hi the value of x's top 19 bits (its sign,
// exponent and 10 mantissa bits: the TF32 value the tensor cores read
// from x's bits, which ignore the low 13) and lo the rest; the cores read
// lo to 11 significant bits too, so hi * hi' + hi * lo' + lo * hi' misses
// x x' by about 2^-21 of it.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x);
  lo = __float_as_uint(x - __uint_as_float(hi & 0xffffe000u));
}

// d += a . b on the tensor cores: a 16 x 8, b 8 x 8, TF32 in, fp32 out.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// the three products of fp32 a . b, the small ones first
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}

// Rows r0 .. r0 + n - 1 of a tensor whose rows are `stride` floats
// apart, W floats of each from g (the first column to load), into dst's
// rows LD floats apart: zeros past nmax rows and past `cols` columns.
template <int W, int LD>
__device__ __forceinline__ void load_rows(float* dst, const float* g, int r0, int n, int nmax,
                                          int cols, int stride, int nt) {
  constexpr int kChunks = W / 4;
  for (int i = threadIdx.x; i < n * kChunks; i += nt) {
    const int r = i / kChunks, col = 4 * (i % kChunks);
    const bool in = r0 + r < nmax && col < cols;
    copy16(dst + r * LD + col, in ? g + int64_t(r0 + r) * stride + col : g, in ? 16 : 0);
  }
}

template <int D, int BQ>
__global__ void __launch_bounds__(2 * BQ, 1)
flash_fwd_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      float* __restrict__ lse, int hq, int hkv, int sq, int skv, int d,
                      int causal, int q_offset, int window, float scale) {
  using S = FaShape<D, BQ>;
  constexpr int kNT = S::kThreads, kBK = S::kBK, kDO = S::kDO;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* ks = qs + S::kQ;                       // stages 0, 1
  float* vs = ks + 2 * S::kK;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int bh = blockIdx.x / S::kHalves;
  const int col0 = (blockIdx.x % S::kHalves) * kDO;     // this block's columns of O and v
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;     // the longest rows first
  const int kvh = (bh / hq) * hkv + (bh % hq) / (hq / hkv);
  const float* qg = q + int64_t(bh) * sq * d;
  const float* kg = k + int64_t(kvh) * skv * d;
  const float* vg = v + int64_t(kvh) * skv * d + col0;
  const int rows_end = min(q0 + BQ, sq);
  const int kv_end = causal ? min(skv, rows_end + q_offset) : skv;
  const int t_lo = window > 0 ? max(0, q0 + q_offset - window + 1) / kBK : 0;
  const int t_hi = (kv_end + kBK - 1) / kBK;

  load_rows<D, S::kLdQ>(qs, qg, q0, BQ, sq, d, d, kNT);
  if (t_lo < t_hi) {
    load_rows<D, S::kLdK>(ks, kg, t_lo * kBK, kBK, skv, d, d, kNT);
    load_rows<kDO, S::kLdV>(vs, vg, t_lo * kBK, kBK, skv, d - col0, d, kNT);
  }
  copies_commit();

  // a warp's rows 16 warp + g (ra) and + 8 (rb); O's columns col0 + 8 n + 2 t, + 1
  float oacc[kDO / 8][4];
#pragma unroll
  for (int n = 0; n < kDO / 8; ++n)
#pragma unroll
    for (int x = 0; x < 4; ++x) oacc[n][x] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const float* qw = qs + 16 * warp * S::kLdQ;
  const int qpos_a = q0 + 16 * warp + g + q_offset;

  for (int tt = t_lo; tt < t_hi; ++tt) {
    const int stage = (tt - t_lo) & 1;
    copies_wait<0>();
    __syncthreads();
    if (tt == t_lo) {               // q scaled after its cast, once
      for (int i = tid; i < S::kQ; i += kNT) qs[i] *= scale;
      __syncthreads();
    }
    if (tt + 1 < t_hi) {
      load_rows<D, S::kLdK>(ks + (stage ^ 1) * S::kK, kg, (tt + 1) * kBK, kBK, skv, d, d, kNT);
      load_rows<kDO, S::kLdV>(vs + (stage ^ 1) * S::kV, vg, (tt + 1) * kBK, kBK, skv, d - col0,
                              d, kNT);
    }
    copies_commit();
    const int k0 = tt * kBK;
    const int wq0 = q0 + 16 * warp + q_offset;
    if ((causal && k0 > wq0 + 15) || (window > 0 && k0 + kBK - 1 <= wq0 - window)) continue;
    const float* kt = ks + stage * S::kK;
    const float* vt = vs + stage * S::kV;

    // S = q k^T: this warp's 16 rows by kBK keys, 8 keys an n-tile
    float sacc[kBK / 8][4];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) sacc[j][x] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < D / 8; ++kk) {
      uint32_t ah[4], al[4];
      split(qw[g * S::kLdQ + 8 * kk + t], ah[0], al[0]);
      split(qw[(g + 8) * S::kLdQ + 8 * kk + t], ah[1], al[1]);
      split(qw[g * S::kLdQ + 8 * kk + t + 4], ah[2], al[2]);
      split(qw[(g + 8) * S::kLdQ + 8 * kk + t + 4], ah[3], al[3]);
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        uint32_t bh[2], bl[2];
        split(kt[(8 * j + g) * S::kLdK + 8 * kk + t], bh[0], bl[0]);
        split(kt[(8 * j + g) * S::kLdK + 8 * kk + t + 4], bh[1], bl[1]);
        mma3(sacc[j], ah, al, bh, bl);
      }
    }

    // the online softmax on the accumulators: a row's kBK keys sit in the
    // 4 threads of a quad
    const bool edge = k0 + kBK > skv || (causal && k0 + kBK - 1 > wq0) ||
                      (window > 0 && k0 <= wq0 + 15 - window);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int h = x >> 1;
        if (edge) {
          const int kpos = k0 + 8 * j + 2 * t + (x & 1), qpos = qpos_a + 8 * h;
          if (kpos >= skv || (causal && kpos > qpos) || (window > 0 && kpos <= qpos - window))
            sacc[j][x] = kNegInf;
        }
        mx[h] = fmaxf(mx[h], sacc[j][x]);
      }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      corr[h] = __expf(m[h] - mx[h]);
      m[h] = mx[h];
    }
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        sacc[j][x] = __expf(sacc[j][x] - m[x >> 1]);
        psum[x >> 1] += sacc[j][x];
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + psum[h];

    // O = O corr + P v: P's accumulator layout moved to the A operand's by
    // shuffles; then for each half of O's columns, the tile's P v summed on
    // the tensor cores from zero and folded into O by FFMA, so no
    // tensor-core sum runs longer than one tile
    const int src0 = 4 * g + (t >> 1), src1 = src0 + 2;
    float pa[kBK / 8][4];
#pragma unroll
    for (int kk = 0; kk < kBK / 8; ++kk) {
      const float x0 = __shfl_sync(0xffffffffu, sacc[kk][0], src0);
      const float x1 = __shfl_sync(0xffffffffu, sacc[kk][1], src0);
      const float y0 = __shfl_sync(0xffffffffu, sacc[kk][2], src0);
      const float y1 = __shfl_sync(0xffffffffu, sacc[kk][3], src0);
      const float z0 = __shfl_sync(0xffffffffu, sacc[kk][0], src1);
      const float z1 = __shfl_sync(0xffffffffu, sacc[kk][1], src1);
      const float w0 = __shfl_sync(0xffffffffu, sacc[kk][2], src1);
      const float w1 = __shfl_sync(0xffffffffu, sacc[kk][3], src1);
      pa[kk][0] = (t & 1) ? x1 : x0;          // (ra, key t)
      pa[kk][1] = (t & 1) ? y1 : y0;          // (rb, key t)
      pa[kk][2] = (t & 1) ? z1 : z0;          // (ra, key t + 4)
      pa[kk][3] = (t & 1) ? w1 : w0;          // (rb, key t + 4)
    }
    constexpr int kN = kDO / 16;              // n-tiles in half of this block's O
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float pv[kN][4];
#pragma unroll
      for (int j = 0; j < kN; ++j)
#pragma unroll
        for (int x = 0; x < 4; ++x) pv[j][x] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kBK / 8; ++kk) {
        uint32_t ah[4], al[4];
#pragma unroll
        for (int x = 0; x < 4; ++x) split(pa[kk][x], ah[x], al[x]);
#pragma unroll
        for (int j = 0; j < kN; ++j) {
          const int n = half * kN + j;
          uint32_t bh[2], bl[2];
          split(vt[(8 * kk + t) * S::kLdV + 8 * n + g], bh[0], bl[0]);
          split(vt[(8 * kk + t + 4) * S::kLdV + 8 * n + g], bh[1], bl[1]);
          mma3(pv[j], ah, al, bh, bl);
        }
      }
#pragma unroll
      for (int j = 0; j < kN; ++j)
#pragma unroll
        for (int x = 0; x < 4; ++x)
          oacc[half * kN + j][x] = fmaf(oacc[half * kN + j][x], corr[x >> 1], pv[j][x]);
    }
  }
  copies_wait<0>();

  const int64_t obase = int64_t(bh) * sq;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lh = l[h];
    lh += __shfl_xor_sync(0xffffffffu, lh, 1);
    lh += __shfl_xor_sync(0xffffffffu, lh, 2);
    const int row = q0 + 16 * warp + g + 8 * h;
    if (row >= sq) continue;
    const float denom = fmaxf(lh, 1e-30f);
#pragma unroll
    for (int n = 0; n < kDO / 8; ++n)
      if (col0 + 8 * n < d)
        *reinterpret_cast<float2*>(o + (obase + row) * d + col0 + 8 * n + 2 * t) =
            make_float2(oacc[n][2 * h] / denom, oacc[n][2 * h + 1] / denom);
    if (t == 0 && col0 == 0) lse[obase + row] = m[h] + logf(denom);
  }
}

template <int D, int BQ>
int launch(const float* q, const float* k, const float* v, float* o, float* lse, int b, int hq,
           int hkv, int sq, int skv, int d, int causal, int q_offset, int window, float scale,
           cudaStream_t s) {
  using S = FaShape<D, BQ>;
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_fp32_kernel<D, BQ>, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(b * hq * S::kHalves, (sq + BQ - 1) / BQ);
  flash_fwd_fp32_kernel<D, BQ><<<grid, S::kThreads, S::kSmem, s>>>(
      q, k, v, o, lse, hq, hkv, sq, skv, d, causal, q_offset, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// fp32 q (B, Hq, Sq, d), k and v (B, Hkv, Skv, d), out and lse; d % 8 == 0,
// 8 <= d <= 256; window 0 (none) or the sliding window; q, k, v and out
// 16-byte aligned.  rows: the query rows a block, 64 or 128 (64 only at
// d > 128), or 0 to choose (64 when B Hq blocks of 128 rows would not fill
// the SMs, and at d > 128; the entry point passes 0, the CPU emulation
// test 128 to reach that block on small grids).  Returns cudaGetLastError() after the launch (0 on success).
extern "C" int flash_attention_fwd_fp32(const void* q, const void* k, const void* v, void* o,
                                        void* lse, int b, int hq, int hkv, int sq, int skv,
                                        int d, int causal, int q_offset, int window,
                                        float scale, int rows, void* stream) {
  if (b <= 0 || hq <= 0 || hkv <= 0 || hq % hkv || sq <= 0 || skv <= 0 || d < 8 || d > 256 ||
      d % 8 || window < 0 || int64_t(b) * hq * 2 > 0x7fffffff || (sq + 63) / 64 > 65535 ||
      (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) rows = d > 128 || int64_t(b) * hq * ((sq + 127) / 128) < kSms ? 64 : 128;
  if ((rows != 64 && rows != 128) || (d > 128 && rows != 64))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qp = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  float* op = static_cast<float*>(o);
  float* lp = static_cast<float*>(lse);
#define FLASH_FP32(D, BQ) \
  launch<D, BQ>(qp, kp, vp, op, lp, b, hq, hkv, sq, skv, d, causal, q_offset, window, scale, s)
  if (d <= 64) return rows == 64 ? FLASH_FP32(64, 64) : FLASH_FP32(64, 128);
  if (d <= 128) return rows == 64 ? FLASH_FP32(128, 64) : FLASH_FP32(128, 128);
  return FLASH_FP32(256, 64);
#undef FLASH_FP32
}
