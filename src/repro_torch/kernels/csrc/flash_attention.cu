// K2: FlashAttention-2 forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (_flash_fwd_kernel / flash_attention_fwd_pallas).  For q (B, Hq, Sq, D)
// and k, v (B, Hkv, Skv, D), contiguous, it writes
//
//   out (B, Hq, Sq, D) in q's type     = softmax(q k^T * D^-0.5 + mask) v
//   lse (B, Hq, Sq)    in fp32         = m + log(max(l, 1e-30))
//
// with an online softmax in fp32 over KV tiles, GQA through KV head
// h / (Hq / Hkv), keys masked by kpos < Skv, when causal by kpos <= qpos,
// and with a sliding window W > 0 by kpos > qpos - W, where qpos is the
// query row plus q_offset.  Writing lse lets the backward skip a second
// forward.  KV tiles wholly above the causal diagonal or wholly below
// every row's window are skipped.
//
// A window leaves a row's first computed tile wholly masked for that row
// when other rows of its block still see keys there.  The row's m then
// stays at -1e30, so its p is 1 on those masked keys and l and acc take
// them in; the first tile where the row sees a key sets a finite m, and
// that tile's corr = exp(-1e30 - m) is exactly 0, which clears them.  So
// every row must see at least one key: the wrapper refuses a window
// under which the last query row sees none (q_offset + Sq - W >= Skv).
//
// Head dims: every D with D % 8 == 0 and D >= 8 (the wrapper pads any
// other D with zero columns to a multiple of 8).  Up to 256 each kernel
// is instantiated at DPAD = 64, 128 and 256 and runs a D on the next of
// the three; past 256 the wide kernels below run it (bf16
// flash_fwd_wgmma_wide_kernel here, fp32 flash_fwd_fp32_wide_kernel).
// The columns D..DPAD-1 of q, k and v are zeros (the bf16 tensor maps
// have D columns and zero-fill the rest of each 64-column box; the fp32
// kernel's copies zero-fill them), so they add nothing to
// q k^T and give zero output columns, which are not stored.  A padded D
// pays DPAD's matmul work (80 runs as 128).  D % 8 == 0 keeps TMA's global
// row stride a multiple of 16 bytes.  The bf16 kernel keeps D = 64, 128
// and 256 on instantiations of their own (kPad false): sharing the padded
// one's runtime row stride and column test made them a few per cent
// slower on the H100.
//
// DPAD = 256.  A consumer warpgroup's 64 x 256 fp32 O would be 128
// registers a thread before S and P, and q (64 KB) beside K and V stages
// of 64 keys at 256 columns (64 KB each) leaves room for one stage.  So
// two blocks share each query block: both compute S = q k^T over all 256
// columns, and each computes O for 128 of them, loading only its half of
// V.  They run the same instructions on the same values, so their S, m
// and l are the same bits; the first writes lse.  Each keeps D = 128's
// registers, and its ring keeps three stages of K (32 KB) and its half of
// V (16 KB) beside q: 209 KB.  S's products are done twice (1.5x the MMA
// work of one block); the two blocks are neighbours in the grid, so the
// second reads K from L2.
//
// Bound on the H100: at the training shapes (S = 1024, causal) the bytes
// of q, k, v, out and lse bound the call (10.1 us at D = 64, 20.1 us at
// D = 128), the tensor-core flops of the two products close behind; at
// (4, 16/8, 1024, 512) the flops (68.7 GFLOP, 69.5 us; its bytes ~201 MB,
// 60 us).
//
// Grid: blocks over (b, h, the blocks sharing a query block) in x and
// query blocks in y, the longest rows first; query blocks past y's limit
// of 65,535 go on in z (query_grid), so any Sq runs.
//
// bf16: tensor cores fed by TMA (flash_fwd_wgmma_kernel), DPAD = 64 or 128.
// A block of 288 threads owns 128 query rows of one (b, h): two consumer
// warpgroups of 64 rows and one producer warp.  TMA loads the q tile once
// and streams K and V tiles of BN keys (128 at D = 64, 64 at D = 128)
// through a 3-stage ring guarded by full and empty mbarriers; 3-D tensor
// maps over (B*H, S, D) zero-fill the ragged ends of Sq and Skv.  Per tile
// a warpgroup computes S = q k^T with one chain of wgmma (q and k both
// K-major in shared memory), runs the online softmax on the accumulator
// fragments in registers (a row's values sit in a quad of threads: two
// shuffles for the max), converts P to bf16 in registers and feeds it as
// the register A operand of the second chain, O += P v, with v read from
// shared memory as an MN-major operand (the transpose bit): P never goes
// through shared memory.  Only tiles on the diagonal, past Skv or across
// the window's lower edge are masked.  With a window the producer starts
// at the block's first visible tile, and a warpgroup releases, without
// computing, the tiles below its own first row's window as it does those
// past its last row's diagonal.  Blocks are ordered so that the query
// blocks with the most KV tiles start first.  Two roundings differ from the TPU kernel, which
// casts q, k, v to fp32 and scales q before its product: the scale
// multiplies S in fp32 after the product (exact at D = 64, where it is
// 1/8; one fp32 rounding apart at D = 128), and P is rounded to bf16
// before P v (a relative error of at most 2^-9 per weight), while l sums
// the fp32 P, so lse keeps the fp32 tolerance.  The plain version
// (flash_attention_fwd_plain) repeats both for bf16 inputs.
//
// fp32 runs in flash_attention_fp32.cu (flash_attention_fwd_fp32), which
// the entry point below calls for dtype 0: each fp32 product there is three
// TF32 products on the tensor cores (split TF32), since TF32 alone would
// break the fp32 tolerance.  q is scaled after its fp32 cast there, as the
// TPU kernel does.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

extern "C" int flash_attention_fwd_fp32(const void* q, const void* k, const void* v, void* o,
                                        void* lse, int b, int hq, int hkv, int sq, int skv,
                                        int d, int causal, int q_offset, int window,
                                        float scale, int rows, void* stream);

namespace {

constexpr float kNegInf = -1e30f;

// ---- bf16 on the tensor cores

constexpr int kTcBQ = 128;        // query rows per block: two warpgroups of 64
constexpr int kTcThreads = 288;   // warps 0-7 consume, warp 8 loads
constexpr int kTcStages = 3;
constexpr int kMaxGridY = 65535;  // gridDim.y's limit: query blocks past it go to gridDim.z

// The grid over query blocks: y, and z for each further kMaxGridY.
inline dim3 query_grid(int x, int nqb) {
  return dim3(x, nqb < kMaxGridY ? nqb : kMaxGridY, (nqb + kMaxGridY - 1) / kMaxGridY);
}

template <int D>
struct TcShape {
  static constexpr int kBN = D == 64 ? 128 : 64;             // keys per tile
  static constexpr int kDO = D > 128 ? 128 : D;              // O's columns a block
  static constexpr int kHalves = D / kDO;                    // blocks a query block
  static constexpr int kChunks = D / 64;                     // 128-byte column blocks of q, K
  static constexpr int kOChunks = kDO / 64;                  // and of V
  static constexpr int kQBytes = kTcBQ * D * 2;
  static constexpr int kKBytes = kBN * D * 2;                // a K tile
  static constexpr int kVBytes = kBN * kDO * 2;              // a V tile: this block's columns
  static constexpr int kStageBytes = kKBytes + kVBytes;
  static constexpr int kSmem = kQBytes + kTcStages * kStageBytes + 1024;
};

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int acc) {
  if constexpr (N == 128) wgmma_ss_n128<0, 0>(d, da, db, acc);
  else wgmma_ss_n64<0, 0>(d, da, db, acc);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (N == 128) wgmma_rs_n128<1>(d, a, db, 1);
  else wgmma_rs_n64<1>(d, a, db, 1);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Shared memory: q as [D/64][128 rows][64], then per stage K as [D/64][BN
// keys][64] and V as [kDO/64][BN keys][64] (columns col0 on); every block
// of 64 columns is one TMA box.  D is the padded head dim; with kPad the
// tensors' rows hold d < D columns, and the boxes' columns past d arrive as
// zeros.  Without kPad, d == D.  kWindow
// compiles the sliding window's tile range and mask in (window > 0): with
// them in a runtime branch the calls without a window ran markedly slower
// on the H100 (the same registers, no spills).
template <int D, bool kPad, bool kWindow>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ o,
                       float* __restrict__ lse, int hq, int hkv, int sq, int skv, int d,
                       int causal, int q_offset, int window, float scale) {
  using T = TcShape<D>;
  constexpr int BN = T::kBN;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t q_full, full[kTcStages], empty[kTcStages];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* kv = smem + T::kQBytes;

  const int nqb = (sq + kTcBQ - 1) / kTcBQ, qb = blockIdx.z * gridDim.y + blockIdx.y;
  if (qb >= nqb) return;                                  // past the last z slab's blocks
  const int bh = blockIdx.x / T::kHalves;
  const int col0 = (blockIdx.x % T::kHalves) * T::kDO;   // this block's columns of O and v
  const int q0 = (nqb - 1 - qb) * kTcBQ;                  // the longest rows first
  const int kvh = (bh / hq) * hkv + (bh % hq) / (hq / hkv);
  const int rows_end = min(q0 + kTcBQ, sq);
  const int kv_end = causal ? min(skv, rows_end + q_offset) : skv;
  const int n_tiles = (kv_end + BN - 1) / BN;
  // with a window the block's tiles start at its first row's lowest key;
  // the ring counts tiles from there (j = i - t_lo)
  const int t_lo = kWindow ? max(0, q0 + q_offset - window + 1) / BN : 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(&q_full, 1);
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);              // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 8) {                          // producer
    if (lane == 0) {
      mbar_expect_tx(&q_full, T::kQBytes);
      for (int c = 0; c < T::kChunks; ++c)
        tma_load_3d(smem + c * kTcBQ * 128, &qmap, &q_full, c * 64, q0, bh);
      for (int i = t_lo; i < n_tiles; ++i) {
        const int j = i - t_lo, s = j % kTcStages;
        if (j >= kTcStages) mbar_wait(&empty[s], (j / kTcStages - 1) & 1);
        uint8_t* ks = kv + s * T::kStageBytes;
        uint8_t* vs = ks + T::kKBytes;
        mbar_expect_tx(&full[s], T::kStageBytes);
        for (int c = 0; c < T::kChunks; ++c)
          tma_load_3d(ks + c * BN * 128, &kmap, &full[s], c * 64, i * BN, kvh);
        for (int c = 0; c < T::kOChunks; ++c)
          tma_load_3d(vs + c * BN * 128, &vmap, &full[s], col0 + c * 64, i * BN, kvh);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows [wq0, wq0 + 64)
  const int wg = warp / 4;
  const int wq0 = q0 + 64 * wg;
  // tiles past this warpgroup's last visible key, or below its first
  // row's window, are only released (on the same empty barrier)
  const int w_kv_end = wq0 >= sq ? 0 : causal ? min(skv, min(wq0 + 64, sq) + q_offset) : skv;
  const int n_mine = (w_kv_end + BN - 1) / BN;
  const int t_mine = kWindow ? max(0, wq0 + q_offset - window + 1) / BN : 0;
  // the last row's lowest visible key: a tile starting below it straddles
  // the window's lower edge for some row
  const int w_lo_last = wq0 + 63 + q_offset - window + 1;
  const int row0 = wq0 + (warp % 4) * 16 + lane / 4;     // and row0 + 8
  constexpr int DO = T::kDO;
  float oacc[DO / 2];
#pragma unroll
  for (int j = 0; j < DO / 2; ++j) oacc[j] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const uint32_t qs = smem_u32(smem) + wg * 64 * 128;
  mbar_wait(&q_full, 0);

  for (int i = t_lo; i < n_tiles; ++i) {
    const int s = (i - t_lo) % kTcStages;
    mbar_wait(&full[s], ((i - t_lo) / kTcStages) & 1);
    if (i >= t_mine && i < n_mine) {
      const uint32_t ks = smem_u32(kv + s * T::kStageBytes);
      const uint32_t vs = ks + T::kKBytes;
      float sc[BN / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint64_t dq = sw128_desc(qs + (kk / 4) * kTcBQ * 128 + (kk % 4) * 32, 16, 1024);
        const uint64_t dk = sw128_desc(ks + (kk / 4) * BN * 128 + (kk % 4) * 32, 16, 1024);
        wgmma_ss<BN>(sc, dq, dk, kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      const int k0 = i * BN;
      const bool edge = k0 + BN > skv || (causal && k0 + BN - 1 > wq0 + q_offset) ||
                        (kWindow && k0 < w_lo_last);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < BN / 2; ++j) {
        float x = sc[j] * scale;
        if (edge) {
          const int kpos = k0 + 8 * (j >> 2) + 2 * (lane % 4) + (j & 1);
          const int qpos = row0 + 8 * ((j >> 1) & 1) + q_offset;
          if (kpos >= skv || (causal && kpos > qpos) || (kWindow && kpos <= qpos - window))
            x = kNegInf;
        }
        sc[j] = x;
        mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], x);
      }
      float corr[2], psum[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        corr[h] = __expf(m[h] - mx[h]);
        m[h] = mx[h];
      }
      uint32_t pa[BN / 16][4];
#pragma unroll
      for (int j = 0; j < BN / 2; j += 2) {
        const int h = (j >> 1) & 1;
        const float p0 = __expf(sc[j] - m[h]), p1 = __expf(sc[j + 1] - m[h]);
        psum[h] += p0 + p1;
        pa[j / 8][(j % 8) / 2] = pack_bf16(p0, p1);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + psum[h];
#pragma unroll
      for (int j = 0; j < DO / 2; ++j) oacc[j] *= corr[(j >> 1) & 1];

      fence_regs(oacc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wgmma_rs<DO>(oacc, pa[kk], sw128_desc(vs + kk * 2048, BN * 128, 1024));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(oacc);
    }
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // l is summed per thread over its own columns; the quad holds the row
  const size_t obase = static_cast<size_t>(bh) * sq;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const float denom = fmaxf(l[h], 1e-30f);
    const int row = row0 + 8 * h;
    if (row >= sq) continue;
    __nv_bfloat16* orow = o + (obase + row) * (kPad ? d : D) + col0 + 2 * (lane % 4);
#pragma unroll
    for (int j = 2 * h; j < DO / 2; j += 4)  // 8-column groups; d % 8 == 0
      if (!kPad || col0 + 8 * (j >> 2) < d)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * (j >> 2)) =
            __floats2bfloat162_rn(oacc[j] / denom, oacc[j + 1] / denom);
    if (lane % 4 == 0 && col0 == 0) lse[obase + row] = m[h] + logf(denom);
  }
}

template <int D, bool kPad, bool kWindow>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, void* lse, int b, int hq,
                 int hkv, int sq, int skv, int d, int causal, int q_offset, int window,
                 float scale, cudaStream_t s) {
  using T = TcShape<D>;
  // maps of d columns: a box's columns past d read as zeros
  CUtensorMap qmap, kmap, vmap;
  int rc = encode_bf16_3d(&qmap, q, d, sq, static_cast<uint64_t>(b) * hq, 64, kTcBQ);
  if (!rc) rc = encode_bf16_3d(&kmap, k, d, skv, static_cast<uint64_t>(b) * hkv, 64, T::kBN);
  if (!rc) rc = encode_bf16_3d(&vmap, v, d, skv, static_cast<uint64_t>(b) * hkv, 64, T::kBN);
  if (rc) return rc;
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<D, kPad, kWindow>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid = query_grid(b * hq * T::kHalves, (sq + kTcBQ - 1) / kTcBQ);
  flash_fwd_wgmma_kernel<D, kPad, kWindow><<<grid, kTcThreads, T::kSmem, s>>>(
      qmap, kmap, vmap, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), hq, hkv, sq,
      skv, d, causal, q_offset, window, scale);
  return static_cast<int>(cudaGetLastError());
}

// Head dims past 256 (any d % 8 == 0): q (128 rows x d) no longer fits
// shared memory beside a K stage, and a TMA box holds at most 256 columns.
// So S = q k^T is summed over 64-column slices of q and K, streamed by TMA
// through one ring with V: a KV tile of 64 keys is nc = ceil(d / 64) steps
// of a q slice (16 KB) and a K slice (8 KB), each a chain of 4 wgmma
// accumulating into S's registers, then one step of V's 64 keys by this
// block's 128 columns (16 KB), the online softmax and P v as in
// flash_fwd_wgmma_kernel.  ceil(d / 128) blocks share a query block, each
// O for 128 columns, all computing the same S, m and l bits; the first
// writes lse.  S's products are done ceil(d / 128) times in all, and q is
// read again for every KV tile (from L2).  kWideStages steps of 24 KB
// are in flight.  At (4, 16/8, 1024, 512) causal that is 2.5x the MMA
// work of one pass (S four times) against a bound of 69.5 us (68.7
// GFLOP); on an H100 80GB HBM3 at 700 W the call takes 0.67 ms (PERF.md),
// still 6.6x faster than SDPA, which past 256 falls back to its math
// backend.  Keeping S once (O's slices looped in one block, or O in
// shared memory) is left to a later redesign.
constexpr int kWideBN = 64;                              // keys a tile
constexpr int kWideStages = 6;
constexpr int kWideQBytes = kTcBQ * 64 * 2;              // a q slice: 128 rows x 64 columns
constexpr int kWideKBytes = kWideBN * 64 * 2;            // a K slice; V's tile is two of these
constexpr int kWideStageBytes = kWideQBytes + kWideKBytes;
constexpr int kWideSmem = kWideStages * kWideStageBytes + 1024;

template <bool kWindow>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_fwd_wgmma_wide_kernel(const __grid_constant__ CUtensorMap qmap,
                            const __grid_constant__ CUtensorMap kmap,
                            const __grid_constant__ CUtensorMap vmap,
                            __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int hq,
                            int hkv, int sq, int skv, int d, int causal, int q_offset,
                            int window, float scale) {
  constexpr int BN = kWideBN, DO = 128;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kWideStages], empty[kWideStages];
  uint8_t* smem = align1024(smem_raw);

  const int nqb = (sq + kTcBQ - 1) / kTcBQ, qb = blockIdx.z * gridDim.y + blockIdx.y;
  if (qb >= nqb) return;
  const int nh = (d + DO - 1) / DO, nc = (d + 63) / 64;
  const int bh = blockIdx.x / nh;
  const int col0 = (blockIdx.x % nh) * DO;                // this block's columns of O and v
  const int q0 = (nqb - 1 - qb) * kTcBQ;                  // the longest rows first
  const int kvh = (bh / hq) * hkv + (bh % hq) / (hq / hkv);
  const int rows_end = min(q0 + kTcBQ, sq);
  const int kv_end = causal ? min(skv, rows_end + q_offset) : skv;
  const int n_tiles = (kv_end + BN - 1) / BN;
  const int t_lo = kWindow ? max(0, q0 + q_offset - window + 1) / BN : 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kWideStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);              // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 8) {                          // producer: step j of tile i is slice c
    if (lane == 0) {
      int j = 0;
      for (int i = t_lo; i < n_tiles; ++i)
        for (int c = 0; c <= nc; ++c, ++j) {
          const int s = j % kWideStages;
          if (j >= kWideStages) mbar_wait(&empty[s], (j / kWideStages - 1) & 1);
          uint8_t* st = smem + s * kWideStageBytes;
          if (c < nc) {                     // q and K's columns [64 c, 64 c + 64)
            mbar_expect_tx(&full[s], kWideStageBytes);
            tma_load_3d(st, &qmap, &full[s], c * 64, q0, bh);
            tma_load_3d(st + kWideQBytes, &kmap, &full[s], c * 64, i * BN, kvh);
          } else {                          // V's tile, this block's 128 columns
            mbar_expect_tx(&full[s], 2 * kWideKBytes);
            tma_load_3d(st, &vmap, &full[s], col0, i * BN, kvh);
            tma_load_3d(st + kWideKBytes, &vmap, &full[s], col0 + 64, i * BN, kvh);
          }
        }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows [wq0, wq0 + 64), as in
  // flash_fwd_wgmma_kernel
  const int wg = warp / 4;
  const int wq0 = q0 + 64 * wg;
  const int w_kv_end = wq0 >= sq ? 0 : causal ? min(skv, min(wq0 + 64, sq) + q_offset) : skv;
  const int n_mine = (w_kv_end + BN - 1) / BN;
  const int t_mine = kWindow ? max(0, wq0 + q_offset - window + 1) / BN : 0;
  const int w_lo_last = wq0 + 63 + q_offset - window + 1;
  const int row0 = wq0 + (warp % 4) * 16 + lane / 4;     // and row0 + 8
  float oacc[DO / 2];
#pragma unroll
  for (int j = 0; j < DO / 2; ++j) oacc[j] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  int j = 0;
  for (int i = t_lo; i < n_tiles; ++i) {
    const bool mine = i >= t_mine && i < n_mine;
    float sc[BN / 2];
    for (int c = 0; c < nc; ++c, ++j) {
      const int s = j % kWideStages;
      mbar_wait(&full[s], (j / kWideStages) & 1);
      if (mine) {
        const uint32_t qs = smem_u32(smem + s * kWideStageBytes) + wg * 64 * 128;
        const uint32_t ks = smem_u32(smem + s * kWideStageBytes) + kWideQBytes;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<BN>(sc, sw128_desc(qs + kk * 32, 16, 1024), sw128_desc(ks + kk * 32, 16, 1024),
                       c > 0 || kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);
      }
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    const int s = j % kWideStages;
    mbar_wait(&full[s], (j / kWideStages) & 1);
    ++j;
    if (mine) {
      const uint32_t vs = smem_u32(smem + s * kWideStageBytes);
      const int k0 = i * BN;
      const bool edge = k0 + BN > skv || (causal && k0 + BN - 1 > wq0 + q_offset) ||
                        (kWindow && k0 < w_lo_last);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int jj = 0; jj < BN / 2; ++jj) {
        float x = sc[jj] * scale;
        if (edge) {
          const int kpos = k0 + 8 * (jj >> 2) + 2 * (lane % 4) + (jj & 1);
          const int qpos = row0 + 8 * ((jj >> 1) & 1) + q_offset;
          if (kpos >= skv || (causal && kpos > qpos) || (kWindow && kpos <= qpos - window))
            x = kNegInf;
        }
        sc[jj] = x;
        mx[(jj >> 1) & 1] = fmaxf(mx[(jj >> 1) & 1], x);
      }
      float corr[2], psum[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        corr[h] = __expf(m[h] - mx[h]);
        m[h] = mx[h];
      }
      uint32_t pa[BN / 16][4];
#pragma unroll
      for (int jj = 0; jj < BN / 2; jj += 2) {
        const int h = (jj >> 1) & 1;
        const float p0 = __expf(sc[jj] - m[h]), p1 = __expf(sc[jj + 1] - m[h]);
        psum[h] += p0 + p1;
        pa[jj / 8][(jj % 8) / 2] = pack_bf16(p0, p1);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + psum[h];
#pragma unroll
      for (int jj = 0; jj < DO / 2; ++jj) oacc[jj] *= corr[(jj >> 1) & 1];
      fence_regs(oacc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wgmma_rs<DO>(oacc, pa[kk], sw128_desc(vs + kk * 2048, BN * 128, 1024));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(oacc);
    }
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  const size_t obase = static_cast<size_t>(bh) * sq;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const float denom = fmaxf(l[h], 1e-30f);
    const int row = row0 + 8 * h;
    if (row >= sq) continue;
    __nv_bfloat16* orow = o + (obase + row) * d + col0 + 2 * (lane % 4);
#pragma unroll
    for (int jj = 2 * h; jj < DO / 2; jj += 4)   // 8-column groups; d % 8 == 0
      if (col0 + 8 * (jj >> 2) < d)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * (jj >> 2)) =
            __floats2bfloat162_rn(oacc[jj] / denom, oacc[jj + 1] / denom);
    if (lane % 4 == 0 && col0 == 0) lse[obase + row] = m[h] + logf(denom);
  }
}

template <bool kWindow>
int launch_wgmma_wide(const void* q, const void* k, const void* v, void* o, void* lse, int b,
                      int hq, int hkv, int sq, int skv, int d, int causal, int q_offset,
                      int window, float scale, cudaStream_t s) {
  CUtensorMap qmap, kmap, vmap;
  int rc = encode_bf16_3d(&qmap, q, d, sq, static_cast<uint64_t>(b) * hq, 64, kTcBQ);
  if (!rc) rc = encode_bf16_3d(&kmap, k, d, skv, static_cast<uint64_t>(b) * hkv, 64, kWideBN);
  if (!rc) rc = encode_bf16_3d(&vmap, v, d, skv, static_cast<uint64_t>(b) * hkv, 64, kWideBN);
  if (rc) return rc;
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_wgmma_wide_kernel<kWindow>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kWideSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid = query_grid(b * hq * ((d + 127) / 128), (sq + kTcBQ - 1) / kTcBQ);
  flash_fwd_wgmma_wide_kernel<kWindow><<<grid, kTcThreads, kWideSmem, s>>>(
      qmap, kmap, vmap, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), hq, hkv, sq,
      skv, d, causal, q_offset, window, scale);
  return static_cast<int>(cudaGetLastError());
}

int launch_bf16(const void* q, const void* k, const void* v, void* o, void* lse, int b, int hq,
                int hkv, int sq, int skv, int d, int causal, int q_offset, int window,
                float scale, cudaStream_t s) {
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (d > 256)
    return window > 0 ? launch_wgmma_wide<true>(q, k, v, o, lse, b, hq, hkv, sq, skv, d, causal,
                                                q_offset, window, scale, s)
                      : launch_wgmma_wide<false>(q, k, v, o, lse, b, hq, hkv, sq, skv, d, causal,
                                                 q_offset, window, scale, s);
#define FLASH_WGMMA(D, PAD, WIN)                                                          \
  launch_wgmma<D, PAD, WIN>(q, k, v, o, lse, b, hq, hkv, sq, skv, d, causal, q_offset, window, \
                            scale, s)
  if (window > 0) {
    if (d == 64) return FLASH_WGMMA(64, false, true);
    if (d == 128) return FLASH_WGMMA(128, false, true);
    if (d == 256) return FLASH_WGMMA(256, false, true);
    if (d < 64) return FLASH_WGMMA(64, true, true);
    if (d < 128) return FLASH_WGMMA(128, true, true);
    return FLASH_WGMMA(256, true, true);
  }
  if (d == 64) return FLASH_WGMMA(64, false, false);
  if (d == 128) return FLASH_WGMMA(128, false, false);
  if (d == 256) return FLASH_WGMMA(256, false, false);
  if (d < 64) return FLASH_WGMMA(64, true, false);
  if (d < 128) return FLASH_WGMMA(128, true, false);
  return FLASH_WGMMA(256, true, false);
#undef FLASH_WGMMA
}

}  // namespace

// dtype: 0 = float32 (split TF32), 1 = bfloat16 (wgmma); d % 8 == 0
// and d >= 8 (past 256 on the wide kernels); any Sq.  window: the sliding
// window W (0 = none).  Both need 16-byte aligned q, k, v and out.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   void* lse, int b, int hq, int hkv, int sq, int skv,
                                   int d, int causal, int q_offset, int window, float scale,
                                   int dtype, void* stream) {
  if (b <= 0 || hq <= 0 || hkv <= 0 || hq % hkv || sq <= 0 || skv <= 0 || d < 8 || d % 8 ||
      window < 0 || static_cast<int64_t>(b) * hq * ((d + 127) / 128) > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return flash_attention_fwd_fp32(q, k, v, o, lse, b, hq, hkv, sq, skv, d, causal, q_offset,
                                    window, scale, 0, stream);
  if (dtype == 1)
    return launch_bf16(q, k, v, o, lse, b, hq, hkv, sq, skv, d, causal, q_offset, window,
                       scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
