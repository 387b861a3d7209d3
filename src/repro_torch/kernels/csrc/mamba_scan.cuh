// K4 and K4-bwd: the Mamba-1 selective scan, forward and backward, for
// Hopper (sm_90a): the kernels and their launchers.  mamba_scan.cu holds
// the C interface; mamba_scan_{ff,fb,bf,bb}.cu build the instantiations
// for each pair of x's and dt's types (f fp32, b bf16), one nvcc each, in
// parallel.
//
// Replaces the Pallas TPU kernel repro/kernels/mamba_scan.py
// (mamba_scan_pallas and its inner `kernel`).  Per batch row b, channel c
// and state element n, over steps t:
//
//   a_t = exp(dt_t[c] * A[c,n]),   u_t = dt_t[c] * x_t[c]
//   h_t = a_t * h_{t-1} + u_t * B_t[n],   y_t[c] = sum_n h_t[c,n] * C_t[n]
//
// y is cast to x's type per step, as the TPU kernel does; the skip term
// x*D stays outside (in the wrapper), so its rounding matches the
// reference.  The TPU kernel's channel-major layout is not copied: here
// neighbouring threads take neighbouring channels, so the (B, S, C)
// tensors are read and written contiguously at every step as they lie.
//
// What it takes.  State sizes NP = 16, 32, 64 and 128, each built with
// its size known to the compiler: with a run-time state count (masked
// loads past it) ptxas spilled in most instantiations.  The wrapper runs
// any N from 1 to 128 on the next of them, its extra states padded with 0
// (A, B, C and h0), which stay 0 and add nothing to y or to any gradient.
// Each input in its own type, as the TPU kernel casts each one to fp32
// on its own: x (and y, dy, dx) fp32 or bf16, dt (and ddt) fp32 or bf16
// (a template type of its own, so an fp32 dt is never rounded to x's
// type); B and C in x's type in the 16-state forward (FwdBC) and fp32
// elsewhere, the wrapper widening them (exactly; they are (B, S, N),
// small).  A run-time type for B and C put converting loads at the top of
// each tile, where their latency showed (K4 at the Falcon shape took 293
// us against 215); widening them in the wrapper for the 16-state forward
// too cost it 15 us.
//
// Bound on the H100.  At the Falcon-Mamba shape (4, 1024, 8192, 16) bf16
// the forward reads x and dt and writes y and the saved states (~0.34 GB,
// ~100 us at 3.35 TB/s; ~0.20 GB, ~61 us, without the states, whose
// interval is the design's choice) and takes one exp per (b, t, c, n):
// 537M exps, which the special-function units (16 a clock per SM, 132
// SMs) need ~128 us for at 1.98 GHz.  Each exp comes with ~4 fp32
// operations on the CUDA cores (8x the SFU's rate), so the exps are the
// floor.  The backward takes 2.5 exps per element (below) and ~30 fp32
// operations, the channel sums included, and moves ~0.5 GB.  At Zamba2's
// SSD shape (4, 1024, 5120, 64), fp32 dt, the exps (1.34G, ~321 us) are
// the floor again; at N = 128 (the public Mamba-2 models' state size),
// 2.68G exps, ~642 us.
//
// Forward design.  A channel's NP states are held in registers by L
// lanes of one warp, 16 states each (L = 1 at 16 states, 2 at 32, 4 at
// 64, 8 at 128; the state arrays are indexed only by unrolled loop
// counters, so nothing goes to local memory), with A
// pre-scaled by log2(e) so each exp is one MUFU.EX2 (ex2.approx.ftz).  A
// lane's states are whole quads dealt to the L lanes in turn, so the L
// lanes read neighbouring 16-byte words of a row.  A block of 128 threads
// takes 128 / L channels of one batch row and walks the sequence in
// tiles of kTile steps.  x and dt are read straight from global memory,
// one coalesced load per warp and step, and the next tile's are loaded
// into registers while this tile computes.  B and C, the same for every
// channel, are staged in double-buffered shared memory, copied a tile
// ahead with cp.async (no registers held: with the next tile in
// registers the 64-state forward spilled), and read as float4s; y_t is a
// register sum, across the L lanes a butterfly of shuffles (the same bits
// on every lane), and is stored per step, coalesced.  One barrier per
// tile.  When a gradient is wanted, the forward also writes the state at
// the start of every chunk of kChunk steps (B, ceil(S/kChunk), C, N).
//
// The backward keeps the same layout and walks the chunks in reverse.
// In a chunk it recomputes the state at the start of each kSeg-step
// segment from the chunk's saved state (the first kChunk - kSeg steps
// once more), then, segment by segment in reverse, recomputes the
// segment's states into shared memory (a column per thread) and walks
// them backwards with g in registers:
//
//   g_t = dy_t[c] * C_t[n] + a_{t+1} * g_{t+1}      (g seeded with dhT)
//   dx_t[c]  = dt_t * sum_n g_t * B_t[n]
//   ddt_t[c] = x_t * sum_n g_t * B_t[n] + sum_n g_t * a_t * h_{t-1} * A[c,n]
//   dA[c,n] += g_t * a_t * h_{t-1} * dt_t
//   dB_t[n] += g_t * u_t,  dC_t[n] += dy_t[c] * h_t (over the channels)
//   dh0 = a_0 * g_0
//
// h_{t-1} is read from the segment's buffer (and carried to the next
// step back as its h_t), so a_t * h_{t-1} is not formed by cancellation.
// Exps per element: the reverse walk's a_t and the segment recompute's
// a_t, plus the segment starts' recompute, (kChunk - kSeg) / kChunk:
// 2.5 at kChunk = 16, kSeg = 8.  The sums over n are register sums, and
// across a channel's L lanes a butterfly.  The sums over channels, dB_t
// and dC_t, are a warp transpose-reduce over the warp's channels (each
// exchange halves the list of 2 NL values; two lists of NL above 16
// states, kSplitV), then a fixed-order sum over
// the block's 4 warps, written as one partial row per block; the sum
// over batch rows of dA is a per-row partial.  The wrapper adds the
// partials with torch.sum: no atomics, and the result is the same bits
// from run to run.  At 128 states a block's 128 threads hold 16 channels,
// and a partial row of dB and dC a block would be 671 MB each at
// (4, 1024, 5120, 128), four times the 168 MB at 64 states; so a block
// there walks kBwdGroups = 4 groups of 16 channels in turn, adding each
// group's sums to the partial rows the group before wrote (the same
// thread reads back its own store, in a fixed order): 64 channels a
// partial row, 168 MB.  Its shared memory (128 KB: the 64 KB of
// recomputed states as at 64 states, and twice the B, C and channel sums)
// leaves one block an SM, where the smaller sizes fit two.
//
// What limits them (measured on the H100; PERF.md has the numbers).
// Neither kernel reaches its exp floor: each warp's step is
// latency-bound, with about two warps per SM sub-partition at the Falcon
// shape.  In throwaway variants timed on the card, replacing every exp
// with an FFMA took little off either time, and dropping the backward's
// channel sums took off more.  The backward runs at the 255-register
// cap, which leaves the compiler no room to overlap one step's shuffles
// with the next step's work.  Two lanes per channel at N = 16 (twice the
// warps, half the states each) measured slower in both kernels, so lanes
// are split only where one thread's registers cannot hold the states.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <type_traits>

namespace k4 {

constexpr int kThreads = 128;            // threads per block
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 16;                // forward: steps per staged tile
constexpr int kChunk = 16;               // steps between saved states (CHUNK)
constexpr int kSeg = 8;                  // backward: steps of states held in shared memory
constexpr int kSegs = kChunk / kSeg;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
static_assert(kChunk % kTile == 0 && kChunk % kSeg == 0, "tiles and segments tile a chunk");

// Lanes that share one channel's NP states, 16 states each above 16
// (`lanes` in the wrapper).
template <int NP>
constexpr int kLanes = NP > 16 ? NP / 16 : 1;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 2^x in one MUFU.EX2.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// *p = v where pred holds, as one predicated store: no branch, so it
// does not split a block of unrolled steps.
__device__ __forceinline__ void store_if(float* p, float v, bool pred) {
  asm volatile("{ .reg .pred q; setp.ne.b32 q, %2, 0; @q st.global.f32 [%0], %1; }"
               ::"l"(p), "f"(v), "r"(static_cast<int>(pred)));
}
__device__ __forceinline__ void store_if(__nv_bfloat16* p, __nv_bfloat16 v, bool pred) {
  asm volatile("{ .reg .pred q; setp.ne.b32 q, %2, 0; @q st.global.b16 [%0], %1; }"
               ::"l"(p), "h"(__bfloat16_as_ushort(v)), "r"(static_cast<int>(pred)));
}

// The state that register k of lane `sub` (of a channel's L lanes)
// holds: the quads of a row are dealt to the lanes in turn, so the L
// lanes' reads of one quad each are neighbouring 16-byte words.
template <int L>
__device__ __forceinline__ int state_of(int sub, int k) {
  return 4 * ((k / 4) * L + sub) + k % 4;
}

// This lane's states of a row of NL * L floats (16-byte aligned), in
// global or shared memory.
template <int NL, int L>
__device__ __forceinline__ void load_row(float (&v)[NL], const float* p, int sub) {
#pragma unroll
  for (int q = 0; q < NL / 4; ++q) {
    const float4 f = reinterpret_cast<const float4*>(p)[q * L + sub];
    v[4 * q] = f.x;
    v[4 * q + 1] = f.y;
    v[4 * q + 2] = f.z;
    v[4 * q + 3] = f.w;
  }
}

template <int NL, int L>
__device__ __forceinline__ void store_row(float* p, const float (&v)[NL], int sub) {
#pragma unroll
  for (int q = 0; q < NL / 4; ++q)
    reinterpret_cast<float4*>(p)[q * L + sub] =
        make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
}

// A thread's column of a [N/4][kThreads] float4 buffer in shared memory:
// each quad is one conflict-free 16-byte access across the warp.
template <int N>
__device__ __forceinline__ void load_col(float (&v)[N], const float4 (*col)[kThreads],
                                         int tid) {
#pragma unroll
  for (int q = 0; q < N / 4; ++q) {
    const float4 f = col[q][tid];
    v[4 * q] = f.x;
    v[4 * q + 1] = f.y;
    v[4 * q + 2] = f.z;
    v[4 * q + 3] = f.w;
  }
}

template <int N>
__device__ __forceinline__ void store_col(float4 (*col)[kThreads], int tid,
                                          const float (&v)[N]) {
#pragma unroll
  for (int q = 0; q < N / 4; ++q)
    col[q][tid] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
}

// K steps [t, t + K) of channel c of a (batch, S, C) tensor; 0 past S or C.
template <typename T, int K>
__device__ __forceinline__ void load_steps(T (&v)[K], const T* __restrict__ p, size_t row0,
                                           int t, int S, int C, int c, bool active) {
#pragma unroll
  for (int r = 0; r < K; ++r)
    v[r] = (active && t + r < S) ? p[(row0 + t + r) * C + c] : from_f<T>(0.f);
}

// This thread's share of B and C (of type E) at steps [t, t + K): flat
// index tid + m * kThreads over [B or C][step][NP]; 0 past S.  They are
// widened only when stored (store_bc), so the loads' latency stays hidden.
template <typename E, int NP, int K>
__device__ __forceinline__ void load_bc(E (&v)[2 * K * NP / kThreads], const E* __restrict__ Bm,
                                        const E* __restrict__ Cm, size_t row0, int t, int S,
                                        int tid) {
  static_assert((2 * K * NP) % kThreads == 0, "B and C tiles split evenly over the block");
#pragma unroll
  for (int m = 0; m < 2 * K * NP / kThreads; ++m) {
    const int j = tid + m * kThreads, which = j / (K * NP), rem = j % (K * NP);
    const E* src = which ? Cm : Bm;
    v[m] = (t + rem / NP < S) ? src[(row0 + t) * NP + rem] : from_f<E>(0.f);
  }
}

// 16 bytes from global to shared memory without registers, or 16 zero
// bytes if not `full` (cp.async's source size 0; src must still be a
// valid address).
__device__ __forceinline__ void copy16_async(float* dst, const float* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               ::"r"(static_cast<unsigned>(__cvta_generic_to_shared(dst))), "l"(src),
               "r"(full ? 16 : 0));
}

// Waits for this thread's copies; a barrier then makes every thread's seen.
__device__ __forceinline__ void copies_wait() { asm volatile("cp.async.wait_all;" ::: "memory"); }

// This thread's share of the copies of B and C at steps [t, t + K) into
// flat [B or C][step][NP] in shared memory: 16-byte pieces tid + m *
// kThreads; zeros past S.
template <int NP, int K>
__device__ __forceinline__ void stage_bc(float* flat, const float* __restrict__ Bm,
                                         const float* __restrict__ Cm, size_t row0, int t,
                                         int S, int tid) {
  constexpr int kPieces = 2 * K * NP / 4, kHalf = kPieces / 2;
  static_assert(kPieces % kThreads == 0, "B and C tiles split evenly over the block");
#pragma unroll
  for (int m = 0; m < kPieces / kThreads; ++m) {
    const int j = tid + m * kThreads, rem = 4 * (j % kHalf);
    const bool in = t + rem / NP < S;
    const float* src = (j < kHalf ? Bm : Cm) + (row0 + (in ? t : 0)) * NP + (in ? rem : 0);
    copy16_async(flat + 4 * j, src, in);
  }
}

template <typename E, int NP, int K>
__device__ __forceinline__ void store_bc(float* flat, const E (&v)[2 * K * NP / kThreads],
                                         int tid) {
#pragma unroll
  for (int m = 0; m < 2 * K * NP / kThreads; ++m) flat[tid + m * kThreads] = to_f(v[m]);
}

// The forward's type of B and C: x's at 16 states, where they are staged
// through registers as x's and dt's next tile is; fp32 above, copied by
// cp.async (with the next tile of B and C in registers too, the 64-state
// forward spilled).
template <typename T, int NP>
using FwdBC = std::conditional_t<(NP > 16), float, T>;

// Sums each of M values over the lanes whose indices differ only in the
// bits O, O/2, ..., Stop.  Each exchange halves the list: the lanes whose
// bit O is set keep the upper half and add the partner's, the others the
// lower half, so M = 32 values over 32 lanes take 31 shuffles; once one
// value is left, the remaining bits are a butterfly.  Afterwards a lane
// holds in v[0, M') (M' = M >> the number of bits) the sums of the values
// from (its bits O..Stop as a number) * M' on.
template <int M, int O, int Stop, int Len>
__device__ __forceinline__ void lane_sum(float (&v)[Len], int lane) {
  if constexpr (O >= Stop) {
    if constexpr (M > 1) {
      const bool upper = (lane & O) != 0;
#pragma unroll
      for (int i = 0; i < M / 2; ++i) {
        const float send = upper ? v[i] : v[i + M / 2];
        const float keep = upper ? v[i + M / 2] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
      }
      lane_sum<M / 2, O / 2, Stop>(v, lane);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], O);
      lane_sum<1, O / 2, Stop>(v, lane);
    }
  }
}

// The sum of v over a channel's L lanes (lanes differing in bits L/2..1):
// a butterfly, so every lane gets the same bits.
template <int L>
__device__ __forceinline__ float lanes_sum(float v) {
#pragma unroll
  for (int o = 1; o < L; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The forward over one tile's steps (all kTile of them when kFull):
// advances the states h and stores y_t.  y's sum over n runs in 4
// partial sums, a shorter chain.  No branch (not even the store's: it is
// predicated) splits the unrolled steps, so the compiler overlaps each
// step's latencies with the next one's work.
template <typename T, typename TD, int NP, bool kFull>
__device__ __forceinline__ void fwd_tile(float (&h)[NP / kLanes<NP>],
                                         const float (&a2)[NP / kLanes<NP>],
                                         const T (&xr)[kTile], const TD (&dr)[kTile],
                                         const float (*sB)[NP], const float (*sC)[NP],
                                         T* __restrict__ y, size_t off, int C, int nt, int sub,
                                         bool writer) {
  constexpr int L = kLanes<NP>, NL = NP / L;
#pragma unroll
  for (int r = 0; r < kTile; ++r) {
    if (kFull || r < nt) {
      const float d = to_f(dr[r]), u = d * to_f(xr[r]);
      float Bv[NL], Cv[NL], ys[4] = {0.f, 0.f, 0.f, 0.f};
      load_row<NL, L>(Bv, sB[r], sub);
      load_row<NL, L>(Cv, sC[r], sub);
#pragma unroll
      for (int k = 0; k < NL; ++k) {
        h[k] = fmaf(h[k], ex2(d * a2[k]), u * Bv[k]);
        ys[k % 4] = fmaf(h[k], Cv[k], ys[k % 4]);
      }
      const float yv = lanes_sum<L>((ys[0] + ys[1]) + (ys[2] + ys[3]));
      store_if(y + off + static_cast<size_t>(r) * C, from_f<T>(yv), writer);
    }
  }
}

// Blocks per SM the forward is compiled for above 16 states: three (a
// 170-register budget), which they fit without spilling at 32 and 64;
// left to itself ptxas took ~250 registers at 64 states (two blocks an
// SM).  At 128 states three spilled (4-16 bytes), so two (~246 registers).
// The 16-state forward keeps its own choice (~168), as before: under 170
// its fp32 instantiation spilled.
template <int NP>
constexpr int kFwdBlocks = NP > 64 ? 2 : NP > 16 ? 3 : 1;

template <typename T, typename TD, int NP>
__global__ void __launch_bounds__(kThreads, kFwdBlocks<NP>)
mamba_scan_fwd_kernel(const T* __restrict__ x, const TD* __restrict__ dt,
                      const float* __restrict__ A, const FwdBC<T, NP>* __restrict__ Bm,
                      const FwdBC<T, NP>* __restrict__ Cm, const float* __restrict__ h0,
                      T* __restrict__ y, float* __restrict__ hT, float* __restrict__ hs,
                      int S, int C) {
  constexpr int L = kLanes<NP>, NL = NP / L;
  __shared__ __align__(16) float sBC[2][2][kTile][NP];   // [buffer][B, C][step][state]
  const int tid = threadIdx.x, sub = tid % L, b = blockIdx.y;
  const int c = blockIdx.x * (kThreads / L) + tid / L;
  const bool active = c < C, writer = active && sub == 0;
  const int nchunk = (S + kChunk - 1) / kChunk;
  const size_t row0 = static_cast<size_t>(b) * S;
  const size_t st = (static_cast<size_t>(b) * C + c) * NP;
  float a2[NL], h[NL];
#pragma unroll
  for (int k = 0; k < NL; ++k) a2[k] = h[k] = 0.f;
  if (active) {
    load_row<NL, L>(a2, A + static_cast<size_t>(c) * NP, sub);
    if (h0) load_row<NL, L>(h, h0 + st, sub);
  }
#pragma unroll
  for (int k = 0; k < NL; ++k) a2[k] *= kLog2e;

  constexpr bool kCopies = NP > 16;        // B and C by cp.async, else through registers
  constexpr int kBC = kCopies ? 1 : 2 * kTile * NP / kThreads;
  T xr[kTile];
  TD dr[kTile];
  FwdBC<T, NP> bc[kBC];
  load_steps<T, kTile>(xr, x, row0, 0, S, C, c, active);
  load_steps<TD, kTile>(dr, dt, row0, 0, S, C, c, active);
  if constexpr (kCopies) {
    stage_bc<NP, kTile>(&sBC[0][0][0][0], Bm, Cm, row0, 0, S, tid);
    copies_wait();
  } else {
    load_bc<T, NP, kTile>(bc, Bm, Cm, row0, 0, S, tid);
    store_bc<T, NP, kTile>(&sBC[0][0][0][0], bc, tid);
  }
  __syncthreads();
  for (int t0 = 0, i = 0; t0 < S; t0 += kTile, ++i) {
    const int nt = min(kTile, S - t0);
    T xn[kTile];                            // the next tile, in flight while this one runs
    TD dn[kTile];
    load_steps<T, kTile>(xn, x, row0, t0 + kTile, S, C, c, active);
    load_steps<TD, kTile>(dn, dt, row0, t0 + kTile, S, C, c, active);
    // every thread is past the last tile's barrier, so none reads this buffer now
    if constexpr (kCopies)
      stage_bc<NP, kTile>(&sBC[(i + 1) & 1][0][0][0], Bm, Cm, row0, t0 + kTile, S, tid);
    else
      load_bc<T, NP, kTile>(bc, Bm, Cm, row0, t0 + kTile, S, tid);
    if (hs && active && t0 % kChunk == 0)
      store_row<NL, L>(hs + ((static_cast<size_t>(b) * nchunk + t0 / kChunk) * C + c) * NP, h,
                       sub);
    const size_t off = (row0 + t0) * C + c;
    if (nt == kTile)
      fwd_tile<T, TD, NP, true>(h, a2, xr, dr, sBC[i & 1][0], sBC[i & 1][1], y, off, C, nt,
                                sub, writer);
    else
      fwd_tile<T, TD, NP, false>(h, a2, xr, dr, sBC[i & 1][0], sBC[i & 1][1], y, off, C, nt,
                                 sub, writer);
    if constexpr (kCopies)
      copies_wait();
    else
      store_bc<T, NP, kTile>(&sBC[(i + 1) & 1][0][0][0], bc, tid);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kTile; ++r) {
      xr[r] = xn[r];
      dr[r] = dn[r];
    }
  }
  if (active) store_row<NL, L>(hT + st, h, sub);
}

// Buffers of the per-warp channel sums: two (written and read in turn,
// one barrier a segment) where they fit beside two blocks an SM, else one
// (a second barrier a segment).
template <int NP>
constexpr int kRedBufs = NP > 32 ? 1 : 2;

template <int NP>
struct BwdSmem {
  static constexpr int NL = NP / kLanes<NP>;
  float4 hbuf[kSeg][NL / 4][kThreads];   // the segment's recomputed states, a column a thread
  float4 ck[kSegs][NL / 4][kThreads];    // the state at the start of each segment of the chunk
  float sBC[2][kChunk][NP];              // the chunk's B and C
  float red[kRedBufs<NP>][kSeg][kWarps][2 * NP];   // per-warp channel sums of dB_t, dC_t
};

// Whether the backward sums dC_t's terms over channels apart from dB_t's
// (two lists of NL values a lane, the first summed before the walk needs
// its registers), or both in one list of 2 NL: split where a channel's
// states span several lanes, whose extra shuffles and sums made ptxas
// spill otherwise.
template <int NP>
constexpr bool kSplitV = kLanes<NP> > 1;

// A lane's share of a warp's channel sums, after lane_sum over a list of
// Len = 2 NL values (dB_t's, then dC_t's) or of NL values (dC_t's when
// kDC, else dB_t's): lanes hold kPer sums each, kSpread lanes the same
// ones.  `row` is the warp's [2 NP] row of sums.
template <int NP, bool kDC, int Len>
__device__ __forceinline__ void put_red(float* row, const float (&v)[Len], int lane) {
  constexpr int L = kLanes<NP>, NL = NP / L;
  constexpr int kPer = Len * L >= 32 ? Len * L / 32 : 1;
  constexpr int kSpread = Len * L >= 32 ? 1 : 32 / (Len * L);
  const int sub = lane % L;
  if (lane % kSpread == 0) {
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      // the lane's p-th sum is value i of its list
      const int i = (lane / L) * kPer / kSpread + p;
      const int which = Len == NL ? kDC : i / NL;
      row[which * NP + state_of<L>(sub, i % NL)] = v[p];
    }
  }
}

// One backward segment of nt steps (all kSeg of them when kFull):
// recomputes its states from ck[sg] into hbuf, then walks them backwards,
// carrying g and adding to dA, storing dx_t and ddt_t, and leaving each
// warp's channel sums of dB_t and dC_t in red[par].  As in fwd_tile, no
// branch splits the unrolled steps.
template <typename T, typename TD, int NP, bool kFull>
__device__ __forceinline__ void bwd_segment(BwdSmem<NP>& sm, int sg, int nt, int par, int tid,
                                            const float (&a2)[NP / kLanes<NP>],
                                            float (&g)[NP / kLanes<NP>],
                                            float (&dA)[NP / kLanes<NP>], const T (&xs)[kSeg],
                                            const TD (&ds)[kSeg], const T (&dys)[kSeg],
                                            T* __restrict__ dx, TD* __restrict__ ddt,
                                            size_t off, int C, bool writer) {
  constexpr int L = kLanes<NP>, NL = NP / L;
  const int warp = tid / 32, lane = tid % 32, sub = lane % L;
  const float(*sB)[NP] = sm.sBC[0] + sg * kSeg;
  const float(*sC)[NP] = sm.sBC[1] + sg * kSeg;
  // recompute the segment's states; h ends as the state after its last step
  float h[NL];
  load_col<NL>(h, sm.ck[sg], tid);
#pragma unroll
  for (int r = 0; r < kSeg; ++r) {
    if (kFull || r < nt) {
      const float d = to_f(ds[r]), u = d * to_f(xs[r]);
      float Bv[NL];
      load_row<NL, L>(Bv, sB[r], sub);
#pragma unroll
      for (int k = 0; k < NL; ++k) h[k] = fmaf(h[k], ex2(d * a2[k]), u * Bv[k]);
      if (r + 1 < (kFull ? kSeg : nt)) store_col<NL>(sm.hbuf[r], tid, h);
    }
  }
  // walk it backwards: h is h_t, hp is h_{t-1}
#pragma unroll
  for (int r = kSeg - 1; r >= 0; --r) {
    if (kFull || r < nt) {
      float hp[NL], Bv[NL], Cv[NL];
      const float d = to_f(ds[r]), xv = to_f(xs[r]), dyv = to_f(dys[r]), u = d * xv;
      if constexpr (kSplitV<NP>) {
        // dC_t's terms first, summed over the warp's channels before the
        // walk needs its registers
        float v[NL];
#pragma unroll
        for (int k = 0; k < NL; ++k) v[k] = dyv * h[k];
        lane_sum<NL, 16, L>(v, lane);
        put_red<NP, true>(sm.red[par][r][warp], v, lane);
      }
      if (r > 0)
        load_col<NL>(hp, sm.hbuf[r - 1], tid);
      else
        load_col<NL>(hp, sm.ck[sg], tid);
      load_row<NL, L>(Bv, sB[r], sub);
      load_row<NL, L>(Cv, sC[r], sub);
      float s1 = 0.f, s2 = 0.f, v[kSplitV<NP> ? NL : 2 * NL];
#pragma unroll
      for (int k = 0; k < NL; ++k) {
        g[k] = fmaf(dyv, Cv[k], g[k]);
        s1 = fmaf(g[k], Bv[k], s1);
        v[k] = g[k] * u;
        if constexpr (!kSplitV<NP>) v[NL + k] = dyv * h[k];
        g[k] *= ex2(d * a2[k]);            // now a_t g_t, the carry to step t - 1
        const float gh = g[k] * hp[k];
        dA[k] = fmaf(gh, d, dA[k]);
        s2 = fmaf(gh, a2[k], s2);
        h[k] = hp[k];
      }
      s1 = lanes_sum<L>(s1);
      s2 = lanes_sum<L>(s2);
      store_if(dx + off + static_cast<size_t>(r) * C, from_f<T>(d * s1), writer);
      store_if(ddt + off + static_cast<size_t>(r) * C, from_f<TD>(fmaf(xv, s1, s2 * kLn2)),
               writer);
      if constexpr (kSplitV<NP>) {
        lane_sum<NL, 16, L>(v, lane);
        put_red<NP, false>(sm.red[par][r][warp], v, lane);
      } else {
        lane_sum<2 * NL, 16, L>(v, lane);
        put_red<NP, false>(sm.red[par][r][warp], v, lane);
      }
    }
  }
}

// Blocks per SM the backward is compiled for: two where their shared
// memory fits an SM's (up to 64 states), else one.  Either sets its
// register budget to the 255-register cap (65536 / (128 * 2)).
template <int NP>
constexpr int kBwdBlocks = sizeof(BwdSmem<NP>) <= 113 * 1024 ? 2 : 1;
static_assert(sizeof(BwdSmem<128>) <= 227 * 1024, "a block fits an SM's shared memory");

// Groups of kThreads / L channels a backward block walks in turn, adding
// their channel sums into one partial row of dB and dC (see the note).
template <int NP>
constexpr int kBwdGroups = NP > 64 ? 4 : 1;

template <typename T, typename TD, int NP>
__global__ void __launch_bounds__(kThreads, kBwdBlocks<NP>)
mamba_scan_bwd_kernel(const T* __restrict__ x, const TD* __restrict__ dt,
                      const float* __restrict__ A, const float* __restrict__ Bm,
                      const float* __restrict__ Cm, const float* __restrict__ hs,
                      const T* __restrict__ dy, const float* __restrict__ dhT,
                      T* __restrict__ dx, TD* __restrict__ ddt, float* __restrict__ dA_part,
                      float* __restrict__ dB_part, float* __restrict__ dC_part,
                      float* __restrict__ dh0, int S, int C) {
  constexpr int L = kLanes<NP>, NL = NP / L;
  // B and C as in the forward: at 16 states the next chunk's are loaded
  // into registers a chunk ahead (4 a thread); above, the chunk's are
  // copied by cp.async at its start, through no registers (through 32 of
  // them the 128-state kernel spilled 144-176 bytes)
  constexpr bool kCopies = NP > 16;
  constexpr int kBC = kCopies ? 1 : 2 * kChunk * NP / kThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  BwdSmem<NP>& sm = *reinterpret_cast<BwdSmem<NP>*>(smem_raw);
  const int tid = threadIdx.x, sub = tid % L;
  const int b = blockIdx.y, blk = blockIdx.x, nblk = gridDim.x;
  const int nchunk = (S + kChunk - 1) / kChunk;
  const size_t row0 = static_cast<size_t>(b) * S;
  int par = 0;
  for (int grp = 0; grp < kBwdGroups<NP>; ++grp) {
    const int c = (blk * kBwdGroups<NP> + grp) * (kThreads / L) + tid / L;
    const bool active = c < C, writer = active && sub == 0;
    const size_t st = (static_cast<size_t>(b) * C + c) * NP;
    float a2[NL], g[NL], dA[NL];
#pragma unroll
    for (int k = 0; k < NL; ++k) a2[k] = g[k] = dA[k] = 0.f;
    if (active) {
      load_row<NL, L>(a2, A + static_cast<size_t>(c) * NP, sub);
      if (dhT) load_row<NL, L>(g, dhT + st, sub);
    }
#pragma unroll
    for (int k = 0; k < NL; ++k) a2[k] *= kLog2e;

    float bc[kBC];
    if constexpr (!kCopies)
      load_bc<float, NP, kChunk>(bc, Bm, Cm, row0, (nchunk - 1) * kChunk, S, tid);
    for (int k = nchunk - 1; k >= 0; --k) {
      const int ts = k * kChunk;
      const int nseg = (min(kChunk, S - ts) + kSeg - 1) / kSeg;
      // every thread is past the last segment's barrier, so none reads sBC now
      if constexpr (kCopies) {
        stage_bc<NP, kChunk>(&sm.sBC[0][0][0], Bm, Cm, row0, ts, S, tid);
        copies_wait();
      } else {
        store_bc<float, NP, kChunk>(&sm.sBC[0][0][0], bc, tid);
      }
      __syncthreads();
      if constexpr (!kCopies) {
        if (k > 0) load_bc<float, NP, kChunk>(bc, Bm, Cm, row0, ts - kChunk, S, tid);
      }
      const float(*sB)[NP] = sm.sBC[0];

      // the state at the start of each segment, from the chunk's saved state
      float h[NL];
#pragma unroll
      for (int q = 0; q < NL; ++q) h[q] = 0.f;
      if (active)
        load_row<NL, L>(h, hs + ((static_cast<size_t>(b) * nchunk + k) * C + c) * NP, sub);
      for (int sg = 0; sg < nseg; ++sg) {
        store_col<NL>(sm.ck[sg], tid, h);
        if (sg + 1 == nseg) break;
        T xs[kSeg];
        TD ds[kSeg];
        load_steps<T, kSeg>(xs, x, row0, ts + sg * kSeg, S, C, c, active);
        load_steps<TD, kSeg>(ds, dt, row0, ts + sg * kSeg, S, C, c, active);
#pragma unroll
        for (int r = 0; r < kSeg; ++r) {       // a whole segment: a later one follows
          const float d = to_f(ds[r]), u = d * to_f(xs[r]);
          float Bv[NL];
          load_row<NL, L>(Bv, sB[sg * kSeg + r], sub);
#pragma unroll
          for (int q = 0; q < NL; ++q) h[q] = fmaf(h[q], ex2(d * a2[q]), u * Bv[q]);
        }
      }

      for (int sg = nseg - 1; sg >= 0; --sg) {
        const int s0 = ts + sg * kSeg, nt = min(kSeg, S - s0);
        T xs[kSeg], dys[kSeg];
        TD ds[kSeg];
        load_steps<T, kSeg>(xs, x, row0, s0, S, C, c, active);
        load_steps<TD, kSeg>(ds, dt, row0, s0, S, C, c, active);
        load_steps<T, kSeg>(dys, dy, row0, s0, S, C, c, active);
        const size_t off = (row0 + s0) * C + c;
        if (nt == kSeg)
          bwd_segment<T, TD, NP, true>(sm, sg, nt, par, tid, a2, g, dA, xs, ds, dys, dx, ddt,
                                       off, C, writer);
        else
          bwd_segment<T, TD, NP, false>(sm, sg, nt, par, tid, a2, g, dA, xs, ds, dys, dx, ddt,
                                        off, C, writer);
        __syncthreads();
        // the block's sums over its channels, warp by warp in a fixed order
        for (int j = tid; j < nt * 2 * NP; j += kThreads) {
          const int r = j / (2 * NP), m = j % (2 * NP);
          float s = 0.f;
#pragma unroll
          for (int w = 0; w < kWarps; ++w) s += sm.red[par][r][w][m];
          const size_t at = ((static_cast<size_t>(b) * nblk + blk) * S + s0 + r) * NP + m % NP;
          float* dst = (m < NP ? dB_part : dC_part) + at;
          *dst = grp ? *dst + s : s;           // this thread's own store of the group before
        }
        if constexpr (kRedBufs<NP> == 2)
          par ^= 1;
        else
          __syncthreads();                     // the sums are read before the next segment's
      }
    }
    if (active) {
      store_row<NL, L>(dh0 + st, g, sub);
      store_row<NL, L>(dA_part + st, dA, sub);
    }
  }
}

// A call's arguments, as the C interface takes them.
struct Args {
  const void *x, *dt;
  const float* A;
  const void *Bm, *Cm;                   // the forward's FwdBC, fp32 for the backward
  const float* h0_or_hs;                 // h0 (forward) or the chunk states (backward)
  const void* dy;
  const float* dhT;
  void *y_or_dx, *ddt;
  float *hT_or_dA, *hs_or_dB, *dC, *dh0;
  int batch, S, C, n, nblk;
  cudaStream_t s;
};

template <typename T, typename TD, int NP>
int launch_fwd(const Args& a) {
  constexpr int kCh = kThreads / kLanes<NP>;
  const dim3 grid((a.C + kCh - 1) / kCh, a.batch);
  mamba_scan_fwd_kernel<T, TD, NP><<<grid, kThreads, 0, a.s>>>(
      static_cast<const T*>(a.x), static_cast<const TD*>(a.dt), a.A,
      static_cast<const FwdBC<T, NP>*>(a.Bm), static_cast<const FwdBC<T, NP>*>(a.Cm), a.h0_or_hs,
      static_cast<T*>(a.y_or_dx), a.hT_or_dA, a.hs_or_dB, a.S, a.C);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename TD, int NP>
int launch_bwd(const Args& a) {
  constexpr int kCh = kThreads / kLanes<NP> * kBwdGroups<NP>;
  const dim3 grid((a.C + kCh - 1) / kCh, a.batch);
  if (static_cast<int>(grid.x) != a.nblk) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(sizeof(BwdSmem<NP>));
  const cudaError_t e = cudaFuncSetAttribute(
      mamba_scan_bwd_kernel<T, TD, NP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  mamba_scan_bwd_kernel<T, TD, NP><<<grid, kThreads, smem, a.s>>>(
      static_cast<const T*>(a.x), static_cast<const TD*>(a.dt), a.A,
      static_cast<const float*>(a.Bm), static_cast<const float*>(a.Cm), a.h0_or_hs,
      static_cast<const T*>(a.dy), a.dhT, static_cast<T*>(a.y_or_dx), static_cast<TD*>(a.ddt),
      a.hT_or_dA, a.hs_or_dB, a.dC, a.dh0, a.S, a.C);
  return static_cast<int>(cudaGetLastError());
}

// The built state sizes: 16, 32, 64 and 128.
template <bool kBwd, typename T, typename TD>
int by_state(const Args& a) {
  switch (a.n) {
    case 16: return kBwd ? launch_bwd<T, TD, 16>(a) : launch_fwd<T, TD, 16>(a);
    case 32: return kBwd ? launch_bwd<T, TD, 32>(a) : launch_fwd<T, TD, 32>(a);
    case 64: return kBwd ? launch_bwd<T, TD, 64>(a) : launch_fwd<T, TD, 64>(a);
    case 128: return kBwd ? launch_bwd<T, TD, 128>(a) : launch_fwd<T, TD, 128>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Launches the forward (or, with bwd, the backward) kernel at x's type T
// and dt's type TD; its instantiations are built in mamba_scan_*.cu.
template <typename T, typename TD>
int run(bool bwd, const Args& a) {
  return bwd ? by_state<true, T, TD>(a) : by_state<false, T, TD>(a);
}

}  // namespace k4
