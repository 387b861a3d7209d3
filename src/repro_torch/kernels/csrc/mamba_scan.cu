// K4 and K4-bwd: the Mamba-1 selective scan, forward and backward, for
// Hopper (sm_90a).
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
// Bound on the H100.  At the training shape (4, 1024, 8192, 16) bf16 the
// forward reads x and dt and writes y and the saved states (~0.34 GB,
// ~100 us at 3.35 TB/s; ~0.20 GB, ~61 us, without the states, whose
// interval is the design's choice) and takes one exp per (b, t, c, n):
// 537M exps, which the special-function units (16 a clock per SM, 132
// SMs) need ~128 us for at 1.98 GHz.  Each exp comes with ~4 fp32 operations on
// the CUDA cores (8x the SFU's rate), so the exps are the floor.  The
// backward takes 2.5 exps per element (below) and ~30 fp32 operations,
// the channel sums included, and moves ~0.5 GB.
//
// Forward design.  One thread per channel holds all N state elements in
// registers (N = 4, 8 or 16: a template parameter, loops fully unrolled
// so nothing goes to local memory), with A pre-scaled by log2(e) so each
// exp is one MUFU.EX2 (ex2.approx.ftz).  A block of 128 threads takes
// 128 channels of one batch row and walks the sequence in tiles of
// kTile steps.  x and dt are read straight from global memory, one
// coalesced load per warp and step, and the next tile's are loaded into
// registers while this tile computes.  B and C, the same for every
// channel, are staged in double-buffered shared memory (also loaded a
// tile ahead) and read as broadcast float4s; y_t is a register sum and
// is stored per step, coalesced.  There is no shuffle and one barrier
// per tile.  When a gradient is wanted, the forward also writes the
// state at the start of every chunk of kChunk steps (B, ceil(S/kChunk),
// C, N), N contiguous floats per thread.
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
// 2.5 at kChunk = 16, kSeg = 8.  The sums over n are register sums.
// The sums over channels, dB_t and dC_t, are a warp transpose-reduce
// (2N values over 32 lanes in 2N - 1 shuffles), then a fixed-order sum
// over the block's 4 warps, written as one partial row per 128-channel
// block; the sum over batch rows of dA is a per-row partial.  The
// wrapper adds the partials with torch.sum: no atomics, and the result
// is the same bits from run to run.
//
// What limits them (measured on the H100; PERF.md has the numbers).
// Neither kernel reaches its exp floor: there are only B * C threads, one
// per channel (about two warps per SM sub-partition at the Falcon shape),
// and each warp's step is latency-bound.  In throwaway variants timed on
// the card, replacing every exp with an FFMA took little off either time,
// and dropping the backward's channel sums took off more.  The backward
// runs at the 255-register cap, which leaves the compiler no room to
// overlap one step's shuffles with the next step's work.  Two lanes per channel (twice the warps, half the
// states each) measured slower in both kernels.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 128;            // channels per block, one thread each
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 16;                // forward: steps per staged tile
constexpr int kChunk = 16;               // steps between saved states (CHUNK)
constexpr int kSeg = 8;                  // backward: steps of states held in shared memory
constexpr int kSegs = kChunk / kSeg;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
static_assert(kChunk % kTile == 0 && kChunk % kSeg == 0, "tiles and segments tile a chunk");

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

// N contiguous floats (16-byte aligned) to and from registers.
template <int N>
__device__ __forceinline__ void load_vec(float (&v)[N], const float* p) {
#pragma unroll
  for (int q = 0; q < N / 4; ++q) {
    const float4 f = reinterpret_cast<const float4*>(p)[q];
    v[4 * q] = f.x;
    v[4 * q + 1] = f.y;
    v[4 * q + 2] = f.z;
    v[4 * q + 3] = f.w;
  }
}

template <int N>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[N]) {
#pragma unroll
  for (int q = 0; q < N / 4; ++q)
    reinterpret_cast<float4*>(p)[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2],
                                                  v[4 * q + 3]);
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

// This thread's share of B and C at steps [t, t + K): flat index
// tid + m * kThreads over [B or C][step][n]; 0 past S.
template <typename T, int N, int K>
__device__ __forceinline__ void load_bc(T (&v)[2 * K * N / kThreads], const T* __restrict__ Bm,
                                        const T* __restrict__ Cm, size_t row0, int t, int S,
                                        int tid) {
  static_assert((2 * K * N) % kThreads == 0, "B and C tiles split evenly over the block");
#pragma unroll
  for (int m = 0; m < 2 * K * N / kThreads; ++m) {
    const int j = tid + m * kThreads, which = j / (K * N), rem = j % (K * N);
    const T* src = which ? Cm : Bm;
    v[m] = (t + rem / N < S) ? src[(row0 + t) * N + rem] : from_f<T>(0.f);
  }
}

template <typename T, int N, int K>
__device__ __forceinline__ void store_bc(float* flat, const T (&v)[2 * K * N / kThreads],
                                         int tid) {
#pragma unroll
  for (int m = 0; m < 2 * K * N / kThreads; ++m) flat[tid + m * kThreads] = to_f(v[m]);
}

// Sums each of M values over the warp's 32 lanes.  Each exchange halves
// the list: the lanes whose bit O is set keep the upper half and add the
// partner's, the others the lower half, so M = 32 values take 31
// shuffles.  Afterwards lane l holds the sum of value l / (32 / M).
template <int M, int O, int L>
struct WarpTransposeSum {
  static __device__ __forceinline__ float run(float (&v)[L], int lane) {
    const bool upper = (lane & O) != 0;
#pragma unroll
    for (int i = 0; i < M / 2; ++i) {
      const float send = upper ? v[i] : v[i + M / 2];
      const float keep = upper ? v[i + M / 2] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
    }
    return WarpTransposeSum<M / 2, O / 2, L>::run(v, lane);
  }
};

template <int O, int L>
struct WarpTransposeSum<1, O, L> {
  static __device__ __forceinline__ float run(float (&v)[L], int) {
    float s = v[0];
#pragma unroll
    for (int o = O; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    return s;
  }
};

// The forward over one tile's steps (all kTile of them when kFull):
// advances the states h and stores y_t.  y's sum over n runs in 4
// partial sums, a shorter chain.  No branch (not even the store's: it is
// predicated) splits the unrolled steps, so the compiler overlaps each
// step's latencies with the next one's work.
template <typename T, int N, bool kFull>
__device__ __forceinline__ void fwd_tile(float (&h)[N], const float (&a2)[N],
                                         const T (&xr)[kTile], const T (&dr)[kTile],
                                         const float (*sB)[N], const float (*sC)[N],
                                         T* __restrict__ y, size_t off, int C, int nt,
                                         bool active) {
#pragma unroll
  for (int r = 0; r < kTile; ++r) {
    if (kFull || r < nt) {
      const float d = to_f(dr[r]), u = d * to_f(xr[r]);
      float Bv[N], Cv[N], ys[4] = {0.f, 0.f, 0.f, 0.f};
      load_vec<N>(Bv, sB[r]);
      load_vec<N>(Cv, sC[r]);
#pragma unroll
      for (int n = 0; n < N; ++n) {
        h[n] = fmaf(h[n], ex2(d * a2[n]), u * Bv[n]);
        ys[n % 4] = fmaf(h[n], Cv[n], ys[n % 4]);
      }
      const float yv = (ys[0] + ys[1]) + (ys[2] + ys[3]);
      store_if(y + off + static_cast<size_t>(r) * C, from_f<T>(yv), active);
    }
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
mamba_scan_fwd_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                      const float* __restrict__ A, const T* __restrict__ Bm,
                      const T* __restrict__ Cm, const float* __restrict__ h0,
                      T* __restrict__ y, float* __restrict__ hT, float* __restrict__ hs,
                      int S, int C) {
  constexpr int kBC = 2 * kTile * N / kThreads;
  __shared__ __align__(16) float sBC[2][2][kTile][N];   // [buffer][B, C][step][n]
  const int tid = threadIdx.x, b = blockIdx.y, c = blockIdx.x * kThreads + tid;
  const bool active = c < C;
  const int nchunk = (S + kChunk - 1) / kChunk;
  const size_t row0 = static_cast<size_t>(b) * S;
  const size_t st = (static_cast<size_t>(b) * C + c) * N;
  float a2[N], h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) a2[n] = h[n] = 0.f;
  if (active) {
    load_vec<N>(a2, A + static_cast<size_t>(c) * N);
    if (h0) load_vec<N>(h, h0 + st);
  }
#pragma unroll
  for (int n = 0; n < N; ++n) a2[n] *= kLog2e;

  T xr[kTile], dr[kTile], bc[kBC];
  load_steps<T, kTile>(xr, x, row0, 0, S, C, c, active);
  load_steps<T, kTile>(dr, dt, row0, 0, S, C, c, active);
  load_bc<T, N, kTile>(bc, Bm, Cm, row0, 0, S, tid);
  store_bc<T, N, kTile>(&sBC[0][0][0][0], bc, tid);
  __syncthreads();
  for (int t0 = 0, i = 0; t0 < S; t0 += kTile, ++i) {
    const int nt = min(kTile, S - t0);
    T xn[kTile], dn[kTile];                 // the next tile, in flight while this one runs
    load_steps<T, kTile>(xn, x, row0, t0 + kTile, S, C, c, active);
    load_steps<T, kTile>(dn, dt, row0, t0 + kTile, S, C, c, active);
    load_bc<T, N, kTile>(bc, Bm, Cm, row0, t0 + kTile, S, tid);
    if (hs && active && t0 % kChunk == 0)
      store_vec<N>(hs + ((static_cast<size_t>(b) * nchunk + t0 / kChunk) * C + c) * N, h);
    const size_t off = (row0 + t0) * C + c;
    if (nt == kTile)
      fwd_tile<T, N, true>(h, a2, xr, dr, sBC[i & 1][0], sBC[i & 1][1], y, off, C, nt, active);
    else
      fwd_tile<T, N, false>(h, a2, xr, dr, sBC[i & 1][0], sBC[i & 1][1], y, off, C, nt, active);
    store_bc<T, N, kTile>(&sBC[(i + 1) & 1][0][0][0], bc, tid);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kTile; ++r) {
      xr[r] = xn[r];
      dr[r] = dn[r];
    }
  }
  if (active) store_vec<N>(hT + st, h);
}

template <int N>
struct BwdSmem {
  float4 hbuf[kSeg][N / 4][kThreads];   // the segment's recomputed states, a column a thread
  float4 ck[kSegs][N / 4][kThreads];    // the state at the start of each segment of the chunk
  float sBC[2][kChunk][N];              // the chunk's B and C
  float red[2][kSeg][kWarps][2 * N];    // per-warp channel sums of dB_t, dC_t (double-buffered)
};

// One backward segment of nt steps (all kSeg of them when kFull):
// recomputes its states from ck[sg] into hbuf, then walks them backwards,
// carrying g and adding to dA, storing dx_t and ddt_t, and leaving each
// warp's channel sums of dB_t and dC_t in red[par].  As in fwd_tile, no
// branch splits the unrolled steps.
template <typename T, int N, bool kFull>
__device__ __forceinline__ void bwd_segment(BwdSmem<N>& sm, int sg, int nt, int par, int tid,
                                            const float (&a2)[N], float (&g)[N],
                                            float (&dA)[N], const T (&xs)[kSeg],
                                            const T (&ds)[kSeg], const T (&dys)[kSeg],
                                            T* __restrict__ dx, T* __restrict__ ddt, size_t off,
                                            int C, bool active) {
  constexpr int kSpread = 32 / (2 * N);      // lanes that end up with the same channel sum
  const int warp = tid / 32, lane = tid % 32;
  const float(*sB)[N] = sm.sBC[0] + sg * kSeg;
  const float(*sC)[N] = sm.sBC[1] + sg * kSeg;
  // recompute the segment's states; h ends as the state after its last step
  float h[N];
  load_col<N>(h, sm.ck[sg], tid);
#pragma unroll
  for (int r = 0; r < kSeg; ++r) {
    if (kFull || r < nt) {
      const float d = to_f(ds[r]), u = d * to_f(xs[r]);
      float Bv[N];
      load_vec<N>(Bv, sB[r]);
#pragma unroll
      for (int n = 0; n < N; ++n) h[n] = fmaf(h[n], ex2(d * a2[n]), u * Bv[n]);
      if (r + 1 < (kFull ? kSeg : nt)) store_col<N>(sm.hbuf[r], tid, h);
    }
  }
  // walk it backwards: h is h_t, hp is h_{t-1}
#pragma unroll
  for (int r = kSeg - 1; r >= 0; --r) {
    if (kFull || r < nt) {
      float hp[N], Bv[N], Cv[N], v[2 * N];
      if (r > 0)
        load_col<N>(hp, sm.hbuf[r - 1], tid);
      else
        load_col<N>(hp, sm.ck[sg], tid);
      load_vec<N>(Bv, sB[r]);
      load_vec<N>(Cv, sC[r]);
      const float d = to_f(ds[r]), xv = to_f(xs[r]), dyv = to_f(dys[r]), u = d * xv;
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        g[n] = fmaf(dyv, Cv[n], g[n]);
        s1 = fmaf(g[n], Bv[n], s1);
        v[n] = g[n] * u;
        v[N + n] = dyv * h[n];
        g[n] *= ex2(d * a2[n]);            // now a_t g_t, the carry to step t - 1
        const float gh = g[n] * hp[n];
        dA[n] = fmaf(gh, d, dA[n]);
        s2 = fmaf(gh, a2[n], s2);
        h[n] = hp[n];
      }
      store_if(dx + off + static_cast<size_t>(r) * C, from_f<T>(d * s1), active);
      store_if(ddt + off + static_cast<size_t>(r) * C, from_f<T>(fmaf(xv, s1, s2 * kLn2)),
               active);
      const float tot = WarpTransposeSum<2 * N, 16, 2 * N>::run(v, lane);
      if (lane % kSpread == 0) sm.red[par][r][warp][lane / kSpread] = tot;
    }
  }
}

// Blocks per SM the backward is compiled for, which sets its register
// budget (65536 / (128 * blocks)).  Two fit its shared memory at N = 16;
// at N = 8 the compiler's schedule under the 255-register cap of two
// spills a few bytes, and under the 170 of three it does not.
template <int N>
constexpr int kBwdBlocks = N == 8 ? 3 : 2;

template <typename T, int N>
__global__ void __launch_bounds__(kThreads, kBwdBlocks<N>)
mamba_scan_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                      const float* __restrict__ A, const T* __restrict__ Bm,
                      const T* __restrict__ Cm, const float* __restrict__ hs,
                      const T* __restrict__ dy, const float* __restrict__ dhT,
                      T* __restrict__ dx, T* __restrict__ ddt, float* __restrict__ dA_part,
                      float* __restrict__ dB_part, float* __restrict__ dC_part,
                      float* __restrict__ dh0, int S, int C) {
  constexpr int kBC = 2 * kChunk * N / kThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  BwdSmem<N>& sm = *reinterpret_cast<BwdSmem<N>*>(smem_raw);
  const int tid = threadIdx.x;
  const int b = blockIdx.y, blk = blockIdx.x, nblk = gridDim.x;
  const int c = blk * kThreads + tid;
  const bool active = c < C;
  const int nchunk = (S + kChunk - 1) / kChunk;
  const size_t row0 = static_cast<size_t>(b) * S;
  const size_t st = (static_cast<size_t>(b) * C + c) * N;
  float a2[N], g[N], dA[N];
#pragma unroll
  for (int n = 0; n < N; ++n) a2[n] = g[n] = dA[n] = 0.f;
  if (active) {
    load_vec<N>(a2, A + static_cast<size_t>(c) * N);
    if (dhT) load_vec<N>(g, dhT + st);
  }
#pragma unroll
  for (int n = 0; n < N; ++n) a2[n] *= kLog2e;

  T bc[kBC];
  load_bc<T, N, kChunk>(bc, Bm, Cm, row0, (nchunk - 1) * kChunk, S, tid);
  int par = 0;
  for (int k = nchunk - 1; k >= 0; --k) {
    const int ts = k * kChunk;
    const int nseg = (min(kChunk, S - ts) + kSeg - 1) / kSeg;
    // every thread is past the last segment's barrier, so none reads sBC now
    store_bc<T, N, kChunk>(&sm.sBC[0][0][0], bc, tid);
    __syncthreads();
    if (k > 0) load_bc<T, N, kChunk>(bc, Bm, Cm, row0, ts - kChunk, S, tid);
    const float(*sB)[N] = sm.sBC[0];

    // the state at the start of each segment, from the chunk's saved state
    float h[N];
#pragma unroll
    for (int n = 0; n < N; ++n) h[n] = 0.f;
    if (active) load_vec<N>(h, hs + ((static_cast<size_t>(b) * nchunk + k) * C + c) * N);
    for (int sg = 0; sg < nseg; ++sg) {
      store_col<N>(sm.ck[sg], tid, h);
      if (sg + 1 == nseg) break;
      T xs[kSeg], ds[kSeg];
      load_steps<T, kSeg>(xs, x, row0, ts + sg * kSeg, S, C, c, active);
      load_steps<T, kSeg>(ds, dt, row0, ts + sg * kSeg, S, C, c, active);
#pragma unroll
      for (int r = 0; r < kSeg; ++r) {       // a whole segment: a later one follows
        const float d = to_f(ds[r]), u = d * to_f(xs[r]);
        float Bv[N];
        load_vec<N>(Bv, sB[sg * kSeg + r]);
#pragma unroll
        for (int n = 0; n < N; ++n) h[n] = fmaf(h[n], ex2(d * a2[n]), u * Bv[n]);
      }
    }

    for (int sg = nseg - 1; sg >= 0; --sg) {
      const int s0 = ts + sg * kSeg, nt = min(kSeg, S - s0);
      T xs[kSeg], ds[kSeg], dys[kSeg];
      load_steps<T, kSeg>(xs, x, row0, s0, S, C, c, active);
      load_steps<T, kSeg>(ds, dt, row0, s0, S, C, c, active);
      load_steps<T, kSeg>(dys, dy, row0, s0, S, C, c, active);
      const size_t off = (row0 + s0) * C + c;
      if (nt == kSeg)
        bwd_segment<T, N, true>(sm, sg, nt, par, tid, a2, g, dA, xs, ds, dys, dx, ddt, off, C,
                                active);
      else
        bwd_segment<T, N, false>(sm, sg, nt, par, tid, a2, g, dA, xs, ds, dys, dx, ddt, off,
                                 C, active);
      __syncthreads();
      // the block's sums over its channels, warp by warp in a fixed order
      for (int j = tid; j < nt * 2 * N; j += kThreads) {
        const int r = j / (2 * N), m = j % (2 * N);
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) s += sm.red[par][r][w][m];
        const size_t off = ((static_cast<size_t>(b) * nblk + blk) * S + s0 + r) * N + m % N;
        (m < N ? dB_part : dC_part)[off] = s;
      }
      par ^= 1;
    }
  }
  if (active) {
    store_vec<N>(dh0 + st, g);
    store_vec<N>(dA_part + st, dA);
  }
}

template <typename T, int N>
int launch_fwd(const void* x, const void* dt, const float* A, const void* Bm, const void* Cm,
               const float* h0, void* y, float* hT, float* hs, int batch, int S, int C,
               cudaStream_t s) {
  const dim3 grid((C + kThreads - 1) / kThreads, batch);
  mamba_scan_fwd_kernel<T, N><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt), A, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), h0, static_cast<T*>(y), hT, hs, S, C);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int N>
int launch_bwd(const void* x, const void* dt, const float* A, const void* Bm, const void* Cm,
               const float* hs, const void* dy, const float* dhT, void* dx, void* ddt,
               float* dA_part, float* dB_part, float* dC_part, float* dh0, int batch, int S,
               int C, int nblk, cudaStream_t s) {
  const dim3 grid((C + kThreads - 1) / kThreads, batch);
  if (static_cast<int>(grid.x) != nblk) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(sizeof(BwdSmem<N>));
  const cudaError_t e = cudaFuncSetAttribute(
      mamba_scan_bwd_kernel<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  mamba_scan_bwd_kernel<T, N><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt), A, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), hs, static_cast<const T*>(dy), dhT, static_cast<T*>(dx),
      static_cast<T*>(ddt), dA_part, dB_part, dC_part, dh0, S, C);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int fwd_n(int n, const void* x, const void* dt, const float* A, const void* Bm,
          const void* Cm, const float* h0, void* y, float* hT, float* hs, int batch, int S,
          int C, cudaStream_t s) {
  switch (n) {
    case 4: return launch_fwd<T, 4>(x, dt, A, Bm, Cm, h0, y, hT, hs, batch, S, C, s);
    case 8: return launch_fwd<T, 8>(x, dt, A, Bm, Cm, h0, y, hT, hs, batch, S, C, s);
    case 16: return launch_fwd<T, 16>(x, dt, A, Bm, Cm, h0, y, hT, hs, batch, S, C, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int bwd_n(int n, const void* x, const void* dt, const float* A, const void* Bm,
          const void* Cm, const float* hs, const void* dy, const float* dhT, void* dx,
          void* ddt, float* dA_part, float* dB_part, float* dC_part, float* dh0, int batch,
          int S, int C, int nblk, cudaStream_t s) {
  switch (n) {
    case 4:
      return launch_bwd<T, 4>(x, dt, A, Bm, Cm, hs, dy, dhT, dx, ddt, dA_part, dB_part,
                              dC_part, dh0, batch, S, C, nblk, s);
    case 8:
      return launch_bwd<T, 8>(x, dt, A, Bm, Cm, hs, dy, dhT, dx, ddt, dA_part, dB_part,
                              dC_part, dh0, batch, S, C, nblk, s);
    case 16:
      return launch_bwd<T, 16>(x, dt, A, Bm, Cm, hs, dy, dhT, dx, ddt, dA_part, dB_part,
                               dC_part, dh0, batch, S, C, nblk, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x, dt: (batch, S, C); A: (C, N) fp32; B, C: (batch, S, N); h0: (batch, C, N)
// fp32 or null.  A, h0 and hs 16-byte aligned.  Writes y (batch, S, C)
// without the x*D term, hT (batch, C, N) fp32 and, when hs is not null, the
// state at the start of every chunk of `chunk` steps: hs (batch,
// ceil(S/chunk), C, N) fp32.  dtype: 0 = float32, 1 = bfloat16 (x, dt, B, C
// and y).  Returns cudaGetLastError() after the launch (0 on success); a
// refused launch is reported here.
extern "C" int mamba_scan_fwd(const void* x, const void* dt, const float* A, const void* Bm,
                              const void* Cm, const float* h0, void* y, float* hT, float* hs,
                              int batch, int S, int C, int n, int chunk, int dtype,
                              void* stream) {
  if (batch <= 0 || S <= 0 || C <= 0 || chunk != kChunk)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return fwd_n<float>(n, x, dt, A, Bm, Cm, h0, y, hT, hs, batch, S, C, s);
  if (dtype == 1)
    return fwd_n<__nv_bfloat16>(n, x, dt, A, Bm, Cm, h0, y, hT, hs, batch, S, C, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The backward from the forward's saved chunk states hs and dy (batch, S, C)
// in x's type; dhT (batch, C, N) fp32 or null, 16-byte aligned.  Writes dx,
// ddt (batch, S, C) in x's type, dh0 (batch, C, N) fp32, and partial sums
// that the caller adds up: dA_part (batch, C, N) over batch rows, dB_part and
// dC_part (batch, nblk, S, N) over the nblk = ceil(C / 128) channel blocks.
extern "C" int mamba_scan_bwd(const void* x, const void* dt, const float* A, const void* Bm,
                              const void* Cm, const float* hs, const void* dy,
                              const float* dhT, void* dx, void* ddt, float* dA_part,
                              float* dB_part, float* dC_part, float* dh0, int batch, int S,
                              int C, int n, int chunk, int nblk, int dtype, void* stream) {
  if (batch <= 0 || S <= 0 || C <= 0 || chunk != kChunk)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return bwd_n<float>(n, x, dt, A, Bm, Cm, hs, dy, dhT, dx, ddt, dA_part, dB_part, dC_part,
                        dh0, batch, S, C, nblk, s);
  if (dtype == 1)
    return bwd_n<__nv_bfloat16>(n, x, dt, A, Bm, Cm, hs, dy, dhT, dx, ddt, dA_part, dB_part,
                                dC_part, dh0, batch, S, C, nblk, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
