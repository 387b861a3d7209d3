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
// tensors are read contiguously at every step as they lie.
//
// Bound on the H100.  Per (b, t, c, n) the forward does one exp and a few
// fp32 FMAs; it reads x and dt and writes y once, so at the training
// shape (4, 1024, 8192, 16) bf16 it moves ~0.2 GB (61 us at 3.35 TB/s)
// and does 537M exps, which the SFU (16 per clock per SM) needs
// ~128 us for: the exps, not the bytes, are the real floor.  The
// backward recomputes the states and does ~3x the exps.
//
// Design.  Each channel gets a group of N lanes (N = 4, 8 or 16: a
// template parameter), one fp32 state element per lane, so the state
// never leaves registers; y_t is a shuffle sum over the group.  A block of
// 256 threads covers 256/N channels of one batch row and walks the whole
// sequence, staging 32 steps of x, dt (per channel) and B, C (shared by
// every channel of the block) in shared memory, and storing y a tile at a
// time so the writes are coalesced.  When a gradient is wanted, the
// forward also writes the state at the start of every chunk of kChunk
// steps (B, ceil(S/kChunk), C, N), so the backward never needs a
// (B, S, C, N) tensor.
//
// The backward walks the chunks in reverse.  For each chunk it recomputes
// the state at the start of each 32-step segment from the chunk's saved
// state, then, segment by segment in reverse, recomputes the segment's 32
// states into shared memory and walks them backwards:
//
//   g_t = dy_t[c] * C_t[n] + a_{t+1} * g_{t+1}      (g seeded with dhT)
//   dx_t[c]  = dt_t * sum_n g_t * B_t[n]
//   ddt_t[c] = x_t * sum_n g_t * B_t[n] + sum_n g_t * h_{t-1} * a_t * A[c,n]
//   dA[c,n] += g_t * h_{t-1} * a_t * dt_t           (per lane, over t)
//   dB_t[n] += g_t * u_t,  dC_t[n] += dy_t[c] * h_t (over the channels)
//   dh0 = a_0 * g_0
//
// The sums over channels (dB, dC) are reduced inside the block in a fixed
// order and written as per-block partials; the sum over batch rows of dA
// is left as a per-row partial.  The wrapper adds the partials with
// torch.sum, so no atomics are used and the result does not change from
// run to run.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;    // steps staged in shared memory at a time
constexpr int kChunk = 128;  // steps between saved states (SSM_CHUNK)
constexpr int kSegs = kChunk / kTile;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Sum over the N lanes of a channel's group (every lane gets the sum).
template <int N>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = N / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum over the channels of a warp, lane by lane of the group.
template <int N>
__device__ __forceinline__ float warp_channel_sum(float v) {
#pragma unroll
  for (int o = N; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Stage rows [t0, t0 + nt) of per-channel tensors (x, dt and, if given,
// dy) and per-step tensors (B and, if given, C) in shared memory as fp32.
// Channels past C read as 0, so they add nothing to any sum.
template <typename T, int N>
__device__ __forceinline__ void stage(const T* __restrict__ x, const T* __restrict__ dt,
                                      const T* __restrict__ dy, const T* __restrict__ Bm,
                                      const T* __restrict__ Cm, float (*sx)[kThreads / N],
                                      float (*sdt)[kThreads / N], float (*sdy)[kThreads / N],
                                      float (*sB)[N], float (*sC)[N], size_t row0, int t0,
                                      int nt, int c0, int C) {
  constexpr int CPB = kThreads / N;
  for (int i = threadIdx.x; i < nt * CPB; i += kThreads) {
    const int r = i / CPB, cc = i % CPB;
    const bool ok = c0 + cc < C;
    const size_t off = (row0 + t0 + r) * C + c0 + cc;
    sx[r][cc] = ok ? to_f(x[off]) : 0.f;
    sdt[r][cc] = ok ? to_f(dt[off]) : 0.f;
    if (dy) sdy[r][cc] = ok ? to_f(dy[off]) : 0.f;
  }
  for (int i = threadIdx.x; i < nt * N; i += kThreads) {
    const int r = i / N, nn = i % N;
    const size_t off = (row0 + t0 + r) * N + nn;
    sB[r][nn] = to_f(Bm[off]);
    if (Cm) sC[r][nn] = to_f(Cm[off]);
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
mamba_scan_fwd_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                      const float* __restrict__ A, const T* __restrict__ Bm,
                      const T* __restrict__ Cm, const float* __restrict__ h0,
                      T* __restrict__ y, float* __restrict__ hT, float* __restrict__ hs,
                      int S, int C) {
  constexpr int CPB = kThreads / N;
  __shared__ float sx[kTile][CPB], sdt[kTile][CPB], sy[kTile][CPB];
  __shared__ float sB[kTile][N], sC[kTile][N];
  const int tid = threadIdx.x, lc = tid / N, n = tid % N;
  const int b = blockIdx.y, c0 = blockIdx.x * CPB, c = c0 + lc;
  const bool active = c < C;
  const int nchunk = (S + kChunk - 1) / kChunk;
  const size_t row0 = static_cast<size_t>(b) * S;
  const size_t st = (static_cast<size_t>(b) * C + c) * N + n;
  const float a = active ? A[static_cast<size_t>(c) * N + n] : 0.f;
  float h = (active && h0) ? h0[st] : 0.f;

  for (int t0 = 0; t0 < S; t0 += kTile) {
    const int nt = min(kTile, S - t0);
    __syncthreads();  // the previous tile's y is stored
    stage<T, N>(x, dt, nullptr, Bm, Cm, sx, sdt, nullptr, sB, sC, row0, t0, nt, c0, C);
    __syncthreads();
    for (int r = 0; r < nt; ++r) {
      const int t = t0 + r;
      if (hs && active && t % kChunk == 0)
        hs[((static_cast<size_t>(b) * nchunk + t / kChunk) * C + c) * N + n] = h;
      const float d = sdt[r][lc];
      h = h * expf(d * a) + (d * sx[r][lc]) * sB[r][n];
      const float p = group_sum<N>(h * sC[r][n]);
      if (n == 0) sy[r][lc] = p;
    }
    __syncthreads();
    for (int i = tid; i < nt * CPB; i += kThreads) {
      const int r = i / CPB, cc = i % CPB;
      if (c0 + cc < C) y[(row0 + t0 + r) * C + c0 + cc] = from_f<T>(sy[r][cc]);
    }
  }
  if (active) hT[st] = h;
}

template <int N>
struct BwdSmem {
  static constexpr int CPB = kThreads / N;
  float hbuf[kTile][kThreads];  // the segment's recomputed states, one column a lane
  float ck[kSegs][kThreads];    // the state at the start of each segment of the chunk
  float sx[kTile][CPB], sdt[kTile][CPB], sdy[kTile][CPB];
  float sdx[kTile][CPB], sddt[kTile][CPB];
  float sB[kTile][N], sC[kTile][N];
  float rdB[kTile][kWarps][N], rdC[kTile][kWarps][N];
};

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
mamba_scan_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                      const float* __restrict__ A, const T* __restrict__ Bm,
                      const T* __restrict__ Cm, const float* __restrict__ hs,
                      const T* __restrict__ dy, const float* __restrict__ dhT,
                      T* __restrict__ dx, T* __restrict__ ddt, float* __restrict__ dA_part,
                      float* __restrict__ dB_part, float* __restrict__ dC_part,
                      float* __restrict__ dh0, int S, int C) {
  constexpr int CPB = kThreads / N;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  BwdSmem<N>& sm = *reinterpret_cast<BwdSmem<N>*>(smem_raw);
  const int tid = threadIdx.x, lc = tid / N, n = tid % N;
  const int warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.y, blk = blockIdx.x, nblk = gridDim.x;
  const int c0 = blk * CPB, c = c0 + lc;
  const bool active = c < C;
  const int nchunk = (S + kChunk - 1) / kChunk;
  const size_t row0 = static_cast<size_t>(b) * S;
  const size_t st = (static_cast<size_t>(b) * C + c) * N + n;
  const float a = active ? A[static_cast<size_t>(c) * N + n] : 0.f;
  float g = (active && dhT) ? dhT[st] : 0.f;
  float dA_acc = 0.f;

  for (int k = nchunk - 1; k >= 0; --k) {
    const int ts = k * kChunk, te = min(S, ts + kChunk);
    const int nseg = (te - ts + kTile - 1) / kTile;
    // The state at the start of each segment, from the chunk's saved state.
    float h = active ? hs[((static_cast<size_t>(b) * nchunk + k) * C + c) * N + n] : 0.f;
    for (int sg = 0; sg < nseg; ++sg) {
      sm.ck[sg][tid] = h;
      if (sg + 1 == nseg) break;
      __syncthreads();
      stage<T, N>(x, dt, nullptr, Bm, nullptr, sm.sx, sm.sdt, nullptr, sm.sB, nullptr,
                  row0, ts + sg * kTile, kTile, c0, C);
      __syncthreads();
      for (int r = 0; r < kTile; ++r) {
        const float d = sm.sdt[r][lc];
        h = h * expf(d * a) + (d * sm.sx[r][lc]) * sm.sB[r][n];
      }
    }
    for (int sg = nseg - 1; sg >= 0; --sg) {
      const int s0 = ts + sg * kTile, nt = min(kTile, te - s0);
      __syncthreads();
      stage<T, N>(x, dt, dy, Bm, Cm, sm.sx, sm.sdt, sm.sdy, sm.sB, sm.sC, row0, s0, nt, c0,
                  C);
      __syncthreads();
      h = sm.ck[sg][tid];
      for (int r = 0; r < nt; ++r) {
        const float d = sm.sdt[r][lc];
        h = h * expf(d * a) + (d * sm.sx[r][lc]) * sm.sB[r][n];
        sm.hbuf[r][tid] = h;
      }
      for (int r = nt - 1; r >= 0; --r) {
        const float d = sm.sdt[r][lc], xv = sm.sx[r][lc], dyv = sm.sdy[r][lc];
        const float hprev = r > 0 ? sm.hbuf[r - 1][tid] : sm.ck[sg][tid];
        const float da = expf(d * a);
        g += dyv * sm.sC[r][n];
        const float gha = g * hprev * da;
        dA_acc += gha * d;
        const float s1 = group_sum<N>(g * sm.sB[r][n]);
        const float s2 = group_sum<N>(gha * a);
        const float pB = warp_channel_sum<N>(g * (d * xv));
        const float pC = warp_channel_sum<N>(dyv * sm.hbuf[r][tid]);
        if (n == 0) {
          sm.sdx[r][lc] = d * s1;
          sm.sddt[r][lc] = xv * s1 + s2;
        }
        if (lane < N) {
          sm.rdB[r][warp][lane] = pB;
          sm.rdC[r][warp][lane] = pC;
        }
        g *= da;
      }
      __syncthreads();
      for (int i = tid; i < nt * CPB; i += kThreads) {
        const int r = i / CPB, cc = i % CPB;
        if (c0 + cc < C) {
          const size_t off = (row0 + s0 + r) * C + c0 + cc;
          dx[off] = from_f<T>(sm.sdx[r][cc]);
          ddt[off] = from_f<T>(sm.sddt[r][cc]);
        }
      }
      for (int i = tid; i < nt * N; i += kThreads) {
        const int r = i / N, nn = i % N;
        float sb = 0.f, sc = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          sb += sm.rdB[r][w][nn];
          sc += sm.rdC[r][w][nn];
        }
        const size_t off = ((static_cast<size_t>(b) * nblk + blk) * S + s0 + r) * N + nn;
        dB_part[off] = sb;
        dC_part[off] = sc;
      }
    }
  }
  if (active) {
    dh0[st] = g;
    dA_part[st] = dA_acc;
  }
}

template <typename T, int N>
int launch_fwd(const void* x, const void* dt, const float* A, const void* Bm, const void* Cm,
               const float* h0, void* y, float* hT, float* hs, int batch, int S, int C,
               cudaStream_t s) {
  const dim3 grid((C + kThreads / N - 1) / (kThreads / N), batch);
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
  const dim3 grid((C + kThreads / N - 1) / (kThreads / N), batch);
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
// fp32 or null.  Writes y (batch, S, C) without the x*D term, hT (batch, C, N)
// fp32 and, when hs is not null, the state at the start of every chunk of
// `chunk` steps: hs (batch, ceil(S/chunk), C, N) fp32.  dtype: 0 = float32,
// 1 = bfloat16 (x, dt, B, C and y).  Returns cudaGetLastError() after the
// launch (0 on success); a refused launch is reported here.
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
// in x's type; dhT (batch, C, N) fp32 or null.  Writes dx, ddt (batch, S, C)
// in x's type, dh0 (batch, C, N) fp32, and partial sums that the caller adds
// up: dA_part (batch, C, N) over batch rows, dB_part and dC_part
// (batch, nblk, S, N) over the nblk = ceil(C / (256 / N)) channel blocks.
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
