// K1: fused RMSNorm forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/rmsnorm.py
// (_rmsnorm_kernel / rmsnorm_pallas).  Computes, per row of x (N, D):
//
//   y = T(T(x * rsqrt(mean(x^2) + eps)) * w)
//
// with the reduction in fp32 and the same two roundings as the reference
// (cast to x's type BEFORE the multiply by w).
//
// Bound on the H100: bytes.  It reads x and w and writes y once, at a
// handful of flops per element, far below the card's ~295 flop/byte
// ridge; at a decode step's few rows, the launch and one round trip to
// memory are all there is.  Reaching the memory rate takes ~100 KB of
// reads in flight on each SM, and in bf16 the instructions an element
// costs come near the time its bytes take: the output is formed two
// elements at a time (one pack to bf16x2 of x * r, one bf16x2 multiply by
// w, whose single rounding of the exact product is the reference's fp32
// product rounded to bf16).
//
// Design.  A row is cut into chunks of 16 bytes (8 bf16 or 4 fp32) and
// spread over `tpr` threads, each holding at most kChunks chunks: thread
// t holds chunks t, t + tpr, ..., so each step of the threads moves tpr x
// 16 contiguous bytes.  tpr grows with D (a power of two up to 32, or
// whole warps up to 512): bf16 rows up to 1280 and fp32 up to 640 take
// one warp and reduce by shuffles alone; wider rows take whole warps and
// a barrier of their own block.  Where D is a multiple of 8 (bf16) or 4
// (fp32) and x, w and y are 16-byte aligned (VEC), each thread reads its
// chunks of a row into registers once, squares and sums them, and writes
// the row's output from the same registers; its share of w is loaded
// once and kept in registers over every row it walks.  The grid holds no
// more blocks than fit on the card at once, each walking rows by the
// grid's stride, all taking the same count of steps.  A block of more
// than one step takes its rows through a ring of kStages row slots in
// shared memory filled by cp.async (16 bytes a copy, no registers held):
// each thread copies exactly the chunks it will read, so no barrier
// guards the ring, and kStages - 1 steps of rows stay in flight while the
// block finishes the current one.  A block of one step (few rows, as at a
// decode step: a block a row, so their loads start on as many SMs as
// there are rows) loads its chunks straight into registers.  Rows of one
// warp are packed kBlockThreads / tpr to a block; wider rows take a block
// each, so a barrier holds only the warps of its own row.  Past 512 x
// kChunks chunks (D > 20480 bf16, 10240 fp32), and wherever VEC does not
// hold (element by element), one generic instantiation a dtype walks the
// same chunks twice, the second time from cache, w read from cache.
//
// Row invariance.  The partition of a row (tpr and the chunks a thread
// holds) depends on D and the dtype alone, never on N, on the rows a
// block takes, or on alignment; each thread sums its elements in chunk
// order and, within a chunk, in element order (one fmaf each); the lanes
// of a row reduce by a fixed xor butterfly (every lane ends with the same
// bits, as fp32 addition commutes), and the warps of a row add their sums
// in warp order through shared memory.  The generic path gathers the
// same chunks in the same order.  So a row's output bits depend on that
// row, w, eps, D and the dtype alone: the multi-rank lanes, whose calls
// cut the same rows into other batches, rely on it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "async_copy.cuh"

namespace {

constexpr int kChunks = 5;          // 16-byte chunks a thread holds, at most
constexpr int kMaxThreads = 512;    // threads a block, and a row, at most
constexpr int kBlockThreads = 256;  // threads a block when many rows share one
constexpr int kStages = 3;          // row slots of the shared ring

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// One chunk: 16 bytes of T.
template <typename T>
struct alignas(16) Chunk {
  static constexpr int kLen = 16 / sizeof(T);
  T v[kLen];
};

// Chunk c of a row of d elements: one 16-byte load (VEC), or element by
// element with the elements past d read as 0 (they add nothing).
template <typename T, bool VEC>
__device__ __forceinline__ void load_chunk(Chunk<T>& p, const T* row, int c, int d) {
  if constexpr (VEC) {
    p = reinterpret_cast<const Chunk<T>*>(row)[c];
  } else {
#pragma unroll
    for (int j = 0; j < Chunk<T>::kLen; ++j) {
      const int i = c * Chunk<T>::kLen + j;
      p.v[j] = i < d ? row[i] : from_f<T>(0.f);
    }
  }
}

template <typename T, bool VEC>
__device__ __forceinline__ void store_chunk(const Chunk<T>& p, T* row, int c, int d) {
  if constexpr (VEC) {
    reinterpret_cast<Chunk<T>*>(row)[c] = p;
  } else {
#pragma unroll
    for (int j = 0; j < Chunk<T>::kLen; ++j) {
      const int i = c * Chunk<T>::kLen + j;
      if (i < d) row[i] = p.v[j];
    }
  }
}

template <typename T>
__device__ __forceinline__ float sum_squares(const Chunk<T>& p, float ss) {
#pragma unroll
  for (int j = 0; j < Chunk<T>::kLen; ++j) {
    const float f = to_f(p.v[j]);
    ss = fmaf(f, f, ss);
  }
  return ss;
}

// T(T(x * r) * w) for a chunk of x and of w.
__device__ __forceinline__ Chunk<float> normed(const Chunk<float>& p, const Chunk<float>& q,
                                               float r) {
  Chunk<float> o;
#pragma unroll
  for (int j = 0; j < 4; ++j) o.v[j] = p.v[j] * r * q.v[j];
  return o;
}

__device__ __forceinline__ Chunk<__nv_bfloat16> normed(const Chunk<__nv_bfloat16>& p,
                                                       const Chunk<__nv_bfloat16>& q, float r) {
  Chunk<__nv_bfloat16> o;
#pragma unroll
  for (int j = 0; j < 8; j += 2) {
    const __nv_bfloat162 n = __floats2bfloat162_rn(to_f(p.v[j]) * r, to_f(p.v[j + 1]) * r);
    const __nv_bfloat162 m = __hmul2(n, __halves2bfloat162(q.v[j], q.v[j + 1]));
    o.v[j] = __low2bfloat16(m);
    o.v[j + 1] = __high2bfloat16(m);
  }
  return o;
}

// The sum of a row's partial sums `ss`, on every thread of the row: the
// xor butterfly over the row's lanes of a warp, then (tpr > 32) the
// row's warps in order through `part` (two buffers taken in turn by the
// row loop's step `it`, so one barrier a step).
__device__ __forceinline__ float row_sum(float ss, int tpr, int it,
                                         float (*part)[kMaxThreads / 32]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    if (o < tpr) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if (tpr > 32) {
    const int warp = threadIdx.x >> 5, wpr = tpr >> 5;
    float* p = part[it & 1];
    if ((threadIdx.x & 31) == 0) p[warp] = ss;
    __syncthreads();
    const float* mine = p + warp / wpr * wpr;
    ss = mine[0];
    for (int k = 1; k < wpr; ++k) ss += mine[k];
  }
  return ss;
}

// One row's step for a thread holding its C chunks `xv` (all threads of
// the block call it, live row or not: row_sum may hold a barrier).
template <typename T, int C>
__device__ __forceinline__ void finish_row(const Chunk<T> (&xv)[C], const Chunk<T> (&wr)[C],
                                           bool live, T* yr, int t, int tpr, int chunks, int d,
                                           int it, float eps,
                                           float (*part)[kMaxThreads / 32]) {
  float ss = 0.f;
  if (live) {
#pragma unroll
    for (int i = 0; i < C; ++i)
      if (t + i * tpr < chunks) ss = sum_squares(xv[i], ss);
  }
  const float r = rsqrtf(row_sum(ss, tpr, it, part) / static_cast<float>(d) + eps);
  if (live) {
#pragma unroll
    for (int i = 0; i < C; ++i)
      if (t + i * tpr < chunks) store_chunk<T, true>(normed(xv[i], wr[i], r), yr, t + i * tpr, d);
  }
}

// C chunks a thread in registers (1 to kChunks, 16-byte accesses: VEC),
// or C = 0: any count, two passes over the row, 16-byte accesses or
// (VEC false) element by element.  The block holds rows_per_block rows
// of tpr threads; blocks walk rows by the grid's stride.  Every thread of
// a block runs the same steps of the row loop (the barrier in row_sum).
// C > 0 takes kStages x rows_per_block x C x tpr chunks of dynamic shared
// memory (the ring), used where the block takes more than one step.
template <typename T, int C, bool VEC>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y, int n,
               int d, int tpr, int rows_per_block, float eps) {
  static_assert(C == 0 || VEC, "registers hold 16-byte chunks only");
  __shared__ float part[2][kMaxThreads / 32];
  constexpr int kLen = Chunk<T>::kLen;
  const int t = threadIdx.x % tpr, slot = threadIdx.x / tpr;
  const int chunks = (d + kLen - 1) / kLen;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * rows_per_block;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * rows_per_block;
  const int64_t steps = (n - first + stride - 1) / stride;   // the same for the whole block
  if constexpr (C > 0) {
    Chunk<T> wr[C], xv[C];
#pragma unroll
    for (int i = 0; i < C; ++i)
      if (t + i * tpr < chunks) load_chunk<T, true>(wr[i], w, t + i * tpr, d);
    if (steps == 1) {
      const int64_t row = first + slot;
      if (row < n) {
#pragma unroll
        for (int i = 0; i < C; ++i)
          if (t + i * tpr < chunks) load_chunk<T, true>(xv[i], x + row * d, t + i * tpr, d);
      }
      finish_row<T, C>(xv, wr, row < n, y + row * d, t, tpr, chunks, d, 0, eps, part);
      return;
    }
    extern __shared__ __align__(16) unsigned char smem_raw[];
    Chunk<T>* ring = reinterpret_cast<Chunk<T>*>(smem_raw);
    // this thread's chunk i of the ring slot of step s
    const auto mine = [&](int64_t s, int i) {
      return ring + ((s % kStages * rows_per_block + slot) * C + i) * tpr + t;
    };
    const auto issue = [&](int64_t s) {    // step s's row into its slot; a group a step
      const int64_t row = first + s * stride + slot;
      if (s < steps && row < n) {
#pragma unroll
        for (int i = 0; i < C; ++i)
          if (t + i * tpr < chunks)
            cuda_core::copy16(reinterpret_cast<float*>(mine(s, i)),
                              reinterpret_cast<const float*>(x + row * d) + (t + i * tpr) * 4, 16);
      }
      cuda_core::copies_commit();
    };
    for (int s = 0; s < kStages - 1; ++s) issue(s);
    for (int64_t s = 0; s < steps; ++s) {
      issue(s + kStages - 1);
      cuda_core::copies_wait<kStages - 1>();    // this thread's copies of step s have landed
      const int64_t row = first + s * stride + slot;
      if (row < n) {
#pragma unroll
        for (int i = 0; i < C; ++i)
          if (t + i * tpr < chunks) xv[i] = *mine(s, i);
      }
      finish_row<T, C>(xv, wr, row < n, y + row * d, t, tpr, chunks, d, static_cast<int>(s),
                       eps, part);
    }
  } else {
    for (int64_t s = 0; s < steps; ++s) {
      const int64_t row = first + s * stride + slot;
      const T* xr = x + row * d;
      Chunk<T> p, q;
      float ss = 0.f;
      if (row < n)
        for (int c = t; c < chunks; c += tpr) {
          load_chunk<T, VEC>(p, xr, c, d);
          ss = sum_squares(p, ss);
        }
      const float r =
          rsqrtf(row_sum(ss, tpr, static_cast<int>(s), part) / static_cast<float>(d) + eps);
      if (row < n)
        for (int c = t; c < chunks; c += tpr) {
          load_chunk<T, VEC>(p, xr, c, d);
          load_chunk<T, VEC>(q, w, c, d);
          store_chunk<T, VEC>(normed(p, q, r), y + row * d, c, d);
        }
    }
  }
}

// The partition of a row of d elements in chunks of `len`: its threads
// (a power of two up to 32, else whole warps up to kMaxThreads: the
// fewest that hold the row at kChunks chunks each) and the chunks each
// holds (0: the generic kernel).  A function of d and the dtype alone.
struct RowShape {
  int tpr, chunks_per_thread;
};

RowShape row_shape(int d, int len) {
  const int chunks = (d + len - 1) / len;
  const int need = (chunks + kChunks - 1) / kChunks;
  int tpr = 1;
  if (need <= 32)
    while (tpr < need) tpr <<= 1;
  else
    tpr = need < kMaxThreads ? (need + 31) / 32 * 32 : kMaxThreads;
  const int c = (chunks + tpr - 1) / tpr;
  return {tpr, c <= kChunks ? c : 0};
}

template <typename T, int C, bool VEC>
cudaError_t launch_shape(const T* x, const T* w, T* y, int n, int d, int tpr,
                         int rows_per_block, int sms, float eps, cudaStream_t s) {
  const int threads = tpr * rows_per_block;
  const int smem = kStages * threads * C * 16;
  if (smem > 0) {    // the ring and `part` may pass the 48 KB a launch gets unasked
    const cudaError_t attr = cudaFuncSetAttribute(
        rmsnorm_kernel<T, C, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (attr != cudaSuccess) return attr;
  }
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, rmsnorm_kernel<T, C, VEC>, threads,
                                                smem);
  // as many blocks as fit at once, or fewer, so that every block takes the
  // same count of steps
  const int64_t blocks = (static_cast<int64_t>(n) + rows_per_block - 1) / rows_per_block;
  const int64_t resident = static_cast<int64_t>(sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  const int64_t steps = (blocks + resident - 1) / resident;
  const dim3 grid(static_cast<unsigned>((blocks + steps - 1) / steps));
  rmsnorm_kernel<T, C, VEC><<<grid, threads, smem, s>>>(x, w, y, n, d, tpr, rows_per_block,
                                                        eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_vec(const T* x, const T* w, T* y, int n, int d, RowShape rs, int rpb,
                       int sms, float eps, cudaStream_t s) {
  switch (rs.chunks_per_thread) {
    case 1: return launch_shape<T, 1, true>(x, w, y, n, d, rs.tpr, rpb, sms, eps, s);
    case 2: return launch_shape<T, 2, true>(x, w, y, n, d, rs.tpr, rpb, sms, eps, s);
    case 3: return launch_shape<T, 3, true>(x, w, y, n, d, rs.tpr, rpb, sms, eps, s);
    case 4: return launch_shape<T, 4, true>(x, w, y, n, d, rs.tpr, rpb, sms, eps, s);
    case 5: return launch_shape<T, 5, true>(x, w, y, n, d, rs.tpr, rpb, sms, eps, s);
    default: return launch_shape<T, 0, true>(x, w, y, n, d, rs.tpr, rpb, sms, eps, s);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* y, int n, int d, float eps,
                   int rows_per_block, cudaStream_t s) {
  constexpr int kLen = Chunk<T>::kLen;
  const RowShape rs = row_shape(d, kLen);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rows_per_block <= 0) rows_per_block = n <= sms || rs.tpr > 32 ? 1 : kBlockThreads / rs.tpr;
  // whole warps, at most kMaxThreads threads
  const int per_warp = rs.tpr < 32 ? 32 / rs.tpr : 1;
  rows_per_block = (rows_per_block + per_warp - 1) / per_warp * per_warp;
  if (rows_per_block * rs.tpr > kMaxThreads) rows_per_block = kMaxThreads / rs.tpr;
  const bool vec = d % kLen == 0 && (reinterpret_cast<uintptr_t>(x) |
                                     reinterpret_cast<uintptr_t>(w) |
                                     reinterpret_cast<uintptr_t>(y)) % 16 == 0;
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  T* yp = static_cast<T*>(y);
  return vec ? launch_vec<T>(xp, wp, yp, n, d, rs, rows_per_block, sms, eps, s)
             : launch_shape<T, 0, false>(xp, wp, yp, n, d, rs.tpr, rows_per_block, sms, eps, s);
}

}  // namespace

// rmsnorm_fwd with the rows a block set by the caller (0: chosen from n
// and the card's SM count, as rmsnorm_fwd does; a test picks either path).
// The rows a block never change a row's bits.
extern "C" int rmsnorm_fwd_rows(const void* x, const void* w, void* y, int n, int d,
                                float eps, int dtype, int rows_per_block, void* stream) {
  if (n <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(launch<float>(x, w, y, n, d, eps, rows_per_block, s));
  if (dtype == 1)
    return static_cast<int>(launch<__nv_bfloat16>(x, w, y, n, d, eps, rows_per_block, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after
// the launch (0 on success); a refused launch is reported here.
extern "C" int rmsnorm_fwd(const void* x, const void* w, void* y, int n, int d, float eps,
                           int dtype, void* stream) {
  return rmsnorm_fwd_rows(x, w, y, n, d, eps, dtype, 0, stream);
}
