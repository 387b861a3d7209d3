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
// ridge.  Design: one warp per row, 8 rows per block.  Where D and the
// pointers allow, each lane moves 16 bytes per load and store (8 bf16 or
// 4 fp32), so a warp request covers 512 contiguous bytes; the sum of
// squares is reduced with warp shuffles alone, and the second pass over
// the row hits L1.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRowsPerBlock = 8;
constexpr int kThreads = 32 * kRowsPerBlock;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// VEC elements of T per access: 16 bytes when vectorized, 1 otherwise.
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y,
               int n, int d, float eps) {
  using P = Pack<T, VEC>;
  const int lane = threadIdx.x & 31;
  const size_t row = static_cast<size_t>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= static_cast<size_t>(n)) return;
  const P* xr = reinterpret_cast<const P*>(x + row * d);
  const P* wp = reinterpret_cast<const P*>(w);
  P* yr = reinterpret_cast<P*>(y + row * d);
  const int chunks = d / VEC;

  float ss = 0.f;
  for (int c = lane; c < chunks; c += 32) {
    const P p = xr[c];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float f = to_f(p.v[j]);
      ss += f * f;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  const float r = rsqrtf(ss / static_cast<float>(d) + eps);

  for (int c = lane; c < chunks; c += 32) {
    const P p = xr[c];
    const P q = wp[c];
    P o;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const T nrm = from_f<T>(to_f(p.v[j]) * r);
      o.v[j] = from_f<T>(to_f(nrm) * to_f(q.v[j]));
    }
    yr[c] = o;
  }
}

template <typename T>
void launch(const void* x, const void* w, void* y, int n, int d, float eps,
            cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  const dim3 grid((n + kRowsPerBlock - 1) / kRowsPerBlock), block(kThreads);
  const bool aligned = d % kVec == 0 && (reinterpret_cast<uintptr_t>(x) |
                                         reinterpret_cast<uintptr_t>(w) |
                                         reinterpret_cast<uintptr_t>(y)) % 16 == 0;
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  T* yp = static_cast<T*>(y);
  if (aligned)
    rmsnorm_kernel<T, kVec><<<grid, block, 0, s>>>(xp, wp, yp, n, d, eps);
  else
    rmsnorm_kernel<T, 1><<<grid, block, 0, s>>>(xp, wp, yp, n, d, eps);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after
// the launch (0 on success); a refused launch is reported here.
extern "C" int rmsnorm_fwd(const void* x, const void* w, void* y, int n, int d,
                           float eps, int dtype, void* stream) {
  if (n <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch<float>(x, w, y, n, d, eps, s);
  else if (dtype == 1)
    launch<__nv_bfloat16>(x, w, y, n, d, eps, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
