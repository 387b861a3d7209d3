// The subset of the CUDA runtime and device API that the kernels without
// TMA or wgmma (src/repro_torch/kernels/csrc/mamba_scan.cuh,
// moe_gmm_fp32.cu, flash_attention_fp32.cu, rmsnorm.cu) use, for running
// them on the CPU in tests: every thread of a block is a std::thread,
// blocks run one after another (over x, y and z), a barrier stands in for
// __syncthreads and one per warp for the shuffles and the warp's
// mma.sync.  The device has emu_multiprocessors SMs, each holding one
// block at a time.  tests/test_torch_scan_emulated.py,
// tests/test_torch_fp32_kernels_emulated.py and
// tests/test_torch_rmsnorm_emulated.py build the sources against it with
// g++.
#pragma once
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))

struct uint3 { unsigned x, y, z; };
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local uint3 threadIdx, blockIdx;
inline dim3 gridDim, blockDim;

struct float4 { float x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
struct float2 { float x, y; };
inline float2 make_float2(float a, float b) { return {a, b}; }

typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef void* cudaStream_t;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class F> cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount };
inline int emu_multiprocessors = 4;
inline cudaError_t cudaGetDevice(int* dev) {
  *dev = 0;
  return 0;
}
inline cudaError_t cudaDeviceGetAttribute(int* value, cudaDeviceAttr, int) {
  *value = emu_multiprocessors;
  return 0;
}
template <class F>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* blocks, F, int, size_t) {
  *blocks = 1;
  return 0;
}
using std::max;
using std::min;

inline std::barrier<>* emu_block_barrier;
inline std::vector<std::unique_ptr<std::barrier<>>> emu_warp_barriers;
// [buffer][warp][lane]: a shuffle's values, in two buffers taken in turn
// (a thread's shuffle count picks one), so one barrier a shuffle does: a
// lane can write a buffer again only after every lane of its warp has
// passed the barrier of the shuffle in between, so after their reads
inline float emu_lanes[2][32][32];
inline thread_local unsigned emu_shuffles;
alignas(16) inline unsigned char emu_dyn_smem[232448];

inline void __syncthreads() { emu_block_barrier->arrive_and_wait(); }

inline float __shfl_xor_sync(unsigned, float v, int mask) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, buf = emu_shuffles++ & 1;
  emu_lanes[buf][warp][lane] = v;
  emu_warp_barriers[warp]->arrive_and_wait();
  return emu_lanes[buf][warp][lane ^ mask];
}

inline float __shfl_sync(unsigned, float v, int src) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, buf = emu_shuffles++ & 1;
  emu_lanes[buf][warp][lane] = v;
  emu_warp_barriers[warp]->arrive_and_wait();
  return emu_lanes[buf][warp][src & 31];
}

inline float __uint_as_float(uint32_t u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}

inline uint32_t __float_as_uint(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  return u;
}

// mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32, d += a . b over the warp's
// fragments (a: rows g and g + 8, columns t and t + 4; b: rows t and t + 4,
// column g; d: rows g and g + 8, columns 2t and 2t + 1): each operand read
// as TF32 (its low 13 bits dropped, as the tensor cores do), sums in fp32;
// the fragments go through two buffers taken in turn, as the shuffles'
// values do: one barrier a call
inline float emu_frag[2][32][32][6];
inline thread_local unsigned emu_mmas;
inline void emu_mma_tf32(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  float (&frag)[32][6] = emu_frag[emu_mmas++ & 1][warp];
  for (int i = 0; i < 4; ++i) frag[lane][i] = __uint_as_float(a[i] & 0xffffe000u);
  for (int i = 0; i < 2; ++i) frag[lane][4 + i] = __uint_as_float(b[i] & 0xffffe000u);
  emu_warp_barriers[warp]->arrive_and_wait();
  for (int i = 0; i < 4; ++i) {
    const int r = g + 8 * (i / 2), c = 2 * t + i % 2;
    float s = d[i];
    for (int k = 0; k < 8; ++k)    // a's (r, k) and b's (k, c), from the lanes holding them
      s += frag[4 * (r % 8) + k % 4][r / 8 + 2 * (k / 4)] * frag[4 * c + k % 4][4 + k / 4];
    d[i] = s;
  }
}

inline float emu_ex2(float x) { return std::exp2(x); }
inline float rsqrtf(float x) { return 1.f / std::sqrt(x); }
inline float __expf(float x) { return std::exp(x); }

// kernel<<<grid, threads, smem, stream>>>(args...), rewritten by the test.
template <class K, class... A>
void emu_launch(dim3 grid, int threads, int, cudaStream_t, K kernel, A... args) {
  gridDim = grid;
  blockDim = dim3(threads);
  std::memset(emu_dyn_smem, 0xff, sizeof(emu_dyn_smem));   // not zero, as on the card
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        std::barrier<> block(threads);
        emu_block_barrier = &block;
        emu_warp_barriers.clear();
        for (int w = 0; w < threads / 32; ++w)
          emu_warp_barriers.emplace_back(std::make_unique<std::barrier<>>(32));
        std::vector<std::thread> team;
        for (int t = 0; t < threads; ++t)
          team.emplace_back([=] {
            threadIdx = {unsigned(t), 0, 0};
            emu_shuffles = emu_mmas = 0;
            blockIdx = {bx, by, bz};
            kernel(args...);
          });
        for (auto& t : team) t.join();
      }
}
