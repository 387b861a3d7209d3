// The subset of the CUDA runtime and device API that the scan kernels
// (src/repro_torch/kernels/csrc/mamba_scan.cuh) use, for running them on
// the CPU in tests: every thread of a block is a std::thread, blocks run
// one after another, a barrier stands in for __syncthreads and one per
// warp for the shuffles.  tests/test_torch_scan_emulated.py builds the
// source against it with g++.
#pragma once
#include <barrier>
#include <cmath>
#include <cstddef>
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

typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef void* cudaStream_t;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class F> cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
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

inline float emu_ex2(float x) { return std::exp2(x); }

// kernel<<<grid, threads, smem, stream>>>(args...), rewritten by the test.
template <class K, class... A>
void emu_launch(dim3 grid, int threads, int, cudaStream_t, K kernel, A... args) {
  gridDim = grid;
  blockDim = dim3(threads);
  std::memset(emu_dyn_smem, 0xff, sizeof(emu_dyn_smem));   // not zero, as on the card
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
          emu_shuffles = 0;
          blockIdx = {bx, by, 0};
          kernel(args...);
        });
      for (auto& t : team) t.join();
    }
}
