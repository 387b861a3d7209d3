// bfloat16 for the CPU emulation of the scan kernels (see cuda_runtime.h):
// storage and round-to-nearest-even conversion, as cuda_bf16.h has them.
#pragma once
#include <cstdint>
#include <cstring>

struct __nv_bfloat16 { uint16_t bits; };

inline float __bfloat162float(__nv_bfloat16 b) {
  const uint32_t u = uint32_t(b.bits) << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}

inline __nv_bfloat16 __float2bfloat16(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  u += 0x7fffu + ((u >> 16) & 1u);
  return {uint16_t(u >> 16)};
}
