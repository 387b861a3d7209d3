// bfloat16 for the CPU emulation of the kernels (see cuda_runtime.h):
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

// bfloat16 pairs (K1's output, two elements at a time): __hmul2 rounds the
// exact product once, as the card's mul.bf16x2 does
struct __nv_bfloat162 { __nv_bfloat16 x, y; };

inline __nv_bfloat162 __halves2bfloat162(__nv_bfloat16 a, __nv_bfloat16 b) { return {a, b}; }
inline __nv_bfloat16 __low2bfloat16(__nv_bfloat162 h) { return h.x; }
inline __nv_bfloat16 __high2bfloat16(__nv_bfloat162 h) { return h.y; }

inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) {
  return {__float2bfloat16(a), __float2bfloat16(b)};
}

inline __nv_bfloat162 __hmul2(__nv_bfloat162 a, __nv_bfloat162 b) {
  return {__float2bfloat16(__bfloat162float(a.x) * __bfloat162float(b.x)),
          __float2bfloat16(__bfloat162float(a.y) * __bfloat162float(b.y))};
}
