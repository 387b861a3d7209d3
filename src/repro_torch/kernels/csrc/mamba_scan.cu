// K4 and K4-bwd's C interface (kernels in mamba_scan.cuh; the note there
// has their design).
#include "mamba_scan.cuh"

namespace k4 {

// built in mamba_scan_{ff,fb,bf,bb}.cu
extern template int run<float, float>(bool, const Args&);
extern template int run<float, __nv_bfloat16>(bool, const Args&);
extern template int run<__nv_bfloat16, float>(bool, const Args&);
extern template int run<__nv_bfloat16, __nv_bfloat16>(bool, const Args&);

namespace {

// dtype codes: 0 = float32, 1 = bfloat16.
int by_type(bool bwd, const Args& a, int dtype, int dt_dtype) {
  if (dtype == 0 && dt_dtype == 0) return run<float, float>(bwd, a);
  if (dtype == 0 && dt_dtype == 1) return run<float, __nv_bfloat16>(bwd, a);
  if (dtype == 1 && dt_dtype == 0) return run<__nv_bfloat16, float>(bwd, a);
  if (dtype == 1 && dt_dtype == 1) return run<__nv_bfloat16, __nv_bfloat16>(bwd, a);
  return -static_cast<int>(cudaErrorInvalidValue);
}

// n: a built size (16, 32, 64, 128) or a multiple of 128 above, run as
// groups of 128 states.
bool valid(int batch, int S, int C, int n, int chunk) {
  const bool built = n == 16 || n == 32 || n == 64 || n == 128 || (n > 128 && n % 128 == 0);
  return batch > 0 && S > 0 && C > 0 && built && chunk == kChunk;
}

}  // namespace
}  // namespace k4

// x, dt: (batch, S, C); A: (C, n) fp32; B, C: (batch, S, n), in x's type
// at n = 16 and fp32 above; h0: (batch, C, n) fp32 or null; n a built
// size (16, 32, 64, 128) or a multiple of 128 above it (G = n / 128
// groups of 128 states, all in one launch; B and C then group-major,
// (G, batch, S, 128)).  A, B, C, h0 and hs 16-byte aligned.  Writes y
// (batch, S, C) in x's type without the x*D term (above 128 states, each
// group's fp32 partial sums: y (G, batch, S, C), which the caller adds
// up), hT (batch, C, n) fp32 and, when hs is not null, the state at the
// start of every chunk of `chunk` steps: hs (batch, ceil(S/chunk), C, n)
// fp32.  Type codes (0 = float32, 1 = bfloat16): dtype for x and y,
// dt_dtype for dt.  Any batch, in launches of at most 65,535 rows.
// Returns the number of launches made (one unless the batch is larger),
// or minus a CUDA error: the call's refusal, or cudaGetLastError() after
// the launch that failed.
extern "C" int mamba_scan_fwd(const void* x, const void* dt, const float* A, const void* Bm,
                              const void* Cm, const float* h0, void* y, float* hT, float* hs,
                              int batch, int S, int C, int n, int chunk, int dtype,
                              int dt_dtype, void* stream) {
  if (!k4::valid(batch, S, C, n, chunk)) return -static_cast<int>(cudaErrorInvalidValue);
  const k4::Args a{x,       dt,      A,     Bm, Cm, h0, nullptr, nullptr, y, nullptr, hT, hs,
                   nullptr, nullptr, batch, S,  C,  n,  0,       static_cast<cudaStream_t>(stream)};
  return k4::by_type(false, a, dtype, dt_dtype);
}

// The backward from the forward's saved chunk states hs and dy (batch, S,
// C) in x's type; B and C fp32; dhT (batch, C, n) fp32 or null, 16-byte
// aligned.  Writes
// dx in x's type, ddt in dt's (above 128 states, the groups' fp32 partial
// sums of each, (G, batch, S, C)), dh0 (batch, C, n) fp32, and partial sums
// that the caller adds up: dA_part (batch, C, n) over batch rows, dB_part
// and dC_part (batch, nblk, S, n) over the nblk channel blocks of 128 / L
// channels (L = 1 at 16 states, 2 at 32, 4 at 64), and of 4 x 16 channels
// at 128 states and above (8 lanes a channel, kBwdGroups).  Above 128
// states B, C, dB_part and dC_part are group-major: (G, batch, S, 128) and
// (G, batch, nblk, S, 128).  Returns as mamba_scan_fwd does.
extern "C" int mamba_scan_bwd(const void* x, const void* dt, const float* A, const float* Bm,
                              const float* Cm, const float* hs, const void* dy,
                              const float* dhT, void* dx, void* ddt, float* dA_part,
                              float* dB_part, float* dC_part, float* dh0, int batch, int S,
                              int C, int n, int chunk, int nblk, int dtype, int dt_dtype,
                              void* stream) {
  if (!k4::valid(batch, S, C, n, chunk)) return -static_cast<int>(cudaErrorInvalidValue);
  const k4::Args a{x,     dt, A, Bm, Cm,   hs, dy, dhT, dx, ddt, dA_part, dB_part, dC_part, dh0,
                   batch, S,  C, n,  nblk, static_cast<cudaStream_t>(stream)};
  return k4::by_type(true, a, dtype, dt_dtype);
}
