// K2: FlashAttention-2 forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (_flash_fwd_kernel / flash_attention_fwd_pallas).  For q (B, Hq, Sq, D)
// and k, v (B, Hkv, Skv, D), contiguous, it writes
//
//   out (B, Hq, Sq, D) in q's type     = softmax(q k^T * D^-0.5 + mask) v
//   lse (B, Hq, Sq)    in fp32         = m + log(max(l, 1e-30))
//
// with an online softmax in fp32 over KV tiles, GQA through KV head
// h / (Hq / Hkv), keys masked by kpos < Skv and, when causal,
// kpos <= qpos + q_offset.  q is scaled after its fp32 cast, as the TPU
// kernel does.  Writing lse lets the backward skip a second forward.
//
// Bound on the H100: at the training shapes (D = 64, S = 1024) the
// tensor-core flops of the two products and the bytes of q, k, v, out
// are of the same order, so the bound is whichever is larger for the
// call.  This first version runs the products on the CUDA cores in fp32:
// a block holds BQ = 64 query rows with 4 threads per row (each owns D/4
// interleaved dims of q and of the accumulator, in registers), stages
// BK = 32 keys and values in shared memory, and reduces each score
// across its 4 threads with two shuffles.  KV tiles wholly above the
// causal diagonal are skipped.  A tensor-core (wgmma) version is later
// work; PERF.md records how far this one sits from the bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;       // query rows per block
constexpr int kBK = 32;       // keys per shared-memory tile
constexpr int kTPR = 4;       // threads per query row
constexpr int kThreads = kBQ * kTPR;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                 int hq, int hkv, int sq, int skv, int causal, int q_offset,
                 float scale) {
  constexpr int DP = D / kTPR;  // dims owned by one thread
  __shared__ T ks[kBK * D];
  __shared__ T vs[kBK * D];

  const int tid = threadIdx.x;
  const int r = tid / kTPR, part = tid % kTPR;
  const int bh = blockIdx.y;
  const int b = bh / hq, h = bh % hq;
  const int n_rep = hq / hkv;
  const int q0 = blockIdx.x * kBQ;
  const int qi = q0 + r;
  const bool row_ok = qi < sq;
  const int qpos = qi + q_offset;

  const size_t qbase = (static_cast<size_t>(bh) * sq + (row_ok ? qi : 0)) * D;
  const size_t kvbase = static_cast<size_t>(b * hkv + h / n_rep) * skv * D;

  float qr[DP], acc[DP];
#pragma unroll
  for (int i = 0; i < DP; ++i) {
    qr[i] = to_f(q[qbase + i * kTPR + part]) * scale;
    acc[i] = 0.f;
  }
  float m = kNegInf, l = 0.f;

  // Causal: no row of this block sees a key past q0 + kBQ - 1 + q_offset.
  int kv_end = skv;
  if (causal) kv_end = min(skv, q0 + kBQ + q_offset);

  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();  // previous tile fully consumed
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int kp = k0 + e / D;
      const bool in = kp < skv;
      const size_t src = kvbase + static_cast<size_t>(kp) * D + e % D;
      ks[e] = in ? k[src] : from_f<T>(0.f);
      vs[e] = in ? v[src] : from_f<T>(0.f);
    }
    __syncthreads();

    float s[kBK];
    float mt = kNegInf;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < DP; ++i) dot += qr[i] * to_f(ks[j * D + i * kTPR + part]);
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      const int kp = k0 + j;
      const bool ok = kp < skv && (!causal || kp <= qpos);
      s[j] = ok ? dot : kNegInf;
      mt = fmaxf(mt, s[j]);
    }
    const float m_new = fmaxf(m, mt);
    const float corr = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      s[j] = expf(s[j] - m_new);
      psum += s[j];
    }
    l = l * corr + psum;
#pragma unroll
    for (int i = 0; i < DP; ++i) acc[i] *= corr;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
#pragma unroll
      for (int i = 0; i < DP; ++i) acc[i] += s[j] * to_f(vs[j * D + i * kTPR + part]);
    }
    m = m_new;
  }

  if (row_ok) {
    const float denom = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < DP; ++i) o[qbase + i * kTPR + part] = from_f<T>(acc[i] / denom);
    if (part == 0) lse[static_cast<size_t>(bh) * sq + qi] = m + logf(denom);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, int b,
           int hq, int hkv, int sq, int skv, int d, int causal, int q_offset,
           float scale, cudaStream_t s) {
  const dim3 grid((sq + kBQ - 1) / kBQ, b * hq), block(kThreads);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(o);
  float* lp = static_cast<float*>(lse);
  if (d == 64) {
    flash_fwd_kernel<T, 64><<<grid, block, 0, s>>>(qp, kp, vp, op, lp, hq, hkv, sq, skv,
                                                   causal, q_offset, scale);
  } else if (d == 128) {
    flash_fwd_kernel<T, 128><<<grid, block, 0, s>>>(qp, kp, vp, op, lp, hq, hkv, sq, skv,
                                                    causal, q_offset, scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; d must be 64 or 128.  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   void* lse, int b, int hq, int hkv, int sq, int skv,
                                   int d, int causal, int q_offset, float scale,
                                   int dtype, void* stream) {
  if (b <= 0 || hq <= 0 || hkv <= 0 || hq % hkv || sq <= 0 || skv <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, o, lse, b, hq, hkv, sq, skv, d, causal, q_offset, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, o, lse, b, hq, hkv, sq, skv, d, causal, q_offset,
                                 scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
