// K4 and K4-bwd's instantiations for bf16 x and fp32 dt (mamba_scan.cuh).
#include "mamba_scan.cuh"

template int k4::run<__nv_bfloat16, float>(bool, const k4::Args&);
