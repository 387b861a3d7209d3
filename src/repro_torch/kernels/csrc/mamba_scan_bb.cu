// K4 and K4-bwd's instantiations for bf16 x and bf16 dt (mamba_scan.cuh).
#include "mamba_scan.cuh"

template int k4::run<__nv_bfloat16, __nv_bfloat16>(bool, const k4::Args&);
