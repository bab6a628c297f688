// The fp32 partial of the paper's memory-resident baseline (apr_matmul.cu's
// apr_matmul_hbm_bf16 and apr_matmul_hbm_f32, apr_conv.cu's apr_conv_hbm):
// the store and the load that send it through global memory at every K
// step, in one place so that the baselines cannot drift apart.
//
// Replaces: the revisited fp32 output block of _hbm_matmul_kernel in
// src/repro/kernels/apr_matmul/kernel.py (o_ref[...] += dot(...), K the
// outermost grid axis).
//
// st.global.cg caches the partial in L2 only and ld.global.cg bypasses L1,
// so L1 never holds it; both are volatile asm with a memory clobber, so the
// compiler neither drops, merges nor reorders them across another memory
// access, and a thread reads back exactly what it wrote (the same thread
// and address, in program order).
#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ void st_cg(float* p, float v) {
  asm volatile("st.global.cg.f32 [%0], %1;\n" ::"l"(p), "f"(v) : "memory");
}

__device__ __forceinline__ float ld_cg(const float* p) {
  float v;
  asm volatile("ld.global.cg.f32 %0, [%1];\n" : "=f"(v) : "l"(p) : "memory");
  return v;
}
