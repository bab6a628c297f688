// The epilogue activations of the fused kernels (apr_conv.cu, apr_matmul.cu,
// quant_matmul.cu), in one place so that their flushes cannot drift apart.
//
// Replaces: the activation branch of apply_epilogue in
// src/repro/kernels/apr_matmul/kernel.py (shared there by the fused matmul,
// conv and int8 kernels).
//
// act: 0 none, 1 relu, 2 silu = x * sigmoid(x), 3 gelu with the tanh
// approximation (jax.nn.gelu's default).  Each is written as the op sequence
// of its plain PyTorch version on the card (activation_ref in
// kernels/apr_matmul/ref.py: torch.clamp_min, x * torch.sigmoid(x) with
// sigmoid = 1 / (1 + exp(-x)), F.gelu(approximate="tanh")), every step
// rounded on its own (the __f*_rn intrinsics are never contracted into an
// FMA by nvcc), so the two agree to the last bit or within the ulps of
// expf / tanhf.
#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case 1:                                      // relu
      return fmaxf(v, 0.0f);
    case 2: {                                    // silu = x * sigmoid(x)
      const float sig = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-v)));
      return __fmul_rn(v, sig);
    }
    case 3: {                                    // gelu, tanh approximation
      const float cube = __fmul_rn(__fmul_rn(v, v), v);
      const float inner =
          __fmul_rn(0.7978845608028654f, __fmaf_rn(0.044715f, cube, v));
      return __fmul_rn(__fmul_rn(0.5f, v), __fadd_rn(1.0f, tanhf(inner)));
    }
    default:
      return v;
  }
}
