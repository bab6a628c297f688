// Pieces shared by the recurrences' backward kernels (rwkv6_bwd.cu,
// mamba2_bwd.cu): a 4-term dot, RT consecutive values from shared memory,
// a block's copy of staged rows to fp32, and the reduction of a run of
// steps' per-lane partial sums (scan::reduce_slots) handed slot by slot to
// the caller.
#pragma once

#include "scan.cuh"

namespace scan_bwd {


// an H100 block's dynamic shared memory
constexpr int MAX_SMEM = 232448;

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  float s = __fmul_rn(a.x, b.x);
  s = __fmaf_rn(a.y, b.y, s);
  s = __fmaf_rn(a.z, b.z, s);
  return __fmaf_rn(a.w, b.w, s);
}

// RT consecutive fp32 values from shared memory, 4·RT-byte aligned.
template <int RT>
__device__ __forceinline__ void load_rows(float (&v)[RT], const float* src) {
  if constexpr (RT == 4) {
    const float4 t = *reinterpret_cast<const float4*>(src);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else if constexpr (RT == 2) {
    const float2 t = *reinterpret_cast<const float2*>(src);
    v[0] = t.x;
    v[1] = t.y;
  } else {
    v[0] = src[0];
  }
}

// All threads of the block copy n values to fp32, both pointers 16-byte
// aligned and n a multiple of 4: bf16 widened 8 a thread at a time.
__device__ __forceinline__ void to_f32(float* dst, const __nv_bfloat16* src,
                                       int n) {
  scan::widen_rows(dst, src, n);
}
__device__ __forceinline__ void to_f32(float* dst, const float* src, int n) {
  for (int e = 4 * threadIdx.x; e < n; e += 4 * blockDim.x) {
    *reinterpret_cast<float4*>(dst + e) =
        *reinterpret_cast<const float4*>(src + e);
  }
}

// Reduces the K slots of v (a run of steps of W values, slot u·W + k for
// step u of the run) over the GROUP lanes STRIDE apart, and hands each sum this
// lane owns to put(u, k, sum).  Every slot is summed by the same tree
// whatever K is (scan::reduce_slots), so the bits do not depend on how
// the steps fall into runs.
template <int K, int W, int GROUP, int STRIDE, typename Put>
__device__ __forceinline__ void flush(float (&v)[K], int lane, Put put) {
  bool owner;
  const int base = scan::reduce_slots<K, GROUP, STRIDE, true>(v, lane, owner);
  if (!owner) return;
#pragma unroll
  for (int i = 0; i < (K >= GROUP ? K / GROUP : 1); ++i) {
    put((base + i) / W, (base + i) % W, v[i]);
  }
}

}  // namespace scan_bwd
