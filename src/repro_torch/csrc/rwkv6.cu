// rwkv6_wkv: the RWKV-6 (Finch) WKV recurrence with the (D, D) state kept
// in registers across the whole time loop and written once -- the APR
// pattern applied to a decaying accumulator.  Per (batch row, head):
//
//   y_t = (S + diag(u) k_t v_t^T)^T r_t
//   S  <- diag(w_t) S + k_t v_t^T
//
// extended by an optional initial state in (s_init, fp32 (B, H, D, D)) and
// final state out (s_out), which the serving path needs; with neither it
// is exactly the TPU kernel (state starts at zero, none comes out).
//
// Replaces: src/repro/kernels/rwkv6/kernel.py::rwkv6_call (kernel body
// _rwkv6_kernel).
//
// What bounds it on an H100: every input value is read once and every
// output written once.  The function needs 5 fp32 operations per state
// element per step (kv = k_i v_j; S = w_i S + kv; y_j += r_i S_ij, with the
// bonus taken out of the element loop as v_j sum_i r_i u_i k_i); this
// kernel spends 7, the reference's literal form below.  That is 5·D^2 per
// head per step against bf16 r, k, v, y and fp32 w, 768 bytes at D = 64:
// ~27 operations per byte, just above the fp32 ridge (20), so over a long
// prompt the operations bound it.  At a decode step (T = 1) the state read
// and written is nearly all the bytes, and the serial time loop makes it
// one round trip to memory per block: latency.
//
// Design:
//  * one block per (b, h); thread (j, g) owns column j of S and the rows
//    i = q·NG + g (q < R = D/NG, NG the smallest power of two with R <= 32),
//    so its R state values live in registers for the whole launch;
//  * the NG threads of one column are adjacent lanes of one warp, so y_j,
//    the sum over i, is a warp-shuffle reduction with no shared memory and
//    no barrier per step;
//  * r, k, v, w of CH = 16 time steps at a time are staged in shared memory
//    (widened to fp32; the TPU kernel's time chunk), then the block walks
//    them; u is staged once;
//  * the state is read from global memory once, at the start, and written
//    once, at the end;
//  * per element the update is the reference's, in its order:
//    kv = k_i v_j; y_j += r_i (S_ij + u_i kv); S_ij = w_i S_ij + kv (nvcc
//    may contract the last into one FMA: a one-ulp difference from the
//    plain version, held to a tolerance).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int CH = 16;                 // time steps staged per round
constexpr int MAX_D = 128, MAX_R = 32, MAX_THREADS = 512;

__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

// T: the element type of r, k, v, u and y (bf16 or fp32); w is fp32.
template <typename T>
__global__ void __launch_bounds__(MAX_THREADS) wkv_kernel(
    const T* __restrict__ r,        // (B, T, H, D)
    const T* __restrict__ k,
    const T* __restrict__ v,
    const float* __restrict__ w,    // (B, T, H, D) decay in (0, 1)
    const T* __restrict__ u,        // (H, D)
    const float* s_init,            // (B, H, D, D) or null (zeros)
    float* s_out,                   // (B, H, D, D) or null; may be s_init
    T* __restrict__ y,              // (B, T, H, D)
    int tlen, int nh, int d, int ng) {
  __shared__ float sr[CH][MAX_D], sk[CH][MAX_D], sv[CH][MAX_D],
      sw[CH][MAX_D];
  __shared__ float su[MAX_D];
  const int bh = blockIdx.x, b = bh / nh, h = bh % nh;
  const int tid = threadIdx.x, j = tid / ng, g = tid % ng;
  const int rows = d / ng;
  const size_t sbase = (size_t)bh * d * d;
  float s[MAX_R];
#pragma unroll
  for (int q = 0; q < MAX_R; ++q) {
    if (q < rows) {
      s[q] = s_init ? s_init[sbase + (size_t)(q * ng + g) * d + j] : 0.f;
    }
  }
  for (int i = tid; i < d; i += blockDim.x) su[i] = widen(u[h * d + i]);
  const size_t step = (size_t)nh * d;                 // one time step
  const size_t base = ((size_t)b * tlen * nh + h) * d;  // (b, 0, h, 0)
  for (int t0 = 0; t0 < tlen; t0 += CH) {
    const int n = min(CH, tlen - t0);
    __syncthreads();                // the previous round's reads are done
    for (int e = tid; e < n * d; e += blockDim.x) {
      const int tt = e / d, i = e % d;
      const size_t off = base + (size_t)(t0 + tt) * step + i;
      sr[tt][i] = widen(r[off]);
      sk[tt][i] = widen(k[off]);
      sv[tt][i] = widen(v[off]);
      sw[tt][i] = w[off];
    }
    __syncthreads();
    for (int tt = 0; tt < n; ++tt) {
      const float vj = sv[tt][j];
      float acc = 0.f;
#pragma unroll
      for (int q = 0; q < MAX_R; ++q) {
        if (q < rows) {
          const int i = q * ng + g;
          const float kv = sk[tt][i] * vj;
          acc += sr[tt][i] * (s[q] + su[i] * kv);
          s[q] = sw[tt][i] * s[q] + kv;
        }
      }
      for (int off = ng / 2; off > 0; off >>= 1) {
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      }
      if (g == 0) store(&y[base + (size_t)(t0 + tt) * step + j], acc);
    }
  }
  if (s_out) {
#pragma unroll
    for (int q = 0; q < MAX_R; ++q) {
      if (q < rows) s_out[sbase + (size_t)(q * ng + g) * d + j] = s[q];
    }
  }
}

// NG: the smallest power of two that leaves each thread at most MAX_R rows.
int groups(int d) {
  int ng = 1;
  while (d / ng > MAX_R) ng *= 2;
  return ng;
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* s_init, void* s_out, void* y, int b,
           int t, int h, int d, void* stream) {
  if (d % 16 != 0 || d < 16 || d > MAX_D) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b * h == 0) return 0;
  const int ng = groups(d);
  wkv_kernel<T><<<b * h, d * ng, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(w),
      static_cast<const T*>(u), static_cast<const float*>(s_init),
      static_cast<float*>(s_out), static_cast<T*>(y), t, h, d, ng);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rwkv6_wkv_bf16(const void* r, const void* k, const void* v,
                              const void* w, const void* u,
                              const void* s_init, void* s_out, void* y,
                              int b, int t, int h, int d, void* stream) {
  return launch<__nv_bfloat16>(r, k, v, w, u, s_init, s_out, y, b, t, h, d,
                               stream);
}

extern "C" int rwkv6_wkv_f32(const void* r, const void* k, const void* v,
                             const void* w, const void* u,
                             const void* s_init, void* s_out, void* y, int b,
                             int t, int h, int d, void* stream) {
  return launch<float>(r, k, v, w, u, s_init, s_out, y, b, t, h, d, stream);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
