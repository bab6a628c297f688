// mamba2_ssd: the Mamba-2 SSD recurrence with the (P, N) state kept in
// registers across the whole time loop and written once -- the APR pattern
// applied to a decaying accumulator.  Per (batch row, head), scalar decay:
//
//   h  <- exp(a · dt_t) h + dt_t x_t b_t^T          h: (P, N)
//   y_t = h c_t + d · x_t
//
// extended by an optional initial state in (h_init, fp32 (B, H, P, N)) and
// final state out (h_out), which the serving path needs; with neither it
// is exactly the TPU kernel (state starts at zero, none comes out).
//
// Replaces: src/repro/kernels/mamba2/kernel.py::mamba2_call (kernel body
// _mamba2_kernel).
//
// What bounds it on an H100: the function needs 5 fp32 operations per
// state element per step (upd = (dt x_p) b_n, with dt x_p formed once per
// row; h = exp(a dt) h + upd; y_p += h c_n); this kernel spends 6, forming
// dt (x_p b_n) per element.  Against P values in and P out per head per
// step (b and c are shared by the heads), that is far above the fp32
// ridge, so over a long prompt the operations bound it.  At a decode step
// (T = 1) the state (32 KB per head at P = 64, N = 128) read and written
// once is nearly all the bytes: bound by them, and in practice by one
// round trip to memory per block.
//
// Design:
//  * one block per (b, h); thread (p, g) owns row p of h and the columns
//    n = q·NG + g (q < R = N/NG, NG the smallest power of two with R <= 32),
//    so its R state values live in registers for the whole launch;
//  * the NG threads of one row are adjacent lanes of one warp, so y_p, the
//    sum over n, is a warp-shuffle reduction with no barrier per step;
//  * b and c are (B, T, N), indexed by batch row and shared by the block's
//    head, never broadcast over heads in memory (the TPU wrapper
//    materialises the broadcast); x, b and c are read through their
//    strides, so the column slices of the fused in-projection need no copy;
//  * x, b, c and dt of CH = 16 time steps at a time are staged in shared
//    memory (widened to fp32; the TPU kernel's time chunk);
//  * per element the update is the reference's, in its order:
//    upd = dt (x_p b_n); h = exp(a dt) h + upd; y_p += h c_n; then
//    y_p + d x_p (nvcc may contract into FMAs: a one-ulp difference from
//    the plain version, held to a tolerance).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int CH = 16;                 // time steps staged per round
constexpr int MAX_P = 64, MAX_N = 128, MAX_R = 32;
constexpr int MAX_THREADS = MAX_P * (MAX_N / 16);

__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

// T: the element type of x, b, c and y (bf16 or fp32); dt, a, d are fp32.
// Strides are in elements; x's last axis, b's and c's last axis, dt
// (B, T, H) and y (B, T, H, P) are contiguous.
template <typename T>
__global__ void __launch_bounds__(MAX_THREADS) ssd_kernel(
    const T* __restrict__ x,        // (B, T, H, P)
    const T* __restrict__ bm,       // (B, T, N)
    const T* __restrict__ cm,       // (B, T, N)
    const float* __restrict__ dt,   // (B, T, H)
    const float* __restrict__ a,    // (H,) negative
    const float* __restrict__ dskip,  // (H,)
    const float* h_init,            // (B, H, P, N) or null (zeros)
    float* h_out,                   // (B, H, P, N) or null; may be h_init
    T* __restrict__ y,              // (B, T, H, P)
    int tlen, int nh, int np, int nn, int ng, long long x_sb, long long x_st,
    long long x_sh, long long b_sb, long long b_st, long long c_sb,
    long long c_st) {
  __shared__ float sx[CH][MAX_P], sb[CH][MAX_N], sc[CH][MAX_N], sdt[CH];
  const int bh = blockIdx.x, b = bh / nh, h = bh % nh;
  const int tid = threadIdx.x, p = tid / ng, g = tid % ng;
  const int cols = nn / ng;
  const size_t sbase = ((size_t)bh * np + p) * nn;
  float hs[MAX_R];
#pragma unroll
  for (int q = 0; q < MAX_R; ++q) {
    if (q < cols) hs[q] = h_init ? h_init[sbase + q * ng + g] : 0.f;
  }
  const float ah = a[h], dh = dskip[h];
  const T* xb = x + b * x_sb + h * x_sh;
  const T* bb = bm + b * b_sb;
  const T* cb = cm + b * c_sb;
  for (int t0 = 0; t0 < tlen; t0 += CH) {
    const int n = min(CH, tlen - t0);
    __syncthreads();                // the previous round's reads are done
    for (int e = tid; e < n * np; e += blockDim.x) {
      const int tt = e / np, i = e % np;
      sx[tt][i] = widen(xb[(t0 + tt) * x_st + i]);
    }
    for (int e = tid; e < n * nn; e += blockDim.x) {
      const int tt = e / nn, i = e % nn;
      sb[tt][i] = widen(bb[(t0 + tt) * b_st + i]);
      sc[tt][i] = widen(cb[(t0 + tt) * c_st + i]);
    }
    for (int e = tid; e < n; e += blockDim.x) {
      sdt[e] = dt[((size_t)b * tlen + t0 + e) * nh + h];
    }
    __syncthreads();
    for (int tt = 0; tt < n; ++tt) {
      const float dtt = sdt[tt];
      const float decay = expf(ah * dtt);
      const float xp = sx[tt][p];
      float acc = 0.f;
#pragma unroll
      for (int q = 0; q < MAX_R; ++q) {
        if (q < cols) {
          const int i = q * ng + g;
          const float upd = dtt * (xp * sb[tt][i]);
          hs[q] = decay * hs[q] + upd;
          acc += hs[q] * sc[tt][i];
        }
      }
      for (int off = ng / 2; off > 0; off >>= 1) {
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      }
      if (g == 0) {
        store(&y[(((size_t)b * tlen + t0 + tt) * nh + h) * np + p],
              acc + dh * xp);
      }
    }
  }
  if (h_out) {
#pragma unroll
    for (int q = 0; q < MAX_R; ++q) {
      if (q < cols) h_out[sbase + q * ng + g] = hs[q];
    }
  }
}

// NG: the smallest power of two that leaves each thread at most MAX_R
// columns.
int groups(int n) {
  int ng = 1;
  while (n / ng > MAX_R) ng *= 2;
  return ng;
}

template <typename T>
int launch(const void* x, const void* bm, const void* cm, const void* dt,
           const void* a, const void* d, const void* h_init, void* h_out,
           void* y, int b, int t, int h, int p, int n, long long x_sb,
           long long x_st, long long x_sh, long long b_sb, long long b_st,
           long long c_sb, long long c_st, void* stream) {
  if (p % 16 != 0 || p < 16 || p > MAX_P || n % 16 != 0 || n < 16 ||
      n > MAX_N) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b * h == 0) return 0;
  const int ng = groups(n);
  ssd_kernel<T><<<b * h, p * ng, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(bm),
      static_cast<const T*>(cm), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const float*>(d),
      static_cast<const float*>(h_init), static_cast<float*>(h_out),
      static_cast<T*>(y), t, h, p, n, ng, x_sb, x_st, x_sh, b_sb, b_st, c_sb,
      c_st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int mamba2_ssd_bf16(const void* x, const void* bm, const void* cm,
                               const void* dt, const void* a, const void* d,
                               const void* h_init, void* h_out, void* y,
                               int b, int t, int h, int p, int n,
                               long long x_sb, long long x_st, long long x_sh,
                               long long b_sb, long long b_st, long long c_sb,
                               long long c_st, void* stream) {
  return launch<__nv_bfloat16>(x, bm, cm, dt, a, d, h_init, h_out, y, b, t,
                               h, p, n, x_sb, x_st, x_sh, b_sb, b_st, c_sb,
                               c_st, stream);
}

extern "C" int mamba2_ssd_f32(const void* x, const void* bm, const void* cm,
                              const void* dt, const void* a, const void* d,
                              const void* h_init, void* h_out, void* y, int b,
                              int t, int h, int p, int n, long long x_sb,
                              long long x_st, long long x_sh, long long b_sb,
                              long long b_st, long long c_sb, long long c_st,
                              void* stream) {
  return launch<float>(x, bm, cm, dt, a, d, h_init, h_out, y, b, t, h, p, n,
                       x_sb, x_st, x_sh, b_sb, b_st, c_sb, c_st, stream);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
