// apr_conv: NHWC 2-D convolution as an implicit GEMM whose fp32 accumulator
// stays in registers across the whole Hf·Wf·C reduction -- the paper's
// architectural pipeline register (APR) -- and is written to device memory
// once, with an optional epilogue activation(acc + bias) applied at that
// flush.  apr_conv_hbm is the paper's baseline on the same tiles: the fp32
// partial goes through global memory on every K step.
//
// Replaces: src/repro/kernels/apr_conv/kernel.py::conv2d_call and
// conv2d_fused_call (im2col, then apr_matmul_call with residency="apr",
// kernel body _apr_matmul_kernel, or apr_matmul_fused_call), and, for
// apr_conv_hbm, apr_matmul_call with residency="hbm" (kernel body
// _hbm_matmul_kernel) under apr_conv2d(residency="hbm").
//
// What bounds it on an H100: the paper's networks are narrow (M = 6 .. 64
// output channels, a reduction of 25 .. 576), so a conv does 2·K
// operations per output value on inputs that are read ~Hf·Wf times from
// cache.  Without the tensor cores (the reference is exact fp32; TF32 would
// round the inputs) the fp32 FMA rate, 67 TFLOP/s, is the ceiling; device
// memory (3.35 TB/s) binds only the 1x1 shortcut convs.
//
// Design:
//  * the GEMM is (B·Ho·Wo pixels) x (M channels) over K = Hf·Wf·C; a block
//    owns a BP x BN output tile (BN = 16, 32 or 64 from M, so LeNet's M = 6
//    does not run 64-wide) and walks K in steps of BK = 32;
//  * the load stage gathers the (BP x BK) patch tile straight from the NHWC
//    input, k = (di·Wf + dj)·C + c (the row order of f.reshape(K, M)), with
//    padding, image edges and the ragged K tail zero-filled; no im2col
//    matrix is ever written.  Each thread owns one k of the tile and
//    decodes it once per step; the block decodes its pixels once;
//  * 256 threads, each with a 4 x 4 register micro-tile (pixels strided by
//    the thread rows, channels by the thread columns, so shared-memory reads
//    are conflict-free and the NHWC store is contiguous across channels);
//  * bf16 inputs are widened to fp32 at the load, so every product is exact
//    and the sum is fp32, as in the JAX kernel; the output is fp32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "epilogue.cuh"

namespace {

constexpr int BK = 32;               // K step: one shared-memory tile
constexpr int THREADS = 256;
constexpr int TP = 4, TN = 4;        // register micro-tile per thread
constexpr int FAR = -(1 << 29);      // a row index no edge test accepts

template <int BN>
struct Tile {
  static constexpr int TXN = BN / TN;          // threads across channels
  static constexpr int TYP = THREADS / TXN;    // threads across pixels
  static constexpr int BP = TYP * TP;          // pixels per block
  static constexpr int LDA = BP + 1;           // odd stride: the transposed
};                                             // stores hit 32 banks

struct Geom {
  int H, W, C, Wf, M, stride, pad, Ho, Wo;
  int P;                             // B·Ho·Wo output pixels
  int K;                             // Hf·Wf·C
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// The block's BP x BN tile of the product over k in [k_begin, k_end),
// accumulated into acc in steps of BK.
template <typename T, int BN>
__device__ __forceinline__ void conv_tile(const T* __restrict__ x,
                                          const T* __restrict__ f,
                                          const Geom& g, int p0, int n0,
                                          int k_begin, int k_end,
                                          float (&acc)[TP][TN]) {
  using Tl = Tile<BN>;
  __shared__ float As[BK][Tl::LDA];              // patch tile, k-major
  __shared__ float Bs[BK][BN];                   // filter tile
  __shared__ int pix_base[Tl::BP], pix_h[Tl::BP], pix_w[Tl::BP];

  const int tid = threadIdx.x;
  const int tx = tid % Tl::TXN, ty = tid / Tl::TXN;

  // each output pixel's top-left input corner, once per block
  for (int i = tid; i < Tl::BP; i += THREADS) {
    int p = p0 + i;
    if (p < g.P) {
      int wo = p % g.Wo, t = p / g.Wo;
      int ho = t % g.Ho, b = t / g.Ho;
      int hi = ho * g.stride - g.pad, wi = wo * g.stride - g.pad;
      pix_h[i] = hi;
      pix_w[i] = wi;
      pix_base[i] = ((b * g.H + hi) * g.W + wi) * g.C;
    } else {
      pix_h[i] = FAR;                            // a pixel past the end
      pix_w[i] = 0;
      pix_base[i] = 0;
    }
  }

  const int kk = tid % BK;                       // this thread's k in a tile
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();             // tables written / previous tile consumed
    int k = k0 + kk, di = FAR, dj = 0, koff = 0;
    if (k < k_end) {
      int c = k % g.C, t = k / g.C;
      dj = t % g.Wf;
      di = t / g.Wf;
      koff = (di * g.W + dj) * g.C + c;
    }
    for (int pp = tid / BK; pp < Tl::BP; pp += THREADS / BK) {
      int hi = pix_h[pp] + di, wi = pix_w[pp] + dj;
      float v = 0.0f;
      if ((unsigned)hi < (unsigned)g.H && (unsigned)wi < (unsigned)g.W)
        v = to_float(x[pix_base[pp] + koff]);
      As[kk][pp] = v;
    }
    for (int idx = tid; idx < BK * BN; idx += THREADS) {
      int r = idx / BN, col = idx % BN;
      int kr = k0 + r, n = n0 + col;
      Bs[r][col] = (kr < k_end && n < g.M)
                       ? to_float(f[(size_t)kr * g.M + n]) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < BK; ++q) {
      float a[TP], b[TN];
#pragma unroll
      for (int i = 0; i < TP; ++i) a[i] = As[q][ty + i * Tl::TYP];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[q][tx + j * Tl::TXN];
#pragma unroll
      for (int i = 0; i < TP; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
}

// APR residency: the whole reduction in registers, one flush with the
// epilogue (act 0 none, 1 relu, 2 silu, 3 gelu-tanh; bias may be null).
template <typename T, int BN>
__global__ void __launch_bounds__(THREADS)
    apr_conv_kernel(const T* __restrict__ x, const T* __restrict__ f,
                    const float* __restrict__ bias, float* __restrict__ out,
                    Geom g, int act) {
  using Tl = Tile<BN>;
  const int p0 = blockIdx.x * Tl::BP, n0 = blockIdx.y * BN;
  float acc[TP][TN] = {};
  conv_tile<T, BN>(x, f, g, p0, n0, 0, g.K, acc);
  const int tx = threadIdx.x % Tl::TXN, ty = threadIdx.x / Tl::TXN;
#pragma unroll
  for (int i = 0; i < TP; ++i) {
    int p = p0 + ty + i * Tl::TYP;
    if (p >= g.P) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      int n = n0 + tx + j * Tl::TXN;
      if (n < g.M) {
        float v = acc[i][j];
        if (bias != nullptr) v = __fadd_rn(v, bias[n]);
        out[(size_t)p * g.M + n] = activate(v, act);
      }
    }
  }
}

// Memory residency (the baseline): one launch per K step; each reads the
// fp32 partial of the steps before it, adds its own product and writes the
// partial back (the first step writes without reading).
template <typename T, int BN>
__global__ void __launch_bounds__(THREADS)
    apr_conv_hbm_kernel(const T* __restrict__ x, const T* __restrict__ f,
                        float* __restrict__ out, Geom g, int step) {
  using Tl = Tile<BN>;
  const int p0 = blockIdx.x * Tl::BP, n0 = blockIdx.y * BN;
  const int k_begin = step * BK;
  const int k_end = min(g.K, k_begin + BK);
  float acc[TP][TN] = {};
  conv_tile<T, BN>(x, f, g, p0, n0, k_begin, k_end, acc);
  const int tx = threadIdx.x % Tl::TXN, ty = threadIdx.x / Tl::TXN;
#pragma unroll
  for (int i = 0; i < TP; ++i) {
    int p = p0 + ty + i * Tl::TYP;
    if (p >= g.P) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      int n = n0 + tx + j * Tl::TXN;
      if (n < g.M) {
        size_t o = (size_t)p * g.M + n;
        out[o] = step == 0 ? acc[i][j] : out[o] + acc[i][j];
      }
    }
  }
}

template <typename T, int BN>
int launch(const void* x, const void* f, const float* bias, float* out,
           const Geom& g, int act, int step, bool hbm, cudaStream_t s) {
  using Tl = Tile<BN>;
  dim3 grid((g.P + Tl::BP - 1) / Tl::BP, (g.M + BN - 1) / BN);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  const T* px = static_cast<const T*>(x);
  const T* pf = static_cast<const T*>(f);
  if (hbm)
    apr_conv_hbm_kernel<T, BN><<<grid, THREADS, 0, s>>>(px, pf, out, g, step);
  else
    apr_conv_kernel<T, BN><<<grid, THREADS, 0, s>>>(px, pf, bias, out, g, act);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_any(const void* x, const void* f, const float* bias, float* out,
               const Geom& g, int act, int step, bool hbm, cudaStream_t s) {
  if (g.M <= 16)
    return launch<T, 16>(x, f, bias, out, g, act, step, hbm, s);
  if (g.M <= 32)
    return launch<T, 32>(x, f, bias, out, g, act, step, hbm, s);
  return launch<T, 64>(x, f, bias, out, g, act, step, hbm, s);
}

// The geometry, or false when it is not one the kernels take.
bool make_geom(int b, int h, int w, int c, int hf, int wf, int m, int stride,
               int pad, Geom* g) {
  if (b <= 0 || h <= 0 || w <= 0 || c <= 0 || hf <= 0 || wf <= 0 || m <= 0 ||
      stride <= 0 || pad < 0)
    return false;
  int ho = (h + 2 * pad - hf) / stride + 1;
  int wo = (w + 2 * pad - wf) / stride + 1;
  if (h + 2 * pad < hf || w + 2 * pad < wf) return false;
  long long pixels = (long long)b * ho * wo;
  if ((long long)b * h * w * c >= (1LL << 31) || pixels * m >= (1LL << 31) ||
      (long long)hf * wf * c * m >= (1LL << 31))
    return false;
  *g = Geom{h, w, c, wf, m, stride, pad, ho, wo, (int)pixels, hf * wf * c};
  return true;
}

int run(const void* x, const void* f, const void* bias, void* out, int b,
        int h, int w, int c, int hf, int wf, int m, int stride, int pad,
        int bf16, int act, int step, bool hbm, void* stream) {
  Geom g;
  if (!make_geom(b, h, w, c, hf, wf, m, stride, pad, &g) || act < 0 ||
      act > 3 || step < 0 || step * BK >= g.K)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* pb = static_cast<const float*>(bias);
  float* po = static_cast<float*>(out);
  if (bf16)
    return launch_any<__nv_bfloat16>(x, f, pb, po, g, act, step, hbm, s);
  return launch_any<float>(x, f, pb, po, g, act, step, hbm, s);
}

}  // namespace

// out (B, Ho, Wo, M) fp32 = act(x (B, H, W, C) ⊛ f (Hf, Wf, C, M) + bias):
// x and f contiguous NHWC / HWIO, both fp32 (bf16 == 0) or both bf16; bias
// fp32 (M,) or null; act 0 none, 1 relu, 2 silu, 3 gelu-tanh.  Launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int apr_conv(const void* x, const void* f, const void* bias,
                        void* out, int b, int h, int w, int c, int hf, int wf,
                        int m, int stride, int pad, int bf16, int act,
                        void* stream) {
  return run(x, f, bias, out, b, h, w, c, hf, wf, m, stride, pad, bf16, act,
             0, false, stream);
}

// Step `step` of the memory-resident baseline: out += the product over
// k in [32·step, 32·step + 32) (out = it, for step 0).  The caller launches
// steps 0, 1, ... ceil(Hf·Wf·C / 32) - 1 in order on one stream.
extern "C" int apr_conv_hbm(const void* x, const void* f, void* out, int b,
                            int h, int w, int c, int hf, int wf, int m,
                            int stride, int pad, int bf16, int step,
                            void* stream) {
  return run(x, f, nullptr, out, b, h, w, c, hf, wf, m, stride, pad, bf16, 0,
             step, true, stream);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
