// apr_conv: NHWC 2-D convolution as an implicit GEMM whose fp32 accumulator
// stays in registers across the whole Hf·Wf·C reduction -- the paper's
// architectural pipeline register (APR) -- and is written to device memory
// once, with an optional epilogue activation(acc + bias) applied at that
// flush.  apr_conv_hbm is the paper's baseline on the same tiles: the fp32
// partial goes through global memory on every K step, in one launch.
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
//
// Memory residency (apr_conv_hbm, B4c): one launch per conv, the same grid
// and tiles.  Each block walks all K steps of BK = 32 rows itself; a step
// is a fresh fp32 FMA chain over its 32 rows (the same loads and FMAs as
// the APR kernel's step), then partial = ld.global.cg(out) + step sum,
// st.global.cg(out); the first step writes without reading.  The partial's
// load is issued before the step's FMAs, which do not depend on it, so the
// round trip overlaps the arithmetic without changing the order of any sum:
// its bits are those of one launch per K step.  The loads and stores are
// partial.cuh's (volatile asm with a memory clobber), so neither the
// compiler nor L1 keeps the partial on chip; the partial (up to 16.8 MB
// for a ResNet-20 conv at batch 256) fits the H100's 50 MB L2, so on this
// card it travels to L2 and back, not necessarily to device memory.  The
// order of the sums is the JAX kernel's (im2col, then partial +
// dot(x_tile, y_tile) per K tile) at a K tile of 32.
// SASS (cuobjdump -sass of the built library, sm_90a, kept by chip_smoke.py
// --baseline): in the K-step loop of the fp32 baseline at 16 channels every
// step issues 16 LDG.E.STRONG.GPU (the partial's loads, before the step's
// FMAs) and 16 STG.E.STRONG.GPU (after them), one of each per output of a
// thread's 4 x 4 micro-tile.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "epilogue.cuh"
#include "partial.cuh"

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

// The conv over the block's BP x BN output tile, K in steps of BK.  APR
// residency (HBM false): one accumulator for the whole reduction, one
// flush with the epilogue (act 0 none, 1 relu, 2 silu, 3 gelu-tanh; bias
// may be null).  Memory residency (HBM): a fresh accumulator each step,
// added to the fp32 partial in `out` of the steps before it (the first
// step writes without reading).
template <typename T, int BN, bool HBM>
__global__ void __launch_bounds__(THREADS)
    conv_kernel(const T* __restrict__ x, const T* __restrict__ f,
                const float* __restrict__ bias, float* __restrict__ out,
                Geom g, int act) {
  using Tl = Tile<BN>;
  __shared__ float As[BK][Tl::LDA];              // patch tile, k-major
  __shared__ float Bs[BK][BN];                   // filter tile
  __shared__ int pix_base[Tl::BP], pix_h[Tl::BP], pix_w[Tl::BP];

  const int tid = threadIdx.x;
  const int tx = tid % Tl::TXN, ty = tid / Tl::TXN;
  const int p0 = blockIdx.x * Tl::BP, n0 = blockIdx.y * BN;

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

  float acc[TP][TN] = {};
  const int kk = tid % BK;                       // this thread's k in a tile
  for (int k0 = 0; k0 < g.K; k0 += BK) {
    float prev[HBM ? TP : 1][TN];    // HBM: the partial of the steps < k0
    if constexpr (HBM) {
#pragma unroll
      for (int i = 0; i < TP; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int p = p0 + ty + i * Tl::TYP, n = n0 + tx + j * Tl::TXN;
          prev[i][j] = k0 > 0 && p < g.P && n < g.M
                           ? ld_cg(out + (size_t)p * g.M + n) : 0.0f;
        }
    }
    __syncthreads();             // tables written / previous tile consumed
    int k = k0 + kk, di = FAR, dj = 0, koff = 0;
    if (k < g.K) {
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
      Bs[r][col] = (kr < g.K && n < g.M)
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
    if constexpr (HBM) {
#pragma unroll
      for (int i = 0; i < TP; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int p = p0 + ty + i * Tl::TYP, n = n0 + tx + j * Tl::TXN;
          if (p < g.P && n < g.M)
            st_cg(out + (size_t)p * g.M + n,
                  k0 > 0 ? __fadd_rn(prev[i][j], acc[i][j]) : acc[i][j]);
          acc[i][j] = 0.0f;
        }
    }
  }
  if constexpr (!HBM) {
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
}

template <typename T, int BN>
int launch(const void* x, const void* f, const float* bias, float* out,
           const Geom& g, int act, bool hbm, cudaStream_t s) {
  using Tl = Tile<BN>;
  dim3 grid((g.P + Tl::BP - 1) / Tl::BP, (g.M + BN - 1) / BN);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  const T* px = static_cast<const T*>(x);
  const T* pf = static_cast<const T*>(f);
  if (hbm)
    conv_kernel<T, BN, true><<<grid, THREADS, 0, s>>>(px, pf, nullptr, out, g,
                                                      0);
  else
    conv_kernel<T, BN, false><<<grid, THREADS, 0, s>>>(px, pf, bias, out, g,
                                                       act);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_any(const void* x, const void* f, const float* bias, float* out,
               const Geom& g, int act, bool hbm, cudaStream_t s) {
  if (g.M <= 16) return launch<T, 16>(x, f, bias, out, g, act, hbm, s);
  if (g.M <= 32) return launch<T, 32>(x, f, bias, out, g, act, hbm, s);
  return launch<T, 64>(x, f, bias, out, g, act, hbm, s);
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
        int bf16, int act, bool hbm, void* stream) {
  Geom g;
  if (!make_geom(b, h, w, c, hf, wf, m, stride, pad, &g) || act < 0 ||
      act > 3)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* pb = static_cast<const float*>(bias);
  float* po = static_cast<float*>(out);
  if (bf16) return launch_any<__nv_bfloat16>(x, f, pb, po, g, act, hbm, s);
  return launch_any<float>(x, f, pb, po, g, act, hbm, s);
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
             false, stream);
}

// The memory-resident baseline, out = x ⊛ f as for apr_conv (no bias, no
// activation) in one launch: out is the fp32 partial, read and written at
// every K step of 32 rows of Hf·Wf·C (the first step only writes).
extern "C" int apr_conv_hbm(const void* x, const void* f, void* out, int b,
                            int h, int w, int c, int hf, int wf, int m,
                            int stride, int pad, int bf16, void* stream) {
  return run(x, f, nullptr, out, b, h, w, c, hf, wf, m, stride, pad, bf16, 0,
             true, stream);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
