// apr_conv: NHWC 2-D convolution as an implicit GEMM whose fp32 accumulator
// stays in registers across the whole Hf·Wf·C reduction -- the paper's
// architectural pipeline register (APR) -- and is written to device memory
// once, with an optional epilogue activation(acc + bias) applied at that
// flush.  apr_conv_hbm is the paper's baseline: the fp32 partial goes
// through global memory on every K step, in one launch.
//
// Replaces: src/repro/kernels/apr_conv/kernel.py::conv2d_call and
// conv2d_fused_call (im2col, then apr_matmul_call with residency="apr",
// kernel body _apr_matmul_kernel, or apr_matmul_fused_call), and, for
// apr_conv_hbm, apr_matmul_call with residency="hbm" (kernel body
// _hbm_matmul_kernel) under apr_conv2d(residency="hbm").
//
// Numerics (both kernels): every output is one fp32 fmaf chain over
// k = (di·Wf + dj)·C + c in ascending order -- the im2col column order, the
// row order of f.reshape(K, M) -- from +0, with exact fp32 products (bf16
// inputs are widened exactly).  Padding and the channels that round C up
// to 4 enter as fmaf(0, w, acc) == acc, so the bits depend on neither the
// tile nor the batch.  The tensor cores cannot give exact fp32 products,
// so both kernels run on the FMA pipes.
//
// What bounds the APR kernel on an H100: the paper's networks are narrow
// (M = 6 .. 64 output channels, a reduction of 25 .. 576), so a conv does
// 2·K operations per output on inputs that every tap reads again.  The
// fp32 FMA rate, 67 TFLOP/s, is the ceiling; device memory (3.35 TB/s)
// binds only the 1x1 shortcut convs.  An SM issues one warp instruction a
// clock per scheduler, so every shared-memory load is an FFMA not issued:
// the first design (4 x 4 outputs a thread, 8 scalar LDS per 16 FFMA, a
// gather of each input Hf·Wf times from L1/L2, no overlap of loads and
// math) ran at 20 % of the bound.
//
// Design of apr_conv (conv_apr_kernel):
//  * a block owns a tile of ti images x th rows x tw columns of output
//    pixels (BP = ti·th·tw at most, chosen per geometry) and BN output
//    channels.  It stages the tile's input halo, ti x ((th-1)·s + Hf) x
//    ((tw-1)·s + Wf) pixels with their whole channel depth, into shared
//    memory once, by cp.async (16 bytes, or 8 for bf16, zero-filled
//    outside the image; 4-byte copies where C % 4 != 0); every tap then
//    reads it there, so each input value comes from L2 about once a block
//    instead of Hf·Wf times;
//  * a staged pixel's channels are padded to an odd number of 4-channel
//    groups, so the 4-channel loads of neighbouring pixels hit distinct
//    banks;
//  * the reduction walks steps of (tap, up to 64 channels): the filter's
//    (channels x BN) slice of a step rides a three-slot cp.async ring, the
//    slices of the next two steps landing while this one computes (one
//    barrier a step); a whole filter slice of at most 16 KB is staged once
//    with the halo instead.  With the whole C resident the chain runs
//    (di, dj) outer and c inner, exactly the k order;
//  * each thread holds TP = 4 pixels x TN = 8 channels (32 fp32
//    accumulators).  Per 4 channels it loads TN 4-wide filter values and
//    TP 4-wide input values (LDS.128, or LDS.64 for bf16) for 4·TP·TN =
//    128 FFMA, 12 loads where the first design issued 64;
//  * the tiles are sized by M (BN = 16, 32 or 64 channels over 256, 128 or
//    64 pixels at 128 threads: 128 registers, 4 blocks an SM, 3 at BN = 64
//    for its ring's 48 KB), so each ResNet-20 class runs 2 .. 4 blocks on
//    each of the 132 SMs;
//  * where the halo with the whole C does not fit in 227 KB of shared
//    memory (very wide rows or large filters), or the stride passes the
//    filter (the 1x1 shortcuts at stride 2, whose halo would be 3/4
//    pixels no tap reads), a step instead restages the tile's pixels
//    shifted by its tap for its channel range (the first design's
//    gather), which keeps the k order;
//  * the flush: v = acc (+ bias, __fadd_rn), activate(v, act) with the
//    activation a template argument picked once a block (a runtime act
//    inside the output loop cost as much as the math: each output ran
//    every activation's code), one store per output (16 bytes where
//    M % 4 == 0).
// SASS (cuobjdump -sass of the built library, sm_90a, kept by
// chip_smoke.py --baseline): the channel loop of the fp32 4 x 8 tiles,
// unrolled 4 times, is 512 FFMA, 48 LDS.128 and 20 address and loop
// instructions (88 % FFMA), 128 registers, no spills.  Measured on an H100
// SXM (--conv-ablation, timing-only variants): that loop alone runs at
// ~88 % of the FMA rate, but it is only ~45 % of a ResNet-20 forward's
// conv time.  The rest: ~10 % is the launch of each conv (an empty block
// costs 3-5 us a conv), ~14 % staging the halo (each class's blocks
// start together and load together, at ~2 TB/s), ~10 % the loop's
// shared loads of the filter, the rest the steps' waits and barriers,
// the flush's stores and the wave tail.  Persistent blocks with a second
// halo buffer, loading a tile's halo while the one before computes,
// measured slower: the second buffer costs a block an SM, and 2 .. 4
// tiles an SM do not spread evenly over fewer slots.
//
// Memory residency (apr_conv_hbm, B4c, conv_hbm_kernel): one launch per
// conv on the first design's tiles.  A block owns a BP x BN output tile
// (BN = 16, 32 or 64 from M, 4096 / BN pixels) and walks K in steps of
// BK = 32, gathering each (BP x BK) patch tile from the NHWC input; a step
// is a fresh fp32 FMA chain over its 32 rows on 4 x 4 outputs a thread,
// then partial = ld.global.cg(out) + step sum, st.global.cg(out); the
// first step writes without reading.  The partial's load is issued before
// the step's FMAs, which do not depend on it, so the round trip overlaps
// the arithmetic without changing the order of any sum: its bits are
// those of one launch per K step.  The loads and stores are partial.cuh's
// (volatile asm with a memory clobber), so neither the compiler nor L1
// keeps the partial on chip; the partial (up to 16.8 MB for a ResNet-20
// conv at batch 256) fits the H100's 50 MB L2, so on this card it travels
// to L2 and back, not necessarily to device memory.  The order of the
// sums is the JAX kernel's (im2col, then partial + dot(x_tile, y_tile) per
// K tile) at a K tile of 32.
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

// The APR kernel's compiled tiles, in order (the wrapper passes the index):
// X(BN channels, TN channels a thread, TP pixels a thread, threads, the
// largest M it is the default tile for).  8 x 8 tiles a thread (168
// registers, 3 blocks an SM) measured slower in every ResNet-20 class.
#define APR_CONV_TILES(X)        \
  X(16, 8, 4, 128, 16)           \
  X(32, 8, 4, 128, 32)           \
  X(64, 8, 4, 128, 1073741824)

namespace {

struct Geom {
  int B, H, W, C, Hf, Wf, M, stride, pad, Ho, Wo;
  int P;                             // B·Ho·Wo output pixels
  int K;                             // Hf·Wf·C
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// ------------------------------------------------------------ apr_conv

constexpr int STEP_CHANNELS = 64;    // channels of one tap a step walks
constexpr int RING = 3;              // filter slots: a step, the next two
constexpr int WHOLE_BYTES = 16384;   // a filter slice this small: staged
                                     // whole, once, for every step
constexpr int SMEM_MAX = 232448;     // shared memory a block can have

// What a launch of the APR kernel stages, computed on the host from the
// geometry and the tile.
struct Plan {
  Geom g;
  int ti, th, tw;          // a block's output tile: images x rows x cols
  int tiles_w, tiles_h, tiles_b;  // tiles across Wo, down Ho, over B
  int resident;            // 1: the tile's halo with every channel, staged
                           // once; 0: its pixels restaged every step
  int hrows, hcols;        // resident: staged rows an image, columns
  int cs;                  // elements between two staged pixels
  int c4;                  // C rounded up to 4: the channels walked
  int fc;                  // channels a step walks (a multiple of 4)
  int ring;                // filter slots of fc x BN: RING, or every
                           // step's (the whole slice staged once)
  int nch;                 // steps a tap: ceil(c4 / fc)
  int vec_x, vec_f;        // 4-element cp.async of x, of f
};

template <int BN_, int TN_, int TP_, int NT_>
struct ConvTile {
  static constexpr int BN = BN_, TN = TN_, TP = TP_, NT = NT_;
  static constexpr int TXN = BN / TN;          // threads across channels
  static constexpr int TYP = NT / TXN;         // threads across pixels
  static constexpr int BP = TYP * TP;          // pixels a block at most
  static_assert(TN % 4 == 0 && BN % TN == 0 && 32 % TXN == 0 &&
                    NT % 32 == 0,
                "4-channel groups, whole warps");
};

// Four consecutive elements from shared memory, widened to fp32 (exact).
__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 lds4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

template <typename T>
__device__ __forceinline__ T zero_of() {
  return T(0.0f);
}
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __ushort_as_bfloat16(0);
}

// Four consecutive elements global -> shared, zero-filled when !valid.
template <typename T>
__device__ __forceinline__ void cp_async4(T* dst, const T* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (sizeof(T) == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(valid ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
                 "l"(src), "r"(valid ? 8 : 0));
}

// One element global -> shared (src null: a zero): by cp.async for 4-byte
// elements, by a load and a store for 2-byte ones (cp.async moves 4 bytes
// at least).
template <typename T>
__device__ __forceinline__ void cp_async1(T* dst, const T* src,
                                          const T* any) {
  if constexpr (sizeof(T) == 4) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                 "l"(src != nullptr ? src : any),
                 "r"(src != nullptr ? 4 : 0));
  } else {
    *dst = src != nullptr ? *src : zero_of<T>();
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage `cells` pixels of `units` 4-element groups (vec) or elements into
// shared memory at dst + cell·cs; pixel `cell` comes from src_of(cell)
// (null: outside the input, zero-filled; `any` is a valid address for the
// zero-filling copies) and element u of it only where u < C.  Lanes split
// a pixel's units, so a warp covers 32 / units pixels at once.
template <typename T, class SrcOf>
__device__ __forceinline__ void stage_cells(T* dst, int cells, int cs,
                                            int units, int C, bool vec,
                                            int lane, const T* any,
                                            SrcOf src_of) {
  const int per = units < 32 ? 32 / units : 1;   // pixels a pass
  const int sub = units < 32 ? lane / units : 0;
  const int u0 = units < 32 ? lane - sub * units : lane;
  if (sub >= per) return;
  for (int cell = sub; cell < cells; cell += per) {
    const T* src = src_of(cell);
    T* d = dst + cell * cs;
    for (int u = u0; u < units; u += 32) {
      if (vec)
        cp_async4(d + 4 * u, src != nullptr ? src + 4 * u : any,
                  src != nullptr);
      else
        cp_async1(d + u, src != nullptr && u < C ? src + u : nullptr, any);
    }
  }
}

// The halo of the tile at (b0, ho0, wo0), every channel: staged row
// rr = qi·hrows + r is input row ho0·s - pad + r of image b0 + qi, column
// col is input column wo0·s - pad + col.  Each warp takes whole rows.
template <typename T, int NT>
__device__ __forceinline__ void stage_halo(T* hs, const T* x, const Plan& pl,
                                           int b0, int ho0, int wo0) {
  const Geom& g = pl.g;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int units = pl.vec_x ? g.C / 4 : pl.c4;
  const int ih0 = ho0 * g.stride - g.pad, iw0 = wo0 * g.stride - g.pad;
  for (int rr = warp; rr < pl.ti * pl.hrows; rr += NT / 32) {
    const int qi = rr / pl.hrows, b = b0 + qi, ih = ih0 + rr - qi * pl.hrows;
    const bool row_in = b < g.B && (unsigned)ih < (unsigned)g.H;
    const T* row = row_in ? x + ((size_t)b * g.H + ih) * g.W * g.C : x;
    stage_cells(hs + rr * pl.hcols * pl.cs, pl.hcols, pl.cs, units, g.C,
                pl.vec_x, lane, x, [&](int col) -> const T* {
                  const int iw = iw0 + col;
                  return row_in && (unsigned)iw < (unsigned)g.W
                             ? row + (size_t)iw * g.C : nullptr;
                });
  }
}

// The tile's pixels shifted by tap (di, dj), channels [c0, c0 + fc):
// pixel q of the tile at hs + q·cs (the restaging path).
template <typename T, int NT>
__device__ __forceinline__ void stage_window(T* hs, const T* x,
                                             const Plan& pl, int b0, int ho0,
                                             int wo0, int di, int dj, int c0) {
  const Geom& g = pl.g;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int npx = pl.ti * pl.th * pl.tw;
  const int chans = min(pl.fc, pl.c4 - c0);
  const int units = pl.vec_x ? chans / 4 : chans;
  const int cmax = g.C - c0;                 // channels of x in the range
  const int per_warp = (npx + NT / 32 - 1) / (NT / 32);
  const int q0 = warp * per_warp, q1 = min(npx, q0 + per_warp);
  if (q0 >= q1) return;
  stage_cells(hs + q0 * pl.cs, q1 - q0, pl.cs, units, cmax, pl.vec_x, lane,
              x, [&](int cell) -> const T* {
                const int q = q0 + cell, px = pl.th * pl.tw;
                const int qi = q / px, qr = q - qi * px, qh = qr / pl.tw;
                const int b = b0 + qi;
                const int ih = (ho0 + qh) * g.stride - g.pad + di;
                const int iw = (wo0 + qr - qh * pl.tw) * g.stride - g.pad + dj;
                return b < g.B && (unsigned)ih < (unsigned)g.H &&
                               (unsigned)iw < (unsigned)g.W
                           ? x + (((size_t)b * g.H + ih) * g.W + iw) * g.C + c0
                           : nullptr;
              });
}

// The filter rows of step (tap, c0) -- f rows tap·C + c0 .. + fc, columns
// n0 .. n0 + BN -- into a slot of fc x BN; rows past C and columns past M
// are zero.
template <typename T, int BN, int NT>
__device__ __forceinline__ void stage_filter(T* slot, const T* f,
                                             const Plan& pl, int tap, int c0,
                                             int n0) {
  const Geom& g = pl.g;
  const int rows = min(pl.fc, pl.c4 - c0);
  const T* base = f + ((size_t)tap * g.C + c0) * g.M + n0;
  if (pl.vec_f) {
    for (int e = threadIdx.x; e < rows * (BN / 4); e += NT) {
      const int r = e / (BN / 4), v = e % (BN / 4);
      const bool ok = c0 + r < g.C && n0 + 4 * v < g.M;
      cp_async4(slot + r * BN + 4 * v, ok ? base + (size_t)r * g.M + 4 * v : f,
                ok);
    }
  } else {
    for (int e = threadIdx.x; e < rows * BN; e += NT) {
      const int r = e / BN, col = e % BN;
      cp_async1(slot + e,
                c0 + r < g.C && n0 + col < g.M ? base + (size_t)r * g.M + col
                                               : nullptr,
                f);
    }
  }
}

// A step of the reduction: tap (di, dj) = tap index `tap`, channels c0 ..
// c0 + fc.  next() walks (di, dj) outer and c0 inner, the k order.
struct StepAt {
  int tap, di, dj, c0;
  __device__ __forceinline__ void next(const Plan& pl) {
    c0 += pl.fc;
    if (c0 < pl.c4) return;
    c0 = 0;
    ++tap;
    if (++dj == pl.g.Wf) {
      dj = 0;
      ++di;
    }
  }
};

// The first output pixel (b0, ho0, wo0) of tile t.
struct TileAt {
  int b0, ho0, wo0;
  __device__ __forceinline__ TileAt(const Plan& pl, int t) {
    wo0 = t % pl.tiles_w * pl.tw;
    t /= pl.tiles_w;
    ho0 = t % pl.tiles_h * pl.th;
    b0 = t / pl.tiles_h * pl.ti;
  }
};

// v = acc (+ bias), ACT applied, one store per output, for the tile at
// `at`; pq[i] packs pixel i's (qi, qh, qw) in the tile, -1 past its end.
template <int ACT, int BN, int TN, int TP, int TXN>
__device__ __forceinline__ void flush(const float (&acc)[TP][TN],
                                      const int (&pq)[TP], const Plan& pl,
                                      const TileAt& at,
                                      const float* __restrict__ bias,
                                      float* __restrict__ out, int n0,
                                      int tx) {
  const Geom& g = pl.g;
#pragma unroll
  for (int i = 0; i < TP; ++i) {
    const int b = at.b0 + (pq[i] >> 20), ho = at.ho0 + (pq[i] >> 10 & 1023);
    const int wo = at.wo0 + (pq[i] & 1023);
    if (pq[i] < 0 || b >= g.B || ho >= g.Ho || wo >= g.Wo) continue;
    float* o = out + (((size_t)b * g.Ho + ho) * g.Wo + wo) * g.M;
#pragma unroll
    for (int j4 = 0; j4 < TN / 4; ++j4) {
      const int n = n0 + (j4 * TXN + tx) * 4;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[e] = acc[i][4 * j4 + e];
        if (bias != nullptr && n + e < g.M)
          v[e] = __fadd_rn(v[e], bias[n + e]);
        v[e] = activate(v[e], ACT);
      }
      if (g.M % 4 == 0) {
        if (n < g.M)
          *reinterpret_cast<float4*>(o + n) = make_float4(v[0], v[1], v[2],
                                                          v[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (n + e < g.M) o[n + e] = v[e];
      }
    }
  }
}

template <typename T, int BN, int TN, int TP, int NT>
__global__ void __launch_bounds__(NT, 4)
    conv_apr_kernel(const T* __restrict__ x, const T* __restrict__ f,
                    const float* __restrict__ bias, float* __restrict__ out,
                    Plan pl, int act) {
  using Tl = ConvTile<BN, TN, TP, NT>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* const fslots = reinterpret_cast<T*>(smem);     // ring x (fc x BN)
  T* const hs = fslots + pl.ring * pl.fc * BN;      // halo or window
  const Geom& g = pl.g;
  const int tx = threadIdx.x % Tl::TXN, ty = threadIdx.x / Tl::TXN;
  const TileAt at(pl, blockIdx.x);
  const int n0 = blockIdx.y * BN;
  const int px = pl.th * pl.tw, npx = pl.ti * px;

  // each pixel's first staged element (pixels past the tile read pixel 0)
  // and its (qi, qh, qw) in the tile, packed (-1 past the tile)
  int pb[TP], pq[TP];
#pragma unroll
  for (int i = 0; i < TP; ++i) {
    const int q = ty + i * Tl::TYP;
    pb[i] = 0;
    pq[i] = -1;
    if (q < npx) {
      const int qi = q / px, qr = q - qi * px, qh = qr / pl.tw;
      const int qw = qr - qh * pl.tw;
      pb[i] = pl.resident ? ((qi * pl.hrows + qh * g.stride) * pl.hcols +
                             qw * g.stride) * pl.cs
                          : q * pl.cs;
      pq[i] = qi << 20 | qh << 10 | qw;
    }
  }

  // Groups of cp.async: the input with step 0's filter, step 1's filter
  // (with the whole slice: every other step's), then at every step s the
  // filter of step s + 2, so that a step waits for all but the newest
  // group -- but restaging, where every step waits for the window staged
  // after the step before, and with the whole slice, whose first step
  // waits for all and the others for nothing.
  const int steps = g.Hf * g.Wf * pl.nch;
  const bool whole = pl.resident && pl.ring >= steps;
  StepAt cur{0, 0, 0, 0}, pre{0, 0, 0, 0};
  if (pl.resident)
    stage_halo<T, NT>(hs, x, pl, at.b0, at.ho0, at.wo0);
  else
    stage_window<T, NT>(hs, x, pl, at.b0, at.ho0, at.wo0, 0, 0, 0);
  stage_filter<T, BN, NT>(fslots, f, pl, pre.tap, pre.c0, n0);
  cp_async_commit();
  pre.next(pl);
  for (int t = 1; t < (whole ? steps : 2) && t < steps; ++t) {
    stage_filter<T, BN, NT>(fslots + t * pl.fc * BN, f, pl, pre.tap, pre.c0,
                            n0);
    pre.next(pl);
  }
  cp_async_commit();

  float acc[TP][TN];
#pragma unroll
  for (int i = 0; i < TP; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  int slot = 0, pslot = 2;        // the slots of step s and of step s + 2
  for (int s = 0; s < steps; ++s) {
    if (whole) {
      if (s == 0) {
        cp_async_wait<0>();
        __syncthreads();          // the input and every filter staged
      }
    } else {
      if (pl.resident || s == 0)
        cp_async_wait<1>();
      else
        cp_async_wait<0>();
      __syncthreads();            // step s staged; step s - 1 consumed
      if (s + 2 < steps) {
        stage_filter<T, BN, NT>(fslots + pslot * pl.fc * BN, f, pl, pre.tap,
                                pre.c0, n0);
        pre.next(pl);
      }
      cp_async_commit();
      pslot = pslot == RING - 1 ? 0 : pslot + 1;
    }
    const int toff = pl.resident ? (cur.di * pl.hcols + cur.dj) * pl.cs +
                                       cur.c0
                                 : 0;
    const int chans = min(pl.fc, pl.c4 - cur.c0);
    const T* fs = fslots + slot * pl.fc * BN + 4 * tx;
    const T* xs = hs + toff;
    slot = whole || slot < RING - 1 ? slot + 1 : 0;
#pragma unroll 4
    for (int c = 0; c < chans; c += 4) {
      float b[4][TN];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j4 = 0; j4 < TN / 4; ++j4) {
          const float4 v = lds4(fs + (c + r) * BN + j4 * Tl::TXN * 4);
          b[r][4 * j4] = v.x;
          b[r][4 * j4 + 1] = v.y;
          b[r][4 * j4 + 2] = v.z;
          b[r][4 * j4 + 3] = v.w;
        }
#pragma unroll
      for (int i = 0; i < TP; ++i) {
        const float4 v = lds4(xs + pb[i] + c);
        const float a[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[i][j] = fmaf(a[r], b[r][j], acc[i][j]);
      }
    }
    cur.next(pl);
    if (!pl.resident && s + 1 < steps) {
      __syncthreads();            // the window of step s consumed
      stage_window<T, NT>(hs, x, pl, at.b0, at.ho0, at.wo0, cur.di, cur.dj,
                          cur.c0);
      cp_async_commit();
    }
  }

  // the flush, its activation fixed at compile time
  switch (act) {
    case 1:
      flush<1, BN, TN, TP, Tl::TXN>(acc, pq, pl, at, bias, out, n0, tx);
      break;
    case 2:
      flush<2, BN, TN, TP, Tl::TXN>(acc, pq, pl, at, bias, out, n0, tx);
      break;
    case 3:
      flush<3, BN, TN, TP, Tl::TXN>(acc, pq, pl, at, bias, out, n0, tx);
      break;
    default:
      flush<0, BN, TN, TP, Tl::TXN>(acc, pq, pl, at, bias, out, n0, tx);
  }
}

// An odd number of 4-element groups covering c elements: 4-wide loads of
// neighbouring staged pixels then fall in distinct banks.
int odd_groups(int c) {
  int n = (c + 3) / 4;
  return 4 * (n % 2 ? n : n + 1);
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// The plan of a launch of tile (BN, BP) on g; the shared bytes it needs.
int make_plan(const Geom& g, int BN, int BP, int esize, const void* x,
              const void* f, Plan* pl) {
  Plan p{};
  p.g = g;
  p.tw = g.Wo < BP ? g.Wo : BP;
  p.th = g.Ho < BP / p.tw ? g.Ho : BP / p.tw;
  p.ti = g.B < BP / (p.tw * p.th) ? g.B : BP / (p.tw * p.th);
  p.tiles_w = (g.Wo + p.tw - 1) / p.tw;
  p.tiles_h = (g.Ho + p.th - 1) / p.th;
  p.tiles_b = (g.B + p.ti - 1) / p.ti;
  p.c4 = (g.C + 3) / 4 * 4;
  p.vec_x = g.C % 4 == 0 && aligned(x, 4 * esize);
  p.vec_f = g.M % 4 == 0 && aligned(f, 4 * esize);
  p.fc = p.c4 < STEP_CHANNELS ? p.c4 : STEP_CHANNELS;
  p.resident = 1;
  p.hrows = (p.th - 1) * g.stride + g.Hf;
  p.hcols = (p.tw - 1) * g.stride + g.Wf;
  p.cs = odd_groups(p.c4);
  const int steps = g.Hf * g.Wf * ((p.c4 + p.fc - 1) / p.fc);
  p.ring = (long long)steps * p.fc * BN * esize <= WHOLE_BYTES ? steps : RING;
  long long bytes = ((long long)p.ring * p.fc * BN +
                     (long long)p.ti * p.hrows * p.hcols * p.cs) * esize;
  // restage the shifted tile at every step where the halo does not fit,
  // or where the stride passes the filter (a 1x1 conv at stride 2): most
  // of a halo would then be pixels no tap reads
  if (bytes > SMEM_MAX || g.stride > g.Hf || g.stride > g.Wf) {
    p.resident = 0;
    p.ring = RING;
    const int npx = p.ti * p.th * p.tw;
    for (;;) {
      p.cs = odd_groups(p.fc);
      bytes = ((long long)RING * p.fc * BN + (long long)npx * p.cs) * esize;
      if (bytes <= SMEM_MAX || p.fc == 4) break;
      p.fc -= 4;
    }
  }
  p.nch = (p.c4 + p.fc - 1) / p.fc;
  *pl = p;
  return (int)bytes;
}

// The opt-in to SMEM_MAX bytes of dynamic shared memory, and the whole of
// the SM's L1/shared carveout as shared memory, so that as many blocks fit
// as the registers allow.
template <class Kernel>
int configure(Kernel kernel) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  return (int)err;
}

// Launch tile <BN, TN, TP, NT> on g, or, with blocks_per_sm, only store
// how many of its blocks an SM holds at once.
template <typename T, int BN, int TN, int TP, int NT>
int launch_apr(const void* x, const void* f, const float* bias, float* out,
               const Geom& g, int act, cudaStream_t s,
               int* blocks_per_sm = nullptr) {
  using Tl = ConvTile<BN, TN, TP, NT>;
  Plan pl;
  const int smem = make_plan(g, BN, Tl::BP, (int)sizeof(T), x, f, &pl);
  const long long tiles = (long long)pl.tiles_w * pl.tiles_h * pl.tiles_b;
  const int slices = (g.M + BN - 1) / BN;
  if (tiles >= (1LL << 31) || slices > 65535 || smem > SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  auto kernel = conv_apr_kernel<T, BN, TN, TP, NT>;
  static int configured = 0;               // once per kernel
  if (!configured) {
    const int err = configure(kernel);
    if (err != 0) return err;
    configured = 1;
  }
  if (blocks_per_sm != nullptr)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm,
                                                              kernel, NT,
                                                              smem);
  kernel<<<dim3((unsigned)tiles, slices), NT, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(f), bias, out, pl, act);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_tile(int tile, const void* x, const void* f, const float* bias,
                float* out, const Geom& g, int act, cudaStream_t s,
                int* blocks_per_sm) {
  int index = 0;
#define APR_CONV_CASE(BN, TN, TP, NT, MMAX)                       \
  if (tile == index++)                                            \
    return launch_apr<T, BN, TN, TP, NT>(x, f, bias, out, g, act, s, \
                                         blocks_per_sm);
  APR_CONV_TILES(APR_CONV_CASE)
#undef APR_CONV_CASE
  return (int)cudaErrorInvalidValue;
}

// The default tile for m output channels: the first whose MMAX >= m.
int default_tile(int m) {
  int index = 0;
#define APR_CONV_DEFAULT(BN, TN, TP, NT, MMAX) \
  if (m <= MMAX) return index;                 \
  ++index;
  APR_CONV_TILES(APR_CONV_DEFAULT)
#undef APR_CONV_DEFAULT
  return -1;
}

// --------------------------------------------------------- apr_conv_hbm

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

// The conv over the block's BP x BN output tile, K in steps of BK: a fresh
// accumulator each step, added to the fp32 partial in `out` of the steps
// before it (the first step writes without reading).
template <typename T, int BN>
__global__ void __launch_bounds__(THREADS)
    conv_hbm_kernel(const T* __restrict__ x, const T* __restrict__ f,
                    float* __restrict__ out, Geom g) {
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
    float prev[TP][TN];              // the partial of the steps < k0
#pragma unroll
    for (int i = 0; i < TP; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int p = p0 + ty + i * Tl::TYP, n = n0 + tx + j * Tl::TXN;
        prev[i][j] = k0 > 0 && p < g.P && n < g.M
                         ? ld_cg(out + (size_t)p * g.M + n) : 0.0f;
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

template <typename T, int BN>
int launch_hbm(const void* x, const void* f, float* out, const Geom& g,
               cudaStream_t s) {
  using Tl = Tile<BN>;
  dim3 grid((g.P + Tl::BP - 1) / Tl::BP, (g.M + BN - 1) / BN);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  conv_hbm_kernel<T, BN><<<grid, THREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(f), out, g);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hbm_any(const void* x, const void* f, float* out, const Geom& g,
                   cudaStream_t s) {
  if (g.M <= 16) return launch_hbm<T, 16>(x, f, out, g, s);
  if (g.M <= 32) return launch_hbm<T, 32>(x, f, out, g, s);
  return launch_hbm<T, 64>(x, f, out, g, s);
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
  *g = Geom{b, h, w, c, hf, wf, m, stride, pad, ho, wo, (int)pixels,
            hf * wf * c};
  return true;
}

int run_apr(const void* x, const void* f, const void* bias, void* out, int b,
            int h, int w, int c, int hf, int wf, int m, int stride, int pad,
            int bf16, int act, int tile, void* stream,
            int* blocks_per_sm = nullptr) {
  Geom g;
  if (!make_geom(b, h, w, c, hf, wf, m, stride, pad, &g) || act < 0 ||
      act > 3)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* pb = static_cast<const float*>(bias);
  float* po = static_cast<float*>(out);
  if (bf16)
    return launch_tile<__nv_bfloat16>(tile, x, f, pb, po, g, act, s,
                                      blocks_per_sm);
  return launch_tile<float>(tile, x, f, pb, po, g, act, s, blocks_per_sm);
}

}  // namespace

// out (B, Ho, Wo, M) fp32 = act(x (B, H, W, C) ⊛ f (Hf, Wf, C, M) + bias):
// x and f contiguous NHWC / HWIO, both fp32 (bf16 == 0) or both bf16; bias
// fp32 (M,) or null; act 0 none, 1 relu, 2 silu, 3 gelu-tanh.  Runs the
// compiled tile `tile` (an index into APR_CONV_TILES; every tile gives the
// same bits).  Launches on `stream` and returns cudaGetLastError() (0 on
// success).
extern "C" int apr_conv_tile(const void* x, const void* f, const void* bias,
                             void* out, int b, int h, int w, int c, int hf,
                             int wf, int m, int stride, int pad, int bf16,
                             int act, int tile, void* stream) {
  return run_apr(x, f, bias, out, b, h, w, c, hf, wf, m, stride, pad, bf16,
                 act, tile, stream);
}

// How many blocks of tile `tile` an SM holds at once on this geometry
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor at the launch's shared
// memory), into *blocks; x and f only set the staging path.  Launches
// nothing.
extern "C" int apr_conv_blocks_per_sm(const void* x, const void* f, int b,
                                      int h, int w, int c, int hf, int wf,
                                      int m, int stride, int pad, int bf16,
                                      int tile, int* blocks) {
  return run_apr(x, f, nullptr, nullptr, b, h, w, c, hf, wf, m, stride, pad,
                 bf16, 0, tile, nullptr, blocks);
}

// apr_conv_tile on the default tile for m output channels.
extern "C" int apr_conv(const void* x, const void* f, const void* bias,
                        void* out, int b, int h, int w, int c, int hf, int wf,
                        int m, int stride, int pad, int bf16, int act,
                        void* stream) {
  return run_apr(x, f, bias, out, b, h, w, c, hf, wf, m, stride, pad, bf16,
                 act, default_tile(m), stream);
}

// The memory-resident baseline, out = x ⊛ f as for apr_conv (no bias, no
// activation) in one launch: out is the fp32 partial, read and written at
// every K step of 32 rows of Hf·Wf·C (the first step only writes).
extern "C" int apr_conv_hbm(const void* x, const void* f, void* out, int b,
                            int h, int w, int c, int hf, int wf, int m,
                            int stride, int pad, int bf16, void* stream) {
  Geom g;
  if (!make_geom(b, h, w, c, hf, wf, m, stride, pad, &g))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* po = static_cast<float*>(out);
  if (bf16) return launch_hbm_any<__nv_bfloat16>(x, f, po, g, s);
  return launch_hbm_any<float>(x, f, po, g, s);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
