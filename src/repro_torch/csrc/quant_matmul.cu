// quant_matmul: C = act(((float)(Xq · Yq) * xs[m]) * ys[n] + bias[n]), where
// Xq / xs are the per-row int8 codes and scales of a float X, quantized
// inside the launch, Yq an int8 weight with per-column scales ys, and the
// int32 accumulator resident in registers across each block's K range --
// the paper's APR at 8 bits -- with C written once, in fp32 or bf16.
// Without bias and activation it is B6, with them B8.
//
// Replaces: src/repro/kernels/quant_matmul/kernel.py::quant_matmul_call
// (kernel body _quant_matmul_kernel) and quant_matmul_fused_call
// (_quant_matmul_fused_kernel), and the activations' quantization the JAX
// wrappers run before them (quant_matmul/ops.py::quantize_activations).
//
// What bounds it on an H100: the serving shapes (M = 4 or 16 rows of
// activations against a (K, N) weight) do 2·M·K·N integer operations on
// K·N weight bytes -- 2·M per byte, far under the ~590 per byte at which
// the int8 tensor cores (1,979 TOP/s dense) become the limit, so the time
// is the time to stream Yq once at 3.35 TB/s.  That needs many bytes in
// flight: about 1 µs x 3.35 TB/s / 132 SMs ~ 25 KB of weight per SM.
//
// Design (one launch a call):
//  * split-K over a thread-block cluster, as apr_matmul.cu's bf16 body: the
//    K range of each column tile is cut into `splits` (1, 2, 4 or 8)
//    contiguous ranges of whole multiples of K_RANGE = 256 rows (the
//    largest compiled BK; the last range cut at K, ranges past K empty),
//    one block each; the blocks of one tile form one cluster (grid
//    (splits, N/BN, M/BM), cluster (splits, 1, 1));
//  * the activations' quantization, in the launch: each block first finds
//    the |x| maximum of each of its rows over its own K range (integer max
//    of the magnitudes' bits, exact), while its first ring stages are in
//    flight; the cluster's blocks combine their maxima through distributed
//    shared memory (max is exact, so no order question arises) into
//    scale = fl(amax > 0 ? amax : 1) * fl(1/127), the plain version's
//    arithmetic.  The raw x tile rides the cp.async ring beside the weight,
//    and each code is made where the MMA's A fragment is built:
//    clamp(round_half_even(fl32(x / scale)), -127, 127), with the IEEE fp32
//    quotient formed exactly in fp64 (code(), below: a per-element
//    __fdiv_rn measured slower at every projection shape on an H100);
//  * one template over the tile (BM x 64 x BK; QMM_TILES) and x's type
//    (bf16 or fp32); 4 warps, laid along K where BK allows (warp w takes
//    the 32-row chunks c of each stage with c % WK == w, WK = min(4, BK /
//    32)) and along N otherwise (BK = 64: 2 x 2), each warp holding all
//    BM rows x BN / WN columns as mma.sync m16n8k32 s8·s8 -> s32 fragments;
//    the warps' int32 partials are added once, at the flush;
//  * no transpose through shared memory: the MMA's B operand wants each
//    column's K values in one register, Yq is (K, N) row-major.  Thread
//    (g, t4) of a warp loads, for each of its 4 K rows t4 + 4j (j = 0..3;
//    the MMA's k index 4·t4 + j is mapped to row t4 + 4j, for A and B
//    alike, which no integer sum sees), the VB = 4 or 8 bytes of columns
//    VB·g .. VB·g + VB - 1 with one shared load, and turns the 4 words into
//    the B registers of VB fragments with 8 __byte_perm per 4 columns:
//    fragment j's column g is tile column VB·g + j (a permutation of the
//    columns, undone at the flush).  The per-step transpose, its stores and
//    its second barrier are gone: one barrier a stage;
//  * the weight tile is stored unpadded, its 16-byte chunks swizzled (byte
//    column c of row r at c ^ ((r & 2) << 4)), which keeps the fragment
//    loads free of bank conflicts; the ring holds ~48 KB of weight (3 to
//    8 stages, in dynamic shared memory), 16-byte cp.async copies
//    when K and N are multiples of 16 bytes' elements and both operands
//    16-byte aligned, masked element loads otherwise; rows of x at or past
//    M are never loaded (their codes are 0, their outputs dropped);
//  * each block adds its warps' int32 partials through shared memory; with
//    splits the cluster's blocks add those through distributed shared
//    memory (cluster.map_shared_rank) after cluster.sync().  int32 sums of
//    int8 products are exact (|sum| <= 127² K < 2^31 for K < 133,000), so
//    every tile and every split count gives the same bits;
//  * the flush computes ((float)acc * xs[m]) * ys[n], then + bias[n] and
//    the activation of epilogue.cuh, each step rounded on its own
//    (__fmul_rn, __fadd_rn: nvcc would otherwise contract them into an FMA),
//    in the JAX kernel's order, so with none/relu and an fp32 output it
//    equals the plain version bit for bit (bf16: the same value rounded).
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "epilogue.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int K_RANGE = 256;                  // split ranges: multiples of
constexpr int MAX_SPLITS = 8;                 // 256 rows; portable clusters
constexpr int WEIGHT_RING = 48 * 1024;        // weight bytes a ring holds
constexpr float INV_INT8_MAX = 0x1.020408p-7f;  // fp32(1 / 127)

// Shared-memory layout of a BM x BN x BK tile over x of type XT, in bytes:
// [ring of (x tile | swizzled Yq tile) stages | row maxima | row scales];
// the flush reuses the ring for the warps' int32 partials.
template <int BM, int BN, int BK, typename XT>
struct QTile {
  static constexpr int WARPS = 4, THREADS = 32 * WARPS;
  static constexpr int WK = BK / 32 < WARPS ? BK / 32 : WARPS;  // warps on K
  static constexpr int WN = WARPS / WK;       // warps on N
  static constexpr int WNC = BN / WN;         // columns per warp
  static constexpr int VB = WNC / 8;          // bytes a lane loads per k row
  static constexpr int FJ = VB;               // n8 fragments per warp
  static constexpr int FM = BM / 16;          // m16 fragments per warp
  static constexpr int CPW = BK / 32 / WK;    // 32-row chunks a warp a stage
  static constexpr int XE = 16 / (int)sizeof(XT);  // x elements per 16 bytes
  static constexpr int LDX = BK + XE;         // x row stride, elements
  static constexpr int X_STAGE = BM * LDX * (int)sizeof(XT);
  static constexpr int Y_STAGE = BK * BN;
  static constexpr int STAGE = X_STAGE + Y_STAGE;
  static constexpr int FIT = WEIGHT_RING / Y_STAGE;
  static constexpr int STAGES = FIT < 3 ? 3 : FIT > 8 ? 8 : FIT;
  static constexpr int RING = STAGES * STAGE;
  static constexpr int FLUSH = WK * BM * BN * 4;
  static constexpr int BODY = RING > FLUSH ? RING : FLUSH;
  static constexpr int SMEM = BODY + 2 * BM * 4;
  static_assert(BN == 64, "the weight tile's swizzle is laid out for 64 "
                          "columns");
  static_assert(BM % 16 == 0 && BK % 32 == 0 && K_RANGE % BK == 0 &&
                    WK * WN == WARPS && (VB == 4 || VB == 8),
                "whole m16n8k32 fragments per warp");
  static_assert(X_STAGE % 16 == 0 && STAGE % 16 == 0 && BODY % 16 == 0,
                "16-byte cp.async destinations");
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  int n = valid ? 16 : 0;                     // 0 bytes read: zero fill
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename XT>
__device__ __forceinline__ XT zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.0f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.0f);
}

// The magnitude bits of the elements of a 16-byte vector, as the largest
// of them: for non-negative floats (and bf16) the order of the bits is the
// order of the values, so the integer max is the exact |x| max.
__device__ __forceinline__ unsigned vec_absmax(uint4 v, float) {
  return max(max(v.x & 0x7fffffffu, v.y & 0x7fffffffu),
             max(v.z & 0x7fffffffu, v.w & 0x7fffffffu));
}
__device__ __forceinline__ unsigned vec_absmax(uint4 v, __nv_bfloat16) {
  // two bf16 magnitudes per word, max taken per 16-bit half
  const unsigned m = __vmaxu2(__vmaxu2(v.x & 0x7fff7fffu, v.y & 0x7fff7fffu),
                              __vmaxu2(v.z & 0x7fff7fffu, v.w & 0x7fff7fffu));
  return max(m & 0xffffu, m >> 16) << 16;     // as fp32 bits
}
__device__ __forceinline__ unsigned abs_bits(float v) {
  return __float_as_uint(v) & 0x7fffffffu;
}
__device__ __forceinline__ unsigned abs_bits(__nv_bfloat16 v) {
  return __float_as_uint(__bfloat162float(v)) & 0x7fffffffu;
}

// The int8 code of x under `scale`, as the plain version computes it:
// clamp(round_half_even(fl(x / scale)), -127, 127), with fl(x / scale) the
// IEEE fp32 quotient.  It is formed as fl32(x · inv) in fp64, inv =
// fl64(1 / scale) (divisor()): that product is within 2^-51.9 of x / scale
// (relative), while the exact quotient of two fp32 values is either an
// fp32 value or at least 2^-49 (relative) from every fp32 rounding
// boundary -- it is never a boundary itself, which would need 25
// significant bits in x -- so rounding the product to fp32 gives the IEEE
// quotient's bits, for every finite x and scale, without the branchy
// division sequence on each element.
using Divisor = double;
__device__ __forceinline__ Divisor divisor(float scale) {
  return __drcp_rn((double)scale);
}
__device__ __forceinline__ int code(float x, Divisor inv) {
  const float q = __double2float_rn(__dmul_rn((double)x, inv));
  return min(max(__float2int_rn(q), -127), 127);
}

// Four codes (low byte first) packed into one register.
__device__ __forceinline__ uint32_t pack4(int q0, int q1, int q2, int q3) {
  return __byte_perm(__byte_perm(q0, q1, 0x0040), __byte_perm(q2, q3, 0x0040),
                     0x5410);
}

// The A register of row `row` of the x tile at k rows k, k + 4, k + 8,
// k + 12: the codes the MMA's k indices 4·t4 .. 4·t4 + 3 take.
template <typename XT>
__device__ __forceinline__ uint32_t a_word(const XT* row, int k,
                                           Divisor inv) {
  return pack4(code(to_float(row[k]), inv), code(to_float(row[k + 4]), inv),
               code(to_float(row[k + 8]), inv),
               code(to_float(row[k + 12]), inv));
}

// Word j of the 4 x 4 byte block (4 k rows of 4 columns; byte p of w[r] is
// row r, column p) as column j's 4 k rows.
__device__ __forceinline__ void transpose4(const uint32_t (&w)[4],
                                           uint32_t (&t)[4]) {
  const uint32_t lo01 = __byte_perm(w[0], w[1], 0x5140);
  const uint32_t hi01 = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t lo23 = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t hi23 = __byte_perm(w[2], w[3], 0x7362);
  t[0] = __byte_perm(lo01, lo23, 0x5410);
  t[1] = __byte_perm(lo01, lo23, 0x7632);
  t[2] = __byte_perm(hi01, hi23, 0x5410);
  t[3] = __byte_perm(hi01, hi23, 0x7632);
}

// Byte offset of column `col` of weight-tile row `r`: 16-byte chunks
// swizzled by bit 1 of the row, so that the 4 rows a warp's lanes read at
// once (t4 = 0..3) fall on distinct banks.
__device__ __forceinline__ int swz(int r, int col) {
  return r * 64 + (col ^ ((r & 2) << 4));
}

// Stage rows [0, rv) of the (BM x BK) x tile and the (BK x BN) Yq tile at
// k0 into the ring stage at `stage` (rows of x past rv are never read).
template <int BM, int BN, int BK, typename XT, bool ALIGNED>
__device__ __forceinline__ void load_stage(unsigned char* stage, const XT* x,
                                           const int8_t* y, int m0, int rv,
                                           int n0, int k0, int N, int K) {
  using T = QTile<BM, BN, BK, XT>;
  XT* sx = reinterpret_cast<XT*>(stage);
  int8_t* sy = reinterpret_cast<int8_t*>(stage + T::X_STAGE);
  const int tid = threadIdx.x;
  if (ALIGNED) {
    constexpr int XC = BK / T::XE;            // 16-byte chunks per x row
    for (int idx = tid; idx < rv * XC; idx += T::THREADS) {
      const int r = idx / XC, c = (idx % XC) * T::XE;
      const int gk = k0 + c;
      const bool ok = gk < K;
      cp_async16(sx + r * T::LDX + c, ok ? x + (size_t)(m0 + r) * K + gk : x,
                 ok);
    }
    // loops of a constant trip count, so that they unroll
    constexpr int Y_CHUNKS = BK * BN / 16;
#pragma unroll
    for (int i = 0; i < (Y_CHUNKS + T::THREADS - 1) / T::THREADS; ++i) {
      const int idx = tid + i * T::THREADS;
      if (Y_CHUNKS % T::THREADS == 0 || idx < Y_CHUNKS) {
        const int r = idx / (BN / 16), c = (idx % (BN / 16)) * 16;
        const int gk = k0 + r, gn = n0 + c;
        const bool ok = gk < K && gn < N;
        cp_async16(sy + swz(r, c), ok ? y + (size_t)gk * N + gn : y, ok);
      }
    }
  } else {
    for (int idx = tid; idx < rv * BK; idx += T::THREADS) {
      const int r = idx / BK, c = idx % BK;
      const int gk = k0 + c;
      sx[r * T::LDX + c] = gk < K ? x[(size_t)(m0 + r) * K + gk] : zero<XT>();
    }
    for (int idx = tid; idx < BK * BN; idx += T::THREADS) {
      const int r = idx / BN, c = idx % BN;
      const int gk = k0 + r, gn = n0 + c;
      sy[swz(r, c)] = (gk < K && gn < N) ? y[(size_t)gk * N + gn] : int8_t(0);
    }
  }
}

// The |x| maximum of each of rows [m0, m0 + rv) over k in [kbeg, kend), as
// fp32 bits, into smax[0 .. rv): warp w takes rows w, w + WARPS, ...
template <int WARPS, typename XT, bool ALIGNED>
__device__ __forceinline__ void row_absmax(const XT* x, int m0, int rv,
                                           int kbeg, int kend, int K,
                                           unsigned* smax) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int r = warp; r < rv; r += WARPS) {
    const XT* row = x + (size_t)(m0 + r) * K;
    unsigned m = 0;
    if (ALIGNED) {
      constexpr int XE = 16 / (int)sizeof(XT);
#pragma unroll 8
      for (int k = kbeg + lane * XE; k < kend; k += 32 * XE)
        m = max(m, vec_absmax(__ldg(reinterpret_cast<const uint4*>(row + k)),
                              XT()));
    } else {
      for (int k = kbeg + lane; k < kend; k += 32)
        m = max(m, abs_bits(row[k]));
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
      m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (lane == 0) smax[r] = m;
  }
}

// act(((float)acc * xs) * ys[gn] + bias[gn]) rounded once into C at o
__device__ __forceinline__ void store_out(void* c, size_t o, int acc,
                                          float xs, const float* ys,
                                          const float* bias, int gn, int act,
                                          int out_f32) {
  float v = __fmul_rn(__fmul_rn(__int2float_rn(acc), xs), ys[gn]);
  if (bias != nullptr) v = __fadd_rn(v, bias[gn]);
  v = activate(v, act);
  if (out_f32)
    static_cast<float*>(c)[o] = v;
  else
    static_cast<__nv_bfloat16*>(c)[o] = __float2bfloat16(v);
}

// C = act(((float)(Xq · Yq) * xs) * ys + bias) over the K tiles (BK wide
// each) of this block's split: with one split (gridDim.x == 1) all of K;
// with more, split blockIdx.x's krange rows, the row maxima and the int32
// partials combined over the cluster.
template <int BM, int BN, int BK, typename XT, bool ALIGNED>
__global__ void __launch_bounds__(QTile<BM, BN, BK, XT>::THREADS)
    quant_matmul_kernel(const XT* __restrict__ x,
                        const int8_t* __restrict__ y,
                        const float* __restrict__ ys,
                        const float* __restrict__ bias, void* c, int M, int N,
                        int K, int krange, int out_f32, int act) {
  using T = QTile<BM, BN, BK, XT>;
  constexpr int STAGES = T::STAGES;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned* smax = reinterpret_cast<unsigned*>(smem + T::BODY);
  float* sscale = reinterpret_cast<float*>(smem + T::BODY + BM * 4);
  int* part = reinterpret_cast<int*>(smem);   // WK partials at the flush

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t4 = lane % 4;      // the MMA's fragment indices
  const int wk = warp % T::WK, wn = warp / T::WK;
  const int wcol = wn * T::WNC;               // this warp's first column
  const int nsplit = gridDim.x;
  const int n0 = blockIdx.y * BN, m0 = blockIdx.z * BM;
  const int rv = min(BM, M - m0);             // rows of x and C here
  int t_begin = 0, t_end = (K + BK - 1) / BK;
  if (nsplit > 1) {                           // this split's K tiles
    t_begin = blockIdx.x * (krange / BK);
    t_end = min(t_end, t_begin + krange / BK);
  }

  // the weight ring's first stages go out before anything waits
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (t_begin + s < t_end)
      load_stage<BM, BN, BK, XT, ALIGNED>(smem + s * T::STAGE, x, y, m0, rv,
                                          n0, (t_begin + s) * BK, N, K);
    cp_async_commit();
  }

  // the rows' |x| maxima over this split's K range, then over the cluster
  row_absmax<T::WARPS, XT, ALIGNED>(x, m0, rv, t_begin * BK,
                                    min(K, t_end * BK), K, smax);
  if (nsplit > 1)
    cg::this_cluster().sync();                // every split's maxima are in
  else
    __syncthreads();
  if ((int)threadIdx.x < rv) {
    unsigned m = nsplit > 1 ? 0u : smax[threadIdx.x];
    for (int r = 0; r < nsplit && nsplit > 1; ++r)
      m = max(m, cg::this_cluster().map_shared_rank(smax, r)[threadIdx.x]);
    const float amax = __uint_as_float(m);
    sscale[threadIdx.x] = __fmul_rn(amax > 0.0f ? amax : 1.0f, INV_INT8_MAX);
  }
  __syncthreads();
  Divisor d_lo[T::FM], d_hi[T::FM];           // divisors of rows g, g + 8
  bool v_lo[T::FM], v_hi[T::FM];
#pragma unroll
  for (int i = 0; i < T::FM; ++i) {
    v_lo[i] = i * 16 + g < rv;
    v_hi[i] = i * 16 + g + 8 < rv;
    d_lo[i] = divisor(v_lo[i] ? sscale[i * 16 + g] : 1.0f);
    d_hi[i] = divisor(v_hi[i] ? sscale[i * 16 + g + 8] : 1.0f);
  }

  // the APR: this warp's int32 partial of the C tile, for its K chunks
  int acc[T::FM][T::FJ][4];
#pragma unroll
  for (int i = 0; i < T::FM; ++i)
#pragma unroll
    for (int j = 0; j < T::FJ; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  // this thread's fragment offsets in a stage: x row g, k row wk·32 + t4;
  // weight row wk·32 + t4 (whose swizzle bit, bit 1 of the row, is t4's:
  // every other row it reads is 4, 16 or 32 rows on), columns wcol + VB·g
  const int a_off = g * T::LDX + wk * 32 + t4;
  const int b_off =
      (wk * 32 + t4) * BN + ((wcol + T::VB * g) ^ ((t4 & 2) << 4));
  int slot = 0, fill = STAGES - 1;
  for (int t = t_begin; t < t_end; ++t) {
    cp_async_wait<STAGES - 2>();              // tile t has landed
    __syncthreads();                          // ... and tile t-1 is consumed
    const int tn = t + STAGES - 1;            // refill the stage t-1 used
    if (tn < t_end)
      load_stage<BM, BN, BK, XT, ALIGNED>(smem + fill * T::STAGE, x, y, m0,
                                          rv, n0, tn * BK, N, K);
    cp_async_commit();
    const XT* tx = reinterpret_cast<const XT*>(smem + slot * T::STAGE);
    const int8_t* ty =
        reinterpret_cast<const int8_t*>(smem + slot * T::STAGE + T::X_STAGE);
#pragma unroll
    for (int u = 0; u < T::CPW; ++u) {
      const int kc = u * T::WK * 32;          // this chunk's rows past wk·32
      uint32_t af[T::FM][4];
#pragma unroll
      for (int i = 0; i < T::FM; ++i) {
        const XT* lo = tx + a_off + i * 16 * T::LDX + kc;
        const XT* hi = lo + 8 * T::LDX;
        af[i][0] = v_lo[i] ? a_word(lo, 0, d_lo[i]) : 0u;
        af[i][1] = v_hi[i] ? a_word(hi, 0, d_hi[i]) : 0u;
        af[i][2] = v_lo[i] ? a_word(lo, 16, d_lo[i]) : 0u;
        af[i][3] = v_hi[i] ? a_word(hi, 16, d_hi[i]) : 0u;
      }
      uint32_t bf[2][T::FJ];                  // b0 / b1 of each fragment
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t w[T::VB / 4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int8_t* p = ty + b_off + (kc + 16 * h + 4 * j) * BN;
          if constexpr (T::VB == 8) {
            const uint2 v = *reinterpret_cast<const uint2*>(p);
            w[0][j] = v.x;
            w[1][j] = v.y;
          } else {
            w[0][j] = *reinterpret_cast<const uint32_t*>(p);
          }
        }
#pragma unroll
        for (int q = 0; q < T::VB / 4; ++q) {
          uint32_t tr[4];
          transpose4(w[q], tr);
#pragma unroll
          for (int p = 0; p < 4; ++p) bf[h][q * 4 + p] = tr[p];
        }
      }
#pragma unroll
      for (int i = 0; i < T::FM; ++i)
#pragma unroll
        for (int j = 0; j < T::FJ; ++j)
          mma_s8(acc[i][j], af[i], bf[0][j], bf[1][j]);
    }
    slot = slot + 1 == STAGES ? 0 : slot + 1;
    fill = fill + 1 == STAGES ? 0 : fill + 1;
  }
  cp_async_wait<0>();
  __syncthreads();

  // flush: each warp's partial into its slice of shared memory (fragment
  // j's column n is tile column wcol + FJ·n + j), the slices added, then
  // the splits over the cluster, scales, bias and activation, C written
  // once, coalesced and masked
  int* slice = part + wk * BM * BN;
#pragma unroll
  for (int i = 0; i < T::FM; ++i)
#pragma unroll
    for (int j = 0; j < T::FJ; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = wcol + T::FJ * (2 * t4 + e) + j;
        slice[(i * 16 + g) * BN + col] = acc[i][j][e];
        slice[(i * 16 + g + 8) * BN + col] = acc[i][j][2 + e];
      }
  __syncthreads();
  for (int idx = threadIdx.x; idx < rv * BN; idx += T::THREADS) {
    int v = part[idx];
#pragma unroll
    for (int w = 1; w < T::WK; ++w) v += part[w * BM * BN + idx];
    const int gn = n0 + idx % BN;
    if (nsplit > 1)
      part[idx] = v;
    else if (gn < N)
      store_out(c, (size_t)(m0 + idx / BN) * N + gn, v, sscale[idx / BN], ys,
                bias, gn, act, out_f32);
  }
  if (nsplit > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();                           // every split's partial is in
    const int rank = (int)cluster.block_rank();
    for (int idx = rank * T::THREADS + (int)threadIdx.x; idx < rv * BN;
         idx += nsplit * T::THREADS) {
      const int gn = n0 + idx % BN;
      if (gn < N) {
        int v = 0;
#pragma unroll
        for (int r = 0; r < MAX_SPLITS; ++r)
          if (r < nsplit) v += cluster.map_shared_rank(part, r)[idx];
        store_out(c, (size_t)(m0 + idx / BN) * N + gn, v, sscale[idx / BN],
                  ys, bias, gn, act, out_f32);
      }
    }
    cluster.sync();                           // keep the partials until read
  }
}

// The split geometry a launch may take: 1, 2, 4 or 8 splits; above one, K
// ranges of krange rows, a multiple of K_RANGE, that cover K.
inline bool valid_splits(int k, int splits, int krange) {
  if (splits != 1 && splits != 2 && splits != 4 && splits != 8) return false;
  return splits == 1 || (krange > 0 && krange % K_RANGE == 0 &&
                         (long long)krange * splits >= k);
}

template <int BM, int BN, int BK, typename XT>
int launch(const void* x, const void* y, const void* ys, const void* bias,
           void* c, int m, int n, int k, int splits, int krange, int out_f32,
           int act, cudaStream_t s) {
  using T = QTile<BM, BN, BK, XT>;
  if ((m + BM - 1) / BM > 65535 || (n + BN - 1) / BN > 65535)
    return (int)cudaErrorInvalidValue;
  const bool aligned = k % T::XE == 0 && n % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(y) % 16 == 0;
  void (*kernel)(const XT*, const int8_t*, const float*, const float*, void*,
                 int, int, int, int, int, int) =
      aligned ? quant_matmul_kernel<BM, BN, BK, XT, true>
              : quant_matmul_kernel<BM, BN, BK, XT, false>;
  if (T::SMEM > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, (n + BN - 1) / BN, (m + BM - 1) / BM);
  cfg.blockDim = dim3(T::THREADS);
  cfg.dynamicSmemBytes = T::SMEM;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const XT*>(x), static_cast<const int8_t*>(y),
      static_cast<const float*>(ys), static_cast<const float*>(bias), c, m, n,
      k, krange, out_f32, act);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The tiles (BM, BN, BK) compiled; bench/specs.py's quant_matmul space
// lists the same
#define QMM_TILES(X) \
  X(16, 64, 64) X(16, 64, 128) X(16, 64, 256) X(32, 64, 64) X(32, 64, 128) \
  X(32, 64, 256)

}  // namespace

// C (M, N) = act(((float)(Xq · Yq (K, N)) * xs[m]) * ys[n] + bias[n]) on a
// (bm, bn, bk) tile, where Xq / xs are the per-row int8 codes and scales of
// x (M, K), bf16 (x_bf16 != 0) or fp32, made inside the launch: x, Yq int8
// row-major and contiguous; ys (N,) fp32; bias fp32 (N,) or null; act as in
// epilogue.cuh; C bf16 (out_f32 == 0) or fp32.  splits 1 (one block per
// tile over all of K) or 2, 4, 8 with krange, a multiple of 256 that
// covers K in `splits` ranges, one block each, combined over a cluster.
// Launches on `stream` and returns cudaGetLastError() (0 on success;
// cudaErrorInvalidValue for a tile or split geometry that is not compiled).
extern "C" int quant_matmul_i8(const void* x, const void* b, const void* ys,
                               const void* bias, void* c, int m, int n, int k,
                               int x_bf16, int bm, int bn, int bk, int splits,
                               int krange, int out_f32, int act,
                               void* stream) {
  if (m <= 0 || n <= 0 || k < 0 || act < 0 || act > 3 ||
      !valid_splits(k, splits, krange))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define QMM_DISPATCH(BM_, BN_, BK_)                                          \
  if (bm == BM_ && bn == BN_ && bk == BK_)                                   \
    return x_bf16 ? launch<BM_, BN_, BK_, __nv_bfloat16>(                    \
                        x, b, ys, bias, c, m, n, k, splits, krange, out_f32, \
                        act, s)                                              \
                  : launch<BM_, BN_, BK_, float>(x, b, ys, bias, c, m, n, k, \
                                                 splits, krange, out_f32,    \
                                                 act, s);
  QMM_TILES(QMM_DISPATCH)
#undef QMM_DISPATCH
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
