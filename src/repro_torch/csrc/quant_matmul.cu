// quant_matmul: C = act(((float)(Xq · Yq) * xs[m]) * ys[n] + bias[n]) with
// int8 operands and an int32 accumulator resident in registers across the
// whole K loop -- the paper's APR at 8 bits -- and C written once, in fp32
// or bf16.  Without bias and activation it is B6, with them B8.
//
// Replaces: src/repro/kernels/quant_matmul/kernel.py::quant_matmul_call
// (kernel body _quant_matmul_kernel) and quant_matmul_fused_call
// (_quant_matmul_fused_kernel).
//
// What bounds it on an H100: the serving shapes (M = 4 or 16 rows of
// activations against a (K, N) weight) do 2·M·K·N integer operations on
// K·N weight bytes -- 2·M per byte, far under the ~590 per byte at which
// the int8 tensor cores (1,979 TOP/s dense) become the limit, so the time
// is the time to stream Yq once at 3.35 TB/s.
//
// Design:
//  * one template over the tile (BM x BN x BK), instantiated for the tiles
//    the tuning layer may choose (QMM_TILES; bench/specs.py lists the
//    same); 4 warps, warp w owning columns [w·BN/4, (w+1)·BN/4) of all BM
//    rows as (BM/16) x (BN/32) fragments of mma.sync m16n8k32 s8·s8 -> s32;
//  * one block per BM x BN tile of C walks the whole K range; the int32
//    fragments never leave registers until the flush (integer sums are
//    exact, so no order question arises);
//  * Xq and Yq tiles are staged by a 4-stage cp.async ring (a static array
//    up to 48 KB, dynamic shared memory above; 16-byte copies
//    when K and N are multiples of 16 and both operands 16-byte aligned,
//    masked element loads otherwise; ragged edges zero-filled);
//  * the MMA's B operand wants each column's K values contiguous, and Yq is
//    (K, N) row-major: each landed tile is transposed once in shared memory
//    (4 x 4 byte blocks with __byte_perm) into a (BN x BK) tile, from which
//    every fragment is one 32-bit load; A fragments are read straight from
//    the row-major Xq tile.  Row strides of BK + 16 bytes keep the fragment
//    loads free of bank conflicts;
//  * the flush goes through shared memory once (coalesced, masked) and
//    computes ((float)acc * xs[m]) * ys[n], then + bias[n] and the
//    activation of epilogue.cuh, each step rounded on its own (__fmul_rn,
//    __fadd_rn: nvcc would otherwise contract them into an FMA), in the
//    JAX kernel's order, so with none/relu and an fp32 output it equals
//    the plain version bit for bit.
//
// The activations' per-row quantization (amax, x / scale, round half to
// even, clip to +-127) runs before the kernel as plain PyTorch ops, as it
// runs outside the Pallas kernel in the JAX package.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "epilogue.cuh"

namespace {

constexpr int THREADS = 128, WARPS = THREADS / 32;
constexpr int STAGES = 4;

// Shared-memory layout of a BM x BN x BK tile, in bytes:
// [Xq ring | raw Yq ring | transposed Yq tile]; the flush reuses the start
// for the int32 C tile.
template <int BM, int BN, int BK>
struct QTile {
  static constexpr int LDA = BK + 16;         // Xq rows, k contiguous
  static constexpr int LDR = BN + 16;         // raw Yq rows, n contiguous
  static constexpr int LDT = BK + 16;         // transposed Yq rows
  static constexpr int A_STAGE = BM * LDA;
  static constexpr int R_STAGE = BK * LDR;
  static constexpr int RING = STAGES * (A_STAGE + R_STAGE);
  static constexpr int BT = BN * LDT;
  static constexpr int FLUSH = BM * BN * 4;
  static constexpr int SMEM = RING + BT > FLUSH ? RING + BT : FLUSH;
  // a static array where it fits the 48 KB a block may declare (as in
  // apr_matmul.cu: dynamic shared memory makes the tile slower)
  static constexpr bool STATIC = SMEM <= 48 * 1024;
  static constexpr int WN = BN / WARPS;       // columns per warp
  static constexpr int FM = BM / 16, FN = WN / 8;  // m16n8k32 fragments
  static_assert(BM % 16 == 0 && WN % 8 == 0 && BK % 32 == 0,
                "whole m16n8k32 fragments per warp");
  static_assert(A_STAGE % 16 == 0 && R_STAGE % 16 == 0 && LDR % 16 == 0,
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

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Stage the (BM x BK) tile of Xq and the (BK x BN) tile of Yq at k0.
template <int BM, int BN, int BK, bool ALIGNED>
__device__ __forceinline__ void load_tile(int8_t* sa, int8_t* sr,
                                          const int8_t* a, const int8_t* b,
                                          int m0, int n0, int k0, int M,
                                          int N, int K) {
  using T = QTile<BM, BN, BK>;
  const int tid = threadIdx.x;
  if (ALIGNED) {
    // loops of a constant trip count, so that they unroll
    constexpr int A_CHUNKS = BM * BK / 16, B_CHUNKS = BK * BN / 16;
#pragma unroll
    for (int i = 0; i < (A_CHUNKS + THREADS - 1) / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      if (A_CHUNKS % THREADS == 0 || idx < A_CHUNKS) {
        int row = idx / (BK / 16), col = (idx % (BK / 16)) * 16;
        int gm = m0 + row, gk = k0 + col;
        bool ok = gm < M && gk < K;
        cp_async16(sa + row * T::LDA + col,
                   ok ? a + (size_t)gm * K + gk : a, ok);
      }
    }
#pragma unroll
    for (int i = 0; i < (B_CHUNKS + THREADS - 1) / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      if (B_CHUNKS % THREADS == 0 || idx < B_CHUNKS) {
        int row = idx / (BN / 16), col = (idx % (BN / 16)) * 16;
        int gk = k0 + row, gn = n0 + col;
        bool ok = gk < K && gn < N;
        cp_async16(sr + row * T::LDR + col,
                   ok ? b + (size_t)gk * N + gn : b, ok);
      }
    }
  } else {
    for (int idx = tid; idx < BM * BK; idx += THREADS) {
      int row = idx / BK, col = idx % BK;
      int gm = m0 + row, gk = k0 + col;
      sa[row * T::LDA + col] =
          (gm < M && gk < K) ? a[(size_t)gm * K + gk] : int8_t(0);
    }
    for (int idx = tid; idx < BK * BN; idx += THREADS) {
      int row = idx / BN, col = idx % BN;
      int gk = k0 + row, gn = n0 + col;
      sr[row * T::LDR + col] =
          (gk < K && gn < N) ? b[(size_t)gk * N + gn] : int8_t(0);
    }
  }
}

// Transpose the raw (BK x BN) Yq tile into the (BN x BK) tile the MMA's
// column-major B operand reads: each thread turns a 4 x 4 block of bytes
// (4 k rows of 4 columns) into 4 words of 4 consecutive k each.
template <int BM, int BN, int BK>
__device__ __forceinline__ void transpose_tile(const int8_t* sr,
                                               int8_t* sbt) {
  using T = QTile<BM, BN, BK>;
  constexpr int QUADS = (BK / 4) * (BN / 4);
  static_assert(QUADS % THREADS == 0, "whole 4 x 4 blocks per thread");
#pragma unroll
  for (int i = 0; i < QUADS / THREADS; ++i) {
    const int q = threadIdx.x + i * THREADS;
    const int kq = q / (BN / 4), nq = q % (BN / 4);
    const int8_t* src = sr + kq * 4 * T::LDR + nq * 4;
    const uint32_t w0 = lds32(src), w1 = lds32(src + T::LDR),
                   w2 = lds32(src + 2 * T::LDR), w3 = lds32(src + 3 * T::LDR);
    // byte j of word r is Yq[k0 + r][n0 + j]
    const uint32_t lo01 = __byte_perm(w0, w1, 0x5140);
    const uint32_t hi01 = __byte_perm(w0, w1, 0x7362);
    const uint32_t lo23 = __byte_perm(w2, w3, 0x5140);
    const uint32_t hi23 = __byte_perm(w2, w3, 0x7362);
    int8_t* dst = sbt + nq * 4 * T::LDT + kq * 4;
    *reinterpret_cast<uint32_t*>(dst) = __byte_perm(lo01, lo23, 0x5410);
    *reinterpret_cast<uint32_t*>(dst + T::LDT) =
        __byte_perm(lo01, lo23, 0x7632);
    *reinterpret_cast<uint32_t*>(dst + 2 * T::LDT) =
        __byte_perm(hi01, hi23, 0x5410);
    *reinterpret_cast<uint32_t*>(dst + 3 * T::LDT) =
        __byte_perm(hi01, hi23, 0x7632);
  }
}

template <int BM, int BN, int BK, bool ALIGNED>
__global__ void __launch_bounds__(THREADS)
    quant_matmul_kernel(const int8_t* __restrict__ a,
                        const int8_t* __restrict__ b,
                        const float* __restrict__ xs,
                        const float* __restrict__ ys,
                        const float* __restrict__ bias, void* c, int M, int N,
                        int K, int out_f32, int act) {
  using T = QTile<BM, BN, BK>;
  __shared__ __align__(128) int8_t smem_static[T::STATIC ? T::SMEM : 16];
  extern __shared__ __align__(128) int8_t smem_dynamic[];
  int8_t* smem = T::STATIC ? smem_static : smem_dynamic;
  int8_t* sa = smem;
  int8_t* sr = smem + STAGES * T::A_STAGE;
  int8_t* sbt = smem + T::RING;
  int* sci = reinterpret_cast<int*>(smem);    // int32 C tile at the flush

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t4 = lane % 4;      // the MMA's fragment indices
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int wcol = warp * T::WN;
  const int ktiles = (K + BK - 1) / BK;

  // the APR: this warp's slice of the C tile, int32, for the whole K
  int acc[T::FM][T::FN][4];
#pragma unroll
  for (int i = 0; i < T::FM; ++i)
#pragma unroll
    for (int j = 0; j < T::FN; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles)
      load_tile<BM, BN, BK, ALIGNED>(sa + s * T::A_STAGE, sr + s * T::R_STAGE,
                                     a, b, m0, n0, s * BK, M, N, K);
    cp_async_commit();
  }
  for (int t = 0; t < ktiles; ++t) {
    const int slot = t % STAGES;
    cp_async_wait<STAGES - 2>();              // tile t has landed
    __syncthreads();                          // ... tile t-1 is consumed
    const int tn = t + STAGES - 1;            // refill the stage t-1 used
    if (tn < ktiles)
      load_tile<BM, BN, BK, ALIGNED>(sa + (tn % STAGES) * T::A_STAGE,
                                     sr + (tn % STAGES) * T::R_STAGE, a, b,
                                     m0, n0, tn * BK, M, N, K);
    cp_async_commit();
    transpose_tile<BM, BN, BK>(sr + slot * T::R_STAGE, sbt);
    __syncthreads();
    const int8_t* ta = sa + slot * T::A_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t af[T::FM][4], bf[T::FN][2];
#pragma unroll
      for (int i = 0; i < T::FM; ++i) {
        const int8_t* p = ta + (i * 16 + g) * T::LDA + kk + t4 * 4;
        af[i][0] = lds32(p);                          // row g,   k 0..15
        af[i][1] = lds32(p + 8 * T::LDA);             // row g+8, k 0..15
        af[i][2] = lds32(p + 16);                     // row g,   k 16..31
        af[i][3] = lds32(p + 8 * T::LDA + 16);        // row g+8, k 16..31
      }
#pragma unroll
      for (int j = 0; j < T::FN; ++j) {
        const int8_t* p = sbt + (wcol + j * 8 + g) * T::LDT + kk + t4 * 4;
        bf[j][0] = lds32(p);                          // column g, k 0..15
        bf[j][1] = lds32(p + 16);                     // column g, k 16..31
      }
#pragma unroll
      for (int i = 0; i < T::FM; ++i)
#pragma unroll
        for (int j = 0; j < T::FN; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // flush: int32 tile through shared memory, then one coalesced, masked
  // write with the scales, bias and activation
#pragma unroll
  for (int i = 0; i < T::FM; ++i)
#pragma unroll
    for (int j = 0; j < T::FN; ++j) {
      const int col = wcol + j * 8 + t4 * 2;
      int* row0 = sci + (i * 16 + g) * BN + col;
      int* row8 = row0 + 8 * BN;
      row0[0] = acc[i][j][0];
      row0[1] = acc[i][j][1];
      row8[0] = acc[i][j][2];
      row8[1] = acc[i][j][3];
    }
  __syncthreads();
  for (int idx = threadIdx.x; idx < BM * BN; idx += THREADS) {
    int r = idx / BN, col = idx % BN;
    int gm = m0 + r, gn = n0 + col;
    if (gm < M && gn < N) {
      float v = __fmul_rn(__fmul_rn(__int2float_rn(sci[idx]), xs[gm]),
                          ys[gn]);
      if (bias != nullptr) v = __fadd_rn(v, bias[gn]);
      v = activate(v, act);
      size_t o = (size_t)gm * N + gn;
      if (out_f32)
        static_cast<float*>(c)[o] = v;
      else
        static_cast<__nv_bfloat16*>(c)[o] = __float2bfloat16(v);
    }
  }
}

template <int BM, int BN, int BK>
int launch(const void* a, const void* b, const void* xs, const void* ys,
           const void* bias, void* c, int m, int n, int k, int out_f32,
           int act, cudaStream_t s) {
  using T = QTile<BM, BN, BK>;
  if ((m + BM - 1) / BM > 65535) return (int)cudaErrorInvalidValue;
  const bool aligned = k % 16 == 0 && n % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(b) % 16 == 0;
  void (*kernel)(const int8_t*, const int8_t*, const float*, const float*,
                 const float*, void*, int, int, int, int, int) =
      aligned ? quant_matmul_kernel<BM, BN, BK, true>
              : quant_matmul_kernel<BM, BN, BK, false>;
  const int dynamic = T::STATIC ? 0 : T::SMEM;
  if (dynamic > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dynamic);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  kernel<<<grid, THREADS, dynamic, s>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(b),
      static_cast<const float*>(xs), static_cast<const float*>(ys),
      static_cast<const float*>(bias), c, m, n, k, out_f32, act);
  return (int)cudaGetLastError();
}

// The tiles (BM, BN, BK) compiled; bench/specs.py's quant_matmul space
// lists the same
#define QMM_TILES(X) \
  X(16, 64, 64) X(16, 64, 128) X(16, 64, 256) X(32, 64, 64) X(32, 64, 128) \
  X(32, 64, 256)

}  // namespace

// C (M, N) = act(((float)(Xq (M, K) · Yq (K, N)) * xs[m]) * ys[n] + bias[n])
// on a (bm, bn, bk) tile: Xq, Yq int8, row-major and contiguous; xs (M,),
// ys (N,) fp32; bias fp32 (N,) or null; act as in epilogue.cuh; C bf16
// (out_f32 == 0) or fp32.  Launches on `stream` and returns
// cudaGetLastError() (0 on success; cudaErrorInvalidValue for a tile that
// is not compiled).
extern "C" int quant_matmul_i8(const void* a, const void* b, const void* xs,
                               const void* ys, const void* bias, void* c,
                               int m, int n, int k, int bm, int bn, int bk,
                               int out_f32, int act, void* stream) {
  if (m <= 0 || n <= 0 || k < 0 || act < 0 || act > 3)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define QMM_DISPATCH(BM_, BN_, BK_)                                       \
  if (bm == BM_ && bn == BN_ && bk == BK_)                                \
    return launch<BM_, BN_, BK_>(a, b, xs, ys, bias, c, m, n, k, out_f32, \
                                 act, s);
  QMM_TILES(QMM_DISPATCH)
#undef QMM_DISPATCH
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
