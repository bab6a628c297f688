// apr_matmul: C = A·B with the fp32 accumulator resident on chip across the
// whole K loop -- the paper's architectural pipeline register (APR) -- and
// C written to device memory once, rounded once; with an optional epilogue
// activation(acc + bias) at that flush, and the paper's memory-resident
// baseline on the same tiles.
//
// Replaces: src/repro/kernels/apr_matmul/kernel.py::apr_matmul_call with
// residency="apr" (kernel body _apr_matmul_kernel) and residency="hbm"
// (_hbm_matmul_kernel), and apr_matmul_fused_call (_apr_matmul_fused_kernel).
//
// What bounds it on an H100: the serving path calls it with M = 4 (a decode
// tick over 4 slots) or M = 16 (one prefill chunk), so a product does 2·M·K·N
// operations on 2·K·N bytes of weight -- M operations per byte, far under the
// ~295 per byte at which the bf16 tensor cores become the limit.  The time
// is the time to stream B from memory once.
//
// Design:
//  * one template over the tile (BM x BN x BK), instantiated for the tiles
//    the tuning layer may choose (TILES below; the family's TuneSpace in
//    bench/specs.py lists exactly these); 4 warps, warp w owning columns
//    [w·BN/4, (w+1)·BN/4) of all BM rows as (BM/16) x (BN/64) WMMA
//    fragments;
//  * one block per BM x BN tile of C; the block walks its K range, so the
//    fp32 accumulators never leave registers until the single write at the
//    end (no split-K, no partial sums in memory).  Each output element sums
//    its K in 16-wide steps in ascending order whatever the tile, so every
//    tile gives the same bits;
//  * A and B tiles are staged through shared memory by a 4-stage cp.async
//    ring (a static array up to 48 KB, dynamic shared memory above, after
//    cudaFuncSetAttribute);
//  * bf16 WMMA 16x16x16 with fp32 accumulate;
//  * B is read as the row-major (K, N) slice of the stacked weight, with no
//    transpose; ragged M, N and K edges are masked inside the kernel:
//    zero-filled 16-byte copies when K and N are multiples of 8 and both
//    operands are 16-byte aligned, element loads with masks otherwise;
//  * the flush goes through shared memory once, so the global write is
//    coalesced and masked; it applies bias (fp32, may be null) and the
//    activation of epilogue.cuh (B7m, apr_matmul_fused), each step rounded
//    on its own as the plain version rounds it.
//
// Memory residency (apr_matmul(residency="hbm"), B4m, the paper's baseline):
// the wrapper launches one grid per K step [t_begin, t_end) = [s, s + 1).
// Step s > 0 seeds the accumulator fragments from the fp32 (M, N) partial
// (through shared memory, an exact fp32 copy), runs the same WMMA sequence
// as the APR kernel over its BK slice, and writes the partial back; the last
// step writes C in its output type.  So the baseline equals the APR kernel
// at the same tile bit for bit and differs from it only in the partial's
// 8·M·N bytes of traffic per step.
//
// int8-weight variant (apr_matmul_int8w): B is an int8 (K, N) weight with
// fp32 per-column scales (1, N), the port's QuantizedTensor.  On the TPU
// XLA fuses the dequantize multiply into the consuming einsum, so the
// weight crosses memory at 1 byte per element; this is that fusion.  The
// int8 tiles ride the same cp.async ring (16-byte copies of 16 codes when
// N % 16 == 0), and each stage is dequantized in shared memory to
// bf16(float(q) * scale[n]) -- the rounding of the JAX package's
// dequantize(bf16) -- into one bf16 tile laid out as the bf16 kernel's B
// tile; each warp converts only the 16-column strip its own WMMA reads,
// with the strip's scales in registers, so the dequantize needs a warp
// barrier and not a block one.  It has one tile, 16 x 64 x 64, and the bf16
// kernel's K order and WMMA sequence there, so the result equals the bf16
// kernel on the dequantized weight bit for bit.  Bound: half the weight
// bytes of the bf16 kernel.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "epilogue.cuh"

using namespace nvcuda;

namespace {

constexpr int THREADS = 128;                  // 4 warps
constexpr int WARPS = THREADS / 32;

// Shared-memory layout of a BM x BN x BK tile by weight type.  bf16
// weights: [A ring | B ring]; int8 weights: [A ring | int8 B ring |
// dequantized bf16 B tile].  The int8 tiles are half as large, so their
// ring is one stage deeper.  The seed and the flush reuse the start for the
// fp32 C tile.
template <bool Q, int BM, int BN, int BK>
struct Tile {
  static constexpr int STAGES = Q ? 5 : 4;
  static constexpr int LDA = BK + 8;          // padded shared-memory strides,
  static constexpr int LDB = BN + 8;          // multiples of 8 elements
  static constexpr int LDQ = BN + 16;         // int8 tile stride, in bytes
  static constexpr int A_STAGE = BM * LDA;    // elements per stage
  static constexpr int B_STAGE = BK * LDB;
  static constexpr int Q_STAGE = BK * LDQ;    // bytes per int8 stage
  static constexpr int A_BYTES = STAGES * A_STAGE * 2;
  static constexpr int B_BYTES = Q ? STAGES * Q_STAGE : STAGES * B_STAGE * 2;
  static constexpr int RING = A_BYTES + B_BYTES + (Q ? B_STAGE * 2 : 0);
  static constexpr int FLUSH = BM * BN * 4;
  static constexpr int SMEM = RING > FLUSH ? RING : FLUSH;
  // a static array where it fits the 48 KB a block may declare: the
  // default tile runs at half the time with it than with dynamic memory
  static constexpr bool STATIC = SMEM <= 48 * 1024;
  static constexpr int WN = BN / WARPS;       // columns per warp
  static constexpr int FM = BM / 16, FN = WN / 16;  // fragments per warp
  static_assert(BM % 16 == 0 && WN % 16 == 0 && BK % 16 == 0,
                "whole WMMA fragments per warp");
  static_assert((A_STAGE * 2) % 32 == 0 && (B_STAGE * 2) % 32 == 0 &&
                    A_BYTES % 32 == 0,
                "WMMA tile alignment");
  // int8 dequantize: warp w converts exactly the 16 columns its WMMA reads
  // (rows lane and lane + 32), keeping their scales in registers
  static_assert(!Q || (BM == 16 && BN == 64 && BK == 64),
                "one 16-column strip of 64 rows per warp");
  static_assert(!Q || (A_BYTES + B_BYTES) % 32 == 0, "WMMA tile alignment");
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

// Stage the (BM x BK) tile of A and the (BK x BN) tile of B at k0.  TB is
// the weight's element type: __nv_bfloat16 (stride LDB elements) or int8_t
// (stride LDQ bytes, 16 codes per 16-byte copy).
template <typename TB, int BM, int BN, int BK, bool ALIGNED>
__device__ __forceinline__ void load_tile(__nv_bfloat16* sa, TB* sb,
                                          const __nv_bfloat16* a,
                                          const TB* b, int m0, int n0, int k0,
                                          int M, int N, int K) {
  constexpr bool Q = sizeof(TB) == 1;
  using T = Tile<Q, BM, BN, BK>;
  constexpr int LD = Q ? T::LDQ : T::LDB;
  constexpr int CHUNK = 16 / sizeof(TB);      // elements per 16 bytes
  const int tid = threadIdx.x;
  if (ALIGNED) {
    // 16-byte chunks; K % 8 == 0 and N % CHUNK == 0 make every chunk
    // wholly inside or wholly outside the matrix.  Loops of a constant
    // trip count, so that they unroll
    constexpr int A_CHUNKS = BM * BK / 8, B_CHUNKS = BK * BN / CHUNK;
#pragma unroll
    for (int i = 0; i < (A_CHUNKS + THREADS - 1) / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      if (A_CHUNKS % THREADS == 0 || idx < A_CHUNKS) {
        int row = idx / (BK / 8), col = (idx % (BK / 8)) * 8;
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
        int row = idx / (BN / CHUNK), col = (idx % (BN / CHUNK)) * CHUNK;
        int gk = k0 + row, gn = n0 + col;
        bool ok = gk < K && gn < N;
        cp_async16(sb + row * LD + col,
                   ok ? b + (size_t)gk * N + gn : b, ok);
      }
    }
  } else {
    const __nv_bfloat16 zero = __float2bfloat16(0.0f);
    for (int idx = tid; idx < BM * BK; idx += THREADS) {
      int row = idx / BK, col = idx % BK;
      int gm = m0 + row, gk = k0 + col;
      sa[row * T::LDA + col] =
          (gm < M && gk < K) ? a[(size_t)gm * K + gk] : zero;
    }
    for (int idx = tid; idx < BK * BN; idx += THREADS) {
      int row = idx / BN, col = idx % BN;
      int gk = k0 + row, gn = n0 + col;
      const bool ok = gk < K && gn < N;
      if constexpr (Q)
        sb[row * LD + col] = ok ? b[(size_t)gk * N + gn] : int8_t(0);
      else
        sb[row * LD + col] = ok ? b[(size_t)gk * N + gn] : zero;
    }
  }
}

// K tiles [t_begin, t_end) of C (BK wide each) accumulated onto `seed` (the
// fp32 partial, or zeros when null); the flush writes
// act(acc + bias) to c, fp32 (out_f32) or bf16.
template <typename TB, int BM, int BN, int BK, bool ALIGNED>
__global__ void __launch_bounds__(THREADS)
    apr_matmul_kernel(const __nv_bfloat16* __restrict__ a,
                      const TB* __restrict__ b,
                      const float* __restrict__ scale,
                      const float* __restrict__ bias, const float* seed,
                      void* c, int M, int N, int K, int t_begin, int t_end,
                      int out_f32, int act) {
  constexpr bool Q = sizeof(TB) == 1;
  using T = Tile<Q, BM, BN, BK>;
  constexpr int STAGES = T::STAGES;
  constexpr int B_RING = Q ? T::Q_STAGE : T::B_STAGE;   // TB per stage
  __shared__ __align__(128) unsigned char smem_static[T::STATIC ? T::SMEM
                                                                : 16];
  extern __shared__ __align__(128) unsigned char smem_dynamic[];
  unsigned char* smem = T::STATIC ? smem_static : smem_dynamic;
  __nv_bfloat16* sa = reinterpret_cast<__nv_bfloat16*>(smem);
  TB* sb = reinterpret_cast<TB*>(smem + T::A_BYTES);
  // int8 weights only: the dequantized bf16 tile
  __nv_bfloat16* sbq =
      reinterpret_cast<__nv_bfloat16*>(smem + T::A_BYTES + T::B_BYTES);
  float* sc = reinterpret_cast<float*>(smem);   // C tile: seed and flush

  const int warp = threadIdx.x / 32;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int wcol = warp * T::WN;              // this warp's first column
  float qs[Q ? 16 : 1];
  if constexpr (Q) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
      qs[j] = n0 + wcol + j < N ? scale[n0 + wcol + j] : 0.0f;
  }

  // the APR: this warp's slice of the C tile, fp32, for the whole K range
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[T::FM][T::FN];
  if (seed != nullptr) {
    // the partial of the K steps before this one, zeros past the edges
    for (int idx = threadIdx.x; idx < BM * BN; idx += THREADS) {
      int r = idx / BN, col = idx % BN;
      int gm = m0 + r, gn = n0 + col;
      sc[idx] = gm < M && gn < N ? seed[(size_t)gm * N + gn] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < T::FM; ++i)
#pragma unroll
      for (int j = 0; j < T::FN; ++j)
        wmma::load_matrix_sync(acc[i][j], sc + i * 16 * BN + wcol + j * 16,
                               BN, wmma::mem_row_major);
    __syncthreads();                          // before the ring reuses sc
  } else {
#pragma unroll
    for (int i = 0; i < T::FM; ++i)
#pragma unroll
      for (int j = 0; j < T::FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
  }
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>
      fa[T::FM];
  wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>
      fb[T::FN];

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (t_begin + s < t_end)
      load_tile<TB, BM, BN, BK, ALIGNED>(sa + s * T::A_STAGE, sb + s * B_RING,
                                         a, b, m0, n0, (t_begin + s) * BK, M,
                                         N, K);
    cp_async_commit();
  }
  for (int t = t_begin; t < t_end; ++t) {
    const int slot = (t - t_begin) % STAGES;
    cp_async_wait<STAGES - 2>();              // tile t has landed
    __syncthreads();                          // ... and tile t-1 is consumed
    const int tn = t + STAGES - 1;            // refill the stage t-1 used
    if (tn < t_end) {
      const int sn = (tn - t_begin) % STAGES;
      load_tile<TB, BM, BN, BK, ALIGNED>(sa + sn * T::A_STAGE,
                                         sb + sn * B_RING, a, b, m0, n0,
                                         tn * BK, M, N, K);
    }
    cp_async_commit();
    const __nv_bfloat16* ta = sa + slot * T::A_STAGE;
    const __nv_bfloat16* tb;
    if constexpr (Q) {
      // dequantize bf16(float(q) * scale[n]) of this warp's strip: each
      // lane loads its two 16-code rows before any store, then writes them
      // 8 bf16 at a time; the warp's WMMA reads only what it wrote
      const int8_t* tq = reinterpret_cast<const int8_t*>(sb) +
                         slot * T::Q_STAGE;
      const int lane = threadIdx.x % 32;
      uint4 raw[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = lane + 32 * i;
        raw[i] = *reinterpret_cast<const uint4*>(tq + row * T::LDQ + wcol);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = lane + 32 * i;
        const int8_t* code = reinterpret_cast<const int8_t*>(&raw[i]);
        uint32_t packed[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          __nv_bfloat162 h =
              __floats2bfloat162_rn((float)code[2 * j] * qs[2 * j],
                                    (float)code[2 * j + 1] * qs[2 * j + 1]);
          packed[j] = *reinterpret_cast<uint32_t*>(&h);
        }
        uint4* dst = reinterpret_cast<uint4*>(sbq + row * T::LDB + wcol);
        dst[0] = make_uint4(packed[0], packed[1], packed[2], packed[3]);
        dst[1] = make_uint4(packed[4], packed[5], packed[6], packed[7]);
      }
      __syncwarp();
      tb = sbq + wcol;
    } else {
      tb = reinterpret_cast<const __nv_bfloat16*>(sb) + slot * T::B_STAGE +
           wcol;
    }
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
#pragma unroll
      for (int i = 0; i < T::FM; ++i)
        wmma::load_matrix_sync(fa[i], ta + i * 16 * T::LDA + kk, T::LDA);
#pragma unroll
      for (int j = 0; j < T::FN; ++j)
        wmma::load_matrix_sync(fb[j], tb + kk * T::LDB + j * 16, T::LDB);
#pragma unroll
      for (int i = 0; i < T::FM; ++i)
#pragma unroll
        for (int j = 0; j < T::FN; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // flush: the tile goes through shared memory once, so the global write
  // is coalesced and masked at the ragged M/N edges
#pragma unroll
  for (int i = 0; i < T::FM; ++i)
#pragma unroll
    for (int j = 0; j < T::FN; ++j)
      wmma::store_matrix_sync(sc + i * 16 * BN + wcol + j * 16, acc[i][j],
                              BN, wmma::mem_row_major);
  __syncthreads();
  for (int idx = threadIdx.x; idx < BM * BN; idx += THREADS) {
    int r = idx / BN, col = idx % BN;
    int gm = m0 + r, gn = n0 + col;
    if (gm < M && gn < N) {
      size_t o = (size_t)gm * N + gn;
      float v = sc[idx];
      if (bias != nullptr) v = __fadd_rn(v, bias[gn]);
      v = activate(v, act);
      if (out_f32)
        static_cast<float*>(c)[o] = v;
      else
        static_cast<__nv_bfloat16*>(c)[o] = __float2bfloat16(v);
    }
  }
}

template <typename TB, int BM, int BN, int BK>
int launch(const void* a, const void* b, const void* scale, const void* bias,
           const void* seed, void* c, int m, int n, int k, int t_begin,
           int t_end, int out_f32, int act, cudaStream_t s) {
  using T = Tile<sizeof(TB) == 1, BM, BN, BK>;
  if ((m + BM - 1) / BM > 65535) return (int)cudaErrorInvalidValue;
  const bool aligned = k % 8 == 0 && n % (16 / sizeof(TB)) == 0 &&
                       reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(b) % 16 == 0;
  void (*kernel)(const __nv_bfloat16*, const TB*, const float*, const float*,
                 const float*, void*, int, int, int, int, int, int, int) =
      aligned ? apr_matmul_kernel<TB, BM, BN, BK, true>
              : apr_matmul_kernel<TB, BM, BN, BK, false>;
  const int dynamic = T::STATIC ? 0 : T::SMEM;
  if (dynamic > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dynamic);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  kernel<<<grid, THREADS, dynamic, s>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const TB*>(b),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<const float*>(seed), c, m, n, k, t_begin, t_end, out_f32,
      act);
  return (int)cudaGetLastError();
}

// The bf16 tiles (BM, BN, BK) compiled; bench/specs.py's apr_matmul space
// lists the same
#define APR_MATMUL_TILES(X) \
  X(16, 64, 32) X(16, 64, 64) X(16, 64, 128) X(32, 64, 32) X(32, 64, 64) \
  X(32, 64, 128)

}  // namespace

// C (M, N) = act(A (M, K) · B (K, N) + bias) over the K tiles
// [t_begin, t_end) of a (bm, bn, bk) tile, added onto `seed` (an fp32 (M, N)
// partial, or null for zeros).  A and B bf16, row-major and contiguous;
// bias fp32 (N,) or null; act as in epilogue.cuh; C bf16 (out_f32 == 0) or
// fp32, and may be `seed` itself.  The APR kernel is one launch over
// [0, ceil(K / bk)); the memory-resident baseline one launch per K tile.
// Launches on `stream` and returns cudaGetLastError() (0 on success;
// cudaErrorInvalidValue for a tile that is not compiled).
extern "C" int apr_matmul_bf16(const void* a, const void* b, const void* bias,
                               const void* seed, void* c, int m, int n,
                               int k, int bm, int bn, int bk, int t_begin,
                               int t_end, int out_f32, int act,
                               void* stream) {
  if (m <= 0 || n <= 0 || k < 0 || t_begin < 0 || t_end < t_begin ||
      act < 0 || act > 3)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define APR_MATMUL_DISPATCH(BM_, BN_, BK_)                                  \
  if (bm == BM_ && bn == BN_ && bk == BK_)                                  \
    return launch<__nv_bfloat16, BM_, BN_, BK_>(a, b, nullptr, bias, seed, \
                                                c, m, n, k, t_begin, t_end, \
                                                out_f32, act, s);
  APR_MATMUL_TILES(APR_MATMUL_DISPATCH)
#undef APR_MATMUL_DISPATCH
  return (int)cudaErrorInvalidValue;
}

// The int8-weight variant (one 16 x 64 x 64 tile): B int8 (K, N) with its
// fp32 column scales (N,), dequantized to bf16(float(q) * scale[n]) in the
// load stage.
extern "C" int apr_matmul_int8w(const void* a, const void* b,
                                const void* scale, void* c, int m, int n,
                                int k, int out_f32, void* stream) {
  if (m <= 0 || n <= 0 || k < 0) return (int)cudaErrorInvalidValue;
  return launch<int8_t, 16, 64, 64>(a, b, scale, nullptr, nullptr, c, m, n, k,
                                    0, (k + 63) / 64, out_f32, 0,
                                    static_cast<cudaStream_t>(stream));
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
