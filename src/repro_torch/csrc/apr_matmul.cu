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
// weight crosses memory at 1 byte per element; this is that fusion, in a
// kernel body of its own.  Bound: half the weight bytes of the bf16 kernel.
//  * It must equal the bf16 kernel on the dequantized weight bit for bit.
//    So each output keeps that kernel's K order -- 16-wide steps in
//    ascending order into one fp32 accumulator for the whole K range, no
//    split-K -- and each step is one bf16 mma.sync.m16n8k16 per 8 columns,
//    the instruction the bf16 kernel's 16x16x16 WMMA lowers to.  The B
//    values are bf16(float(q) * scale[n]), the rounding of the JAX
//    package's dequantize(bf16);
//  * narrow column tiles, so that more SMs stream at the serving shapes:
//    BN = 16, 32 (one 32-byte sector of each K row) or 64 columns, 4 warps,
//    each computing warp owning max(8, BN/4) columns as n8 MMAs; the grid
//    is N/BN blocks (128 at N = 4096 with BN = 32, against 64 for the bf16
//    kernel's 64-column tile).  The tile is the tuning layer's choice
//    (INT8W_TILES; every tile gives the same bits).  One accumulator chain
//    of K/16 dependent MMAs per 8 columns is what no tile can shorten;
//  * the dequantize runs in registers, straight into the MMA's B fragment:
//    a thread's fragment column g is tile column J·g + j of MMA j (a column
//    permutation, which no sum sees), so its J columns of one K row are one
//    J-byte shared-memory load; no bf16 tile, no barrier for it.  A
//    fragments come from the bf16 A tile by ldmatrix;
//  * the int8 and A tiles ride a cp.async ring as deep as 48 KB of static
//    shared memory allows (3 to 8 stages), one block barrier a stage; BK =
//    128 halves the barriers of BK = 64 and measured faster on an H100,
//    while deeper rings in dynamic shared memory, a warp-private ring of
//    8-byte copies without block barriers, and producer warps that
//    dequantize stage t+1 into a bf16 double buffer while consumer warps
//    run the MMAs of stage t, all measured slower;
//  * rows of A at or past M are zero-filled and their outputs dropped; the
//    flush writes each accumulator straight from registers (masked).
//
// fp32 variant (apr_matmul_f32, B1 and B7m for fp32 operands): A and B
// fp32, every product and sum an fp32 FMA (no TF32: the plain version on
// the card is torch.matmul in full fp32, and the JAX kernel multiplies fp32
// operands in fp32).  Bound: 4 bytes a weight element, twice the bf16
// kernel's bytes.  One tile, a simple kernel that is right first:
//  * a block owns 16 rows x 32 columns of C; its 8 warps cut K into 8
//    contiguous slices, and lane l of every warp owns column n0 + l: 16
//    fp32 accumulators in registers across the warp's whole K slice (the
//    APR), no partial sum in memory;
//  * B rows are read 8 at a time, 8 independent coalesced 128-byte loads
//    a warp in flight; A values are warp-wide broadcasts (float4 when K %
//    4 == 0 and A is 16-byte aligned), read through the L1;
//  * the flush adds the 8 slices in warp order through shared memory (a
//    fixed order, so the same inputs give the same bits) and applies bias
//    and activation (epilogue.cuh) before the single write, bf16 or fp32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "epilogue.cuh"

using namespace nvcuda;

namespace {

constexpr int THREADS = 128;                  // 4 warps
constexpr int WARPS = THREADS / 32;

// Shared-memory layout of a BM x BN x BK bf16 tile: [A ring | B ring];
// the seed and the flush reuse the start for the fp32 C tile.
template <int BM, int BN, int BK>
struct Tile {
  static constexpr int STAGES = 4;
  static constexpr int LDA = BK + 8;          // padded shared-memory strides,
  static constexpr int LDB = BN + 8;          // multiples of 8 elements
  static constexpr int A_STAGE = BM * LDA;    // elements per stage
  static constexpr int B_STAGE = BK * LDB;
  static constexpr int A_BYTES = STAGES * A_STAGE * 2;
  static constexpr int B_BYTES = STAGES * B_STAGE * 2;
  static constexpr int RING = A_BYTES + B_BYTES;
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

// Stage the (BM x BK) tile of A (row stride LDA elements) and the
// (BK x BN) tile of B (row stride LDB elements of TB) at k0.  TB is the
// weight's element type: __nv_bfloat16, or int8_t (16 codes per 16-byte
// copy) for the int8-weight kernel.
template <typename TB, int BM, int BN, int BK, int LDA, int LDB, bool ALIGNED>
__device__ __forceinline__ void load_tile(__nv_bfloat16* sa, TB* sb,
                                          const __nv_bfloat16* a,
                                          const TB* b, int m0, int n0, int k0,
                                          int M, int N, int K) {
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
        cp_async16(sa + row * LDA + col,
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
        cp_async16(sb + row * LDB + col,
                   ok ? b + (size_t)gk * N + gn : b, ok);
      }
    }
  } else {
    const __nv_bfloat16 zero = __float2bfloat16(0.0f);
    for (int idx = tid; idx < BM * BK; idx += THREADS) {
      int row = idx / BK, col = idx % BK;
      int gm = m0 + row, gk = k0 + col;
      sa[row * LDA + col] =
          (gm < M && gk < K) ? a[(size_t)gm * K + gk] : zero;
    }
    for (int idx = tid; idx < BK * BN; idx += THREADS) {
      int row = idx / BN, col = idx % BN;
      int gk = k0 + row, gn = n0 + col;
      const bool ok = gk < K && gn < N;
      if constexpr (sizeof(TB) == 1)
        sb[row * LDB + col] = ok ? b[(size_t)gk * N + gn] : int8_t(0);
      else
        sb[row * LDB + col] = ok ? b[(size_t)gk * N + gn] : zero;
    }
  }
}

// K tiles [t_begin, t_end) of C (BK wide each) accumulated onto `seed` (the
// fp32 partial, or zeros when null); the flush writes
// act(acc + bias) to c, fp32 (out_f32) or bf16.
template <int BM, int BN, int BK, bool ALIGNED>
__global__ void __launch_bounds__(THREADS)
    apr_matmul_kernel(const __nv_bfloat16* __restrict__ a,
                      const __nv_bfloat16* __restrict__ b,
                      const float* __restrict__ bias, const float* seed,
                      void* c, int M, int N, int K, int t_begin, int t_end,
                      int out_f32, int act) {
  using T = Tile<BM, BN, BK>;
  constexpr int STAGES = T::STAGES;
  __shared__ __align__(128) unsigned char smem_static[T::STATIC ? T::SMEM
                                                                : 16];
  extern __shared__ __align__(128) unsigned char smem_dynamic[];
  unsigned char* smem = T::STATIC ? smem_static : smem_dynamic;
  __nv_bfloat16* sa = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sb = reinterpret_cast<__nv_bfloat16*>(smem + T::A_BYTES);
  float* sc = reinterpret_cast<float*>(smem);   // C tile: seed and flush

  const int warp = threadIdx.x / 32;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int wcol = warp * T::WN;              // this warp's first column

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
      load_tile<__nv_bfloat16, BM, BN, BK, T::LDA, T::LDB, ALIGNED>(
          sa + s * T::A_STAGE, sb + s * T::B_STAGE, a, b, m0, n0,
          (t_begin + s) * BK, M, N, K);
    cp_async_commit();
  }
  for (int t = t_begin; t < t_end; ++t) {
    const int slot = (t - t_begin) % STAGES;
    cp_async_wait<STAGES - 2>();              // tile t has landed
    __syncthreads();                          // ... and tile t-1 is consumed
    const int tn = t + STAGES - 1;            // refill the stage t-1 used
    if (tn < t_end) {
      const int sn = (tn - t_begin) % STAGES;
      load_tile<__nv_bfloat16, BM, BN, BK, T::LDA, T::LDB, ALIGNED>(
          sa + sn * T::A_STAGE, sb + sn * T::B_STAGE, a, b, m0, n0, tn * BK,
          M, N, K);
    }
    cp_async_commit();
    const __nv_bfloat16* ta = sa + slot * T::A_STAGE;
    const __nv_bfloat16* tb = sb + slot * T::B_STAGE + wcol;
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

template <int BM, int BN, int BK>
int launch(const void* a, const void* b, const void* bias, const void* seed,
           void* c, int m, int n, int k, int t_begin, int t_end, int out_f32,
           int act, cudaStream_t s) {
  using T = Tile<BM, BN, BK>;
  if ((m + BM - 1) / BM > 65535) return (int)cudaErrorInvalidValue;
  const bool aligned = k % 8 == 0 && n % 8 == 0 &&
                       reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(b) % 16 == 0;
  void (*kernel)(const __nv_bfloat16*, const __nv_bfloat16*, const float*,
                 const float*, void*, int, int, int, int, int, int, int) =
      aligned ? apr_matmul_kernel<BM, BN, BK, true>
              : apr_matmul_kernel<BM, BN, BK, false>;
  const int dynamic = T::STATIC ? 0 : T::SMEM;
  if (dynamic > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dynamic);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  kernel<<<grid, THREADS, dynamic, s>>>(
      static_cast<const __nv_bfloat16*>(a),
      static_cast<const __nv_bfloat16*>(b), static_cast<const float*>(bias),
      static_cast<const float*>(seed), c, m, n, k, t_begin, t_end, out_f32,
      act);
  return (int)cudaGetLastError();
}

// ------------------------------------------------ the int8-weight kernel
// Shared-memory layout of a 16 x BN x BK int8-weight tile, in bytes: a ring
// of [A stage | int8 B stage] pairs, as deep as 48 KB of static shared
// memory allows (at most 8 stages).  A 16-column tile computes on two warps
// and loads on all four.
template <int BN, int BK>
struct QTile {
  static constexpr int BM = 16;
  static constexpr int J = BN >= 32 ? BN / 32 : 1;  // n8 MMAs per warp/step
  static constexpr int WN = 8 * J;            // columns per warp
  static constexpr int CW = BN / WN;          // warps that compute
  static constexpr int LDA = BK + 8;          // A row stride, elements
  static constexpr int LDQ = BN + 16 > 48 ? BN + 16 : 48;  // int8, bytes
  static constexpr int A_STAGE = BM * LDA;    // elements
  static constexpr int Q_STAGE = BK * LDQ;    // bytes
  static constexpr int STAGE = A_STAGE * 2 + Q_STAGE;
  static constexpr int FIT = 48 * 1024 / STAGE;
  static constexpr int STAGES = FIT < 8 ? FIT : 8;
  static constexpr int SMEM = STAGES * STAGE;
  static_assert(BN % WN == 0 && CW <= WARPS && BK % 16 == 0,
                "whole n8k16 fragments per warp");
  static_assert(STAGES >= 3, "a ring of at least three stages");
  // 16-byte cp.async destinations and ldmatrix rows; rows 2t of the int8
  // tile (t = lane % 4) fall in distinct banks
  static_assert((LDA * 2) % 16 == 0 && LDQ % 16 == 0 && STAGE % 16 == 0,
                "aligned stages");
};

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const __nv_bfloat16* p) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The J codes of one K row at p (J adjacent bytes), as one shared load.
template <int J>
__device__ __forceinline__ uint32_t lds_codes(const int8_t* p) {
  if constexpr (J == 1) return *reinterpret_cast<const uint8_t*>(p);
  else if constexpr (J == 2) return *reinterpret_cast<const uint16_t*>(p);
  else return *reinterpret_cast<const uint32_t*>(p);
}

// bf16(float(code j of w) * s), as a 16-bit pattern
__device__ __forceinline__ uint32_t dequant(uint32_t w, int j, float s) {
  const float x = (float)(int8_t)((w >> (8 * j)) & 0xffu);
  return __bfloat16_as_ushort(__float2bfloat16(__fmul_rn(x, s)));
}

template <int BN, int BK, bool ALIGNED>
__global__ void __launch_bounds__(THREADS)
    int8w_kernel(const __nv_bfloat16* __restrict__ a,
                 const int8_t* __restrict__ b,
                 const float* __restrict__ scale, void* c, int M, int N,
                 int K, int out_f32) {
  using T = QTile<BN, BK>;
  constexpr int STAGES = T::STAGES, J = T::J;
  __shared__ __align__(128) unsigned char smem[T::SMEM];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;       // the MMA's group, thread
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * T::BM;
  const int wcol = warp * T::WN;              // this warp's first column
  const bool computes = warp < T::CW;         // every warp loads
  auto sa = [&](int slot) {
    return reinterpret_cast<__nv_bfloat16*>(smem + slot * T::STAGE);
  };
  auto sq = [&](int slot) {
    return reinterpret_cast<int8_t*>(smem + slot * T::STAGE +
                                     T::A_STAGE * 2);
  };

  // this thread's columns: wcol + J*g + j is fragment column g of MMA j
  float qs[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int col = n0 + wcol + J * g + j;
    qs[j] = col < N ? scale[col] : 0.0f;
  }
  // the APR: fp32 accumulators of rows g, g + 8 for the whole K range
  float acc[J][4];
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  // this lane's ldmatrix row: matrix lane / 8 of the 16 x 16 A fragment
  const int mi = lane / 8;
  const int a_off = ((lane % 8) + (mi % 2) * 8) * T::LDA + (mi / 2) * 8;
  const int q_off = 2 * t * T::LDQ + wcol + J * g;

  const int ktiles = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles)
      load_tile<int8_t, T::BM, BN, BK, T::LDA, T::LDQ, ALIGNED>(
          sa(s), sq(s), a, b, m0, n0, s * BK, M, N, K);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<STAGES - 2>();              // tile kt has landed
    __syncthreads();                          // ... and kt-1 is consumed
    const int kn = kt + STAGES - 1;           // refill the stage kt-1 used
    if (kn < ktiles)
      load_tile<int8_t, T::BM, BN, BK, T::LDA, T::LDQ, ALIGNED>(
          sa(kn % STAGES), sq(kn % STAGES), a, b, m0, n0, kn * BK, M, N, K);
    cp_async_commit();
    if (!computes) continue;
    const __nv_bfloat16* ta = sa(kt % STAGES) + a_off;
    const int8_t* tq = sq(kt % STAGES) + q_off;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[4];
      ldmatrix_x4(af, ta + kk);
      // rows kk + 2t, +1, +8, +9 of this thread's J columns
      const uint32_t w0 = lds_codes<J>(tq + kk * T::LDQ);
      const uint32_t w1 = lds_codes<J>(tq + (kk + 1) * T::LDQ);
      const uint32_t w2 = lds_codes<J>(tq + (kk + 8) * T::LDQ);
      const uint32_t w3 = lds_codes<J>(tq + (kk + 9) * T::LDQ);
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const uint32_t b0 = dequant(w0, j, qs[j]) |
                            (dequant(w1, j, qs[j]) << 16);
        const uint32_t b1 = dequant(w2, j, qs[j]) |
                            (dequant(w3, j, qs[j]) << 16);
        mma_bf16(acc[j], af, b0, b1);
      }
    }
  }
  cp_async_wait<0>();
  if (!computes) return;

  // flush straight from registers: acc[j][2h + e] is row g + 8h, fragment
  // column 2t + e, i.e. tile column wcol + J*(2t + e) + j
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int gm = m0 + g + 8 * h;
        const int gn = n0 + wcol + J * (2 * t + e) + j;
        if (gm < M && gn < N) {
          const size_t o = (size_t)gm * N + gn;
          if (out_f32)
            static_cast<float*>(c)[o] = acc[j][2 * h + e];
          else
            static_cast<__nv_bfloat16*>(c)[o] =
                __float2bfloat16(acc[j][2 * h + e]);
        }
      }
}

template <int BN, int BK>
int launch_int8w(const void* a, const void* b, const void* scale, void* c,
                 int m, int n, int k, int out_f32, cudaStream_t s) {
  if ((m + 15) / 16 > 65535) return (int)cudaErrorInvalidValue;
  const bool aligned = k % 8 == 0 && n % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(b) % 16 == 0;
  void (*kernel)(const __nv_bfloat16*, const int8_t*, const float*, void*,
                 int, int, int, int) =
      aligned ? int8w_kernel<BN, BK, true> : int8w_kernel<BN, BK, false>;
  dim3 grid((n + BN - 1) / BN, (m + 15) / 16);
  kernel<<<grid, THREADS, 0, s>>>(static_cast<const __nv_bfloat16*>(a),
                                  static_cast<const int8_t*>(b),
                                  static_cast<const float*>(scale), c, m, n,
                                  k, out_f32);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------ the fp32 kernel
constexpr int F32_BM = 16, F32_BN = 32, F32_KU = 8;  // rows, cols, K unroll
constexpr int F32_WARPS = 8, F32_THREADS = 32 * F32_WARPS;

template <bool VEC>
__global__ void __launch_bounds__(F32_THREADS)
    f32_kernel(const float* __restrict__ a, const float* __restrict__ b,
               const float* __restrict__ bias, void* c, int M, int N, int K,
               int out_f32, int act) {
  __shared__ float red_s[F32_WARPS][F32_BM][F32_BN + 1];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int n0 = blockIdx.x * F32_BN, m0 = blockIdx.y * F32_BM;
  const int n = n0 + lane, rows = min(F32_BM, M - m0);
  // this warp's K slice: a multiple of F32_KU wide, so float4 loads align
  const int slice =
      (K + F32_WARPS * F32_KU - 1) / (F32_WARPS * F32_KU) * F32_KU;
  const int k0 = min(K, warp * slice), k1 = min(K, k0 + slice);
  const bool col = n < N;
  const float* bp = b + (col ? n : 0);
  const float* ap = a + (size_t)m0 * K;

  float acc[F32_BM];
#pragma unroll
  for (int m = 0; m < F32_BM; ++m) acc[m] = 0.0f;
  int k = k0;
  for (; k + F32_KU <= k1; k += F32_KU) {
    float w[F32_KU];
#pragma unroll
    for (int i = 0; i < F32_KU; ++i)
      w[i] = col ? __ldg(bp + (size_t)(k + i) * N) : 0.0f;
#pragma unroll
    for (int m = 0; m < F32_BM; ++m) {
      if (m < rows) {
        const float* xr = ap + (size_t)m * K + k;
        float x[F32_KU];
        if (VEC) {
#pragma unroll
          for (int i = 0; i < F32_KU; i += 4) {
            const float4 v = __ldg(reinterpret_cast<const float4*>(xr + i));
            x[i] = v.x;
            x[i + 1] = v.y;
            x[i + 2] = v.z;
            x[i + 3] = v.w;
          }
        } else {
#pragma unroll
          for (int i = 0; i < F32_KU; ++i) x[i] = __ldg(xr + i);
        }
#pragma unroll
        for (int i = 0; i < F32_KU; ++i) acc[m] = fmaf(x[i], w[i], acc[m]);
      }
    }
  }
  for (; k < k1; ++k) {
    const float w = col ? __ldg(bp + (size_t)k * N) : 0.0f;
#pragma unroll
    for (int m = 0; m < F32_BM; ++m)
      if (m < rows) acc[m] = fmaf(__ldg(ap + (size_t)m * K + k), w, acc[m]);
  }
#pragma unroll
  for (int m = 0; m < F32_BM; ++m) red_s[warp][m][lane] = acc[m];
  __syncthreads();
  for (int idx = threadIdx.x; idx < F32_BM * F32_BN; idx += F32_THREADS) {
    const int r = idx / F32_BN, cl = idx % F32_BN;
    const int gm = m0 + r, gn = n0 + cl;
    if (gm < M && gn < N) {
      float v = red_s[0][r][cl];
#pragma unroll
      for (int w = 1; w < F32_WARPS; ++w) v += red_s[w][r][cl];
      if (bias != nullptr) v = __fadd_rn(v, bias[gn]);
      v = activate(v, act);
      const size_t o = (size_t)gm * N + gn;
      if (out_f32)
        static_cast<float*>(c)[o] = v;
      else
        static_cast<__nv_bfloat16*>(c)[o] = __float2bfloat16(v);
    }
  }
}

// The bf16 tiles (BM, BN, BK) compiled; bench/specs.py's apr_matmul space
// lists the same
#define APR_MATMUL_TILES(X) \
  X(16, 64, 32) X(16, 64, 64) X(16, 64, 128) X(32, 64, 32) X(32, 64, 64) \
  X(32, 64, 128)
// The int8-weight tiles (16, BN, BK) compiled; kernels/apr_matmul/ops.py's
// INT8W_TILES lists the same
#define INT8W_TILES(X) X(16, 128) X(32, 64) X(64, 64) X(32, 128) X(64, 128)

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
    return launch<BM_, BN_, BK_>(a, b, bias, seed, c, m, n, k, t_begin,     \
                                 t_end, out_f32, act, s);
  APR_MATMUL_TILES(APR_MATMUL_DISPATCH)
#undef APR_MATMUL_DISPATCH
  return (int)cudaErrorInvalidValue;
}

// The int8-weight variant at a (16, bn, bk) tile: B int8 (K, N) with its
// fp32 column scales (N,), dequantized to bf16(float(q) * scale[n]) into
// the MMA's B fragments; equal to apr_matmul_bf16 on the dequantized weight
// bit for bit, at every tile of either.
extern "C" int apr_matmul_int8w(const void* a, const void* b,
                                const void* scale, void* c, int m, int n,
                                int k, int bn, int bk, int out_f32,
                                void* stream) {
  if (m <= 0 || n <= 0 || k < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define INT8W_DISPATCH(BN_, BK_) \
  if (bn == BN_ && bk == BK_)    \
    return launch_int8w<BN_, BK_>(a, b, scale, c, m, n, k, out_f32, s);
  INT8W_TILES(INT8W_DISPATCH)
#undef INT8W_DISPATCH
  return (int)cudaErrorInvalidValue;
}

// C (M, N) = act(A (M, K) · B (K, N) + bias) with fp32 A and B, row-major
// and contiguous, fp32 FMAs throughout; bias fp32 (N,) or null; act as in
// epilogue.cuh; C bf16 (out_f32 == 0) or fp32.  One compiled tile (16 rows
// x 32 columns, K cut over 8 warps, 8 K rows a load step).  Launches on
// `stream` and returns cudaGetLastError().
extern "C" int apr_matmul_f32(const void* a, const void* b, const void* bias,
                              void* c, int m, int n, int k, int out_f32,
                              int act, void* stream) {
  if (m <= 0 || n <= 0 || k < 0 || act < 0 || act > 3 ||
      (m + F32_BM - 1) / F32_BM > 65535)
    return (int)cudaErrorInvalidValue;
  const bool vec = k % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
  void (*kernel)(const float*, const float*, const float*, void*, int, int,
                 int, int, int) = vec ? f32_kernel<true> : f32_kernel<false>;
  dim3 grid((n + F32_BN - 1) / F32_BN, (m + F32_BM - 1) / F32_BM);
  kernel<<<grid, F32_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(bias), c, m, n, k, out_f32, act);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
