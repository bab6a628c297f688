// apr_matmul: C = A·B with the fp32 accumulator resident on chip across the
// whole K loop -- the paper's architectural pipeline register (APR) -- and
// C written to device memory once, rounded once.
//
// Replaces: src/repro/kernels/apr_matmul/kernel.py::apr_matmul_call with
// residency="apr" (kernel body _apr_matmul_kernel).
//
// What bounds it on an H100: the serving path calls it with M = 4 (a decode
// tick over 4 slots) or M = 16 (one prefill chunk), so a product does 2·M·K·N
// operations on 2·K·N bytes of weight -- M operations per byte, far under the
// ~295 per byte at which the bf16 tensor cores become the limit.  The time
// is the time to stream B from memory once.
//
// Design:
//  * one block per 16 x 64 tile of C; the block walks the whole K range, so
//    the fp32 accumulators (one 16x16 WMMA fragment per warp) never leave
//    registers until the single write at the end (no split-K, no partial
//    sums in memory);
//  * A and B tiles are staged through shared memory by a 4-stage cp.async
//    ring, keeping three 64 x 64 tiles of B (24 KB) in flight per block to
//    cover memory latency (5 stages, four 4 KB tiles, for int8 weights);
//  * bf16 WMMA 16x16x16 with fp32 accumulate;
//  * B is read as the row-major (K, N) slice of the stacked weight, with no
//    transpose; ragged M, N and K edges are masked inside the kernel:
//    zero-filled 16-byte copies when K and N are multiples of 8 and both
//    operands are 16-byte aligned, element loads with masks otherwise.
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
// barrier and not a block one.  Tiles, K order and WMMA sequence are the bf16 kernel's, so the
// result equals apr_matmul_bf16 on the dequantized weight bit for bit.
// Bound: half the weight bytes of the bf16 kernel.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BM = 16, BN = 64, BK = 64;
constexpr int THREADS = 128;                  // 4 warps, one per 16 columns
constexpr int LDA = BK + 8;                   // padded shared-memory strides,
constexpr int LDB = BN + 8;                   // multiples of 8 elements
constexpr int LDQ = BN + 16;                  // int8 tile stride, in bytes
constexpr int A_STAGE = BM * LDA;             // elements per stage
constexpr int B_STAGE = BK * LDB;
constexpr int Q_STAGE = BK * LDQ;             // bytes per int8 stage
// Shared-memory layout by weight type.  bf16 weights: [A ring | B ring];
// int8 weights: [A ring | int8 B ring | dequantized bf16 B tile].  The
// int8 tiles are half as large, so their ring is one stage deeper.
template <bool Q>
struct Ring {
  static constexpr int STAGES = Q ? 5 : 4;
  static constexpr int A_BYTES = STAGES * A_STAGE * 2;
  static constexpr int B_BYTES = Q ? STAGES * Q_STAGE : STAGES * B_STAGE * 2;
  static constexpr int SMEM = A_BYTES + B_BYTES + (Q ? B_STAGE * 2 : 0);
};
static_assert(Ring<false>::SMEM <= 48 * 1024 && Ring<true>::SMEM <= 48 * 1024,
              "static shared memory limit");
static_assert((Ring<true>::A_BYTES + Ring<true>::B_BYTES) % 32 == 0,
              "WMMA tile alignment");
static_assert(BM * BN * 4 <= Ring<false>::A_BYTES, "epilogue reuses A ring");
// int8 dequantize: warp w converts exactly the 16 columns its WMMA reads
// (rows lane and lane + 32), keeping their scales in registers, so no
// other warp waits for it
static_assert(BN == 16 * (THREADS / 32) && BK == 64,
              "one 16-column strip of 64 rows per warp");

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
template <typename TB, bool ALIGNED>
__device__ __forceinline__ void load_tile(__nv_bfloat16* sa, TB* sb,
                                          const __nv_bfloat16* a,
                                          const TB* b, int m0, int n0, int k0,
                                          int M, int N, int K) {
  constexpr bool Q = sizeof(TB) == 1;
  constexpr int LD = Q ? LDQ : LDB;
  constexpr int CHUNK = 16 / sizeof(TB);      // elements per 16 bytes
  const int tid = threadIdx.x;
  if (ALIGNED) {
    // 16-byte chunks; K % 8 == 0 and N % CHUNK == 0 make every chunk
    // wholly inside or wholly outside the matrix
    {
      int row = tid / (BK / 8), col = (tid % (BK / 8)) * 8;
      int gm = m0 + row, gk = k0 + col;
      bool ok = gm < M && gk < K;
      cp_async16(sa + row * LDA + col,
                 ok ? a + (size_t)gm * K + gk : a, ok);
    }
#pragma unroll
    for (int i = 0; i < (BK * BN / CHUNK) / THREADS; ++i) {
      int idx = tid + i * THREADS;
      int row = idx / (BN / CHUNK), col = (idx % (BN / CHUNK)) * CHUNK;
      int gk = k0 + row, gn = n0 + col;
      bool ok = gk < K && gn < N;
      cp_async16(sb + row * LD + col,
                 ok ? b + (size_t)gk * N + gn : b, ok);
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
      if constexpr (Q)
        sb[row * LD + col] = ok ? b[(size_t)gk * N + gn] : int8_t(0);
      else
        sb[row * LD + col] = ok ? b[(size_t)gk * N + gn] : zero;
    }
  }
}

template <typename TB, bool ALIGNED>
__global__ void __launch_bounds__(THREADS)
    apr_matmul_kernel(const __nv_bfloat16* __restrict__ a,
                      const TB* __restrict__ b,
                      const float* __restrict__ scale, void* c, int M,
                      int N, int K, int out_f32) {
  constexpr bool Q = sizeof(TB) == 1;
  using R = Ring<Q>;
  constexpr int STAGES = R::STAGES;
  constexpr int B_RING = Q ? Q_STAGE : B_STAGE;   // TB elements per stage
  __shared__ __align__(128) unsigned char smem[R::SMEM];
  __nv_bfloat16* sa = reinterpret_cast<__nv_bfloat16*>(smem);
  TB* sb = reinterpret_cast<TB*>(smem + R::A_BYTES);
  // int8 weights only: the dequantized bf16 tile
  __nv_bfloat16* sbq =
      reinterpret_cast<__nv_bfloat16*>(smem + R::A_BYTES + R::B_BYTES);

  const int warp = threadIdx.x / 32;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int ktiles = (K + BK - 1) / BK;
  const int qcol = warp * 16;                 // this warp's 16 columns
  float qs[Q ? 16 : 1];
  if constexpr (Q) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
      qs[j] = n0 + qcol + j < N ? scale[n0 + qcol + j] : 0.0f;
  }

  // the APR: this warp's 16x16 slice of the C tile, fp32, for the whole K
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
  wmma::fill_fragment(acc, 0.0f);
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>
      fa;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>
      fb;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles)
      load_tile<TB, ALIGNED>(sa + s * A_STAGE, sb + s * B_RING, a, b, m0, n0,
                             s * BK, M, N, K);
    cp_async_commit();
  }
  for (int t = 0; t < ktiles; ++t) {
    cp_async_wait<STAGES - 2>();              // tile t has landed
    __syncthreads();                          // ... and tile t-1 is consumed
    const int tn = t + STAGES - 1;            // refill the stage t-1 used
    if (tn < ktiles)
      load_tile<TB, ALIGNED>(sa + (tn % STAGES) * A_STAGE,
                             sb + (tn % STAGES) * B_RING, a, b, m0, n0,
                             tn * BK, M, N, K);
    cp_async_commit();
    const __nv_bfloat16* ta = sa + (t % STAGES) * A_STAGE;
    const __nv_bfloat16* tb;
    if constexpr (Q) {
      // dequantize bf16(float(q) * scale[n]) of this warp's strip: each
      // lane loads its two 16-code rows before any store, then writes them
      // 8 bf16 at a time; the warp's WMMA reads only what it wrote
      const int8_t* tq = reinterpret_cast<const int8_t*>(sb) +
                         (t % STAGES) * Q_STAGE;
      const int lane = threadIdx.x % 32;
      uint4 raw[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = lane + 32 * i;
        raw[i] = *reinterpret_cast<const uint4*>(tq + row * LDQ + qcol);
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
        uint4* dst = reinterpret_cast<uint4*>(sbq + row * LDB + qcol);
        dst[0] = make_uint4(packed[0], packed[1], packed[2], packed[3]);
        dst[1] = make_uint4(packed[4], packed[5], packed[6], packed[7]);
      }
      __syncwarp();
      tb = sbq + qcol;
    } else {
      tb = reinterpret_cast<const __nv_bfloat16*>(sb) +
           (t % STAGES) * B_STAGE + warp * 16;
    }
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::load_matrix_sync(fa, ta + kk, LDA);
      wmma::load_matrix_sync(fb, tb + kk * LDB, LDB);
      wmma::mma_sync(acc, fa, fb, acc);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // flush: the tile goes through shared memory once, so the global write
  // is coalesced and masked at the ragged M/N edges
  float* sc = reinterpret_cast<float*>(smem);
  wmma::store_matrix_sync(sc + warp * 16, acc, BN, wmma::mem_row_major);
  __syncthreads();
  for (int idx = threadIdx.x; idx < BM * BN; idx += THREADS) {
    int r = idx / BN, col = idx % BN;
    int gm = m0 + r, gn = n0 + col;
    if (gm < M && gn < N) {
      size_t o = (size_t)gm * N + gn;
      if (out_f32)
        static_cast<float*>(c)[o] = sc[idx];
      else
        static_cast<__nv_bfloat16*>(c)[o] = __float2bfloat16(sc[idx]);
    }
  }
}

template <typename TB>
int launch(const void* a, const void* b, const void* scale, void* c, int m,
           int n, int k, int out_f32, void* stream) {
  if (m <= 0 || n <= 0 || k < 0 || (m + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  const bool aligned = k % 8 == 0 && n % (16 / sizeof(TB)) == 0 &&
                       reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(b) % 16 == 0;
  dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* pa = static_cast<const __nv_bfloat16*>(a);
  const TB* pb = static_cast<const TB*>(b);
  const float* ps = static_cast<const float*>(scale);
  if (aligned)
    apr_matmul_kernel<TB, true><<<grid, THREADS, 0, s>>>(pa, pb, ps, c, m, n,
                                                         k, out_f32);
  else
    apr_matmul_kernel<TB, false><<<grid, THREADS, 0, s>>>(pa, pb, ps, c, m,
                                                          n, k, out_f32);
  return (int)cudaGetLastError();
}

}  // namespace

// C (M, N) = A (M, K) · B (K, N); A and B bf16, row-major and contiguous;
// C bf16 (out_f32 == 0) or fp32.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int apr_matmul_bf16(const void* a, const void* b, void* c, int m,
                               int n, int k, int out_f32, void* stream) {
  return launch<__nv_bfloat16>(a, b, nullptr, c, m, n, k, out_f32, stream);
}

// The same with an int8 B (K, N) and its fp32 column scales (N,): B is
// dequantized to bf16(float(q) * scale[n]) in the load stage.
extern "C" int apr_matmul_int8w(const void* a, const void* b,
                                const void* scale, void* c, int m, int n,
                                int k, int out_f32, void* stream) {
  return launch<int8_t>(a, b, scale, c, m, n, k, out_f32, stream);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
