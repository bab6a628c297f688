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
//    cover memory latency;
//  * bf16 WMMA 16x16x16 with fp32 accumulate;
//  * B is read as the row-major (K, N) slice of the stacked weight, with no
//    transpose; ragged M, N and K edges are masked inside the kernel:
//    zero-filled 16-byte copies when K and N are multiples of 8 and both
//    operands are 16-byte aligned, element loads with masks otherwise.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BM = 16, BN = 64, BK = 64, STAGES = 4;
constexpr int THREADS = 128;                  // 4 warps, one per 16 columns
constexpr int LDA = BK + 8;                   // padded shared-memory strides,
constexpr int LDB = BN + 8;                   // multiples of 8 elements
constexpr int A_STAGE = BM * LDA;             // elements per stage
constexpr int B_STAGE = BK * LDB;
constexpr int SMEM_BYTES = STAGES * (A_STAGE + B_STAGE) * 2;
static_assert(SMEM_BYTES <= 48 * 1024, "static shared memory limit");
static_assert(BM * BN * 4 <= STAGES * A_STAGE * 2, "epilogue reuses A ring");

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

// Stage the (BM x BK) tile of A and the (BK x BN) tile of B at k0.
template <bool ALIGNED>
__device__ __forceinline__ void load_tile(__nv_bfloat16* sa,
                                          __nv_bfloat16* sb,
                                          const __nv_bfloat16* a,
                                          const __nv_bfloat16* b, int m0,
                                          int n0, int k0, int M, int N,
                                          int K) {
  const int tid = threadIdx.x;
  if (ALIGNED) {
    // 16-byte chunks of 8 elements; K % 8 == 0 and N % 8 == 0 make every
    // chunk wholly inside or wholly outside the matrix
    {
      int row = tid / (BK / 8), col = (tid % (BK / 8)) * 8;
      int gm = m0 + row, gk = k0 + col;
      bool ok = gm < M && gk < K;
      cp_async16(sa + row * LDA + col,
                 ok ? a + (size_t)gm * K + gk : a, ok);
    }
#pragma unroll
    for (int i = 0; i < (BK * BN / 8) / THREADS; ++i) {
      int idx = tid + i * THREADS;
      int row = idx / (BN / 8), col = (idx % (BN / 8)) * 8;
      int gk = k0 + row, gn = n0 + col;
      bool ok = gk < K && gn < N;
      cp_async16(sb + row * LDB + col,
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
      sb[row * LDB + col] =
          (gk < K && gn < N) ? b[(size_t)gk * N + gn] : zero;
    }
  }
}

template <bool ALIGNED>
__global__ void __launch_bounds__(THREADS)
    apr_matmul_kernel(const __nv_bfloat16* __restrict__ a,
                      const __nv_bfloat16* __restrict__ b, void* c, int M,
                      int N, int K, int out_f32) {
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  __nv_bfloat16* sa = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sb = sa + STAGES * A_STAGE;

  const int warp = threadIdx.x / 32;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int ktiles = (K + BK - 1) / BK;

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
      load_tile<ALIGNED>(sa + s * A_STAGE, sb + s * B_STAGE, a, b, m0, n0,
                         s * BK, M, N, K);
    cp_async_commit();
  }
  for (int t = 0; t < ktiles; ++t) {
    cp_async_wait<STAGES - 2>();              // tile t has landed
    __syncthreads();                          // ... and tile t-1 is consumed
    const int tn = t + STAGES - 1;            // refill the stage t-1 used
    if (tn < ktiles)
      load_tile<ALIGNED>(sa + (tn % STAGES) * A_STAGE,
                         sb + (tn % STAGES) * B_STAGE, a, b, m0, n0, tn * BK,
                         M, N, K);
    cp_async_commit();
    const __nv_bfloat16* ta = sa + (t % STAGES) * A_STAGE;
    const __nv_bfloat16* tb = sb + (t % STAGES) * B_STAGE + warp * 16;
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

}  // namespace

// C (M, N) = A (M, K) · B (K, N); A and B bf16, row-major and contiguous;
// C bf16 (out_f32 == 0) or fp32.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int apr_matmul_bf16(const void* a, const void* b, void* c, int m,
                               int n, int k, int out_f32, void* stream) {
  if (m <= 0 || n <= 0 || k < 0 || (m + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  const bool aligned = k % 8 == 0 && n % 8 == 0 &&
                       reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(b) % 16 == 0;
  dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* pa = static_cast<const __nv_bfloat16*>(a);
  const __nv_bfloat16* pb = static_cast<const __nv_bfloat16*>(b);
  if (aligned)
    apr_matmul_kernel<true><<<grid, THREADS, 0, s>>>(pa, pb, c, m, n, k,
                                                     out_f32);
  else
    apr_matmul_kernel<false><<<grid, THREADS, 0, s>>>(pa, pb, c, m, n, k,
                                                      out_f32);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
