// apr_matmul: C = A·B with fp32 accumulators resident on chip across the
// K loop -- the paper's architectural pipeline register (APR) -- and C
// written to device memory once, rounded once; with an optional epilogue
// activation(acc + bias) at that flush, and the paper's memory-resident
// baseline on the same tiles.
//
// Replaces: src/repro/kernels/apr_matmul/kernel.py::apr_matmul_call with
// residency="apr" (kernel body _apr_matmul_kernel) and residency="hbm"
// (_hbm_matmul_kernel), and apr_matmul_fused_call (_apr_matmul_fused_kernel).
//
// What bounds it on an H100: the serving path calls it with M = 4 (a decode
// tick over 4 slots) or M = 16 (one prefill chunk), so a product does 2·M·K·N
// operations on 2·K·N bytes of weight (4·K·N in fp32) -- M operations per
// byte, far under the ~295 per byte at which the bf16 tensor cores become
// the limit.  The time is the time to stream B from memory once, which
// needs many blocks with many bytes in flight: at N = 1024 a 64-column tile
// gives 16 blocks for 132 SMs.  The whole-sequence paths (a forward or a
// prefill over B·T rows, whisper's 2 x 1500 frames, a 1024-token prefill
// around the scans) call it with M in the hundreds or thousands: about M
// operations a byte again, now far above 295, so the tensor cores bound it.
// There the 16-row tiles lose (each weight tile read M / 16 times, every
// WMMA waiting on its fragment loads), and from 128 rows the wrapper takes
// the wide body below: 128 x 128 or 128 x 256 tiles staged by TMA into
// wgmma, each weight tile read M / 128 times.
//
// Split-K over a thread-block cluster (the bf16 and fp32 bodies): the K
// range of each column tile is cut into `splits` (1, 2, 4 or 8) contiguous
// ranges of whole multiples of 128 rows (the largest compiled BK; the last
// range cut at K, ranges past K empty), one block each; the blocks of one
// tile form one cluster (grid (splits, N/BN, M/BM), cluster (splits, 1, 1)).
// Each block keeps its fp32 partial in registers across its range (the
// APR); after cluster.sync() the cluster's blocks add the partials in split
// order, reading them through distributed shared memory
// (cluster.map_shared_rank), apply bias and activation and write C once.
// No partial sum reaches global memory, the order of every sum is fixed by
// the split count alone (so every tile gives the same bits at one split
// count), and at one split the kernel is the one-chain kernel it was.  The
// wrapper picks the split count from the geometry (enough tiles x splits to
// put about one block on each SM) or takes a tuned or pinned one.
//
// bf16 body (apr_matmul_bf16):
//  * one template over the tile (BM x BN x BK), instantiated for the tiles
//    the tuning layer may choose (TILES below; the family's TuneSpace in
//    bench/specs.py lists exactly these); 4 warps, warp w owning columns
//    [w·BN/4, (w+1)·BN/4) of all BM rows as (BM/16) x (BN/64) WMMA
//    fragments;
//  * each block walks its split's K range; each output element sums its
//    range in 16-wide steps in ascending order into one accumulator
//    whatever the tile, so every tile gives the same bits;
//  * A and B tiles are staged through shared memory by a 4-stage cp.async
//    ring (a static array up to 48 KB, dynamic shared memory above, after
//    cudaFuncSetAttribute);
//  * bf16 WMMA 16x16x16 with fp32 accumulate;
//  * B is read as the row-major (K, N) slice of the stacked weight, with no
//    transpose; ragged M, N and K edges are masked inside the kernel:
//    zero-filled 16-byte copies when K and N are multiples of 8 and both
//    operands are 16-byte aligned, element loads with masks otherwise;
//  * the flush goes through shared memory once (the split partial each
//    block of a cluster reads), so the global write is coalesced and
//    masked; it applies bias (fp32, may be null) and the activation of
//    epilogue.cuh (B7m, apr_matmul_fused), each step rounded on its own as
//    the plain version rounds it.
//
// Wide bf16 body (apr_matmul_bf16 at APR_MATMUL_WIDE_TILES, M >= 128; B1
// and B7m): the same function and the same bits as the bf16 body at every
// split count, on the card's large-M shape.
//  * a block of 3 warpgroups per BM x BN tile (BM = 128): warpgroup 0's
//    first thread keeps a 4-stage ring of shared memory full by TMA (2-D
//    tensor maps built per call; the (BM x 64) K-major A box and BN / 64
//    boxes of the (64 x BN) row-major weight as it lies in memory, all under
//    the 128-byte swizzle; elements past M, N and K arrive as zeros), one
//    full and one empty mbarrier a stage;
//  * warpgroups 1 and 2 own 64 rows each and keep their fp32 accumulators
//    in registers over the whole split range (the APR), one wgmma
//    m64n128k16 a 128 columns and 16 K rows, B read N-major (transposed)
//    straight from the ring; each output sums its range in 16-wide steps in
//    ascending order, as above.  That wgmma's k16 step rounds as WMMA
//    16x16x16's (HMMA.16816.F32.BF16 on sm_90a) is what the bits rest on:
//    chip_smoke.py's phase 2 probes it on random and hard operands
//    (cancelling sums, mixed exponents, subnormal products) and holds the
//    two bodies equal bit for bit at every tile and split count;
//  * the split-K combine is the bf16 body's, through distributed shared
//    memory in split order; the flush pads the C tile's rows (no bank
//    conflicts on the fragment stores), applies bias and activation as
//    store_out and writes 4 outputs a thread (K and N multiples of 8, the
//    bases 16-byte aligned: what TMA needs, so the wrapper sends only such
//    operands here);
//  * the grid runs row tiles fastest, so the blocks in flight share a
//    weight column tile: the weight crosses device memory about once even
//    where it is far larger than the L2 (the lm_head's 1 GB).
//
// Memory residency (apr_matmul(residency="hbm"), B4m, the paper's baseline,
// the F-extension's fmac.s through memory of its Fig. 1(b)): one launch per
// call, grid (N/BN, M/BM), one split.  Each block walks its K tiles in
// ascending order through the same cp.async ring and the same WMMA
// sequence as the APR kernel, but its accumulators leave the chip at every
// K tile: after a tile's MMAs each thread writes its fragment elements to
// the fp32 (M, N) partial with st.global.cg, and before the next tile's
// MMAs reads them back with ld.global.cg (partial.cuh: volatile asm with a
// memory clobber, so neither the compiler nor L1 keeps the partial on chip).
// The first tile reads nothing; the last tile's sum is flushed as the APR
// kernel flushes it, to C in its output type (C is the partial itself when
// it is fp32).  Where each fragment element lies in the 16 x 16 tile is
// read from the fragment layout itself (a load_matrix_sync of the indices
// 0..255), so no layout is assumed; elements past M or N, the tile's zero
// padding, have no place in the partial and stay in registers.  The fp32
// copy is exact, so the baseline equals the APR kernel at one split and the
// same tile bit for bit, and differs from it only in the round trip: 8·M·N
// bytes per K tile, which the ring's prefetch of the next A/B tiles
// overlaps but nothing hides.  At the serving shapes the partial (16-230 KB
// a call at M = 4) fits the H100's 50 MB L2, so on this card it travels to
// L2 and back, not necessarily to device memory.
// SASS (cuobjdump -sass of the built library, sm_90a, kept by chip_smoke.py
// --baseline): in the K loop of the bf16 baseline at the 16 x 64 x 64 tile
// every iteration issues 8 LDG.E.STRONG.GPU (the reload, before the tile's
// HMMAs) and 8 STG.E.STRONG.GPU (after them), one of each per accumulator
// element a thread holds; in the fp32 baseline's (4 rows, BN = BK = 64) 2
// and 2, one of each per output a thread adds.
//
// The fp32 baseline (apr_matmul_hbm_f32, fp32 operands) is the same round
// trip on the fp32 body: at each K tile the block adds its 8 chains in
// chain order (through shared memory beside the ring), adds that tile's
// sum to the partial read back with ld.global.cg (the first tile reads
// nothing) and writes it with st.global.cg, or at the last tile to C; the
// partial's load is issued before the tile's FMAs, which do not depend on
// it.  It is the per-tile round trip on the fp32 body rather than the 1x1
// case of apr_conv.cu's baseline because it keeps the matmul family's
// tiles (F32_TILES), its vectorised weight stream and its tune space; the
// order of its sums is the JAX kernel's, partial + dot(x_tile, y_tile).
//
// int8-weight variant (apr_matmul_int8w): B is an int8 (K, N) weight with
// fp32 per-column scales (1, N), the port's QuantizedTensor.  On the TPU
// XLA fuses the dequantize multiply into the consuming einsum, so the
// weight crosses memory at 1 byte per element; this is that fusion, in a
// kernel body of its own.  Bound: half the weight bytes of the bf16 kernel.
//  * It must equal the bf16 kernel at one split on the dequantized weight
//    bit for bit.  So each output keeps that kernel's K order -- 16-wide
//    steps in ascending order into one fp32 accumulator for the whole K
//    range, no split-K -- and each step is one bf16 mma.sync.m16n8k16 per 8
//    columns, the instruction the bf16 kernel's 16x16x16 WMMA lowers to.
//    The B values are bf16(float(q) * scale[n]), the rounding of the JAX
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
// fp32 body (apr_matmul_f32, B1 and B7m for fp32 operands; apr_matmul_f32_
// int8w, an fp32 A over an int8 weight): every product and sum an fp32 FMA
// (no TF32: the plain version on the card is torch.matmul in full fp32, and
// the JAX kernel multiplies fp32 operands in fp32).  Bound: 4 bytes a
// weight element (1 for int8 codes, plus the scales).
//  * a block owns up to 16 rows x 64 columns of one split range (the
//    body takes BN = 4·CL for any CL; 64 is compiled); 8·BN/4 = 128
//    threads, thread (g, c) holding columns 4c..4c+3 of all
//    the block's rows (MR = 4, 8 or 16 rows, from M: 4·MR fp32
//    accumulators in registers across the range, the APR);
//  * each output sums its split range in 8 interleaved chains: chain g
//    takes the 4-row units u of the range with u % 8 == g, in ascending
//    order, one fmaf a row; the block adds its chains in chain order
//    through shared memory, then the cluster adds the splits in split
//    order.  That order depends on the split count alone (BK is a multiple
//    of 32 rows and the ranges of 128), so every tile gives the same bits;
//  * A's (MR x BK) slice and the weight's (BK x BN) slice ride a cp.async
//    ring of 16-byte copies in dynamic shared memory (about 64 KB: 3 to 8
//    stages, so a block keeps 30-50 KB of weight in flight); a thread reads
//    a unit's 4 weight rows as 4 16-byte vectors (4 columns each) and A as
//    one 16-byte broadcast vector per row, so a row costs 4·MR FMAs for
//    MR/4 + 1 shared loads;
//  * the int8 weight: its codes ride the ring at 1 byte each, and a value
//    is __fmul_rn(float(q), scale[n]), the one fp32 rounding of
//    QuantizedTensor.dequantize(float32); the products and sums are then
//    exactly the fp32 body's, so the two give the same bits.
#include <cooperative_groups.h>
#include <cuda.h>                              // CUtensorMap (no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "epilogue.cuh"
#include "partial.cuh"

using namespace nvcuda;
namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 128;                  // 4 warps
constexpr int WARPS = THREADS / 32;

// Shared-memory layout of a BM x BN x BK bf16 tile: [A ring | B ring];
// the baseline's layout probe and the flush's fp32 C tile reuse the start.
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

constexpr int K_RANGE = 128;                  // split ranges: multiples of
constexpr int MAX_SPLITS = 8;                 // 128 rows; portable clusters

// act(v + bias[gn]) rounded once into C at o: an output's one write
__device__ __forceinline__ void store_out(void* c, size_t o, float v,
                                          const float* bias, int gn, int act,
                                          int out_f32) {
  if (bias != nullptr) v = __fadd_rn(v, bias[gn]);
  v = activate(v, act);
  if (out_f32)
    static_cast<float*>(c)[o] = v;
  else
    static_cast<__nv_bfloat16*>(c)[o] = __float2bfloat16(v);
}

// The cluster's split partials -- each block's fp32 (rows x cols) tile
// `part` of C at (m0, n0), in its shared memory -- added in split order and
// flushed; block r of the cluster writes elements r·NT + tid,
// (r + splits)·NT + tid, ...  Every thread of every block calls it.
template <int NT>
__device__ __forceinline__ void combine_splits(float* part, int rows,
                                               int cols, int m0, int n0,
                                               int M, int N, void* c,
                                               const float* bias, int act,
                                               int out_f32) {
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();                             // every split's partial is in
  const int nsplit = (int)gridDim.x, rank = (int)cluster.block_rank();
  for (int idx = rank * NT + (int)threadIdx.x; idx < rows * cols;
       idx += nsplit * NT) {
    const int gm = m0 + idx / cols, gn = n0 + idx % cols;
    if (gm < M && gn < N) {
      float v = cluster.map_shared_rank(part, 0)[idx];
#pragma unroll
      for (int r = 1; r < MAX_SPLITS; ++r)
        if (r < nsplit) v = __fadd_rn(v, cluster.map_shared_rank(part, r)[idx]);
      store_out(c, (size_t)gm * N + gn, v, bias, gn, act, out_f32);
    }
  }
  cluster.sync();                             // keep the partials until read
}

// Launch `kernel` on grid (splits, ...) with the splits of one tile as one
// cluster (splits, 1, 1); returns the launch's error, then
// cudaGetLastError().
template <typename... Params, typename... Args>
int launch_split(void (*kernel)(Params...), dim3 grid, int threads,
                 int dynamic, cudaStream_t s, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = dynamic;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = grid.x;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = grid.x > 1 ? 1 : 0;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The split geometry a launch may take: 1, 2, 4 or 8 splits; above one, K
// ranges of krange rows, a multiple of K_RANGE, that cover K.
inline bool valid_splits(int k, int splits, int krange) {
  if (splits != 1 && splits != 2 && splits != 4 && splits != 8) return false;
  return splits == 1 || (krange >= 0 && krange % K_RANGE == 0 &&
                         (long long)krange * splits >= k);
}

using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// The memory-resident baseline's round trip of this warp's accumulators:
// element e of fragment (i, j) is C's (m0 + 16i + where[e] / 16,
// wcol0 + 16j + where[e] % 16), with wcol0 the warp's first column of C;
// elements past M or N (the tile's zero padding) have no place in the
// partial and are left alone.  STORE writes them, else reads them back.
constexpr int ACC_ELEMS = Acc::num_elements;

template <bool STORE, int FM, int FN>
__device__ __forceinline__ void partial_trip(Acc (&acc)[FM][FN],
                                             float* partial,
                                             const int (&where)[ACC_ELEMS],
                                             int m0, int wcol0, int M,
                                             int N) {
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
#pragma unroll
      for (int e = 0; e < ACC_ELEMS; ++e) {
        const int gm = m0 + i * 16 + where[e] / 16;
        const int gn = wcol0 + j * 16 + where[e] % 16;
        if (gm < M && gn < N) {
          float* p = partial + (size_t)gm * N + gn;
          if (STORE)
            st_cg(p, acc[i][j].x[e]);
          else
            acc[i][j].x[e] = ld_cg(p);
        }
      }
}

// C = act(A·B + bias) over the K tiles (BK wide each) of this block's
// split: with one split (gridDim.x == 1) all of K; with more, split
// blockIdx.x's krange rows, partials combined over the cluster.  The flush
// writes act(acc + bias) to c, fp32 (out_f32) or bf16.  HBM (one split, no
// bias or activation) is the memory-resident baseline: the accumulators
// round-trip through the fp32 partial at every K tile but the last.
template <int BM, int BN, int BK, bool ALIGNED, bool HBM>
__global__ void __launch_bounds__(THREADS)
    apr_matmul_kernel(const __nv_bfloat16* __restrict__ a,
                      const __nv_bfloat16* __restrict__ b,
                      const float* __restrict__ bias, float* partial, void* c,
                      int M, int N, int K, int krange, int out_f32, int act) {
  using T = Tile<BM, BN, BK>;
  constexpr int STAGES = T::STAGES;
  __shared__ __align__(128) unsigned char smem_static[T::STATIC ? T::SMEM
                                                                : 16];
  extern __shared__ __align__(128) unsigned char smem_dynamic[];
  unsigned char* smem = T::STATIC ? smem_static : smem_dynamic;
  __nv_bfloat16* sa = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sb = reinterpret_cast<__nv_bfloat16*>(smem + T::A_BYTES);
  float* sc = reinterpret_cast<float*>(smem);   // C tile of the flush

  const int warp = threadIdx.x / 32;
  const int nsplit = gridDim.x;
  const int n0 = blockIdx.y * BN, m0 = blockIdx.z * BM;
  const int wcol = warp * T::WN;              // this warp's first column
  int t_begin = 0, t_end = (K + BK - 1) / BK;
  if (nsplit > 1) {                           // this split's K tiles
    t_begin = blockIdx.x * (krange / BK);
    t_end = min(t_end, t_begin + krange / BK);
  }

  // the APR: this warp's slice of the C tile, fp32, for the whole K range
  Acc acc[T::FM][T::FN];
#pragma unroll
  for (int i = 0; i < T::FM; ++i)
#pragma unroll
    for (int j = 0; j < T::FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
  int where[ACC_ELEMS];                       // HBM: each element's place
  if constexpr (HBM) {
    float* probe = reinterpret_cast<float*>(smem);
    for (int idx = threadIdx.x; idx < 256; idx += THREADS)
      probe[idx] = (float)idx;
    __syncthreads();
    Acc at;
    wmma::load_matrix_sync(at, probe, 16, wmma::mem_row_major);
#pragma unroll
    for (int e = 0; e < ACC_ELEMS; ++e) where[e] = (int)at.x[e];
    __syncthreads();                          // before the ring reuses it
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
    if constexpr (HBM)                        // the partial of tiles < t
      if (t > t_begin)
        partial_trip<false>(acc, partial, where, m0, n0 + wcol, M, N);
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
    if constexpr (HBM)                        // ... and of tiles <= t
      if (t + 1 < t_end)
        partial_trip<true>(acc, partial, where, m0, n0 + wcol, M, N);
  }
  cp_async_wait<0>();
  __syncthreads();

  // flush: the tile goes through shared memory once, so the global write
  // is coalesced and masked at the ragged M/N edges (and the cluster's
  // blocks read each split's partial there)
#pragma unroll
  for (int i = 0; i < T::FM; ++i)
#pragma unroll
    for (int j = 0; j < T::FN; ++j)
      wmma::store_matrix_sync(sc + i * 16 * BN + wcol + j * 16, acc[i][j],
                              BN, wmma::mem_row_major);
  if (nsplit > 1) {
    combine_splits<THREADS>(sc, BM, BN, m0, n0, M, N, c, bias, act,
                            out_f32);
    return;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < BM * BN; idx += THREADS) {
    int gm = m0 + idx / BN, gn = n0 + idx % BN;
    if (gm < M && gn < N)
      store_out(c, (size_t)gm * N + gn, sc[idx], bias, gn, act, out_f32);
  }
}

template <int BM, int BN, int BK, bool HBM>
int launch(const void* a, const void* b, const void* bias, void* partial,
           void* c, int m, int n, int k, int splits, int krange, int out_f32,
           int act, cudaStream_t s) {
  using T = Tile<BM, BN, BK>;
  if ((m + BM - 1) / BM > 65535 || (n + BN - 1) / BN > 65535)
    return (int)cudaErrorInvalidValue;
  const bool aligned = k % 8 == 0 && n % 8 == 0 &&
                       reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(b) % 16 == 0;
  void (*kernel)(const __nv_bfloat16*, const __nv_bfloat16*, const float*,
                 float*, void*, int, int, int, int, int, int) =
      aligned ? apr_matmul_kernel<BM, BN, BK, true, HBM>
              : apr_matmul_kernel<BM, BN, BK, false, HBM>;
  const int dynamic = T::STATIC ? 0 : T::SMEM;
  if (dynamic > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dynamic);
    if (e != cudaSuccess) return (int)e;
  }
  return launch_split(
      kernel, dim3(splits, (n + BN - 1) / BN, (m + BM - 1) / BM), THREADS,
      dynamic, s, static_cast<const __nv_bfloat16*>(a),
      static_cast<const __nv_bfloat16*>(b), static_cast<const float*>(bias),
      static_cast<float*>(partial), c, m, n, k, krange, out_f32, act);
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

// ------------------------------------------------------ the fp32 body
constexpr int F32_BM = 16;                    // rows of a block, at most
constexpr int F32_CHAINS = 8;                 // interleaved sums an output
constexpr int F32_UNIT = 4;                   // K rows a chain takes at once

// A block of the fp32 body over a TB weight (float, or int8_t codes): BN
// columns, BK K rows a stage, MR rows of A computed; shared memory is a
// ring of [A (MR x BK fp32) | W (BK x LDW of TB)] stages, reused after the
// K loop for the chains' partials and the block's; the memory-resident
// baseline adds its chains at every stage, beside the ring (SMEM_HBM).
template <typename TB, int BN, int BK, int MR>
struct FTile {
  static constexpr int CL = BN / 4;           // threads across the columns
  static constexpr int THREADS = F32_CHAINS * CL;
  // int8 rows padded so that the two chains of a warp read distinct banks
  static constexpr int LDW = sizeof(TB) == 4 ? BN : BN + 16;
  static constexpr int A_STAGE = MR * BK * 4;                   // bytes
  static constexpr int W_STAGE = BK * LDW * (int)sizeof(TB);
  static constexpr int STAGE = A_STAGE + W_STAGE;
  static constexpr int FIT = 64 * 1024 / STAGE;
  static constexpr int STAGES = FIT < 3 ? 3 : (FIT > 8 ? 8 : FIT);
  static constexpr int RING = STAGES * STAGE;
  static constexpr int RED = (F32_CHAINS + 1) * MR * BN * 4;
  static constexpr int SMEM = RING > RED ? RING : RED;
  static constexpr int SMEM_HBM = RING + F32_CHAINS * MR * BN * 4;
  static_assert(BK % (F32_CHAINS * F32_UNIT) == 0 && K_RANGE % BK == 0,
                "whole units of every chain in a stage; stages in a range");
  static_assert(A_STAGE % 16 == 0 && STAGE % 16 == 0 &&
                    (LDW * (int)sizeof(TB)) % 16 == 0,
                "16-byte cp.async destinations");
};

// Stage A's (MR x BK) slice at (m0, k0) (row stride BK) and the weight's
// (BK x BN) slice at (k0, n0) (row stride LDW); zeros past M, N and K.
template <typename TB, int BN, int BK, int MR, bool ALIGNED>
__device__ __forceinline__ void f32_load_stage(float* sa, TB* sw,
                                               const float* a, const TB* b,
                                               int m0, int n0, int k0, int M,
                                               int N, int K) {
  using T = FTile<TB, BN, BK, MR>;
  constexpr int NT = T::THREADS;
  const int tid = threadIdx.x;
  if (ALIGNED) {
    // K % 4 == 0 and N % (16 / sizeof(TB)) == 0: every 16-byte chunk lies
    // wholly inside or wholly outside its matrix
    constexpr int A_CH = MR * BK / 4;
#pragma unroll
    for (int i = 0; i < (A_CH + NT - 1) / NT; ++i) {
      const int idx = tid + i * NT;
      if (A_CH % NT == 0 || idx < A_CH) {
        const int row = idx / (BK / 4), col = (idx % (BK / 4)) * 4;
        const int gm = m0 + row, gk = k0 + col;
        const bool ok = gm < M && gk < K;
        cp_async16(sa + row * BK + col, ok ? a + (size_t)gm * K + gk : a, ok);
      }
    }
    constexpr int CH = 16 / (int)sizeof(TB);  // elements per 16 bytes
    constexpr int W_CH = BK * BN / CH;
#pragma unroll
    for (int i = 0; i < (W_CH + NT - 1) / NT; ++i) {
      const int idx = tid + i * NT;
      if (W_CH % NT == 0 || idx < W_CH) {
        const int row = idx / (BN / CH), col = (idx % (BN / CH)) * CH;
        const int gk = k0 + row, gn = n0 + col;
        const bool ok = gk < K && gn < N;
        cp_async16(sw + row * T::LDW + col,
                   ok ? b + (size_t)gk * N + gn : b, ok);
      }
    }
  } else {
    for (int idx = tid; idx < MR * BK; idx += NT) {
      const int row = idx / BK, col = idx % BK;
      const int gm = m0 + row, gk = k0 + col;
      sa[idx] = gm < M && gk < K ? a[(size_t)gm * K + gk] : 0.0f;
    }
    for (int idx = tid; idx < BK * BN; idx += NT) {
      const int row = idx / BN, col = idx % BN;
      const int gk = k0 + row, gn = n0 + col;
      sw[row * T::LDW + col] = gk < K && gn < N ? b[(size_t)gk * N + gn]
                                                : TB(0);
    }
  }
}

// C = act(A·B + bias) on fp32 A (M, K) and a (K, N) weight of TB (int8
// codes with fp32 column scales `scale`, dequantized to
// __fmul_rn(float(q), scale[n])), over split blockIdx.x's krange rows of K
// (all of K at one split).  HBM (float weights, one split, no bias or
// activation) is the memory-resident baseline: at every K tile the block's
// chains, added in chain order, are added to the fp32 partial of the tiles
// before it (none for the first) and written back, or at the last to C.
template <typename TB, int BN, int BK, int MR, bool ALIGNED, bool HBM>
__global__ void __launch_bounds__(FTile<TB, BN, BK, MR>::THREADS)
    f32_kernel(const float* __restrict__ a, const TB* __restrict__ b,
               const float* __restrict__ scale,
               const float* __restrict__ bias, float* partial, void* c,
               int M, int N, int K, int krange, int out_f32, int act) {
  using T = FTile<TB, BN, BK, MR>;
  constexpr int STAGES = T::STAGES;
  constexpr int PER = MR * BN / T::THREADS;   // outputs a thread adds (HBM)
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, g = tid / T::CL, cl = tid % T::CL;
  const int nsplit = gridDim.x;
  const int n0 = blockIdx.y * BN, m0 = blockIdx.z * F32_BM;
  auto sa = [&](int slot) {
    return reinterpret_cast<float*>(smem + slot * T::STAGE);
  };
  auto sw = [&](int slot) {
    return reinterpret_cast<TB*>(smem + slot * T::STAGE + T::A_STAGE);
  };
  float qs[4];                                // this thread's column scales
  if constexpr (sizeof(TB) == 1) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = n0 + 4 * cl + e;
      qs[e] = col < N ? scale[col] : 0.0f;
    }
  }
  // the APR: rows 0..MR-1 of columns 4cl..4cl+3, chain g, the whole range
  // (HBM: one K tile)
  float acc[MR][4];
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[m][e] = 0.0f;

  const int ktiles = (K + BK - 1) / BK;
  int t_begin = 0, t_end = ktiles;
  if (nsplit > 1) {
    t_begin = blockIdx.x * (krange / BK);
    t_end = min(ktiles, t_begin + krange / BK);
  }
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (t_begin + s < t_end)
      f32_load_stage<TB, BN, BK, MR, ALIGNED>(sa(s), sw(s), a, b, m0, n0,
                                              (t_begin + s) * BK, M, N, K);
    cp_async_commit();
  }
  for (int t = t_begin; t < t_end; ++t) {
    const int slot = (t - t_begin) % STAGES;
    cp_async_wait<STAGES - 2>();              // stage t has landed
    __syncthreads();                          // ... and t-1 is consumed
    const int tn = t + STAGES - 1;            // refill the stage t-1 used
    if (tn < t_end) {
      const int sn = (tn - t_begin) % STAGES;
      f32_load_stage<TB, BN, BK, MR, ALIGNED>(sa(sn), sw(sn), a, b, m0, n0,
                                              tn * BK, M, N, K);
    }
    cp_async_commit();
    float prev[HBM ? PER : 1];                // HBM: the partial of tiles < t
    if constexpr (HBM) {
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int idx = tid + i * T::THREADS;
        const int gm = m0 + idx / BN, gn = n0 + idx % BN;
        prev[i] = t > t_begin && gm < M && gn < N
                      ? ld_cg(partial + (size_t)gm * N + gn) : 0.0f;
      }
    }
    const float* ta = sa(slot);
    const TB* tw = sw(slot) + 4 * cl;
#pragma unroll
    for (int j = 0; j < BK / (F32_CHAINS * F32_UNIT); ++j) {
      const int r = F32_UNIT * (g + F32_CHAINS * j);  // this unit's rows
      float w[F32_UNIT][4];
#pragma unroll
      for (int i = 0; i < F32_UNIT; ++i) {
        if constexpr (sizeof(TB) == 4) {
          const float4 v =
              *reinterpret_cast<const float4*>(tw + (r + i) * T::LDW);
          w[i][0] = v.x;
          w[i][1] = v.y;
          w[i][2] = v.z;
          w[i][3] = v.w;
        } else {
          const uint32_t v =
              *reinterpret_cast<const uint32_t*>(tw + (r + i) * T::LDW);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            w[i][e] =
                __fmul_rn((float)(int8_t)((v >> (8 * e)) & 0xffu), qs[e]);
        }
      }
#pragma unroll
      for (int m = 0; m < MR; ++m) {
        const float4 x = *reinterpret_cast<const float4*>(ta + m * BK + r);
        const float xs[F32_UNIT] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int i = 0; i < F32_UNIT; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[m][e] = fmaf(xs[i], w[i][e], acc[m][e]);
      }
    }
    if constexpr (HBM) {
      // this tile's sum, its chains added in chain order beside the ring
      // (read before the next tile's barrier, written after it), onto the
      // partial, then back to memory (C at the last tile)
      float* red = reinterpret_cast<float*>(smem + T::RING);
#pragma unroll
      for (int m = 0; m < MR; ++m) {
        *reinterpret_cast<float4*>(red + (g * MR + m) * BN + 4 * cl) =
            make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][e] = 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int idx = tid + i * T::THREADS;
        float v = red[idx];
#pragma unroll
        for (int ch = 1; ch < F32_CHAINS; ++ch)
          v = __fadd_rn(v, red[ch * MR * BN + idx]);
        const int gm = m0 + idx / BN, gn = n0 + idx % BN;
        if (gm < M && gn < N) {
          const size_t o = (size_t)gm * N + gn;
          if (t > t_begin) v = __fadd_rn(prev[i], v);
          if (t + 1 < t_end)
            st_cg(partial + o, v);
          else
            store_out(c, o, v, nullptr, gn, 0, out_f32);
        }
      }
    }
  }
  cp_async_wait<0>();
  if constexpr (HBM) {
    if (t_begin == t_end)                     // K = 0: C is zeros
      for (int idx = tid; idx < MR * BN; idx += T::THREADS) {
        const int gm = m0 + idx / BN, gn = n0 + idx % BN;
        if (gm < M && gn < N)
          store_out(c, (size_t)gm * N + gn, 0.0f, nullptr, gn, 0, out_f32);
      }
    return;
  }
  __syncthreads();

  // the block's chains, added in chain order through shared memory
  float* red = reinterpret_cast<float*>(smem);          // [chain][MR][BN]
  float* part = red + F32_CHAINS * MR * BN;             // [MR][BN]
#pragma unroll
  for (int m = 0; m < MR; ++m)
    *reinterpret_cast<float4*>(red + (g * MR + m) * BN + 4 * cl) =
        make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
  __syncthreads();
  for (int idx = tid; idx < MR * BN; idx += T::THREADS) {
    float v = red[idx];
#pragma unroll
    for (int ch = 1; ch < F32_CHAINS; ++ch)
      v = __fadd_rn(v, red[ch * MR * BN + idx]);
    if (nsplit > 1) {
      part[idx] = v;
    } else {
      const int gm = m0 + idx / BN, gn = n0 + idx % BN;
      if (gm < M && gn < N)
        store_out(c, (size_t)gm * N + gn, v, bias, gn, act, out_f32);
    }
  }
  if (nsplit > 1)
    combine_splits<T::THREADS>(part, MR, BN, m0, n0, M, N, c, bias, act,
                               out_f32);
}

template <typename TB, int BN, int BK, int MR, bool HBM>
int launch_f32_rows(const void* a, const void* b, const void* scale,
                    const void* bias, void* partial, void* c, int m, int n,
                    int k, int splits, int krange, int out_f32, int act,
                    cudaStream_t s) {
  using T = FTile<TB, BN, BK, MR>;
  constexpr int SMEM = HBM ? T::SMEM_HBM : T::SMEM;
  const bool aligned = k % 4 == 0 && n % (16 / (int)sizeof(TB)) == 0 &&
                       reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(b) % 16 == 0;
  void (*kernel)(const float*, const TB*, const float*, const float*, float*,
                 void*, int, int, int, int, int, int) =
      aligned ? f32_kernel<TB, BN, BK, MR, true, HBM>
              : f32_kernel<TB, BN, BK, MR, false, HBM>;
  if (SMEM > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e != cudaSuccess) return (int)e;
  }
  return launch_split(
      kernel, dim3(splits, (n + BN - 1) / BN, (m + F32_BM - 1) / F32_BM),
      T::THREADS, SMEM, s, static_cast<const float*>(a),
      static_cast<const TB*>(b), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<float*>(partial), c, m, n,
      k, krange, out_f32, act);
}

// The rows a block computes: 4, 8 or 16, the fewest that hold M's rows
template <typename TB, int BN, int BK, bool HBM = false>
int launch_f32(const void* a, const void* b, const void* scale,
               const void* bias, void* partial, void* c, int m, int n, int k,
               int splits, int krange, int out_f32, int act, cudaStream_t s) {
  if ((m + F32_BM - 1) / F32_BM > 65535 || (n + BN - 1) / BN > 65535)
    return (int)cudaErrorInvalidValue;
  if (m <= 4)
    return launch_f32_rows<TB, BN, BK, 4, HBM>(
        a, b, scale, bias, partial, c, m, n, k, splits, krange, out_f32, act,
        s);
  if (m <= 8)
    return launch_f32_rows<TB, BN, BK, 8, HBM>(
        a, b, scale, bias, partial, c, m, n, k, splits, krange, out_f32, act,
        s);
  return launch_f32_rows<TB, BN, BK, 16, HBM>(
      a, b, scale, bias, partial, c, m, n, k, splits, krange, out_f32, act,
      s);
}

// ------------------------------------------------------ the wide bf16 body
// Shared-memory layout of a BM x BN wide tile, from a 1024-byte aligned
// base (the 128-byte swizzle's period): a ring of STAGES stages [A | B],
// A the (BM x 64) K-major tile, 128 bytes a row, B the (64 x BN) N-major
// slice as BN / 64 boxes of 64 rows x 128 bytes; then the full and empty
// barriers of each stage.  The flush's fp32 C tile (rows padded by 8
// floats, so a warp's fragment stores fall in distinct banks) reuses the
// ring.
constexpr int WIDE_BK = 64;                   // one 128-byte row of A
constexpr int WG = 128;                       // threads of a warpgroup

template <int BM, int BN>
struct WideTile {
  static constexpr int CONSUMERS = BM / 64;   // warpgroups, 64 rows each
  static constexpr int THREADS = WG * (CONSUMERS + 1);  // + the producer
  static constexpr int A_STAGE = BM * WIDE_BK * 2;      // bytes
  static constexpr int B_BOX = WIDE_BK * 64 * 2;        // 64 columns
  static constexpr int B_STAGE = BN / 64 * B_BOX;
  static constexpr int STAGE = A_STAGE + B_STAGE;
  static constexpr int STAGES = 4;
  static constexpr int RING = STAGES * STAGE;
  static constexpr int LDC = BN + 8;          // the C tile's row stride
  static constexpr int FLUSH = BM * LDC * 4;
  static constexpr int BODY = RING > FLUSH ? RING : FLUSH;
  static constexpr int SMEM = 1024 + BODY + 2 * STAGES * 8;  // + alignment
  static constexpr int ACC = BN / 2;          // accumulators a thread holds
  static_assert(BM % 64 == 0 && BN % 128 == 0 && K_RANGE % WIDE_BK == 0,
                "whole warpgroups, m64n128 products and stages in a range");
  static_assert(SMEM <= 232448, "within 227 KB of shared memory");
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk `chunk` of 128-byte row `row` under the
// 128-byte swizzle: the chunk index XOR the row index modulo 8.
__device__ __forceinline__ int sw128(int row, int chunk) {
  return row * 128 + ((chunk ^ (row & 7)) << 4);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// A wait on one ring stage that lasts this long is a deadlock: it traps, so
// a fault ends the launch with an error instead of holding the card.  The
// bound is 10 s of the card's global timer, not a count of tries, whose
// time depends on how often the block is scheduled.
constexpr uint64_t MBAR_DEADLOCK_NS = 10'000'000'000ull;

// Wait for the phase of `parity` to complete; the clock is read once every
// 1024 failed tries.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done, tries = 0;
  uint64_t since = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (++tries % 1024 == 0) {
      const uint64_t now = global_ns();
      if (since == 0) since = now;
      else if (now - since > MBAR_DEADLOCK_NS) __trap();
    }
  }
}

// The box of `map` at (c0 columns, c1 rows) into shared memory at dst,
// its bytes reported to bar; elements past the tensor's edges arrive as 0.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// A wgmma shared-memory descriptor under the 128-byte swizzle: start
// address, leading and stride byte offsets, each in 16-byte units.
__device__ __forceinline__ uint64_t gmma_desc(const void* p, int lbo,
                                              int sbo) {
  return ((smem_addr(p) & 0x3FFFFu) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         (1ull << 62);
}

template <int N>
__device__ __forceinline__ void keep_in_registers(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128 fp32, this warpgroup's fragment) += A (64 x 16, K-major) ·
// B (16 x 128, N-major: imm-trans-b 1), both read from shared memory.
// d[4j + e] is element (16·warp + lane / 4 + 8·(e / 2), 8j + 2·(lane % 4)
// + e % 2) of the 64 x 128 tile, the layout of mma.sync.m16n8k16's
// accumulators, which WMMA 16x16x16 lowers to on sm_90a.
__device__ __forceinline__ void wgmma_m64n128k16(float* d, uint64_t desc_a,
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// act(v[i] + bias[gn + i]) rounded once, for 4 adjacent outputs of C at
// o (o % 4 == 0): store_out's steps, written as one 16-byte (fp32) or
// 8-byte (bf16) store
__device__ __forceinline__ void store_out4(void* c, size_t o, float4 v,
                                          const float* bias, int gn, int act,
                                          int out_f32) {
  float x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (bias != nullptr) x[i] = __fadd_rn(x[i], bias[gn + i]);
    x[i] = activate(x[i], act);
  }
  if (out_f32) {
    *reinterpret_cast<float4*>(static_cast<float*>(c) + o) =
        make_float4(x[0], x[1], x[2], x[3]);
  } else {
    __nv_bfloat162 lo = __floats2bfloat162_rn(x[0], x[1]);
    __nv_bfloat162 hi = __floats2bfloat162_rn(x[2], x[3]);
    uint2 u;
    u.x = *reinterpret_cast<uint32_t*>(&lo);
    u.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(c) + o) = u;
  }
}

// The wide body's flush: the C tile `part` (BM x BN, row stride LDC) of
// each block of the cluster, added in split order (combine_splits' sums,
// 4 adjacent outputs a thread: N % 8 == 0 puts a group of 4 wholly inside
// or outside C) and written once; one split writes its own tile.
template <int BM, int BN, int LDC, int NT>
__device__ __forceinline__ void wide_flush(float* part, int m0, int n0,
                                           int M, int N, void* c,
                                           const float* bias, int act,
                                           int out_f32) {
  cg::cluster_group cluster = cg::this_cluster();
  const int nsplit = (int)gridDim.x;
  const int rank = nsplit > 1 ? (int)cluster.block_rank() : 0;
  if (nsplit > 1)
    cluster.sync();                           // every split's partial is in
  else
    __syncthreads();
  constexpr int GROUPS = BM * BN / 4;
  for (int g = rank * NT + (int)threadIdx.x; g < GROUPS; g += nsplit * NT) {
    const int r = g / (BN / 4), col = 4 * (g % (BN / 4));
    const int gm = m0 + r, gn = n0 + col;
    if (gm < M && gn < N) {
      float4 v = *reinterpret_cast<const float4*>(
          (nsplit > 1 ? cluster.map_shared_rank(part, 0) : part) + r * LDC +
          col);
#pragma unroll
      for (int s = 1; s < MAX_SPLITS; ++s)
        if (s < nsplit) {
          const float4 u = *reinterpret_cast<const float4*>(
              cluster.map_shared_rank(part, s) + r * LDC + col);
          v = make_float4(__fadd_rn(v.x, u.x), __fadd_rn(v.y, u.y),
                          __fadd_rn(v.z, u.z), __fadd_rn(v.w, u.w));
        }
      store_out4(c, (size_t)gm * N + gn, v, bias, gn, act, out_f32);
    }
  }
  if (nsplit > 1) cluster.sync();             // keep the partials until read
}

// C = act(A·B + bias) over this block's split (as apr_matmul_kernel: all
// of K at one split, else split blockIdx.x's krange rows), BM x BN a block:
// row tile blockIdx.y, column tile blockIdx.z, so that the blocks that run
// together share a column tile of the weight (read from device memory
// about once, not once a row tile) and A, a few MB, stays in the L2.
// Warpgroup 0 is the producer: one thread keeps the ring full by TMA (the
// A box and BN / 64 B boxes a stage, each stage's bytes counted by its full
// barrier).  Warpgroups 1.. each own 64 rows and every column: per stage
// BN / 128 wgmma m64n128k16 products for each of its four 16-row K steps,
// one commit group a stage, the previous stage released (one arrive a
// warp on its empty barrier) once its group has completed.  The
// accumulators stay in registers over the whole range and each output
// sums its range in 16-wide steps in ascending order, so the bits are
// apr_matmul_kernel's at every split count.
template <int BM, int BN>
__global__ void __launch_bounds__(WideTile<BM, BN>::THREADS, 1)
    wide_kernel(const __grid_constant__ CUtensorMap map_a,
                const __grid_constant__ CUtensorMap map_b,
                const float* __restrict__ bias, void* c, int M, int N, int K,
                int krange, int out_f32, int act) {
  using T = WideTile<BM, BN>;
  constexpr int STAGES = T::STAGES;
  extern __shared__ __align__(1024) unsigned char smem_dynamic[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_dynamic) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + T::BODY);
  uint64_t* empty = full + STAGES;

  const int wg = threadIdx.x / WG;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.z * BN;
  int t_begin = 0, t_end = (K + WIDE_BK - 1) / WIDE_BK;
  if (gridDim.x > 1) {                        // this split's K tiles
    t_begin = blockIdx.x * (krange / WIDE_BK);
    t_end = min(t_end, t_begin + krange / WIDE_BK);
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * T::CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float acc[T::ACC];                          // the APR (consumers)
#pragma unroll
  for (int i = 0; i < T::ACC; ++i) acc[i] = 0.0f;
  if (wg == 0) {
    if (threadIdx.x == 0) {
      for (int t = t_begin; t < t_end; ++t) {
        const int i = t - t_begin, s = i % STAGES;
        if (i >= STAGES) mbar_wait(&empty[s], ((i / STAGES) - 1) & 1);
        unsigned char* st = ring + s * T::STAGE;
        mbar_expect_tx(&full[s], T::STAGE);
        tma_load(st, &map_a, t * WIDE_BK, m0, &full[s]);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          tma_load(st + T::A_STAGE + j * T::B_BOX, &map_b, n0 + 64 * j,
                   t * WIDE_BK, &full[s]);
      }
    }
  } else {
    const unsigned char* rows = ring + (wg - 1) * 64 * 128;
    const bool arrives = threadIdx.x % 32 == 0;
    for (int t = t_begin; t < t_end; ++t) {
      const int i = t - t_begin, s = i % STAGES;
      mbar_wait(&full[s], (i / STAGES) & 1);
      const unsigned char* sa = rows + s * T::STAGE;
      const unsigned char* sb = ring + s * T::STAGE + T::A_STAGE;
      keep_in_registers<T::ACC>(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < WIDE_BK / 16; ++kk) {
        const uint64_t da = gmma_desc(sa + 32 * kk, 16, 1024);
#pragma unroll
        for (int h = 0; h < BN / 128; ++h)
          wgmma_m64n128k16(acc + 64 * h, da,
                           gmma_desc(sb + 2 * h * T::B_BOX + 2048 * kk,
                                     T::B_BOX, 1024));
      }
      wgmma_commit();
      wgmma_wait<1>();                        // stage i - 1's products done
      keep_in_registers<T::ACC>(acc);
      if (i > 0 && arrives) mbar_arrive(&empty[(i - 1) % STAGES]);
    }
    wgmma_wait<0>();
    keep_in_registers<T::ACC>(acc);
  }
  __syncthreads();                            // every stage consumed

  // the C tile through shared memory, then one coalesced, masked write
  float* sc = reinterpret_cast<float*>(ring);
  if (wg > 0) {
    const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
    const int r = (wg - 1) * 64 + 16 * warp + lane / 4, c0 = 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      *reinterpret_cast<float2*>(sc + r * T::LDC + 8 * j + c0) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<float2*>(sc + (r + 8) * T::LDC + 8 * j + c0) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
  wide_flush<BM, BN, T::LDC, T::THREADS>(sc, m0, n0, M, N, c, bias, act,
                                         out_f32);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, from the driver at run time (no -lcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The tensor map of a row-major bf16 (rows x cols) matrix in boxes of
// (box_rows x 64 columns) under the 128-byte swizzle, zeros past its edges
int tensor_map(CUtensorMap* map, const void* base, int rows, int cols,
               int box_rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t step[2] = {1, 1};
  CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                      const_cast<void*>(base), dims, strides, box, step,
                      CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_128B,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int BM, int BN>
int launch_wide(const void* a, const void* b, const void* bias, void* c,
                int m, int n, int k, int splits, int krange, int out_f32,
                int act, cudaStream_t s) {
  using T = WideTile<BM, BN>;
  // TMA: 16-byte aligned bases and row strides
  if ((m + BM - 1) / BM > 65535 || (n + BN - 1) / BN > 65535 || k % 8 ||
      n % 8 || reinterpret_cast<uintptr_t>(a) % 16 ||
      reinterpret_cast<uintptr_t>(b) % 16)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map_a, map_b;
  const int kk = k > 0 ? k : 8;               // K = 0 loads nothing
  int e = tensor_map(&map_a, a, m, kk, BM);
  if (e == 0) e = tensor_map(&map_b, b, kk, n, WIDE_BK);
  if (e != 0) return e;
  void (*kernel)(const CUtensorMap, const CUtensorMap, const float*, void*,
                 int, int, int, int, int, int) = wide_kernel<BM, BN>;
  // on every launch, as the attribute belongs to the current device
  cudaError_t r = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (r != cudaSuccess) return (int)r;
  return launch_split(kernel,
                      dim3(splits, (m + BM - 1) / BM, (n + BN - 1) / BN),
                      T::THREADS, T::SMEM, s, map_a, map_b,
                      static_cast<const float*>(bias), c, m, n, k, krange,
                      out_f32, act);
}

// The instruction probe: C (64 x 128, fp32) = A (64 x K) · B (K x 128),
// bf16 row-major, K a multiple of 64, by one warpgroup as one chain of
// wgmma m64n128k16 over the 16-row steps of K in ascending order, B read
// N-major (transposed) from shared memory, as the wide body reads it; the
// operands staged by plain loads under the 128-byte swizzle.
__global__ void __launch_bounds__(WG)
    wgmma_probe_kernel(const __nv_bfloat16* __restrict__ a,
                       const __nv_bfloat16* __restrict__ b, float* c, int K) {
  constexpr int B_BOX = WIDE_BK * 64 * 2;
  __shared__ __align__(1024) unsigned char smem[64 * 128 + 2 * B_BOX];
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  for (int k0 = 0; k0 < K; k0 += WIDE_BK) {
    __syncthreads();                          // the last step is read
    for (int idx = threadIdx.x; idx < 64 * 8; idx += WG) {
      const int row = idx / 8, ch = idx % 8;
      *reinterpret_cast<uint4*>(smem + sw128(row, ch)) =
          *reinterpret_cast<const uint4*>(a + (size_t)row * K + k0 + 8 * ch);
    }
    for (int idx = threadIdx.x; idx < 64 * 16; idx += WG) {
      const int row = idx / 16, col8 = idx % 16;
      *reinterpret_cast<uint4*>(smem + 64 * 128 + (col8 / 8) * B_BOX +
                                sw128(row, col8 % 8)) =
          *reinterpret_cast<const uint4*>(b + (size_t)(k0 + row) * 128 +
                                          8 * col8);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    keep_in_registers<64>(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WIDE_BK / 16; ++kk)
      wgmma_m64n128k16(acc, gmma_desc(smem + 32 * kk, 16, 1024),
                       gmma_desc(smem + 64 * 128 + 2048 * kk, B_BOX, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    keep_in_registers<64>(acc);
  }
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int r = 16 * warp + lane / 4, c0 = 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    c[r * 128 + 8 * j + c0] = acc[4 * j];
    c[r * 128 + 8 * j + c0 + 1] = acc[4 * j + 1];
    c[(r + 8) * 128 + 8 * j + c0] = acc[4 * j + 2];
    c[(r + 8) * 128 + 8 * j + c0 + 1] = acc[4 * j + 3];
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
// The fp32-body tiles (16, BN, BK) compiled; kernels/apr_matmul/ops.py's
// F32_TILES lists the same
#define F32_TILES(X) X(64, 32) X(64, 64)

// The wide bf16 tiles (BM, BN, 64) compiled, for M >= 128 (the wide body);
// kernels/apr_matmul/ops.py's WIDE_TILES lists the same
#define APR_MATMUL_WIDE_TILES(X) X(128, 128, 64) X(128, 256, 64)

}  // namespace

// C (M, N) = act(A (M, K) · B (K, N) + bias) at a (bm, bn, bk) tile.  A and
// B bf16, row-major and contiguous; bias fp32 (N,) or null; act as in
// epilogue.cuh; C bf16 (out_f32 == 0) or fp32.  splits 1 (one chain over
// all of K), or 2, 4 or 8: K cut into ranges of krange rows (a multiple of
// 128 that covers K in `splits` ranges), one block each, combined over a
// cluster.  Launches on `stream` and returns cudaGetLastError() (0 on
// success; cudaErrorInvalidValue for a tile that is not compiled or a bad
// split).
extern "C" int apr_matmul_bf16(const void* a, const void* b, const void* bias,
                               void* c, int m, int n, int k, int bm, int bn,
                               int bk, int splits, int krange, int out_f32,
                               int act, void* stream) {
  if (m <= 0 || n <= 0 || k < 0 || act < 0 || act > 3 ||
      !valid_splits(k, splits, krange))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define APR_MATMUL_DISPATCH(BM_, BN_, BK_)                                  \
  if (bm == BM_ && bn == BN_ && bk == BK_)                                  \
    return launch<BM_, BN_, BK_, false>(a, b, bias, nullptr, c, m, n, k,    \
                                        splits, krange, out_f32, act, s);
  APR_MATMUL_TILES(APR_MATMUL_DISPATCH)
#undef APR_MATMUL_DISPATCH
#define WIDE_DISPATCH(BM_, BN_, BK_)                                        \
  if (bm == BM_ && bn == BN_ && bk == BK_)                                  \
    return launch_wide<BM_, BN_>(a, b, bias, c, m, n, k, splits, krange,   \
                                 out_f32, act, s);
  APR_MATMUL_WIDE_TILES(WIDE_DISPATCH)
#undef WIDE_DISPATCH
  return (int)cudaErrorInvalidValue;
}

// The wgmma-vs-WMMA probe: C (64 x 128, fp32) = A (64 x K) · B (K x 128),
// bf16 row-major, K a multiple of 64 (wgmma_probe_kernel).
extern "C" int apr_matmul_wgmma_probe(const void* a, const void* b, void* c,
                                      int k, void* stream) {
  if (k <= 0 || k % WIDE_BK) return (int)cudaErrorInvalidValue;
  wgmma_probe_kernel<<<1, WG, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(a),
      static_cast<const __nv_bfloat16*>(b), static_cast<float*>(c), k);
  return (int)cudaGetLastError();
}

// The memory-resident baseline, C (M, N) = A (M, K) · B (K, N) in one
// launch at a (bm, bn, bk) tile of the bf16 body, one split: every K tile
// but the last sends the accumulators to the fp32 (M, N) `partial` and back;
// C bf16 (out_f32 == 0) or fp32, and then may be `partial` itself.  Equal to
// apr_matmul_bf16 at one split and the same tile bit for bit.  Launches on
// `stream` and returns cudaGetLastError().
extern "C" int apr_matmul_hbm_bf16(const void* a, const void* b,
                                   void* partial, void* c, int m, int n,
                                   int k, int bm, int bn, int bk, int out_f32,
                                   void* stream) {
  if (m <= 0 || n <= 0 || k < 0 || partial == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define HBM_DISPATCH(BM_, BN_, BK_)                                         \
  if (bm == BM_ && bn == BN_ && bk == BK_)                                  \
    return launch<BM_, BN_, BK_, true>(a, b, nullptr, partial, c, m, n, k,  \
                                       1, 0, out_f32, 0, s);
  APR_MATMUL_TILES(HBM_DISPATCH)
#undef HBM_DISPATCH
  return (int)cudaErrorInvalidValue;
}

// The int8-weight variant at a (16, bn, bk) tile: B int8 (K, N) with its
// fp32 column scales (N,), dequantized to bf16(float(q) * scale[n]) into
// the MMA's B fragments; equal to apr_matmul_bf16 at one split on the
// dequantized weight bit for bit, at every tile of either.
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
// and contiguous, fp32 FMAs throughout, at a (16, bn, bk) tile of the fp32
// body; bias fp32 (N,) or null; act as in epilogue.cuh; C bf16 (out_f32 ==
// 0) or fp32; splits and krange as for apr_matmul_bf16.  Every tile gives
// the same bits at one split count.  Launches on `stream` and returns
// cudaGetLastError().
extern "C" int apr_matmul_f32(const void* a, const void* b, const void* bias,
                              void* c, int m, int n, int k, int bn, int bk,
                              int splits, int krange, int out_f32, int act,
                              void* stream) {
  if (m <= 0 || n <= 0 || k < 0 || act < 0 || act > 3 ||
      !valid_splits(k, splits, krange))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define F32_DISPATCH(BN_, BK_)                                               \
  if (bn == BN_ && bk == BK_)                                                \
    return launch_f32<float, BN_, BK_>(a, b, nullptr, bias, nullptr, c, m,  \
                                       n, k, splits, krange, out_f32, act,  \
                                       s);
  F32_TILES(F32_DISPATCH)
#undef F32_DISPATCH
  return (int)cudaErrorInvalidValue;
}

// The same with an int8 (K, N) weight and its fp32 column scales (N,):
// each value __fmul_rn(float(q), scale[n]), so at each tile and split count
// it equals apr_matmul_f32 on QuantizedTensor.dequantize(float32) bit for
// bit.
extern "C" int apr_matmul_f32_int8w(const void* a, const void* b,
                                    const void* scale, void* c, int m, int n,
                                    int k, int bn, int bk, int splits,
                                    int krange, int out_f32, void* stream) {
  if (m <= 0 || n <= 0 || k < 0 || !valid_splits(k, splits, krange))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define F32_INT8W_DISPATCH(BN_, BK_)                                        \
  if (bn == BN_ && bk == BK_)                                               \
    return launch_f32<int8_t, BN_, BK_>(a, b, scale, nullptr, nullptr, c,  \
                                        m, n, k, splits, krange, out_f32, 0,\
                                        s);
  F32_TILES(F32_INT8W_DISPATCH)
#undef F32_INT8W_DISPATCH
  return (int)cudaErrorInvalidValue;
}

// The memory-resident baseline on fp32 operands, C (M, N) = A (M, K) ·
// B (K, N) in one launch at a (16, bn, bk) tile of the fp32 body, one
// split: each K tile's sum is added to the fp32 (M, N) `partial` of the
// tiles before it and sent back to memory (to C at the last); C bf16
// (out_f32 == 0) or fp32, and then may be `partial` itself.  Launches on
// `stream` and returns cudaGetLastError().
extern "C" int apr_matmul_hbm_f32(const void* a, const void* b,
                                  void* partial, void* c, int m, int n, int k,
                                  int bn, int bk, int out_f32, void* stream) {
  if (m <= 0 || n <= 0 || k < 0 || partial == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define F32_HBM_DISPATCH(BN_, BK_)                                          \
  if (bn == BN_ && bk == BK_)                                               \
    return launch_f32<float, BN_, BK_, true>(a, b, nullptr, nullptr,        \
                                             partial, c, m, n, k, 1, 0,     \
                                             out_f32, 0, s);
  F32_TILES(F32_HBM_DISPATCH)
#undef F32_HBM_DISPATCH
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
