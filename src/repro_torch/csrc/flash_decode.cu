// flash_decode: one-token GQA attention over a KV cache, with the
// online-softmax state (m, l, acc) kept on chip across the whole sequence
// and the output written once -- the APR pattern applied to attention.
// One kernel body, three entry points:
//
//   flash_decode_paged_bf16  paged bf16 pools
//   flash_decode_paged_int8  paged int8 pools + fp32 (P, ps, Hkv) scales
//   flash_decode_bf16        contiguous bf16 cache (B, S, Hkv, D)
//
// Replaces: src/repro/kernels/flash_decode/kernel.py::paged_flash_decode_call
// (kernel body _paged_decode_kernel, quantized=False and quantized=True) and
// src/repro/kernels/flash_decode/kernel.py::flash_decode_call (kernel body
// _flash_decode_kernel).
//
// What bounds it on an H100: every cached K and V value is read once and
// used for G = Hq/Hkv query rows, so the kernel does about 2·G operations
// per byte and is bound by reading the live tokens' K and V (2 bytes per
// value, or 1 plus a 4-byte scale per (token, head) for int8 pools).  At
// the serving path's sizes (4 slots of a few hundred tokens, 8 kv heads)
// that is a few MB, so in practice memory latency, not bandwidth, sets its
// time: a block walks its sequence chunk by chunk, and each chunk costs a
// few dependent round trips to memory.
//
// Design:
//  * one block per (batch row, kv head); its G query rows share every K/V
//    row the block reads (query head h reads kv head h / G, as the TPU
//    kernel's q.reshape(b, hkv, g, d));
//  * a contiguous cache is a paged one whose row b is page b of size S, so
//    both layouts share the row arithmetic; the paged layouts read each
//    token's physical page from the block table;
//  * the block walks logical tokens in chunks of 32 and stops at the row's
//    length: the positions past it are never read;
//  * per chunk each warp owns 8 tokens and issues the K and V loads of all
//    of them at once (one memory round trip per chunk, not one per token);
//    lane l holds dims l, l+32, ... of q, K and V; int8 codes are
//    dequantized in fp32 right after the load, code * scale, with no bf16
//    rounding, as the TPU kernel dequantizes in VMEM;
//  * the running max m and normaliser l are fp32 registers of every thread
//    (all threads compute the same values); the weighted sum acc is kept
//    per warp in fp32 registers and the four warps' sums are added once, at
//    the flush, which divides by max(l, 1e-30);
//  * masking is the TPU kernels': a position at or past the length scores
//    -1e30.  The paged kernels also give such lanes weight exactly 0, so a
//    row of length 0 is zeros; the contiguous kernel does not zero them
//    (_flash_decode_kernel does not), so a row of length 0 walks all S
//    positions with equal weights and returns the mean of V, as the JAX
//    oracle does.  For a row of length > 0 a dead lane's weight
//    exp(-1e30 - m) is exactly 0 in fp32, so stopping at the length is
//    exact;
//  * a block-table entry outside the pool is treated as a dead lane rather
//    than read.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128, NWARPS = THREADS / 32;
constexpr int TC = 32, TPW = TC / NWARPS;     // tokens per chunk, per warp
constexpr int MAX_G = 8, MAX_D = 128, EPL = MAX_D / 32;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float widen(int8_t x) { return (float)x; }

// T: the cache's element type (bf16, or int8 with fp32 scales ks/vs).
// PAGED: rows come from block tables (p_max pages of ps tokens, p_pool
// pages in the pool); otherwise row b is page b, ps = S and p_max = 1.
template <typename T, bool PAGED>
__global__ void __launch_bounds__(THREADS) decode_kernel(
    const __nv_bfloat16* __restrict__ q,       // (B, Hq, D)
    const T* __restrict__ kp,                  // (P, ps, Hkv, D)
    const T* __restrict__ vp,                  // (P, ps, Hkv, D)
    const float* __restrict__ ks,              // (P, ps, Hkv) int8 only
    const float* __restrict__ vs,
    const int* __restrict__ lengths,           // (B,)
    const int* __restrict__ tables,            // (B, P_max), paged only
    __nv_bfloat16* __restrict__ out,           // (B, Hq, D)
    int hkv, int g, int d, int ps, int p_pool, int p_max, float scale) {
  constexpr bool QUANT = sizeof(T) == 1;
  __shared__ float w_s[MAX_G][TC];             // scores, then weights
  __shared__ long long row_s[TC];              // K/V row of each token, or -1
  __shared__ float ks_s[TC], vs_s[TC];         // its scales (int8 only)
  __shared__ float red_s[NWARPS][MAX_G][MAX_D];
  __shared__ float l_s[MAX_G];

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const size_t q_base = ((size_t)b * hkv * g + (size_t)h * g) * d;

  float qr[MAX_G][EPL];                        // this lane's dims of q
#pragma unroll
  for (int gi = 0; gi < MAX_G; ++gi)
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      const int di = lane + 32 * e;
      qr[gi][e] = (gi < g && di < d)
                      ? __bfloat162float(q[q_base + (size_t)gi * d + di]) *
                            scale
                      : 0.0f;
    }
  const int len = max(0, min(lengths[b], p_max * ps));
  // positions walked: the live ones, or all S for an empty contiguous row
  const int walk = (PAGED || len > 0) ? len : ps;

  float m[MAX_G], l[MAX_G], acc[MAX_G][EPL];
#pragma unroll
  for (int gi = 0; gi < MAX_G; ++gi) {
    m[gi] = NEG_INF;
    l[gi] = 0.0f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[gi][e] = 0.0f;
  }

  for (int c0 = 0; c0 < walk; c0 += TC) {
    if (tid < TC) {
      const int pos = c0 + tid;
      long long row = -1;
      if (pos < walk) {
        const int page = PAGED ? tables[(size_t)b * p_max + pos / ps] : b;
        if (page >= 0 && page < p_pool)
          row = ((long long)page * ps + pos % ps) * hkv + h;
      }
      row_s[tid] = row;
      if constexpr (QUANT) {
        ks_s[tid] = row >= 0 ? ks[row] : 0.0f;
        vs_s[tid] = row >= 0 ? vs[row] : 0.0f;
      }
    }
    __syncthreads();

    // K and V of this warp's tokens, all loads issued before any use; a
    // dead token reads row 0 and is masked below
    float kv[TPW][EPL], vv[TPW][EPL];
#pragma unroll
    for (int jj = 0; jj < TPW; ++jj) {
      const int j = warp * TPW + jj;
      const long long row = row_s[j];
      const size_t base = (size_t)(row >= 0 ? row : 0) * d;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        const int di = lane + 32 * e;
        kv[jj][e] = di < d ? widen(kp[base + di]) : 0.0f;
        vv[jj][e] = di < d ? widen(vp[base + di]) : 0.0f;
        if constexpr (QUANT) {
          kv[jj][e] *= ks_s[j];
          vv[jj][e] *= vs_s[j];
        }
      }
    }
#pragma unroll
    for (int jj = 0; jj < TPW; ++jj) {
      const int j = warp * TPW + jj;
      const bool live = row_s[j] >= 0 && c0 + j < len;
#pragma unroll
      for (int gi = 0; gi < MAX_G; ++gi) {
        if (gi < g) {                          // uniform across the warp
          float s = 0.0f;
#pragma unroll
          for (int e = 0; e < EPL; ++e) s += qr[gi][e] * kv[jj][e];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            s += __shfl_xor_sync(0xffffffffu, s, off);
          if (lane == 0) w_s[gi][j] = live ? s : NEG_INF;
        }
      }
    }
    __syncthreads();

    // online softmax: every thread derives the same m_new from the scores
    float m_new[MAX_G];
#pragma unroll
    for (int gi = 0; gi < MAX_G; ++gi) {
      float mc = NEG_INF;
      if (gi < g)
        for (int j = 0; j < TC; ++j) mc = fmaxf(mc, w_s[gi][j]);
      m_new[gi] = fmaxf(m[gi], mc);
    }
    __syncthreads();                           // scores read; now weights
    for (int idx = tid; idx < g * TC; idx += THREADS) {
      const int gi = idx / TC, j = idx % TC;
      float mg = NEG_INF;
#pragma unroll
      for (int x = 0; x < MAX_G; ++x)
        if (x == gi) mg = m_new[x];
      // a position that does not exist adds nothing; a paged dead lane
      // does not exist (its row is -1), a contiguous one weighs exp(s - m)
      w_s[gi][j] = row_s[j] >= 0 ? expf(w_s[gi][j] - mg) : 0.0f;
    }
    __syncthreads();

#pragma unroll
    for (int gi = 0; gi < MAX_G; ++gi) {
      if (gi < g) {
        const float alpha = expf(m[gi] - m_new[gi]);
        float psum = 0.0f;
        for (int j = 0; j < TC; ++j) psum += w_s[gi][j];
        l[gi] = l[gi] * alpha + psum;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[gi][e] *= alpha;
        m[gi] = m_new[gi];
      }
    }
#pragma unroll
    for (int jj = 0; jj < TPW; ++jj) {
      const int j = warp * TPW + jj;
      if (row_s[j] < 0) continue;              // absent: adds nothing at all
#pragma unroll
      for (int gi = 0; gi < MAX_G; ++gi) {
        if (gi < g) {
          const float wgt = w_s[gi][j];
#pragma unroll
          for (int e = 0; e < EPL; ++e) acc[gi][e] += wgt * vv[jj][e];
        }
      }
    }
    __syncthreads();                           // before the next chunk
  }

  // flush: add the warps' sums, normalise, write once
#pragma unroll
  for (int gi = 0; gi < MAX_G; ++gi)
#pragma unroll
    for (int e = 0; e < EPL; ++e) red_s[warp][gi][lane + 32 * e] = acc[gi][e];
  if (tid == 0) {
#pragma unroll
    for (int gi = 0; gi < MAX_G; ++gi) l_s[gi] = l[gi];
  }
  __syncthreads();
  for (int idx = tid; idx < g * d; idx += THREADS) {
    const int gi = idx / d, di = idx % d;
    float sum = 0.0f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) sum += red_s[w][gi][di];
    out[q_base + idx] = __float2bfloat16(sum / fmaxf(l_s[gi], 1e-30f));
  }
}

template <typename T, bool PAGED>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const void* lengths, const void* tables, void* out,
           int b, int hq, int hkv, int d, int ps, int p_pool, int p_max,
           void* stream) {
  if (b <= 0 || hkv <= 0 || hq % hkv != 0 || hq / hkv > MAX_G || d <= 0 ||
      d > MAX_D || ps <= 0 || p_max <= 0 || b > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid(hkv, b);
  decode_kernel<T, PAGED>
      <<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const __nv_bfloat16*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const float*>(ks),
          static_cast<const float*>(vs), static_cast<const int*>(lengths),
          static_cast<const int*>(tables), static_cast<__nv_bfloat16*>(out),
          hkv, hq / hkv, d, ps, p_pool, p_max, 1.0f / sqrtf((float)d));
  return (int)cudaGetLastError();
}

}  // namespace

// out (B, Hq, D) = attention of q (B, Hq, D) over the paged pools k/v
// (P, ps, Hkv, D), all bf16 and contiguous; lengths (B,) and block tables
// (B, P_max) int32.  Launches on `stream` and returns cudaGetLastError().
extern "C" int flash_decode_paged_bf16(const void* q, const void* k,
                                       const void* v, const void* lengths,
                                       const void* tables, void* out, int b,
                                       int hq, int hkv, int d, int ps,
                                       int p_pool, int p_max, void* stream) {
  return launch<__nv_bfloat16, true>(q, k, v, nullptr, nullptr, lengths,
                                     tables, out, b, hq, hkv, d, ps, p_pool,
                                     p_max, stream);
}

// The same over int8 pools k/v with fp32 scale pools k_scale/v_scale
// (P, ps, Hkv): value = code * scale of its (page slot, head).
extern "C" int flash_decode_paged_int8(const void* q, const void* k,
                                       const void* v, const void* k_scale,
                                       const void* v_scale,
                                       const void* lengths,
                                       const void* tables, void* out, int b,
                                       int hq, int hkv, int d, int ps,
                                       int p_pool, int p_max, void* stream) {
  return launch<int8_t, true>(q, k, v, k_scale, v_scale, lengths, tables,
                              out, b, hq, hkv, d, ps, p_pool, p_max, stream);
}

// out (B, Hq, D) = attention of q (B, Hq, D) over the contiguous cache k/v
// (B, S, Hkv, D), bf16 and contiguous; lengths (B,) int32.  A row of length
// 0 returns the mean of its S values of V.
extern "C" int flash_decode_bf16(const void* q, const void* k, const void* v,
                                 const void* lengths, void* out, int b, int hq,
                                 int hkv, int d, int s, void* stream) {
  return launch<__nv_bfloat16, false>(q, k, v, nullptr, nullptr, lengths,
                                      nullptr, out, b, hq, hkv, d, s, b, 1,
                                      stream);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
