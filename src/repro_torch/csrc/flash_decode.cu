// flash_decode: one-token GQA attention over a KV cache, with the
// online-softmax state (m, l, acc) kept on chip across the whole sequence
// and the output written once -- the APR pattern applied to attention.
// Two kernel bodies, five entry points:
//
//   paged body (B2, B2q)
//     flash_decode_paged_bf16  paged bf16 pools, bf16 q
//     flash_decode_paged_int8  paged int8 pools + fp32 (P, ps, Hkv) scales
//     flash_decode_paged_f32   paged fp32 pools, bf16 or fp32 q
//   split body (B3)
//     flash_decode_bf16        contiguous bf16 cache (B, S, Hkv, D)
//     flash_decode_f32         contiguous fp32 cache, bf16 or fp32 q
//
// The output has the type of q, as the TPU kernels' out_shape does.
//
// Replaces: src/repro/kernels/flash_decode/kernel.py::paged_flash_decode_call
// (kernel body _paged_decode_kernel, quantized=False and quantized=True) and
// src/repro/kernels/flash_decode/kernel.py::flash_decode_call (kernel body
// _flash_decode_kernel).
//
// What bounds it on an H100: every cached K and V value is read once and
// used for G = Hq/Hkv query rows, so the kernel does about 2·G operations
// per byte and is bound by reading the live tokens' K and V (2 bytes per
// value, 4 for fp32 caches, or 1 plus a 4-byte scale per (token, head) for
// int8 pools).  At the serving path's sizes (4 slots of a few hundred
// tokens, 8 kv heads) that is a few MB, so in practice memory latency and
// the launch, not bandwidth, set its time.
//
// Paged body (B2, B2q):
//  * one block per (batch row, kv head); its G query rows share every K/V
//    row the block reads (query head h reads kv head h / G, as the TPU
//    kernel's q.reshape(b, hkv, g, d)); each token's physical page comes
//    from the block table;
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
//  * a position at or past the length scores -1e30 and gets weight exactly
//    0, so a row of length 0 is zeros, as the TPU paged kernel returns it;
//    a block-table entry outside the pool is treated as a dead lane rather
//    than read.
//
// Split body (B3): the sequence is split over the blocks of a thread-block
// cluster and the splits are combined on chip.
//  * grid (splits, Hkv, B), cluster (splits, 1, 1), splits <= 8 (the
//    portable cluster size); the wrapper picks the split count from the
//    geometry and the SM count (the lengths live on the device), so that
//    the B·Hkv·splits blocks put about two on each SM: a block's walk is
//    latency-bound, so a second block on the SM streams alongside it.
//    Split s walks positions [s·range, (s+1)·range) of its row, cut at the
//    row's walk;
//  * inside a split, each warp owns TPW tokens of every 32-token step (8
//    for bf16, 4 for fp32: 16 bytes of K and of V per lane and token
//    either way) and keeps its own online-softmax state (m, l, acc[G][4])
//    in registers: no block barrier inside the walk.  Lane l holds dims
//    4l..4l+3, loaded as one 8- or 16-byte vector.  The next step's K and V
//    are loaded into a second register buffer before the current step is
//    consumed, so each warp keeps two steps of loads in flight;
//  * a score is a per-lane partial dot product; a step's G·TPW scores are
//    reduced together by one transposing butterfly of shuffles (G·TPW - 1
//    of them, not 5 per score), after which each lane holds the scores of
//    one group; the group's max and sum of weights are a few shuffles among
//    its lanes, each weight's exp is taken once, and the weights reach the
//    lanes that own the dims through 100-odd bytes of the warp's shared
//    memory between two __syncwarp;
//  * G is a template parameter (1, 2, 4, 8; a group of 3, 5, 6 or 7 runs
//    in the next one with the extra rows masked), so the register arrays
//    match the model;
//  * at the end the block's warps are combined in shared memory, in warp
//    order; then, after cluster.sync(), every block of the cluster combines
//    a slice of the (G, D) outputs, reading each split's (m, l, acc) from
//    that block's shared memory (distributed shared memory,
//    cluster.map_shared_rank): it rescales each by exp(m_s - M), adds them
//    in split order, divides by max(l, 1e-30) and writes the output once.
//    The partials never reach global memory, and the combine order is
//    fixed, so the same inputs give the same bits on every run;
//  * semantics of _flash_decode_kernel: scale 1/sqrt(D) applied to q; a
//    position at or past the length scores -1e30; a row of length 0 walks
//    all S positions with equal weights and returns the mean of V (every
//    split's m is then -1e30, exp(0) = 1 weights each split by its count).
//    A split whose range lies past the walk keeps m = -1e30, l = 0 and
//    adds nothing.  For a row of length > 0 a dead position's weight
//    exp(-1e30 - m) is exactly 0 in fp32, so stopping at the length is
//    exact.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int MAX_G = 8, MAX_D = 128;

__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float widen(int8_t x) { return (float)x; }
__device__ __forceinline__ float widen(float x) { return x; }

__device__ __forceinline__ void narrow(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
__device__ __forceinline__ void narrow(float* p, float x) { *p = x; }

// ------------------------------------------------------------ paged body
constexpr int THREADS = 128, NWARPS = THREADS / 32;
constexpr int TC = 32, TPW = TC / NWARPS;     // tokens per chunk, per warp
constexpr int EPL = MAX_D / 32;

// TQ: the type of q and of the output (bf16 or fp32).  T: the pools'
// element type (bf16, fp32, or int8 with fp32 scales ks/vs).  Rows come
// from block tables (p_max pages of ps tokens, p_pool pages in the pool).
template <typename TQ, typename T>
__global__ void __launch_bounds__(THREADS) paged_kernel(
    const TQ* __restrict__ q,                  // (B, Hq, D)
    const T* __restrict__ kp,                  // (P, ps, Hkv, D)
    const T* __restrict__ vp,                  // (P, ps, Hkv, D)
    const float* __restrict__ ks,              // (P, ps, Hkv) int8 only
    const float* __restrict__ vs,
    const int* __restrict__ lengths,           // (B,)
    const int* __restrict__ tables,            // (B, P_max)
    TQ* __restrict__ out,                      // (B, Hq, D)
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
                      ? widen(q[q_base + (size_t)gi * d + di]) * scale
                      : 0.0f;
    }
  const int len = max(0, min(lengths[b], p_max * ps));

  float m[MAX_G], l[MAX_G], acc[MAX_G][EPL];
#pragma unroll
  for (int gi = 0; gi < MAX_G; ++gi) {
    m[gi] = NEG_INF;
    l[gi] = 0.0f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[gi][e] = 0.0f;
  }

  for (int c0 = 0; c0 < len; c0 += TC) {
    if (tid < TC) {
      const int pos = c0 + tid;
      long long row = -1;
      if (pos < len) {
        const int page = tables[(size_t)b * p_max + pos / ps];
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
      // a position that does not exist (its row is -1) adds nothing
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
    narrow(out + q_base + idx, sum / fmaxf(l_s[gi], 1e-30f));
  }
}

template <typename TQ, typename T>
int launch_paged(const void* q, const void* k, const void* v, const void* ks,
                 const void* vs, const void* lengths, const void* tables,
                 void* out, int b, int hq, int hkv, int d, int ps, int p_pool,
                 int p_max, void* stream) {
  if (b <= 0 || hkv <= 0 || hq % hkv != 0 || hq / hkv > MAX_G || d <= 0 ||
      d > MAX_D || ps <= 0 || p_max <= 0 || b > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid(hkv, b);
  paged_kernel<TQ, T><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const TQ*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(lengths),
      static_cast<const int*>(tables), static_cast<TQ*>(out), hkv, hq / hkv,
      d, ps, p_pool, p_max, 1.0f / sqrtf((float)d));
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ split body
constexpr int STEP = 32;                       // tokens per block step
constexpr int MAX_SPLITS = 8;                  // the portable cluster size
constexpr int E = 4;                           // dims per lane (D <= 128)

// Per cache type: tokens per warp per step and the block's warps.
template <typename T>
struct Split {
  static constexpr int TPW = sizeof(T) == 2 ? 8 : 4;
  static constexpr int NW = STEP / TPW;        // 4 (bf16) or 8 (fp32) warps
  static constexpr int THREADS = NW * 32;
};

// E consecutive values of a K or V row as loaded: one 8-byte (bf16) or
// 16-byte (fp32) vector per lane, widened only when consumed.
template <typename T>
struct Raw;
template <>
struct Raw<__nv_bfloat16> {
  uint2 r;
  __device__ __forceinline__ void unpack(float (&x)[E]) const {
    x[0] = __uint_as_float(r.x << 16);
    x[1] = __uint_as_float(r.x & 0xffff0000u);
    x[2] = __uint_as_float(r.y << 16);
    x[3] = __uint_as_float(r.y & 0xffff0000u);
  }
  __device__ __forceinline__ void zero() { r = make_uint2(0u, 0u); }
  template <bool VEC>
  __device__ __forceinline__ void load(const __nv_bfloat16* p, int n) {
    if (VEC) {
      r = __ldg(reinterpret_cast<const uint2*>(p));
    } else {                                   // n <= E values, masked
      const unsigned short* s = reinterpret_cast<const unsigned short*>(p);
      unsigned v[E];
#pragma unroll
      for (int e = 0; e < E; ++e) v[e] = e < n ? s[e] : 0u;
      r = make_uint2(v[0] | (v[1] << 16), v[2] | (v[3] << 16));
    }
  }
};
template <>
struct Raw<float> {
  float4 r;
  __device__ __forceinline__ void unpack(float (&x)[E]) const {
    x[0] = r.x;
    x[1] = r.y;
    x[2] = r.z;
    x[3] = r.w;
  }
  __device__ __forceinline__ void zero() { r = make_float4(0, 0, 0, 0); }
  template <bool VEC>
  __device__ __forceinline__ void load(const float* p, int n) {
    if (VEC) {
      r = __ldg(reinterpret_cast<const float4*>(p));
    } else {
      float v[E];
#pragma unroll
      for (int e = 0; e < E; ++e) v[e] = e < n ? p[e] : 0.0f;
      r = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
};

// One warp's online-softmax state over its tokens.
template <int G>
struct WarpState {
  float m[G], l[G], acc[G][E];
};

// Load the K and V of this warp's TPW tokens starting at position p (those
// at or past hi are not read).
template <typename T, bool VEC, int TPW>
__device__ __forceinline__ void load_step(Raw<T> (&kr)[TPW],
                                          Raw<T> (&vr)[TPW], const T* kb,
                                          const T* vb, size_t stride, int p,
                                          int hi, int n) {
#pragma unroll
  for (int j = 0; j < TPW; ++j) {
    if (p + j < hi && n > 0) {
      kr[j].template load<VEC>(kb + (size_t)(p + j) * stride, n);
      vr[j].template load<VEC>(vb + (size_t)(p + j) * stride, n);
    } else {
      kr[j].zero();
      vr[j].zero();
    }
  }
}

// Sum V values across the warp with a transposing butterfly: at each
// halving step a lane sends half of its values and keeps the other half, so
// the V values take V - 1 shuffles in all, not 5 each.  On return lane l
// holds in v[0..CF) the totals of values (l / DUP) * CF + i, where CF =
// max(1, V / 32) and DUP = max(1, 32 / V) lanes hold each total.
template <int COUNT, int O>
struct Fold {
  template <int V>
  static __device__ __forceinline__ void run(float (&v)[V], int lane) {
    if constexpr (O > 0) {
      if constexpr (COUNT > 1) {
        constexpr int H = COUNT / 2;
        const bool up = lane & O;
#pragma unroll
        for (int i = 0; i < H; ++i) {
          const float send = up ? v[i] : v[i + H];
          const float keep = up ? v[i + H] : v[i];
          v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
        }
        Fold<H, O / 2>::run(v, lane);
      } else {
        v[0] += __shfl_xor_sync(0xffffffffu, v[0], O);
        Fold<1, O / 2>::run(v, lane);
      }
    }
  }
};

// Fold the TPW tokens at positions p.. into the warp's state: positions
// below hi exist; those below len score q·k, the others -1e30.  The G·TPW
// scores are reduced by one butterfly (Fold), after which each lane holds
// CF scores of one group gi; the group's max and sum of weights are taken
// by shuffles among the lanes holding it, each weight's exp is taken once,
// and the weights and the rescale factors go through the warp's slice of
// shared memory (ps: V weights, then G rescales, maxima and sums) to every
// lane, which holds the dims its acc covers.
template <typename T, int G, int TPW>
__device__ __forceinline__ void consume_step(WarpState<G>& st,
                                             const float (&qr)[G][E],
                                             const Raw<T> (&kr)[TPW],
                                             const Raw<T> (&vr)[TPW],
                                             float* ps, int lane, int p,
                                             int hi, int len) {
  constexpr int V = G * TPW;
  constexpr int CF = V >= 32 ? V / 32 : 1, DUP = V >= 32 ? 1 : 32 / V;
  float sc[V];                                 // [gi][j]
#pragma unroll
  for (int j = 0; j < TPW; ++j) {
    float kx[E];
    kr[j].unpack(kx);
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      float s = 0.0f;
#pragma unroll
      for (int e = 0; e < E; ++e) s += qr[gi][e] * kx[e];
      sc[gi * TPW + j] = s;
    }
  }
  Fold<V, 16>::run(sc, lane);
  const int base = (lane / DUP) * CF;          // this lane's first value
  const int gi = base / TPW, j0 = base % TPW;
  float mold = st.m[0];
#pragma unroll
  for (int x = 1; x < G; ++x)
    if (x == gi) mold = st.m[x];
  float sv[CF], mc = NEG_INF;
#pragma unroll
  for (int i = 0; i < CF; ++i) {
    sv[i] = p + j0 + i < len ? sc[i] : NEG_INF;
    if (p + j0 + i < hi) mc = fmaxf(mc, sv[i]);
  }
#pragma unroll
  for (int o = DUP; o < DUP * (TPW / CF); o <<= 1)
    mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, o));
  const float mn = fmaxf(mold, mc);
  float w[CF], psum = 0.0f;
#pragma unroll
  for (int i = 0; i < CF; ++i) {
    w[i] = p + j0 + i < hi ? expf(sv[i] - mn) : 0.0f;
    psum += w[i];
  }
#pragma unroll
  for (int o = DUP; o < DUP * (TPW / CF); o <<= 1)
    psum += __shfl_xor_sync(0xffffffffu, psum, o);
  __syncwarp();                                // the last step's reads done
#pragma unroll
  for (int i = 0; i < CF; ++i) ps[base + i] = w[i];
  if (j0 == 0) {
    ps[V + gi] = expf(mold - mn);
    ps[V + G + gi] = mn;
    ps[V + 2 * G + gi] = psum;
  }
  __syncwarp();
#pragma unroll
  for (int x = 0; x < G; ++x) {
    const float alpha = ps[V + x];
    st.l[x] = st.l[x] * alpha + ps[V + 2 * G + x];
    st.m[x] = ps[V + G + x];
#pragma unroll
    for (int e = 0; e < E; ++e) st.acc[x][e] *= alpha;
  }
#pragma unroll
  for (int j = 0; j < TPW; ++j) {
    float vx[E];
    vr[j].unpack(vx);
#pragma unroll
    for (int x = 0; x < G; ++x) {
      const float wj = ps[x * TPW + j];
#pragma unroll
      for (int e = 0; e < E; ++e) st.acc[x][e] += wj * vx[e];
    }
  }
}

// TQ: the type of q and of the output; T: the cache's (bf16 or fp32); G:
// the group size the arrays hold (g <= G); VEC: D % 4 == 0 and 16-byte
// aligned rows, so a lane's 4 values are one vector load.
template <typename TQ, typename T, int G, bool VEC>
__global__ void __launch_bounds__(Split<T>::THREADS) split_kernel(
    const TQ* __restrict__ q,                  // (B, Hq, D)
    const T* __restrict__ k,                   // (B, S, Hkv, D)
    const T* __restrict__ v,
    const int* __restrict__ lengths,           // (B,)
    TQ* __restrict__ out,                      // (B, Hq, D)
    int hkv, int g, int d, int s, int range, float scale) {
  constexpr int TPW = Split<T>::TPW, NW = Split<T>::NW;
  constexpr int THREADS_ = Split<T>::THREADS;
  __shared__ float ps_s[NW][G * TPW + 3 * G];  // each warp's step weights
  __shared__ float wm_s[NW][G], wl_s[NW][G];
  __shared__ __align__(16) float wacc_s[NW][G][MAX_D];
  // this split's combined state, read by the cluster's blocks
  __shared__ float pm_s[G], pl_s[G];
  __shared__ __align__(16) float pacc_s[G][MAX_D];

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nsplit = gridDim.x;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const size_t q_base = ((size_t)b * hkv + h) * g * d;
  const int d0 = lane * E;                     // this lane's first dim
  const int n = min(E, d - d0);                // its dims inside D

  float qr[G][E];
#pragma unroll
  for (int gi = 0; gi < G; ++gi)
#pragma unroll
    for (int e = 0; e < E; ++e)
      qr[gi][e] = (gi < g && e < n)
                      ? widen(q[q_base + (size_t)gi * d + d0 + e]) * scale
                      : 0.0f;
  const int len = max(0, min(lengths[b], s));
  const int walk = len > 0 ? len : s;          // all S for an empty row
  const int lo = split * range, hi = min(lo + range, walk);

  WarpState<G> st;
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    st.m[gi] = NEG_INF;
    st.l[gi] = 0.0f;
#pragma unroll
    for (int e = 0; e < E; ++e) st.acc[gi][e] = 0.0f;
  }

  // this warp's tokens: TPW of every STEP, two steps' loads in flight
  const size_t stride = (size_t)hkv * d;       // one position
  const T* kb = k + ((size_t)b * s * hkv + h) * d + (n > 0 ? d0 : 0);
  const T* vb = v + ((size_t)b * s * hkv + h) * d + (n > 0 ? d0 : 0);
  Raw<T> ka[TPW], va[TPW], kn[TPW], vn[TPW];
  int p = lo + warp * TPW;
  if (p < hi) load_step<T, VEC, TPW>(ka, va, kb, vb, stride, p, hi, n);
  while (p < hi) {
    const int p1 = p + STEP;
    if (p1 < hi) load_step<T, VEC, TPW>(kn, vn, kb, vb, stride, p1, hi, n);
    consume_step<T, G, TPW>(st, qr, ka, va, ps_s[warp], lane, p, hi, len);
    if (p1 >= hi) break;
    const int p2 = p1 + STEP;
    if (p2 < hi) load_step<T, VEC, TPW>(ka, va, kb, vb, stride, p2, hi, n);
    consume_step<T, G, TPW>(st, qr, kn, vn, ps_s[warp], lane, p1, hi, len);
    p = p2;
  }

  // the block's warps, combined in warp order
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    if (d0 < MAX_D)
      *reinterpret_cast<float4*>(&wacc_s[warp][gi][d0]) = make_float4(
          st.acc[gi][0], st.acc[gi][1], st.acc[gi][2], st.acc[gi][3]);
    if (lane == 0) {
      wm_s[warp][gi] = st.m[gi];
      wl_s[warp][gi] = st.l[gi];
    }
  }
  __syncthreads();
  for (int idx = tid; idx < g * d; idx += THREADS_) {
    const int gi = idx / d, di = idx % d;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, wm_s[w][gi]);
    float lsum = 0.0f, asum = 0.0f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float c = expf(wm_s[w][gi] - mx);
      lsum += c * wl_s[w][gi];
      asum += c * wacc_s[w][gi][di];
    }
    if (nsplit == 1) {
      narrow(out + q_base + idx, asum / fmaxf(lsum, 1e-30f));
    } else {
      pacc_s[gi][di] = asum;
      if (di == 0) {
        pm_s[gi] = mx;
        pl_s[gi] = lsum;
      }
    }
  }
  if (nsplit == 1) return;

  // the cluster's splits, combined in split order; block r writes outputs
  // r·THREADS.., reading every split's state from its shared memory
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();                              // every split's state is in
  const int rank = (int)cluster.block_rank();
  for (int idx = rank * THREADS_ + tid; idx < g * d;
       idx += nsplit * THREADS_) {
    const int gi = idx / d, di = idx % d;
    float ms[MAX_SPLITS];
    float mx = NEG_INF;
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r) {
      if (r < nsplit) {
        ms[r] = cluster.map_shared_rank(&pm_s[0], r)[gi];
        mx = fmaxf(mx, ms[r]);
      }
    }
    float lsum = 0.0f, asum = 0.0f;
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r) {
      if (r < nsplit) {
        const float c = expf(ms[r] - mx);
        lsum += c * cluster.map_shared_rank(&pl_s[0], r)[gi];
        asum += c * cluster.map_shared_rank(&pacc_s[0][0], r)[gi * MAX_D + di];
      }
    }
    narrow(out + q_base + idx, asum / fmaxf(lsum, 1e-30f));
  }
  cluster.sync();                              // keep the states until read
}

template <typename TQ, typename T, int G>
int launch_split_g(const void* q, const void* k, const void* v,
                   const void* lengths, void* out, int b, int hkv, int g,
                   int d, int s, int splits, void* stream) {
  const bool vec = d % E == 0 &&
                   reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v) % 16 == 0;
  void (*kernel)(const TQ*, const T*, const T*, const int*, TQ*, int, int,
                 int, int, int, float) =
      vec ? split_kernel<TQ, T, G, true> : split_kernel<TQ, T, G, false>;
  // split ranges: whole steps, the last split cut at S
  const int steps = (s + STEP - 1) / STEP;
  const int range = (steps + splits - 1) / splits * STEP;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, hkv, b);
  cfg.blockDim = dim3(Split<T>::THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const TQ*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(lengths),
      static_cast<TQ*>(out), hkv, g, d, s, range, 1.0f / sqrtf((float)d));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename TQ, typename T>
int launch_split(const void* q, const void* k, const void* v,
                 const void* lengths, void* out, int b, int hq, int hkv, int d,
                 int s, int splits, void* stream) {
  if (b <= 0 || hkv <= 0 || hq % hkv != 0 || hq / hkv > MAX_G || d <= 0 ||
      d > MAX_D || s <= 0 || b > 65535 || hkv > 65535 ||
      (splits != 1 && splits != 2 && splits != 4 && splits != 8))
    return (int)cudaErrorInvalidValue;
  const int g = hq / hkv;
  if (g == 1)
    return launch_split_g<TQ, T, 1>(q, k, v, lengths, out, b, hkv, g, d, s,
                                    splits, stream);
  if (g == 2)
    return launch_split_g<TQ, T, 2>(q, k, v, lengths, out, b, hkv, g, d, s,
                                    splits, stream);
  if (g <= 4)
    return launch_split_g<TQ, T, 4>(q, k, v, lengths, out, b, hkv, g, d, s,
                                    splits, stream);
  return launch_split_g<TQ, T, 8>(q, k, v, lengths, out, b, hkv, g, d, s,
                                  splits, stream);
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
  return launch_paged<__nv_bfloat16, __nv_bfloat16>(
      q, k, v, nullptr, nullptr, lengths, tables, out, b, hq, hkv, d, ps,
      p_pool, p_max, stream);
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
  return launch_paged<__nv_bfloat16, int8_t>(q, k, v, k_scale, v_scale,
                                             lengths, tables, out, b, hq, hkv,
                                             d, ps, p_pool, p_max, stream);
}

// The same over fp32 pools; q and out are bf16 (q_f32 == 0) or fp32.
extern "C" int flash_decode_paged_f32(const void* q, const void* k,
                                      const void* v, const void* lengths,
                                      const void* tables, void* out, int b,
                                      int hq, int hkv, int d, int ps,
                                      int p_pool, int p_max, int q_f32,
                                      void* stream) {
  if (q_f32)
    return launch_paged<float, float>(q, k, v, nullptr, nullptr, lengths,
                                      tables, out, b, hq, hkv, d, ps, p_pool,
                                      p_max, stream);
  return launch_paged<__nv_bfloat16, float>(q, k, v, nullptr, nullptr,
                                            lengths, tables, out, b, hq, hkv,
                                            d, ps, p_pool, p_max, stream);
}

// out (B, Hq, D) = attention of q (B, Hq, D) over the contiguous cache k/v
// (B, S, Hkv, D), bf16 and contiguous; lengths (B,) int32; the sequence
// split over `splits` blocks of one cluster (1, 2, 4 or 8).  A row of
// length 0 returns the mean of its S values of V.
extern "C" int flash_decode_bf16(const void* q, const void* k, const void* v,
                                 const void* lengths, void* out, int b, int hq,
                                 int hkv, int d, int s, int splits,
                                 void* stream) {
  return launch_split<__nv_bfloat16, __nv_bfloat16>(
      q, k, v, lengths, out, b, hq, hkv, d, s, splits, stream);
}

// The same over an fp32 cache; q and out are bf16 (q_f32 == 0) or fp32.
extern "C" int flash_decode_f32(const void* q, const void* k, const void* v,
                                const void* lengths, void* out, int b, int hq,
                                int hkv, int d, int s, int splits, int q_f32,
                                void* stream) {
  if (q_f32)
    return launch_split<float, float>(q, k, v, lengths, out, b, hq, hkv, d, s,
                                      splits, stream);
  return launch_split<__nv_bfloat16, float>(q, k, v, lengths, out, b, hq, hkv,
                                            d, s, splits, stream);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
