// flash_decode: one-token GQA attention over a KV cache, with the
// online-softmax state (m, l, acc) kept on chip across the whole sequence
// and the output written once -- the APR pattern applied to attention.
// One kernel body, the sequence split over a thread-block cluster, with two
// loaders (a contiguous cache, paged pools), five entry points:
//
//   paged loader (B2, B2q)
//     flash_decode_paged_bf16  paged bf16 pools, bf16 or fp32 q
//     flash_decode_paged_int8  paged int8 pools + fp32 (P, ps, Hkv) scales,
//                              bf16 or fp32 q
//     flash_decode_paged_f32   paged fp32 pools, bf16 or fp32 q
//   contiguous loader (B3)
//     flash_decode_bf16        contiguous bf16 cache (B, S, Hkv, D), bf16
//                              or fp32 q
//     flash_decode_f32         contiguous fp32 cache, bf16 or fp32 q
//
// The output has the type of q, as the TPU kernels' out_shape does.  q is
// widened to fp32 as it is loaded, so an fp32 q over a bf16 or int8 cache
// runs the same body (the K/V loads and the walk do not change).
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
// the launch, not bandwidth, set its time: the design puts many blocks and
// many loads in flight.
//
// The split body:
//  * grid (splits, Hkv, B) (Hkv·parts for a group wider than 8, below),
//    cluster (splits, 1, 1), splits <= 8 (the portable cluster size); the
//    wrapper picks the split count from the geometry, the SM count and the
//    cache's bytes a value (the lengths live on the device), so that the
//    B·Hkv·splits blocks put about two on each SM (a block's walk is
//    latency-bound, so a second block on the SM streams alongside it), or,
//    for fp32 caches, whose 8-warp blocks fill an SM's registers, one on
//    every other SM.
//    Split s walks positions [s·range, (s+1)·range) of its row (range from
//    S, or from the table width P_max·ps), cut at the row's walk;
//  * inside a split, each warp owns TPW tokens of every 32-token step (8
//    for bf16 and int8 payloads, 4 for fp32) and keeps its own
//    online-softmax state (m, l, acc[G][4]) in registers: no block barrier
//    inside the walk.  Lane l holds dims 4l..4l+3, loaded as one 4-, 8- or
//    16-byte vector.  The next step's K and V are loaded into a second
//    register buffer before the current step is consumed, so each warp
//    keeps two steps of loads in flight;
//  * a score is a per-lane partial dot product; a step's G·TPW scores are
//    reduced together by one transposing butterfly of shuffles (G·TPW - 1
//    of them, not 5 per score), after which each lane holds the scores of
//    one group; the group's max and sum of weights are a few shuffles among
//    its lanes, each weight's exp is taken once, and the weights reach the
//    lanes that own the dims through 100-odd bytes of the warp's shared
//    memory between two __syncwarp;
//  * G is a template parameter (1, 2, 4, 8; a group of 3, 5, 6 or 7 runs
//    in the next one with the extra rows masked), so the register arrays
//    match the model.  A group wider than 8 (up to 16: starcoder2's 12,
//    chatglm3's 16) runs in parts of 8 query rows on the grid (WIDE): grid
//    (splits, Hkv·parts, B), block y = (kv head, part), part p holding rows
//    8p .. min(8p + 8, g) of the head's group in the G = 8 body.  So the
//    registers, the shared memory and the combine order stay those of
//    G = 8 (static arrays ~38 KB with 4 warps, and G = 16 in one block
//    would need ~64 KB of them for fp32 caches and spill its 128 scores a
//    step); the cost is that each part reads the head's K and V once, the
//    second read mostly from L2.  The G <= 8 instantiations (WIDE false)
//    compile to the code they did before;
//  * at the end the block's warps are combined in shared memory, in warp
//    order; then, after cluster.sync(), every block of the cluster combines
//    a slice of the (G, D) outputs, reading each split's (m, l, acc) from
//    that block's shared memory (distributed shared memory,
//    cluster.map_shared_rank): it rescales each by exp(m_s - M), adds them
//    in split order, divides by max(l, 1e-30) and writes the output once.
//    The partials never reach global memory, and the combine order is
//    fixed, so the same inputs give the same bits on every run.
//
// Each step's token is present (the position takes a weight exp(score -
// m)) or not (it is not read and weighs exactly 0), and scored (its score
// is q·k) or not (it scores -1e30).  The contiguous walk decides both from
// the position; the paged loader records which tokens it found live, and
// those are present and scored.
//
// Contiguous loader (B3), the semantics of _flash_decode_kernel: a row
// walks its first `length` positions, all scored; a row of length 0 walks
// all S positions, none scored, and returns the mean of V (every split's m
// is then -1e30, and exp(0) = 1 weighs each split by its count).  A split
// whose range lies past the walk keeps m = -1e30, l = 0 and adds nothing.
//
// Paged loader (B2, B2q), the semantics of _paged_decode_kernel: a row
// walks its first `length` positions (clamped to P_max·ps); logical
// position p lives in slot p % ps of page block_tables[row, p / ps].
//  * Before the walk the block stages its split's slice of the block-table
//    row in shared memory (dynamic, one int a page), so a step's loads need
//    no dependent global read.  A 32-token step may cross pages, so the page
//    is looked up per token, from a page and slot counter advanced token by
//    token (one division a step);
//  * a table entry outside [0, p_pool) is a dead lane: never read, weight
//    exactly 0, as are positions past the length.  A row of length 0 (or of
//    only dead lanes) keeps m = -1e30, l = 0 and acc = 0 in every split, so
//    the combine gives 0 / max(0, 1e-30) = 0: zeros, as the TPU paged
//    kernel returns them (it too weighs dead lanes where(live, exp, 0));
//  * int8 codes (4 a lane, one 32-bit load) are dequantized in fp32 as
//    they are consumed, code * scale with the fp32 scale of each (token,
//    head), each lane reading it alongside the codes: no bf16 rounding, as
//    the TPU kernel dequantizes in VMEM.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int MAX_G = 8, MAX_D = 128;          // a block's rows; D
constexpr int MAX_WIDE_G = 16;                 // a group, in parts of MAX_G
constexpr int STEP = 32;                       // tokens per block step
constexpr int MAX_SPLITS = 8;                  // the portable cluster size
constexpr int E = 4;                           // dims per lane (D <= 128)

__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float widen(float x) { return x; }

__device__ __forceinline__ void narrow(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
__device__ __forceinline__ void narrow(float* p, float x) { *p = x; }

// Per cache type: tokens per warp per step and the block's warps.
template <typename T>
struct Split {
  static constexpr int TPW = sizeof(T) == 4 ? 4 : 8;
  static constexpr int NW = STEP / TPW;        // 4 (bf16, int8), 8 (fp32)
  static constexpr int THREADS = NW * 32;
};

// E consecutive values of a K or V row as loaded: one 8-byte (bf16),
// 16-byte (fp32) or 4-byte (int8, with its scale) vector per lane, widened
// only when consumed.
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
template <>
struct Raw<int8_t> {
  unsigned r;                                  // four codes
  float s;                                     // their (token, head) scale
  __device__ __forceinline__ void unpack(float (&x)[E]) const {
#pragma unroll
    for (int e = 0; e < E; ++e)
      x[e] = __fmul_rn((float)(int8_t)((r >> (8 * e)) & 0xffu), s);
  }
  __device__ __forceinline__ void zero() {
    r = 0u;
    s = 0.0f;
  }
  template <bool VEC>
  __device__ __forceinline__ void load(const int8_t* p, int n) {
    if (VEC) {
      r = __ldg(reinterpret_cast<const unsigned*>(p));
    } else {
      unsigned v = 0u;
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (e < n) v |= (unsigned)(uint8_t)p[e] << (8 * e);
      r = v;
    }
  }
};

// One step of one warp: its TPW tokens' K and V as loaded, and (paged
// loader) which of them are live (bit j: token j).
template <typename T, int TPW>
struct Step {
  Raw<T> k[TPW], v[TPW];
  unsigned live;
};

// One warp's online-softmax state over its tokens.
template <int G>
struct WarpState {
  float m[G], l[G], acc[G][E];
};

// What a launch needs.  TQ: the type of q and of the output; T: the cache
// element type.
template <typename TQ, typename T>
struct Args {
  const TQ* q;                                 // (B, Hq, D)
  const T* k;                                  // (B, S, Hkv, D) contiguous,
  const T* v;                                  // or pools (P, ps, Hkv, D)
  const float* ks;                             // (P, ps, Hkv), int8 pools
  const float* vs;
  const int* lengths;                          // (B,)
  const int* tables;                           // (B, P_max), paged
  TQ* out;                                     // (B, Hq, D)
  int hkv, g, d;
  int s;                                       // S, or P_max * ps
  int range;                                   // positions per split
  int ps, p_pool, p_max;                       // paged
  float scale;
  int parts;                                   // WIDE: ceil(g / G)
};

// Contiguous loader: the TPW tokens at positions p.. (below hi) of the row
// whose position 0 is at kb/vb, stride elements apart.  Which are present
// and scored follows from the positions alone (consume_step).
template <typename T, bool VEC, int TPW>
__device__ __forceinline__ void load_contig(Step<T, TPW>& st, const T* kb,
                                            const T* vb, size_t stride,
                                            int p, int hi, int n) {
#pragma unroll
  for (int j = 0; j < TPW; ++j) {
    if (p + j < hi && n > 0) {
      st.k[j].template load<VEC>(kb + (size_t)(p + j) * stride, n);
      st.v[j].template load<VEC>(vb + (size_t)(p + j) * stride, n);
    } else {
      st.k[j].zero();
      st.v[j].zero();
    }
  }
}

// Paged loader: the TPW tokens at logical positions p.. (below hi) of kv
// head h, pages[i] holding the physical page of the row's logical page
// pg0 + i, or -1 for an entry outside the pool.  kb/vb point at the pools
// plus this lane's first dim.
template <typename T, bool VEC, int TPW>
__device__ __forceinline__ void load_paged(Step<T, TPW>& st, const T* kb,
                                           const T* vb, const float* ks,
                                           const float* vs,
                                           const int* pages, int pg0,
                                           int ps, int hkv, int h, int d,
                                           int p, int hi, int n) {
  int pg = p / ps - pg0, sl = p % ps;
  unsigned live = 0u;
#pragma unroll
  for (int j = 0; j < TPW; ++j) {
    const int page = p + j < hi ? pages[pg] : -1;
    if (page >= 0) {
      live |= 1u << j;
      const size_t row = ((size_t)page * ps + sl) * hkv + h;
      if (n > 0) {
        st.k[j].template load<VEC>(kb + row * d, n);
        st.v[j].template load<VEC>(vb + row * d, n);
      } else {
        st.k[j].zero();
        st.v[j].zero();
      }
      if constexpr (sizeof(T) == 1) {
        st.k[j].s = ks[row];
        st.v[j].s = vs[row];
      }
    } else {
      st.k[j].zero();
      st.v[j].zero();
    }
    if (++sl == ps) {
      sl = 0;
      ++pg;
    }
  }
  st.live = live;
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

// Fold one step's TPW tokens, at positions p.., into the warp's state: a
// present token takes the weight exp(score - m), with score q·k when it is
// scored and -1e30 otherwise; any other token weighs exactly 0.  PAGED:
// the live tokens (bit j of `live`) are present and scored; else those
// below hi are present and those below len scored.  The G·TPW scores
// are reduced by one butterfly (Fold), after which each lane holds CF
// scores of one group gi; the group's max and sum of weights are taken by
// shuffles among the lanes holding it, each weight's exp is taken once,
// and the weights and the rescale factors go through the warp's slice of
// shared memory (ps: V weights, then G rescales, maxima and sums) to every
// lane, which holds the dims its acc covers.
template <typename T, int G, int TPW, bool PAGED>
__device__ __forceinline__ void consume_step(WarpState<G>& st,
                                             const float (&qr)[G][E],
                                             const Step<T, TPW>& in, int p,
                                             int hi, int len, float* ps,
                                             int lane) {
  constexpr int V = G * TPW;
  constexpr int CF = V >= 32 ? V / 32 : 1, DUP = V >= 32 ? 1 : 32 / V;
  float sc[V];                                 // [gi][j]
#pragma unroll
  for (int j = 0; j < TPW; ++j) {
    float kx[E];
    in.k[j].unpack(kx);
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
  bool present[CF], scored[CF];
#pragma unroll
  for (int i = 0; i < CF; ++i) {
    if constexpr (PAGED) {
      present[i] = scored[i] = (in.live >> (j0 + i)) & 1u;
    } else {
      present[i] = p + j0 + i < hi;
      scored[i] = p + j0 + i < len;
    }
  }
  float sv[CF], mc = NEG_INF;
#pragma unroll
  for (int i = 0; i < CF; ++i) {
    sv[i] = scored[i] ? sc[i] : NEG_INF;
    if (present[i]) mc = fmaxf(mc, sv[i]);
  }
#pragma unroll
  for (int o = DUP; o < DUP * (TPW / CF); o <<= 1)
    mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, o));
  const float mn = fmaxf(mold, mc);
  float w[CF], psum = 0.0f;
#pragma unroll
  for (int i = 0; i < CF; ++i) {
    w[i] = present[i] ? expf(sv[i] - mn) : 0.0f;
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
    in.v[j].unpack(vx);
#pragma unroll
    for (int x = 0; x < G; ++x) {
      const float wj = ps[x * TPW + j];
#pragma unroll
      for (int e = 0; e < E; ++e) st.acc[x][e] += wj * vx[e];
    }
  }
}

// G: the group size the arrays hold (g <= G, or, WIDE, the rows of a part);
// VEC: D % 4 == 0 and 16-byte aligned caches, so a lane's 4 values are one
// vector load; PAGED: the paged loader (its block-table slice in dynamic
// shared memory); WIDE: a group of g > G split into a.parts parts of G rows
// on grid y (the last part holds the remainder).
template <typename TQ, typename T, int G, bool VEC, bool PAGED, bool WIDE>
__global__ void __launch_bounds__(Split<T>::THREADS)
    split_kernel(const Args<TQ, T> a) {
  constexpr int TPW = Split<T>::TPW, NW = Split<T>::NW;
  constexpr int THREADS_ = Split<T>::THREADS;
  __shared__ float ps_s[NW][G * TPW + 3 * G];  // each warp's step weights
  __shared__ float wm_s[NW][G], wl_s[NW][G];
  __shared__ __align__(16) float wacc_s[NW][G][MAX_D];
  // this split's combined state, read by the cluster's blocks
  __shared__ float pm_s[G], pl_s[G];
  __shared__ __align__(16) float pacc_s[G][MAX_D];
  extern __shared__ int pages_s[];             // paged: the table slice

  const int split = blockIdx.x, b = blockIdx.z;
  // the kv head, and (WIDE) the first of this part's query rows
  const int h = WIDE ? (int)blockIdx.y / a.parts : (int)blockIdx.y;
  const int r0 = WIDE ? (int)blockIdx.y % a.parts * G : 0;
  const int nsplit = gridDim.x;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int d = a.d, g = WIDE ? min(G, a.g - r0) : a.g;
  const size_t q_base = WIDE ? (((size_t)b * a.hkv + h) * a.g + r0) * d
                             : ((size_t)b * a.hkv + h) * g * d;
  const int d0 = lane * E;                     // this lane's first dim
  const int n = min(E, d - d0);                // its dims inside D

  float qr[G][E];
#pragma unroll
  for (int gi = 0; gi < G; ++gi)
#pragma unroll
    for (int e = 0; e < E; ++e)
      qr[gi][e] = (gi < g && e < n)
                      ? widen(a.q[q_base + (size_t)gi * d + d0 + e]) * a.scale
                      : 0.0f;
  const int len = max(0, min(a.lengths[b], a.s));
  const int walk = PAGED || len > 0 ? len : a.s;  // contiguous: all S if 0
  const int lo = split * a.range, hi = min(lo + a.range, walk);

  // the loaders' row bases: the contiguous row, or the pools
  const size_t row0 = PAGED ? 0 : (size_t)b * a.s * a.hkv + h;
  const T* kb = a.k + row0 * d + (n > 0 ? d0 : 0);
  const T* vb = a.v + row0 * d + (n > 0 ? d0 : 0);
  int pg0 = 0;
  if constexpr (PAGED) {
    pg0 = lo / a.ps;
    const int npg = lo < hi ? (hi - 1) / a.ps - pg0 + 1 : 0;
    for (int i = tid; i < npg; i += THREADS_) {
      const int page = a.tables[(size_t)b * a.p_max + pg0 + i];
      pages_s[i] = page >= 0 && page < a.p_pool ? page : -1;
    }
    __syncthreads();
  }

  WarpState<G> st;
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    st.m[gi] = NEG_INF;
    st.l[gi] = 0.0f;
#pragma unroll
    for (int e = 0; e < E; ++e) st.acc[gi][e] = 0.0f;
  }

  // this warp's tokens: TPW of every STEP, two steps' loads in flight
  auto load = [&](Step<T, TPW>& s, int p) {
    if constexpr (PAGED)
      load_paged<T, VEC, TPW>(s, kb, vb, a.ks, a.vs, pages_s, pg0, a.ps,
                              a.hkv, h, d, p, hi, n);
    else
      load_contig<T, VEC, TPW>(s, kb, vb, (size_t)a.hkv * d, p, hi, n);
  };
  Step<T, TPW> sa, sb;
  int p = lo + warp * TPW;
  if (p < hi) load(sa, p);
  while (p < hi) {
    const int p1 = p + STEP;
    if (p1 < hi) load(sb, p1);
    consume_step<T, G, TPW, PAGED>(st, qr, sa, p, hi, len, ps_s[warp], lane);
    if (p1 >= hi) break;
    const int p2 = p1 + STEP;
    if (p2 < hi) load(sa, p2);
    consume_step<T, G, TPW, PAGED>(st, qr, sb, p1, hi, len, ps_s[warp],
                                   lane);
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
      narrow(a.out + q_base + idx, asum / fmaxf(lsum, 1e-30f));
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
    narrow(a.out + q_base + idx, asum / fmaxf(lsum, 1e-30f));
  }
  cluster.sync();                              // keep the states until read
}

template <typename TQ, typename T, int G, bool PAGED, bool WIDE>
int launch_g(const Args<TQ, T>& a, int b, int splits, cudaStream_t stream) {
  const bool vec = a.d % E == 0 &&
                   reinterpret_cast<uintptr_t>(a.k) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(a.v) % 16 == 0;
  void (*kernel)(const Args<TQ, T>) =
      vec ? split_kernel<TQ, T, G, true, PAGED, WIDE>
          : split_kernel<TQ, T, G, false, PAGED, WIDE>;
  // the paged table slice: the pages a split's range may touch.  The static
  // arrays take at most ~38 KB (G = 8, the widest a block holds: a wider
  // group runs in parts of 8), so up to 8 KB more fits the default 48 KB
  const int dynamic =
      PAGED ? (int)sizeof(int) * ((a.range + a.ps - 1) / a.ps + 1) : 0;
  if (dynamic > 8 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dynamic);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, a.hkv * (WIDE ? a.parts : 1), b);
  cfg.blockDim = dim3(Split<T>::THREADS);
  cfg.dynamicSmemBytes = dynamic;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Check the geometry, set g, range and the score scale, and launch at the
// compiled G that holds g, or a group wider than MAX_G in parts of MAX_G.
template <typename TQ, typename T, bool PAGED>
int launch(Args<TQ, T> a, int b, int hq, int splits, void* stream) {
  if (b <= 0 || a.hkv <= 0 || hq % a.hkv != 0 || hq / a.hkv > MAX_WIDE_G ||
      a.d <= 0 || a.d > MAX_D || a.s <= 0 || b > 65535 || a.hkv > 65535 ||
      (splits != 1 && splits != 2 && splits != 4 && splits != 8))
    return (int)cudaErrorInvalidValue;
  a.g = hq / a.hkv;
  a.parts = (a.g + MAX_G - 1) / MAX_G;
  if (a.hkv * a.parts > 65535) return (int)cudaErrorInvalidValue;
  // split ranges: whole steps, the last split cut at S
  const int steps = (a.s + STEP - 1) / STEP;
  a.range = (steps + splits - 1) / splits * STEP;
  a.scale = 1.0f / sqrtf((float)a.d);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.g == 1) return launch_g<TQ, T, 1, PAGED, false>(a, b, splits, s);
  if (a.g == 2) return launch_g<TQ, T, 2, PAGED, false>(a, b, splits, s);
  if (a.g <= 4) return launch_g<TQ, T, 4, PAGED, false>(a, b, splits, s);
  if (a.g <= MAX_G) return launch_g<TQ, T, 8, PAGED, false>(a, b, splits, s);
  return launch_g<TQ, T, MAX_G, PAGED, true>(a, b, splits, s);
}

template <typename TQ, typename T>
int launch_paged(const void* q, const void* k, const void* v, const void* ks,
                 const void* vs, const void* lengths, const void* tables,
                 void* out, int b, int hq, int hkv, int d, int ps, int p_pool,
                 int p_max, int splits, void* stream) {
  if (ps <= 0 || p_max <= 0 || p_pool < 0) return (int)cudaErrorInvalidValue;
  Args<TQ, T> a = {};
  a.q = static_cast<const TQ*>(q);
  a.k = static_cast<const T*>(k);
  a.v = static_cast<const T*>(v);
  a.ks = static_cast<const float*>(ks);
  a.vs = static_cast<const float*>(vs);
  a.lengths = static_cast<const int*>(lengths);
  a.tables = static_cast<const int*>(tables);
  a.out = static_cast<TQ*>(out);
  a.hkv = hkv;
  a.d = d;
  a.s = p_max * ps;
  a.ps = ps;
  a.p_pool = p_pool;
  a.p_max = p_max;
  return launch<TQ, T, true>(a, b, hq, splits, stream);
}

template <typename TQ, typename T>
int launch_contig(const void* q, const void* k, const void* v,
                  const void* lengths, void* out, int b, int hq, int hkv,
                  int d, int s, int splits, void* stream) {
  Args<TQ, T> a = {};
  a.q = static_cast<const TQ*>(q);
  a.k = static_cast<const T*>(k);
  a.v = static_cast<const T*>(v);
  a.lengths = static_cast<const int*>(lengths);
  a.out = static_cast<TQ*>(out);
  a.hkv = hkv;
  a.d = d;
  a.s = s;
  return launch<TQ, T, false>(a, b, hq, splits, stream);
}

}  // namespace

// out (B, Hq, D) = attention of q (B, Hq, D) over the paged pools k/v
// (P, ps, Hkv, D), bf16 and contiguous; q and out bf16 (q_f32 == 0) or
// fp32; lengths (B,) and block tables (B, P_max) int32; each row's walk
// split over `splits` blocks of one cluster (1, 2, 4 or 8).  Hq / Hkv <= 16
// and D <= 128.  A row of length 0 returns zeros.  Launches on `stream`
// and returns cudaGetLastError().
extern "C" int flash_decode_paged_bf16(const void* q, const void* k,
                                       const void* v, const void* lengths,
                                       const void* tables, void* out, int b,
                                       int hq, int hkv, int d, int ps,
                                       int p_pool, int p_max, int q_f32,
                                       int splits, void* stream) {
  if (q_f32)
    return launch_paged<float, __nv_bfloat16>(
        q, k, v, nullptr, nullptr, lengths, tables, out, b, hq, hkv, d, ps,
        p_pool, p_max, splits, stream);
  return launch_paged<__nv_bfloat16, __nv_bfloat16>(
      q, k, v, nullptr, nullptr, lengths, tables, out, b, hq, hkv, d, ps,
      p_pool, p_max, splits, stream);
}

// The same over int8 pools k/v with fp32 scale pools k_scale/v_scale
// (P, ps, Hkv): value = code * scale of its (page slot, head).
extern "C" int flash_decode_paged_int8(const void* q, const void* k,
                                       const void* v, const void* k_scale,
                                       const void* v_scale,
                                       const void* lengths,
                                       const void* tables, void* out, int b,
                                       int hq, int hkv, int d, int ps,
                                       int p_pool, int p_max, int q_f32,
                                       int splits, void* stream) {
  if (q_f32)
    return launch_paged<float, int8_t>(q, k, v, k_scale, v_scale, lengths,
                                       tables, out, b, hq, hkv, d, ps,
                                       p_pool, p_max, splits, stream);
  return launch_paged<__nv_bfloat16, int8_t>(
      q, k, v, k_scale, v_scale, lengths, tables, out, b, hq, hkv, d, ps,
      p_pool, p_max, splits, stream);
}

// The same over fp32 pools; q and out are bf16 (q_f32 == 0) or fp32.
extern "C" int flash_decode_paged_f32(const void* q, const void* k,
                                      const void* v, const void* lengths,
                                      const void* tables, void* out, int b,
                                      int hq, int hkv, int d, int ps,
                                      int p_pool, int p_max, int q_f32,
                                      int splits, void* stream) {
  if (q_f32)
    return launch_paged<float, float>(q, k, v, nullptr, nullptr, lengths,
                                      tables, out, b, hq, hkv, d, ps, p_pool,
                                      p_max, splits, stream);
  return launch_paged<__nv_bfloat16, float>(q, k, v, nullptr, nullptr,
                                            lengths, tables, out, b, hq, hkv,
                                            d, ps, p_pool, p_max, splits,
                                            stream);
}

// out (B, Hq, D) = attention of q (B, Hq, D) over the contiguous cache k/v
// (B, S, Hkv, D), bf16 and contiguous; q and out bf16 (q_f32 == 0) or
// fp32; lengths (B,) int32; the sequence split over `splits` blocks of one
// cluster (1, 2, 4 or 8); Hq / Hkv <= 16 and D <= 128.  A row of length 0
// returns the mean of its S values of V.
extern "C" int flash_decode_bf16(const void* q, const void* k, const void* v,
                                 const void* lengths, void* out, int b, int hq,
                                 int hkv, int d, int s, int splits, int q_f32,
                                 void* stream) {
  if (q_f32)
    return launch_contig<float, __nv_bfloat16>(q, k, v, lengths, out, b, hq,
                                               hkv, d, s, splits, stream);
  return launch_contig<__nv_bfloat16, __nv_bfloat16>(
      q, k, v, lengths, out, b, hq, hkv, d, s, splits, stream);
}

// The same over an fp32 cache; q and out are bf16 (q_f32 == 0) or fp32.
extern "C" int flash_decode_f32(const void* q, const void* k, const void* v,
                                const void* lengths, void* out, int b, int hq,
                                int hkv, int d, int s, int splits, int q_f32,
                                void* stream) {
  if (q_f32)
    return launch_contig<float, float>(q, k, v, lengths, out, b, hq, hkv, d,
                                       s, splits, stream);
  return launch_contig<__nv_bfloat16, float>(q, k, v, lengths, out, b, hq,
                                             hkv, d, s, splits, stream);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
