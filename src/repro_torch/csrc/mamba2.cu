// mamba2_ssd: the Mamba-2 SSD recurrence with the (P, N) state kept in
// registers across the whole time loop and written once -- the APR pattern
// applied to a decaying accumulator.  Per (batch row, head), scalar decay:
//
//   h  <- exp(a · dt_t) h + dt_t x_t b_t^T          h: (P, N)
//   y_t = h c_t + d · x_t
//
// extended by an optional initial state in (h_init, fp32 (B, H, P, N)) and
// final state out (h_out), which the serving path needs; with neither it
// is exactly the TPU kernel (state starts at zero, none comes out).
//
// Replaces: src/repro/kernels/mamba2/kernel.py::mamba2_call (kernel body
// _mamba2_kernel).
//
// What bounds it on an H100: the function needs 5 fp32 operations per
// state element per step (upd = (dt x_p) b_n, with dt x_p formed once per
// row; h = exp(a dt) h + upd; y_p += h c_n); this kernel issues 4
// instructions an element, forming dt (x_p b_n) per element as the plain
// version does.  Against P values in and P out per head per step (b and c
// are shared by the heads), that is far above the fp32 ridge, so over a
// long prompt the issue rate bounds it.  At a decode step (T = 1) the state
// (32 KB per head at P = 64, N = 128), read and written once, is nearly
// all the bytes.
//
// Design:
//  * rows of h are independent (row p needs x_p, dt and all of b and c),
//    so the H·P rows of a batch row are cut into tiles of `rows`, one
//    block each, a tile free to span heads -- a B = 1, T = 1024 call at
//    rows = 40 is 128 blocks, about one an SM, not 80;
//  * LPR (4, 8 or 16) lanes share a row; a lane owns RT rows (1 at LPR 4
//    and 8, 2 at 16), so a thread holds 32 (LPR 4) or 16 state values at
//    N = 128 in registers, and a warp's 4 or 8 rows lie in one head.  Lane
//    q of a row owns the 16-byte vectors v = j·LPR + q (columns
//    4v .. 4v+3): each warp instruction that loads or stores h reads whole
//    runs of LPR·16 contiguous bytes of a row, and RT rows share every b
//    and c vector a lane loads;
//  * y_p is one fixed tree per row over the 32 vectors of N = 128 (a
//    shorter N pads with zeros): each vector's four products as a chain,
//    then pairs over the vector index from its highest bit down, the
//    in-lane bits (j) before the lane bits (q).  Every configuration and
//    both paths below sum in this order, so a row's bits do not depend on
//    the batch, the tile, the lanes, the staging depth or how T is split;
//  * y leaves the per-step chain: the state update of RUN = 8 steps runs
//    first, then the 8·RT partial sums of a lane are reduced over the row's
//    lanes together (scan::reduce_slots, ~8·RT shuffles for 8 steps);
//  * T > 1: x, b, c and dt of `chunk` steps are staged by cp.async into a
//    double buffer, the next round's copies in flight while the block
//    walks the current one; bf16 rows are widened once into fp32 buffers
//    and exp(a dt) is formed once per step and head; T = 1 (the decode
//    tick) skips the staging and reads its few values straight from memory;
//  * N = 128 (every published Mamba-2 width) runs a body whose state
//    vectors are all live: no clamp of the vector index and no select of
//    a row's partial (4 % of a 1024-token prefill); shorter N runs the
//    guarded one, and both sum in the same order;
//  * per element the update is the plain version's, in its order, with
//    every rounding explicit (no contraction left to the compiler):
//    h = fma(exp(a dt), h, dt · (x_p · b_n)); y = fma(d, x_p, tree).
//    That is 4 fp32 instructions an element where the bound counts 5
//    operations (an FMA as 2), so the issue rate, not the operation
//    rate, is this kernel's ceiling over a long prompt.
#include <type_traits>

#include "scan.cuh"

namespace {

using scan::widen;

constexpr int MAX_P = 64, MAX_N = 128, VECS = MAX_N / 4;
constexpr int RUN = 8;             // steps whose y sums are reduced together
constexpr int MAX_ROWS = 64;
// rows a lane owns (RT) and rows a warp owns (RPW) for LPR lanes a row:
// 32 state values a thread at LPR = 4, 16 at LPR = 8 and 16
__host__ __device__ constexpr int rows_per_lane(int lpr) {
  return lpr >= 16 ? lpr / 8 : 1;
}
__host__ __device__ constexpr int rows_per_warp(int lpr) {
  return 32 / lpr * rows_per_lane(lpr);
}
// heads a tile of rows may touch: MAX_ROWS rows of heads of 16 or more
constexpr int MAX_HEADS = MAX_ROWS / 16 + 1;
constexpr int MAX_SMEM = 232448;   // an H100 block's dynamic shared memory

__device__ __forceinline__ float decay_of(float a, float dt) {
  return expf(__fmul_rn(a, dt));
}

// One step of a lane's RT rows over its VPL vectors: the state update, and
// each row's partial y over the lane's vectors (in-lane part of the tree).
// Vectors past N (v >= nv) are updated from a live vector's b and c, which
// keeps the step free of branches; their state is never stored and their
// partial is taken as zero.  FULL: N = MAX_N, every vector live.
template <int RT, int VPL, int LPR, bool FULL>
__device__ __forceinline__ void ssd_step(float4 (&hs)[RT][VPL],
                                         const float4 (&bv)[VPL],
                                         const float4 (&cv)[VPL],
                                         const float (&xp)[RT], float dtt,
                                         float dec, int q, int nv,
                                         float* part) {
  float pv[RT][VPL];
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const bool live = FULL || j * LPR + q < nv;
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      float4& h = hs[r][j];
      h.x = __fmaf_rn(dec, h.x, __fmul_rn(dtt, __fmul_rn(xp[r], bv[j].x)));
      h.y = __fmaf_rn(dec, h.y, __fmul_rn(dtt, __fmul_rn(xp[r], bv[j].y)));
      h.z = __fmaf_rn(dec, h.z, __fmul_rn(dtt, __fmul_rn(xp[r], bv[j].z)));
      h.w = __fmaf_rn(dec, h.w, __fmul_rn(dtt, __fmul_rn(xp[r], bv[j].w)));
      float acc = __fmul_rn(h.x, cv[j].x);
      acc = __fmaf_rn(h.y, cv[j].y, acc);
      acc = __fmaf_rn(h.z, cv[j].z, acc);
      acc = __fmaf_rn(h.w, cv[j].w, acc);
      pv[r][j] = live ? acc : 0.f;
    }
  }
#pragma unroll
  for (int r = 0; r < RT; ++r) {
#pragma unroll
    for (int m = VPL / 2; m >= 1; m /= 2) {
#pragma unroll
      for (int j = 0; j < m; ++j) pv[r][j] = __fadd_rn(pv[r][j], pv[r][j + m]);
    }
    part[r] = pv[r][0];
  }
}

// RT consecutive fp32 values from shared memory, 4·RT-byte aligned.
template <int RT>
__device__ __forceinline__ void load_rows(float (&xp)[RT], const float* p) {
  if constexpr (RT == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    xp[0] = v.x;
    xp[1] = v.y;
    xp[2] = v.z;
    xp[3] = v.w;
  } else if constexpr (RT == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    xp[0] = v.x;
    xp[1] = v.y;
  } else {
    xp[0] = p[0];
  }
}

template <typename T>
__device__ __forceinline__ float4 load4(const T* p) {
  return make_float4(widen(p[0]), widen(p[1]), widen(p[2]), widen(p[3]));
}

// Shared-memory layout of the staged path for `ch` steps: the fp32 rows the
// steps read (bf16 streams only; fp32 ones are read where they land), the
// decay of each step and head, then two raw buffers of b, c, x (in T) and
// dt.  Rows of b and c are MAX_N values apart whatever N is, and a step's
// dt and decay MAX_HEADS, so the step loop's addresses are constant
// offsets.
struct Layout {
  int wide, dec, raw, total;
  __host__ __device__ Layout(int ch, int rows, int es) {
    wide = es == 4 ? 0 : ch * (2 * MAX_N + rows) * 4;
    dec = ch * MAX_HEADS * 4;
    raw = ch * (2 * MAX_N + rows) * es + ch * MAX_HEADS * 4;
    total = wide + dec + 2 * raw;
  }
};

// T: the element type of x, b, c and y (bf16 or fp32); dt, a, d are fp32.
// Strides are in elements; x's last axis, b's and c's last axis, dt
// (B, T, H) and y (B, T, H, P) are contiguous.  The H·P rows of a batch
// row are cut into tiles of `rows` (a multiple of 8 that divides H·P);
// block blockIdx.x = b·(H·P / rows) + tile owns rows [tile·rows,
// tile·rows + rows) of batch row b, flattened as h·P + p, and its rows / 8
// warps own 8 rows each -- all of one head, since 8 divides P.  FULL: the
// body for N = MAX_N, whose vectors are all live (no clamp, no guard).
template <typename T, int LPR, bool FULL>
__global__ void __launch_bounds__(MAX_ROWS / rows_per_warp(LPR) * 32)
    ssd_kernel(
    const T* __restrict__ x,        // (B, T, H, P)
    const T* __restrict__ bm,       // (B, T, N)
    const T* __restrict__ cm,       // (B, T, N)
    const float* __restrict__ dt,   // (B, T, H)
    const float* __restrict__ a,    // (H,) negative
    const float* __restrict__ dskip,  // (H,)
    const float* h_init,            // (B, H, P, N) or null (zeros)
    float* h_out,                   // (B, H, P, N) or null; may be h_init
    T* __restrict__ y,              // (B, T, H, P)
    int tlen, int nh, int np, int nn, int rows, int ch, long long x_sb,
    long long x_st, long long x_sh, long long b_sb, long long b_st,
    long long c_sb, long long c_st) {
  constexpr int RT = rows_per_lane(LPR), RPW = rows_per_warp(LPR);
  constexpr int VPL = VECS / LPR, K = RUN * RT;
  const int tiles = nh * np / rows;
  const int tile = blockIdx.x % tiles, b = blockIdx.x / tiles;
  const int lane = threadIdx.x % 32, q = lane % LPR;
  const int lrow = threadIdx.x / 32 * RPW + lane / LPR * RT;
  const int g0 = tile * rows, g = g0 + lrow;     // first row: block, lane
  const int h = g / np, p = g % np;              // the lane's head and row
  const int hb0 = g0 / np, hh = h - hb0;         // heads from the block's
  const int nhb = (g0 + rows - 1) / np - hb0 + 1;
  const int nv = nn / 4;
  const size_t sbase = ((size_t)b * nh * np + g) * nn;
  float4 hs[RT][VPL];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      const int vi = j * LPR + q;
      hs[r][j] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (h_init && (FULL || vi < nv)) {
        hs[r][j] = *reinterpret_cast<const float4*>(h_init + sbase +
                                                    (size_t)r * nn + 4 * vi);
      }
    }
  }
  const float ah = a[h], dh = dskip[h];
  const T* xb = x + b * x_sb;
  const T* bb = bm + b * b_sb;
  const T* cb = cm + b * c_sb;
  const float* dtb = dt + (size_t)b * tlen * nh;          // step stride nh
  T* yb = y + (size_t)b * tlen * nh * np + g;             // step nh·np
  const size_t ystep = (size_t)nh * np;
  bool owner;

  if (tlen == 1) {
    float xp[RT], part[RT];
    float4 bv[VPL], cv[VPL];
    const T* xr = xb + h * x_sh + p;
#pragma unroll
    for (int r = 0; r < RT; ++r) xp[r] = widen(xr[r]);
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      const int vi = FULL ? j * LPR + q : min(j * LPR + q, nv - 1);
      bv[j] = load4(bb + 4 * vi);
      cv[j] = load4(cb + 4 * vi);
    }
    const float dtt = dtb[h];
    ssd_step<RT, VPL, LPR, FULL>(hs, bv, cv, xp, dtt, decay_of(ah, dtt), q,
                                 nv, part);
    const int slot = scan::reduce_slots<RT, LPR, 1, true>(part, lane, owner);
    if (owner) {
      scan::store(yb + slot, __fmaf_rn(dh, widen(xr[slot]), part[0]));
    }
  } else if (tlen > 1) {
    extern __shared__ __align__(16) unsigned char smem[];
    constexpr int ES = sizeof(T);
    const Layout lay(ch, rows, ES);
    float* wide = reinterpret_cast<float*>(smem);
    float* sdec = reinterpret_cast<float*>(smem + lay.wide);
    unsigned char* raw = smem + lay.wide + lay.dec;
    const int wb = scan::copy_width(bb, b_st * ES, nn * ES);
    const int wc = scan::copy_width(cb, c_st * ES, nn * ES);
    auto raw_b = [&](int buf) {
      return reinterpret_cast<T*>(raw + buf * lay.raw);
    };
    auto issue = [&](int c0, int buf) {
      const int n = min(ch, tlen - c0);
      T* rb = raw_b(buf);
      T* rc = rb + ch * MAX_N;
      T* rx = rc + ch * MAX_N;
      float* rdt = reinterpret_cast<float*>(rx + ch * rows);
      scan::stage(rb, MAX_N * ES, bb + c0 * b_st, b_st * ES, nn * ES, n, wb);
      scan::stage(rc, MAX_N * ES, cb + c0 * c_st, c_st * ES, nn * ES, n, wc);
      for (int k = 0; k < nhb; ++k) {    // x: each head's run of rows
        const int lo = max(g0, (hb0 + k) * np);
        const int hi = min(g0 + rows, (hb0 + k + 1) * np);
        const T* src = xb + c0 * x_st + (hb0 + k) * x_sh + lo % np;
        scan::stage(rx + (lo - g0), rows * ES, src, x_st * ES, (hi - lo) * ES,
                    n, scan::copy_width(src, x_st * ES, (hi - lo) * ES));
      }
      scan::stage(rdt, MAX_HEADS * 4, dtb + (size_t)c0 * nh + hb0,
                  (long long)nh * 4, nhb * 4, n, 4);
      scan::cp_commit();
    };
    issue(0, 0);
    for (int c0 = 0, k = 0; c0 < tlen; c0 += ch, ++k) {
      const int n = min(ch, tlen - c0);
      scan::cp_wait_all();
      __syncthreads();   // round k landed; round k - 1's reads are done,
                         // so its buffer takes round k + 1 while k runs
      if (c0 + ch < tlen) issue(c0 + ch, (k + 1) & 1);
      const T* rb = raw_b(k & 1);
      const T* rc = rb + ch * MAX_N;
      const T* rx = rc + ch * MAX_N;
      const float* rdt = reinterpret_cast<const float*>(rx + ch * rows);
      const float *fb, *fc, *fx;
      if constexpr (ES == 4) {
        fb = reinterpret_cast<const float*>(rb);
        fc = reinterpret_cast<const float*>(rc);
        fx = reinterpret_cast<const float*>(rx);
      } else {
        float* wx_ = wide + 2 * ch * MAX_N;
        scan::widen_rows(wide, rb, n * MAX_N);
        scan::widen_rows(wide + ch * MAX_N, rc, n * MAX_N);
        scan::widen_rows(wx_, rx, n * rows);
        fb = wide;
        fc = wide + ch * MAX_N;
        fx = wx_;
      }
      for (int e = threadIdx.x; e < n * nhb; e += blockDim.x) {
        const int tt = e / nhb, k2 = e - tt * nhb;
        sdec[tt * MAX_HEADS + k2] =
            decay_of(a[hb0 + k2], rdt[tt * MAX_HEADS + k2]);
      }
      __syncthreads();
      // RUN steps, their y sums reduced together; full runs carry no
      // per-step guard, so the compiler may overlap one step's loads with
      // the previous step's arithmetic
      auto run = [&](int s0, auto tail) {
        constexpr bool TAIL = decltype(tail)::value;
        float part[K];
#pragma unroll
        for (int s = 0; s < RUN; ++s) {
          const int tt = s0 + s;
          if (!TAIL || tt < n) {
            float xp[RT];
            float4 bv[VPL], cv[VPL];
            load_rows<RT>(xp, fx + tt * rows + lrow);
            const float4* b4 =
                reinterpret_cast<const float4*>(fb + tt * MAX_N);
            const float4* c4 =
                reinterpret_cast<const float4*>(fc + tt * MAX_N);
#pragma unroll
            for (int j = 0; j < VPL; ++j) {
              const int vi = FULL ? j * LPR + q : min(j * LPR + q, nv - 1);
              bv[j] = b4[vi];
              cv[j] = c4[vi];
            }
            ssd_step<RT, VPL, LPR, FULL>(hs, bv, cv, xp,
                                         rdt[tt * MAX_HEADS + hh],
                                         sdec[tt * MAX_HEADS + hh], q, nv,
                                         part + s * RT);
          } else {
#pragma unroll
            for (int r = 0; r < RT; ++r) part[s * RT + r] = 0.f;
          }
        }
        const int base = scan::reduce_slots<K, LPR, 1, true>(part, lane,
                                                             owner);
#pragma unroll
        for (int i = 0; i < (K >= LPR ? K / LPR : 1); ++i) {
          const int slot = base + i, tt = s0 + slot / RT, r = slot % RT;
          if (owner && (!TAIL || tt < n)) {
            scan::store(yb + (size_t)(c0 + tt) * ystep + r,
                        __fmaf_rn(dh, fx[tt * rows + lrow + r], part[i]));
          }
        }
      };
      int s0 = 0;
      for (; s0 + RUN <= n; s0 += RUN) run(s0, std::false_type{});
      if (s0 < n) run(s0, std::true_type{});
    }
  }
  if (h_out) {
#pragma unroll
    for (int r = 0; r < RT; ++r) {
#pragma unroll
      for (int j = 0; j < VPL; ++j) {
        const int vi = j * LPR + q;
        if (FULL || vi < nv) {
          *reinterpret_cast<float4*>(h_out + sbase + (size_t)r * nn +
                                     4 * vi) = hs[r][j];
        }
      }
    }
  }
}

template <typename T, int LPR, bool FULL>
int launch_body(const void* x, const void* bm, const void* cm,
                const void* dt, const void* a, const void* d,
                const void* h_init, void* h_out, void* y, int b, int t,
                int h, int p, int n, int rows, int ch, long long x_sb,
                long long x_st, long long x_sh, long long b_sb,
                long long b_st, long long c_sb, long long c_st,
                cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      ssd_kernel<T, LPR, FULL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      MAX_SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int smem = t > 1 ? Layout(ch, rows, sizeof(T)).total : 0;
  if (smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  ssd_kernel<T, LPR, FULL>
      <<<b * (h * p / rows), rows / rows_per_warp(LPR) * 32, smem, stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(bm),
          static_cast<const T*>(cm), static_cast<const float*>(dt),
          static_cast<const float*>(a), static_cast<const float*>(d),
          static_cast<const float*>(h_init), static_cast<float*>(h_out),
          static_cast<T*>(y), t, h, p, n, rows, ch, x_sb, x_st, x_sh, b_sb,
          b_st, c_sb, c_st);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int LPR>
int launch_lanes(const void* x, const void* bm, const void* cm,
                 const void* dt, const void* a, const void* d,
                 const void* h_init, void* h_out, void* y, int b, int t,
                 int h, int p, int n, int rows, int ch, long long x_sb,
                 long long x_st, long long x_sh, long long b_sb,
                 long long b_st, long long c_sb, long long c_st,
                 cudaStream_t stream) {
  if (n == MAX_N) {
    return launch_body<T, LPR, true>(x, bm, cm, dt, a, d, h_init, h_out, y,
                                     b, t, h, p, n, rows, ch, x_sb, x_st,
                                     x_sh, b_sb, b_st, c_sb, c_st, stream);
  }
  return launch_body<T, LPR, false>(x, bm, cm, dt, a, d, h_init, h_out, y, b,
                                    t, h, p, n, rows, ch, x_sb, x_st, x_sh,
                                    b_sb, b_st, c_sb, c_st, stream);
}

template <typename T>
int launch(const void* x, const void* bm, const void* cm, const void* dt,
           const void* a, const void* d, const void* h_init, void* h_out,
           void* y, int b, int t, int h, int p, int n, int rows, int lanes,
           int ch, long long x_sb, long long x_st, long long x_sh,
           long long b_sb, long long b_st, long long c_sb, long long c_st,
           void* stream) {
  if (p % 16 != 0 || p < 16 || p > MAX_P || n % 16 != 0 || n < 16 ||
      n > MAX_N || rows % 8 != 0 || rows > MAX_ROWS ||
      (h * p) % rows != 0 || ch < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b * h == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
#define REPRO_SSD_LANES(L)                                                   \
  case L:                                                                    \
    return launch_lanes<T, L>(x, bm, cm, dt, a, d, h_init, h_out, y, b, t, h, \
                              p, n, rows, ch, x_sb, x_st, x_sh, b_sb, b_st,  \
                              c_sb, c_st, s);
  switch (lanes) {
    REPRO_SSD_LANES(4)
    REPRO_SSD_LANES(8)
    REPRO_SSD_LANES(16)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_SSD_LANES
}

}  // namespace

extern "C" int mamba2_ssd_bf16(const void* x, const void* bm, const void* cm,
                               const void* dt, const void* a, const void* d,
                               const void* h_init, void* h_out, void* y,
                               int b, int t, int h, int p, int n, int rows,
                               int lanes, int chunk, long long x_sb,
                               long long x_st, long long x_sh, long long b_sb,
                               long long b_st, long long c_sb, long long c_st,
                               void* stream) {
  return launch<__nv_bfloat16>(x, bm, cm, dt, a, d, h_init, h_out, y, b, t,
                               h, p, n, rows, lanes, chunk, x_sb, x_st, x_sh,
                               b_sb, b_st, c_sb, c_st, stream);
}

extern "C" int mamba2_ssd_f32(const void* x, const void* bm, const void* cm,
                              const void* dt, const void* a, const void* d,
                              const void* h_init, void* h_out, void* y, int b,
                              int t, int h, int p, int n, int rows, int lanes,
                              int chunk, long long x_sb, long long x_st,
                              long long x_sh, long long b_sb, long long b_st,
                              long long c_sb, long long c_st, void* stream) {
  return launch<float>(x, bm, cm, dt, a, d, h_init, h_out, y, b, t, h, p, n,
                       rows, lanes, chunk, x_sb, x_st, x_sh, b_sb, b_st, c_sb,
                       c_st, stream);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
