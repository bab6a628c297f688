// rwkv6_wkv: the RWKV-6 (Finch) WKV recurrence with the (D, D) state kept
// in registers across the whole time loop and written once -- the APR
// pattern applied to a decaying accumulator.  Per (batch row, head):
//
//   y_t = (S + diag(u) k_t v_t^T)^T r_t
//   S  <- diag(w_t) S + k_t v_t^T
//
// extended by an optional initial state in (s_init, fp32 (B, H, D, D)) and
// final state out (s_out), which the serving path needs; with neither it
// is exactly the TPU kernel (state starts at zero, none comes out).
//
// Replaces: src/repro/kernels/rwkv6/kernel.py::rwkv6_call (kernel body
// _rwkv6_kernel).
//
// What bounds it on an H100: every input value is read once and every
// output written once.  The function needs 5 fp32 operations per state
// element per step (kv = k_i v_j; S = w_i S + kv; y_j += r_i S_ij, with the
// bonus taken out of the element loop as v_j sum_i r_i u_i k_i); this
// kernel issues 3 instructions an element, that form.  That is 5·D^2 per
// head per step against bf16 r, k, v, y and fp32 w, 768 bytes at D = 64:
// ~27 operations per byte, just above the fp32 ridge (20), so over a long
// prompt the operations bound it.  At a decode step (T = 1) the state read
// and written is nearly all the bytes.
//
// Design:
//  * columns j of S are independent (column j needs r, k, w and u over i,
//    and v_j), so a block owns a run of columns of one (b, h), a head's
//    columns cut into `parts` runs of nearly equal length, at most 8
//    warps each (a B = 1, T = 1024 call at 3 parts is 120 blocks of 5 or 6
//    warps, not 40);
//  * a lane owns 4 adjacent columns (one 16-byte vector of each state row)
//    and IR adjacent rows i = ig·IR + m; LJ (1, 2 or 4) lanes side by side
//    along j, LI = 32 / LJ lane groups along i cover all of the rows, so a
//    column's sum over i stays in its warp.  A warp instruction that loads
//    or stores S reads runs of LJ·16 contiguous bytes of a row;
//  * y_j is one fixed tree per column: chains of G = min(4, max(1, IP/32))
//    adjacent rows (IP, the head size rounded up to a power of two), then
//    pairs over the row index from its lowest bit up, the in-lane bits
//    before the lane bits; the bonus v_j · beta is added last, beta one
//    warp-wide sum per step (bonus()).  Every configuration and both paths
//    below sum in this order, so a column's bits do not depend on the
//    batch, the tile, the lanes, the staging depth or how T is split;
//  * y leaves the per-step chain: the state update of RUN = 8 steps runs
//    first, then the 4·8 partial sums of a lane are reduced over its lane
//    groups together (scan::reduce_slots);
//  * T > 1: r, k, v, w of `chunk` steps are staged by cp.async into a
//    double buffer, the next round's copies in flight while the block
//    walks the current one; bf16 rows are widened once into fp32 buffers
//    and beta is formed once per step, 4 steps a warp at a time; T = 1
//    (the decode tick) skips the staging and reads its few values straight
//    from memory;
//  * per element the update is the plain version's state update, in its
//    order, every rounding explicit: S = fma(w_i, S, k_i · v_j).
#include <type_traits>

#include "scan.cuh"

namespace {

using scan::widen;

constexpr int MAX_D = 128, RUN = 8;
constexpr int BONUS_STEPS = 4;     // steps a warp's bonus pass sums at once
// at most 8 warps a block, so that a lane may hold up to 255 registers
constexpr int MAX_WARPS = 8;
constexpr int MAX_SMEM = 232448;   // an H100 block's dynamic shared memory

// beta = sum_i r_i u_i k_i by the whole warp in one fixed order: lane l
// adds the terms i = l, l + 32, ... in turn, then a butterfly over the
// lanes; every lane returns the same bits.
template <typename R, typename U>
__device__ __forceinline__ float bonus(const R* r, const U* u, const R* k,
                                       int d, int lane) {
  float s = 0.f;
  for (int i = lane; i < d; i += 32) {
    s = __fadd_rn(s, __fmul_rn(__fmul_rn(widen(r[i]), widen(u[i])),
                               widen(k[i])));
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    s = __fadd_rn(s, __shfl_xor_sync(scan::FULL, s, off));
  }
  return s;
}

// bonus() for up to NB steps at once (rows `stride` apart, `count` of
// them), the steps' sums interleaved so that their shuffles overlap; each
// step's bits are bonus()'s.  Lane s < count returns step s's sum in
// out[0].
template <int NB, typename R, typename U>
__device__ __forceinline__ void bonus_steps(float (&out)[NB], const R* r,
                                            int stride, int count,
                                            const U* u, const R* k, int d,
                                            int lane) {
  float s[NB];
#pragma unroll
  for (int q = 0; q < NB; ++q) {
    s[q] = 0.f;
    if (q < count) {
      for (int i = lane; i < d; i += 32) {
        s[q] = __fadd_rn(s[q], __fmul_rn(__fmul_rn(widen(r[q * stride + i]),
                                                   widen(u[i])),
                                         widen(k[q * stride + i])));
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
#pragma unroll
    for (int q = 0; q < NB; ++q) {
      s[q] = __fadd_rn(s[q], __shfl_xor_sync(scan::FULL, s[q], off));
    }
  }
  out[0] = s[0];
#pragma unroll
  for (int q = 1; q < NB; ++q) {
    if (lane == q) out[0] = s[q];
  }
}

__device__ __forceinline__ float& at(float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// One step over a lane's IR rows and 4 columns: each column's partial y
// over the lane's rows (old S), then the state update.
template <int IR, int G>
__device__ __forceinline__ void wkv_step(float4 (&st)[IR],
                                         const float (&ri)[IR],
                                         const float (&ki)[IR],
                                         const float (&wi)[IR], float4 vj,
                                         float* part) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float vc = at(vj, c);
    float g[IR / G];
#pragma unroll
    for (int gi = 0; gi < IR / G; ++gi) {
      float acc = __fmul_rn(ri[gi * G], at(st[gi * G], c));
#pragma unroll
      for (int e = 1; e < G; ++e) {
        acc = __fmaf_rn(ri[gi * G + e], at(st[gi * G + e], c), acc);
      }
      g[gi] = acc;
    }
#pragma unroll
    for (int step = 1; step < IR / G; step *= 2) {
#pragma unroll
      for (int i = 0; i + step < IR / G; i += 2 * step) {
        g[i] = __fadd_rn(g[i], g[i + step]);
      }
    }
    part[c] = g[0];
#pragma unroll
    for (int m = 0; m < IR; ++m) {
      float& s = at(st[m], c);
      s = __fmaf_rn(wi[m], s, __fmul_rn(ki[m], vc));
    }
  }
}

// Shared-memory layout of the staged path for `ch` steps: u, the per-step
// beta, the fp32 rows of r, k and the block's v the steps read (bf16 only;
// fp32 ones are read where they land), then two raw buffers of r, k (in
// T), w (fp32) and v (in T).
// Rows of r, k and w are IP values apart (IP, D rounded up to a power of
// two), so the step loop's addresses are constant offsets.
struct Layout {
  int head, wide, raw, total;
  __host__ __device__ Layout(int ch, int d, int ip, int cols, int es) {
    head = d * 4 + ch * 4;
    wide = es == 4 ? 0 : ch * (2 * ip + cols) * 4;
    raw = ch * ((2 * ip + cols) * es + ip * 4);
    total = head + wide + 2 * raw;
  }
};

// IR consecutive fp32 values from shared memory, 4·IR-byte aligned.
template <int IR>
__device__ __forceinline__ void load_rows(float (&v)[IR], const float* p) {
  if constexpr (IR % 4 == 0) {
#pragma unroll
    for (int m = 0; m < IR; m += 4) {
      const float4 f = *reinterpret_cast<const float4*>(p + m);
      v[m] = f.x;
      v[m + 1] = f.y;
      v[m + 2] = f.z;
      v[m + 3] = f.w;
    }
  } else if constexpr (IR == 2) {
    const float2 f = *reinterpret_cast<const float2*>(p);
    v[0] = f.x;
    v[1] = f.y;
  } else {
    v[0] = p[0];
  }
}

// T: the element type of r, k, v, u and y (bf16 or fp32); w is fp32.
// A head's D / (4·LJ) warps of columns are cut into `parts` runs of
// nearly equal length; block blockIdx.x = (b·H + h)·parts + part owns run
// `part` of head h of batch row b (its spare warps, if any, stage and
// idle).  IP is D rounded up to a power of two (rows past D are zeros).
template <typename T, int LJ, int IP>
__global__ void __launch_bounds__(MAX_WARPS * 32) wkv_kernel(
    const T* __restrict__ r,        // (B, T, H, D)
    const T* __restrict__ k,
    const T* __restrict__ v,
    const float* __restrict__ w,    // (B, T, H, D) decay in (0, 1)
    const T* __restrict__ u,        // (H, D)
    const float* s_init,            // (B, H, D, D) or null (zeros)
    float* s_out,                   // (B, H, D, D) or null; may be s_init
    T* __restrict__ y,              // (B, T, H, D)
    int tlen, int nh, int d, int parts, int ch) {
  constexpr int LI = 32 / LJ, IR = IP / LI;
  constexpr int G = IP >= 128 ? 4 : IP >= 64 ? 2 : 1;
  constexpr int K = RUN * 4;
  static_assert(IR >= G && IR % G == 0, "a chain lies in one lane");
  constexpr int WC = 4 * LJ;                    // columns a warp
  const int part = blockIdx.x % parts, bh = blockIdx.x / parts;
  const int b = bh / nh, h = bh % nh;
  const int wlo = part * (d / WC) / parts;      // the block's warps
  const int nw = (part + 1) * (d / WC) / parts - wlo, cols = nw * WC;
  const int lane = threadIdx.x % 32, ig = lane / LJ, jl = lane % LJ;
  const int warp = threadIdx.x / 32;
  const bool active = warp < nw;                // warp-uniform
  const int lcol = warp * WC + 4 * jl;          // in the block's columns
  const int j0 = wlo * WC + lcol, i0 = ig * IR;
  const size_t sbase = (size_t)bh * d * d + j0;
  float4 st[IR];
#pragma unroll
  for (int m = 0; m < IR; ++m) {
    st[m] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (active && s_init && i0 + m < d) {
      st[m] = *reinterpret_cast<const float4*>(s_init + sbase +
                                               (size_t)(i0 + m) * d);
    }
  }
  const size_t step = (size_t)nh * d;                   // one time step
  const size_t base = ((size_t)b * tlen * nh + h) * d;  // (b, 0, h, 0)
  bool owner;

  if (tlen == 1 && active) {
    float ri[IR], ki[IR], wi[IR], part[4];
#pragma unroll
    for (int m = 0; m < IR; ++m) {
      const int i = min(i0 + m, d - 1);
      const bool live = i0 + m < d;
      ri[m] = live ? widen(r[base + i]) : 0.f;
      ki[m] = live ? widen(k[base + i]) : 0.f;
      wi[m] = live ? w[base + i] : 0.f;
    }
    const T* vb = v + base + j0;
    const float4 vj = make_float4(widen(vb[0]), widen(vb[1]), widen(vb[2]),
                                  widen(vb[3]));
    const float beta = bonus(r + base, u + (size_t)h * d, k + base, d, lane);
    wkv_step<IR, G>(st, ri, ki, wi, vj, part);
    const int c = scan::reduce_slots<4, LI, LJ, false>(part, lane, owner);
    if (owner) {
      scan::store(y + base + j0 + c, __fmaf_rn(widen(vb[c]), beta, part[0]));
    }
  } else if (tlen > 1) {
    extern __shared__ __align__(16) unsigned char smem[];
    constexpr int ES = sizeof(T);
    const Layout lay(ch, d, IP, cols, ES);
    float* su = reinterpret_cast<float*>(smem);
    float* sbeta = su + d;
    float* wide = reinterpret_cast<float*>(smem + lay.head);
    unsigned char* raw = smem + lay.head + lay.wide;
    for (int i = threadIdx.x; i < d; i += blockDim.x) {
      su[i] = widen(u[(size_t)h * d + i]);
    }
    auto issue = [&](int c0, int buf) {
      const int n = min(ch, tlen - c0);
      T* rr = reinterpret_cast<T*>(raw + buf * lay.raw);
      T* rk = rr + ch * IP;
      T* rv = rk + ch * IP;
      float* rw = reinterpret_cast<float*>(rv + ch * cols);
      const size_t off = base + (size_t)c0 * step;
      const long long sb = (long long)step * ES;
      scan::stage(rr, IP * ES, r + off, sb, d * ES, n, 16);
      scan::stage(rk, IP * ES, k + off, sb, d * ES, n, 16);
      const T* vsrc = v + off + wlo * WC;
      scan::stage(rv, cols * ES, vsrc, sb, cols * ES, n,
                  scan::copy_width(vsrc, sb, cols * ES));
      scan::stage(rw, IP * 4, w + off, (long long)step * 4, d * 4, n, 16);
      scan::cp_commit();
    };
    issue(0, 0);
    const int warps = blockDim.x / 32, warp = threadIdx.x / 32;
    for (int c0 = 0, kk = 0; c0 < tlen; c0 += ch, ++kk) {
      const int n = min(ch, tlen - c0);
      scan::cp_wait_all();
      __syncthreads();   // round kk landed; round kk - 1's reads are done,
                         // so its buffer takes round kk + 1 while kk runs
      if (c0 + ch < tlen) issue(c0 + ch, (kk + 1) & 1);
      const T* rr = reinterpret_cast<const T*>(raw + (kk & 1) * lay.raw);
      const T* rk = rr + ch * IP;
      const T* rv = rk + ch * IP;
      const float* fw = reinterpret_cast<const float*>(rv + ch * cols);
      const float *fr, *fk, *fv;
      if constexpr (ES == 4) {
        fr = reinterpret_cast<const float*>(rr);
        fk = reinterpret_cast<const float*>(rk);
        fv = reinterpret_cast<const float*>(rv);
      } else {
        float* wr = wide;
        float* wk = wr + ch * IP;
        float* wv = wk + ch * IP;
        scan::widen_rows(wr, rr, n * IP);
        scan::widen_rows(wk, rk, n * IP);
        scan::widen_rows(wv, rv, n * cols);
        fr = wr;
        fk = wk;
        fv = wv;
      }
      for (int t0 = BONUS_STEPS * warp; t0 < n; t0 += BONUS_STEPS * warps) {
        float beta[BONUS_STEPS];
        bonus_steps(beta, rr + t0 * IP, IP, min(BONUS_STEPS, n - t0), su,
                    rk + t0 * IP, d, lane);
        if (lane < min(BONUS_STEPS, n - t0)) sbeta[t0 + lane] = beta[0];
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
            float ri[IR], ki[IR], wi[IR];
            load_rows<IR>(ri, fr + tt * IP + i0);
            load_rows<IR>(ki, fk + tt * IP + i0);
            load_rows<IR>(wi, fw + tt * IP + i0);
            if (d < IP) {        // rows past D (padding) take zeros
#pragma unroll
              for (int m = 0; m < IR; ++m) {
                const bool live = i0 + m < d;
                ri[m] = live ? ri[m] : 0.f;
                ki[m] = live ? ki[m] : 0.f;
                wi[m] = live ? wi[m] : 0.f;
              }
            }
            const float4 vj =
                *reinterpret_cast<const float4*>(fv + tt * cols + lcol);
            wkv_step<IR, G>(st, ri, ki, wi, vj, part + 4 * s);
          } else {
#pragma unroll
            for (int c = 0; c < 4; ++c) part[4 * s + c] = 0.f;
          }
        }
        const int first = scan::reduce_slots<K, LI, LJ, false>(part, lane,
                                                               owner);
#pragma unroll
        for (int i = 0; i < (K >= LI ? K / LI : 1); ++i) {
          const int slot = first + i, tt = s0 + slot / 4, c = slot % 4;
          if (owner && (!TAIL || tt < n)) {
            scan::store(y + base + (size_t)(c0 + tt) * step + j0 + c,
                        __fmaf_rn(fv[tt * cols + lcol + c], sbeta[tt],
                                  part[i]));
          }
        }
      };
      if (active) {
        int s0 = 0;
        for (; s0 + RUN <= n; s0 += RUN) run(s0, std::false_type{});
        if (s0 < n) run(s0, std::true_type{});
      }
    }
  }
  if (s_out && active) {
#pragma unroll
    for (int m = 0; m < IR; ++m) {
      if (i0 + m < d) {
        *reinterpret_cast<float4*>(s_out + sbase + (size_t)(i0 + m) * d) =
            st[m];
      }
    }
  }
}

template <typename T, int LJ, int IP>
int launch_geometry(const void* r, const void* k, const void* v,
                    const void* w, const void* u, const void* s_init,
                    void* s_out, void* y, int b, int t, int h, int d,
                    int parts, int ch, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      wkv_kernel<T, LJ, IP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      MAX_SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int warps = (d / (4 * LJ) + parts - 1) / parts;
  const int smem =
      t > 1 ? Layout(ch, d, IP, warps * 4 * LJ, sizeof(T)).total : 0;
  if (smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  wkv_kernel<T, LJ, IP><<<b * h * parts, warps * 32, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(w),
      static_cast<const T*>(u), static_cast<const float*>(s_init),
      static_cast<float*>(s_out), static_cast<T*>(y), t, h, d, parts, ch);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* s_init, void* s_out, void* y, int b,
           int t, int h, int d, int parts, int lanes, int ch, void* stream) {
  int ip = 16;
  while (ip < d) ip *= 2;
  if (d % 16 != 0 || d < 16 || d > MAX_D || lanes < 1 || lanes > 4 ||
      parts < 1 || parts > d / (4 * lanes) ||
      (d / (4 * lanes) + parts - 1) / parts > MAX_WARPS ||
      32 / lanes > ip || ch < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b * h == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
#define REPRO_WKV(L, IPV)                                                    \
  if (lanes == L && ip == IPV)                                               \
    return launch_geometry<T, L, IPV>(r, k, v, w, u, s_init, s_out, y, b, t, \
                                      h, d, parts, ch, s);
  REPRO_WKV(1, 32)
  REPRO_WKV(1, 64)
  REPRO_WKV(1, 128)
  REPRO_WKV(2, 16)
  REPRO_WKV(2, 32)
  REPRO_WKV(2, 64)
  REPRO_WKV(2, 128)
  REPRO_WKV(4, 16)
  REPRO_WKV(4, 32)
  REPRO_WKV(4, 64)
  REPRO_WKV(4, 128)
#undef REPRO_WKV
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int rwkv6_wkv_bf16(const void* r, const void* k, const void* v,
                              const void* w, const void* u,
                              const void* s_init, void* s_out, void* y,
                              int b, int t, int h, int d, int parts,
                              int lanes, int chunk, void* stream) {
  return launch<__nv_bfloat16>(r, k, v, w, u, s_init, s_out, y, b, t, h, d,
                               parts, lanes, chunk, stream);
}

extern "C" int rwkv6_wkv_f32(const void* r, const void* k, const void* v,
                             const void* w, const void* u,
                             const void* s_init, void* s_out, void* y, int b,
                             int t, int h, int d, int parts, int lanes,
                             int chunk, void* stream) {
  return launch<float>(r, k, v, w, u, s_init, s_out, y, b, t, h, d, parts,
                       lanes, chunk, stream);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
