// mamba2_ssd_bwd: the gradient of the Mamba-2 SSD recurrence (mamba2.cu,
// from a zero state, none out) with respect to x, b, c, dt, a and d, given
// dy.  With h_t the state after step t, decay_t = exp(a dt_t) and G_t =
// dL/dh_t:
//
//   G_t = dy_t c_t^T + decay_{t+1} G_{t+1}               (G_T = 0)
//   dx_t = dt_t G_t b_t + d dy_t
//   db_t = sum_h dt_t G_t^T x_t,   dc_t = sum_h h_t^T dy_t
//   q_t = decay_t sum G_t . h_{t-1}     (dL/d(a dt_t))
//   ddt_t = a q_t + sum G_t . x_t b_t^T,   da = sum_{b,t} dt_t q_t
//   dd = sum_{b,t,p} dy_t . x_t
//
// Replaces: no TPU kernel.  The JAX package differentiates its chunked jnp
// formula (src/repro/models/ssm.py); the port's card path runs the
// per-step kernel of mamba2.cu (src/repro/kernels/mamba2/kernel.py::
// mamba2_call) in its place, so its gradient is a kernel too.
//
// What bounds it on an H100: ~15 fp32 operations per state element per
// step (the update recomputed twice, dc's, dx's, q's and db's contractions,
// G's two updates) against P values in and out per head and step: at
// mamba2-2.7b's B = 2, T = 512, H = 80, P = 64, N = 128, 10 GFLOP (0.15 ms
// at the fp32 rate) against ~30 MB, so the operations.
//
// Design:
//  * the APR pattern runs backwards: G is a decaying accumulator kept in
//    registers across the reverse time loop and never written to memory;
//  * rows p of h and of G are independent in both sweeps, and dx and the
//    sums behind q and ddt run along a row.  A block owns one (b, h); NP / 4
//    lanes share a row (NP, N rounded up to a power of two, at least 16),
//    each holding 4 adjacent state columns of RT = NP / 16 rows, 4·P
//    threads; a row's sums are one butterfly over its lanes.  dc and db
//    (sums over rows) are a butterfly over the warp's row groups, then a
//    fixed-order sum over the warps; their sum over heads, and da's and
//    dd's over batch rows, come from per-block partials reduced in order by
//    a second kernel;
//  * the forward states are not invertible (decay_t underflows), so the
//    reverse sweep takes h_{t-1} from a recompute: a forward sweep writes h
//    at each chunk's start (CH steps, as many as shared memory holds) to
//    `ckpt` and forms dc (which needs h_t and dy only); the reverse sweep
//    walks the chunks last to first, recomputes a chunk's states from its
//    checkpoint into shared memory (each thread reads back only what it
//    wrote), then steps back through them.  The decay's gradient is taken
//    with respect to a·dt (q_t), never by dividing by the decay;
//  * no float atomics: every sum is in a fixed order, so two runs give the
//    same bits;
//  * inputs of a chunk are staged into shared memory in fp32 (zeros past
//    N); the gradients are written in fp32 (the wrapper casts them).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_P = 64, MAX_N = 128;
constexpr int MAX_SMEM = 232448;   // an H100 block's dynamic shared memory

__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float widen(float x) { return x; }

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  float s = __fmul_rn(a.x, b.x);
  s = __fmaf_rn(a.y, b.y, s);
  s = __fmaf_rn(a.z, b.z, s);
  return __fmaf_rn(a.w, b.w, s);
}

// Sum over the lanes whose ids differ in the bits LO, 2·LO, ..., HI / 2;
// every such lane gets the same bits.
template <int LO, int HI>
__device__ __forceinline__ float lane_sum(float v) {
#pragma unroll
  for (int off = LO; off < HI; off *= 2) {
    v = __fadd_rn(v, __shfl_xor_sync(FULL, v, off));
  }
  return v;
}

// Shared memory of a launch, in floats, at `ch` steps a chunk: the chunk's
// states (ch·P·NP), the per-warp column partials (ch·warps·NP), the staged
// b, c (2·ch·NP), x, dy (2·ch·P), the per-warp q and s partials (2·ch·
// warps) and the per-step dt, decay and x·dy.
__host__ __device__ constexpr int smem_floats(int ch, int p, int np) {
  return ch * p * np + ch * (p / 8) * np + 2 * ch * np + 2 * ch * p +
         2 * ch * (p / 8) + 3 * ch;
}

template <typename T, int NP>
__global__ void __launch_bounds__(4 * MAX_P) ssd_bwd_kernel(
    const T* __restrict__ x,        // (B, T, H, P)
    const T* __restrict__ bm,       // (B, T, N)
    const T* __restrict__ cm,       // (B, T, N)
    const float* __restrict__ dt,   // (B, T, H)
    const float* __restrict__ a,    // (H,)
    const float* __restrict__ dsk,  // (H,)
    const T* __restrict__ dy,       // (B, T, H, P)
    float4* __restrict__ ckpt,      // (B·H, chunks, RT, 4·P) float4
    float* __restrict__ dx,         // (B, T, H, P) fp32
    float* __restrict__ db_part,    // (B, T, H, N): each head's db
    float* __restrict__ dc_part,    // (B, T, H, N): each head's dc
    float* __restrict__ ddt,        // (B, T, H)
    float* __restrict__ da_part,    // (B, H)
    float* __restrict__ dd_part,    // (B, H)
    int tlen, int nh, int p, int n, int ch) {
  constexpr int LN = NP / 4, RT = NP / 16;
  const int threads = 4 * p, warps = p / 8;
  const int bh = blockIdx.x, b = bh / nh, h = bh % nh;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int j0 = 4 * (lane % LN);                    // the lane's columns
  const int i0 = (warp * (32 / LN) + lane / LN) * RT;  // and rows
  const bool lead = lane % LN == 0;                  // writes a row's sums
  const int chunks = (tlen + ch - 1) / ch;
  const float ah = a[h], dh = dsk[h];
  extern __shared__ __align__(16) float sm[];
  float4* sst = reinterpret_cast<float4*>(sm);       // (ch, RT, threads)
  float* scol = sm + ch * p * NP;                    // (ch, warps, NP)
  float* sb = scol + ch * warps * NP;                // (ch, NP) each
  float* sc = sb + ch * NP;
  float* sx = sc + ch * NP;                          // (ch, P) each
  float* sdy = sx + ch * p;
  float* sq = sdy + ch * p;                          // (ch, warps) each
  float* ss = sq + ch * warps;
  float* sdt = ss + ch * warps;                      // (ch) each
  float* sdec = sdt + ch;
  float* sxdy = sdec + ch;
  // stages steps t0 .. t0 + n - 1 (zeros past N), each step's decay and
  // its x · dy (one thread's sum over p in order)
  auto stage = [&](int t0, int n_steps) {
    for (int e = tid; e < n_steps * NP; e += threads) {
      const int s = e / NP, j = e - s * NP;
      const size_t at = ((size_t)b * tlen + t0 + s) * n + j;
      sb[e] = j < n ? widen(bm[at]) : 0.f;
      sc[e] = j < n ? widen(cm[at]) : 0.f;
    }
    for (int e = tid; e < n_steps * p; e += threads) {
      const int s = e / p, i = e - s * p;
      const size_t at = (((size_t)b * tlen + t0 + s) * nh + h) * p + i;
      sx[e] = widen(x[at]);
      sdy[e] = widen(dy[at]);
    }
    if (tid < n_steps) {
      const float dtt = dt[((size_t)b * tlen + t0 + tid) * nh + h];
      sdt[tid] = dtt;
      sdec[tid] = expf(__fmul_rn(ah, dtt));
    }
    __syncthreads();
    if (tid < n_steps) {
      float acc = 0.f;
      for (int i = 0; i < p; ++i) {
        acc = __fmaf_rn(sx[tid * p + i], sdy[tid * p + i], acc);
      }
      sxdy[tid] = acc;
    }
    __syncthreads();
  };
  // h <- decay h + dt x b^T, the forward kernel's form
  auto update = [&](float4 (&st)[RT], int s) {
    const float4 bq = *reinterpret_cast<const float4*>(sb + s * NP + j0);
    const float dec = sdec[s], dtt = sdt[s];
#pragma unroll
    for (int m = 0; m < RT; ++m) {
      const float xp = sx[s * p + i0 + m];
      st[m].x = __fmaf_rn(dec, st[m].x, __fmul_rn(dtt, __fmul_rn(xp, bq.x)));
      st[m].y = __fmaf_rn(dec, st[m].y, __fmul_rn(dtt, __fmul_rn(xp, bq.y)));
      st[m].z = __fmaf_rn(dec, st[m].z, __fmul_rn(dtt, __fmul_rn(xp, bq.z)));
      st[m].w = __fmaf_rn(dec, st[m].w, __fmul_rn(dtt, __fmul_rn(xp, bq.w)));
    }
  };
  // the column partials of a step, summed over the warp's row groups, go
  // to scol[s][warp]
  auto put_col = [&](float4 col, int s) {
    col.x = lane_sum<LN, 32>(col.x);
    col.y = lane_sum<LN, 32>(col.y);
    col.z = lane_sum<LN, 32>(col.z);
    col.w = lane_sum<LN, 32>(col.w);
    if (lane < LN) {
      *reinterpret_cast<float4*>(scol + (s * warps + warp) * NP + j0) = col;
    }
  };
  float4* my_ckpt = ckpt + (size_t)bh * chunks * RT * threads + tid;

  // forward sweep: checkpoints, dc's per-head partials, dd
  float4 st[RT];
#pragma unroll
  for (int m = 0; m < RT; ++m) st[m] = make_float4(0.f, 0.f, 0.f, 0.f);
  float ddacc = 0.f;
  for (int c = 0; c < chunks; ++c) {
    const int t0 = c * ch, nst = min(ch, tlen - t0);
#pragma unroll
    for (int m = 0; m < RT; ++m) {
      my_ckpt[((size_t)c * RT + m) * threads] = st[m];
    }
    stage(t0, nst);
    for (int s = 0; s < nst; ++s) {
      update(st, s);
      float4 col = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int m = 0; m < RT; ++m) {
        const float dyp = sdy[s * p + i0 + m];
        col.x = __fmaf_rn(st[m].x, dyp, col.x);
        col.y = __fmaf_rn(st[m].y, dyp, col.y);
        col.z = __fmaf_rn(st[m].z, dyp, col.z);
        col.w = __fmaf_rn(st[m].w, dyp, col.w);
      }
      put_col(col, s);
    }
    __syncthreads();
    for (int e = tid; e < nst * NP; e += threads) {   // warps in order
      const int s = e / NP, j = e - s * NP;
      if (j < n) {
        float acc = 0.f;
        for (int q = 0; q < warps; ++q) {
          acc = __fadd_rn(acc, scol[(s * warps + q) * NP + j]);
        }
        dc_part[(((size_t)b * tlen + t0 + s) * nh + h) * n + j] = acc;
      }
    }
    if (tid == 0) {
      for (int s = 0; s < nst; ++s) ddacc = __fadd_rn(ddacc, sxdy[s]);
    }
    __syncthreads();
  }

  // reverse sweep: G in registers (`carry` = decay_{t+1} G_{t+1}), each
  // chunk's states recomputed
  float4 carry[RT];
#pragma unroll
  for (int m = 0; m < RT; ++m) carry[m] = make_float4(0.f, 0.f, 0.f, 0.f);
  float daacc = 0.f;
  for (int c = chunks - 1; c >= 0; --c) {
    const int t0 = c * ch, nst = min(ch, tlen - t0);
    stage(t0, nst);
#pragma unroll
    for (int m = 0; m < RT; ++m) {
      st[m] = my_ckpt[((size_t)c * RT + m) * threads];
    }
    for (int s = 0; s < nst; ++s) {      // sst[s] = h_{t0 + s - 1}
#pragma unroll
      for (int m = 0; m < RT; ++m) sst[(s * RT + m) * threads + tid] = st[m];
      update(st, s);
    }
    for (int s = nst - 1; s >= 0; --s) {
      const float4 bq = *reinterpret_cast<const float4*>(sb + s * NP + j0);
      const float4 cq = *reinterpret_cast<const float4*>(sc + s * NP + j0);
      float gb[RT], qacc = 0.f;
      float4 col = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int m = 0; m < RT; ++m) {
        const float dyp = sdy[s * p + i0 + m], xp = sx[s * p + i0 + m];
        float4 g;                                 // G_t
        g.x = __fmaf_rn(dyp, cq.x, carry[m].x);
        g.y = __fmaf_rn(dyp, cq.y, carry[m].y);
        g.z = __fmaf_rn(dyp, cq.z, carry[m].z);
        g.w = __fmaf_rn(dyp, cq.w, carry[m].w);
        gb[m] = lane_sum<1, LN>(dot4(g, bq));
        qacc = __fadd_rn(qacc,
                         dot4(g, sst[(s * RT + m) * threads + tid]));
        col.x = __fmaf_rn(g.x, xp, col.x);
        col.y = __fmaf_rn(g.y, xp, col.y);
        col.z = __fmaf_rn(g.z, xp, col.z);
        col.w = __fmaf_rn(g.w, xp, col.w);
        const float dec = sdec[s];
        carry[m] = make_float4(__fmul_rn(dec, g.x), __fmul_rn(dec, g.y),
                               __fmul_rn(dec, g.z), __fmul_rn(dec, g.w));
      }
      put_col(col, s);
      float sacc = 0.f;                           // sum_p x_p (G_t b_t)_p
      if (lead) {
        const size_t out = (((size_t)b * tlen + t0 + s) * nh + h) * p;
#pragma unroll
        for (int m = 0; m < RT; ++m) {
          const int i = i0 + m;
          sacc = __fmaf_rn(sx[s * p + i], gb[m], sacc);
          dx[out + i] = __fmaf_rn(sdt[s], gb[m], __fmul_rn(dh, sdy[s * p + i]));
        }
      }
      qacc = lane_sum<1, 32>(qacc);
      sacc = lane_sum<1, 32>(sacc);
      if (lane == 0) {
        sq[s * warps + warp] = qacc;
        ss[s * warps + warp] = sacc;
      }
    }
    __syncthreads();
    for (int e = tid; e < nst * NP; e += threads) {   // warps in order
      const int s = e / NP, j = e - s * NP;
      if (j < n) {
        float acc = 0.f;
        for (int q = 0; q < warps; ++q) {
          acc = __fadd_rn(acc, scol[(s * warps + q) * NP + j]);
        }
        db_part[(((size_t)b * tlen + t0 + s) * nh + h) * n + j] =
            __fmul_rn(sdt[s], acc);
      }
    }
    if (tid < nst) {
      const int s = tid;
      float q = 0.f, sv = 0.f;
      for (int w = 0; w < warps; ++w) {
        q = __fadd_rn(q, sq[s * warps + w]);
        sv = __fadd_rn(sv, ss[s * warps + w]);
      }
      q = __fmul_rn(sdec[s], q);
      ddt[((size_t)b * tlen + t0 + s) * nh + h] = __fmaf_rn(ah, q, sv);
      sq[s * warps] = __fmul_rn(sdt[s], q);       // da's term of step s
    }
    __syncthreads();
    if (tid == 0) {
      for (int s = nst - 1; s >= 0; --s) daacc = __fadd_rn(daacc, sq[s * warps]);
    }
    __syncthreads();
  }
  if (tid == 0) {
    da_part[bh] = daacc;
    dd_part[bh] = ddacc;
  }
}

// db, dc (B, T, N): the per-head partials summed over heads in order; da,
// dd (H,): the per-block partials summed over batch rows in order.
__global__ void ssd_bwd_reduce(const float* __restrict__ db_part,
                               const float* __restrict__ dc_part,
                               const float* __restrict__ da_part,
                               const float* __restrict__ dd_part,
                               float* __restrict__ db, float* __restrict__ dc,
                               float* __restrict__ da, float* __restrict__ dd,
                               int bsz, int tlen, int nh, int n) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long rows = (long long)bsz * tlen * n;
  if (e < rows) {
    const long long bt = e / n, j = e - bt * n;
    float sb = 0.f, sc = 0.f;
    for (int h = 0; h < nh; ++h) {
      const size_t at = ((size_t)bt * nh + h) * n + j;
      sb = __fadd_rn(sb, db_part[at]);
      sc = __fadd_rn(sc, dc_part[at]);
    }
    db[e] = sb;
    dc[e] = sc;
  }
  if (e < nh) {
    float sa = 0.f, sd = 0.f;
    for (int b = 0; b < bsz; ++b) {
      sa = __fadd_rn(sa, da_part[(size_t)b * nh + e]);
      sd = __fadd_rn(sd, dd_part[(size_t)b * nh + e]);
    }
    da[e] = sa;
    dd[e] = sd;
  }
}

template <typename T, int NP>
int launch_np(const void* x, const void* bm, const void* cm, const void* dt,
              const void* a, const void* d, const void* dy, void* ckpt,
              void* dx, void* db_part, void* dc_part, void* ddt,
              void* da_part, void* dd_part, void* db, void* dc, void* da,
              void* dd, int bsz, int t, int h, int p, int n, int ch,
              cudaStream_t stream) {
  const int smem = smem_floats(ch, p, NP) * 4;
  if (smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t attr = cudaFuncSetAttribute(
      ssd_bwd_kernel<T, NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      MAX_SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  ssd_bwd_kernel<T, NP><<<bsz * h, 4 * p, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(bm),
      static_cast<const T*>(cm), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const float*>(d),
      static_cast<const T*>(dy), static_cast<float4*>(ckpt),
      static_cast<float*>(dx), static_cast<float*>(db_part),
      static_cast<float*>(dc_part), static_cast<float*>(ddt),
      static_cast<float*>(da_part), static_cast<float*>(dd_part), t, h, p, n,
      ch);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long work = (long long)bsz * t * n > h ? (long long)bsz * t * n
                                                    : h;
  ssd_bwd_reduce<<<static_cast<unsigned>((work + 255) / 256), 256, 0,
                   stream>>>(
      static_cast<const float*>(db_part), static_cast<const float*>(dc_part),
      static_cast<const float*>(da_part), static_cast<const float*>(dd_part),
      static_cast<float*>(db), static_cast<float*>(dc),
      static_cast<float*>(da), static_cast<float*>(dd), bsz, t, h, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, const void* bm, const void* cm, const void* dt,
           const void* a, const void* d, const void* dy, void* ckpt,
           void* dx, void* db_part, void* dc_part, void* ddt, void* da_part,
           void* dd_part, void* db, void* dc, void* da, void* dd, int bsz,
           int t, int h, int p, int n, int ch, void* stream) {
  if (p % 16 != 0 || n % 16 != 0 || p < 16 || p > MAX_P || n < 16 ||
      n > MAX_N || ch < 1 || t < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (bsz * h == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  int np = 16;
  while (np < n) np *= 2;
#define REPRO_SSD_BWD(NPV)                                                   \
  if (np == NPV)                                                             \
    return launch_np<T, NPV>(x, bm, cm, dt, a, d, dy, ckpt, dx, db_part,     \
                             dc_part, ddt, da_part, dd_part, db, dc, da, dd, \
                             bsz, t, h, p, n, ch, s);
  REPRO_SSD_BWD(16)
  REPRO_SSD_BWD(32)
  REPRO_SSD_BWD(64)
  REPRO_SSD_BWD(128)
#undef REPRO_SSD_BWD
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int mamba2_ssd_bwd_bf16(
    const void* x, const void* b, const void* c, const void* dt,
    const void* a, const void* d, const void* dy, void* ckpt, void* dx,
    void* db_part, void* dc_part, void* ddt, void* da_part, void* dd_part,
    void* db, void* dc, void* da, void* dd, int bsz, int t, int h, int p,
    int n, int chunk, void* stream) {
  return launch<__nv_bfloat16>(x, b, c, dt, a, d, dy, ckpt, dx, db_part,
                               dc_part, ddt, da_part, dd_part, db, dc, da, dd,
                               bsz, t, h, p, n, chunk, stream);
}

extern "C" int mamba2_ssd_bwd_f32(
    const void* x, const void* b, const void* c, const void* dt,
    const void* a, const void* d, const void* dy, void* ckpt, void* dx,
    void* db_part, void* dc_part, void* ddt, void* da_part, void* dd_part,
    void* db, void* dc, void* da, void* dd, int bsz, int t, int h, int p,
    int n, int chunk, void* stream) {
  return launch<float>(x, b, c, dt, a, d, dy, ckpt, dx, db_part, dc_part,
                       ddt, da_part, dd_part, db, dc, da, dd, bsz, t, h, p, n,
                       chunk, stream);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
