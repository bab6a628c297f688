// rwkv6_wkv_bwd: the gradient of the RWKV-6 WKV recurrence (rwkv6.cu, from
// a zero state, none out) with respect to r, k, v, w and u, given dy.  With
// S_t the state after step t and G_t = dL/dS_t:
//
//   G_{t-1} = diag(w_t) G_t + r_t dy_t^T                 (G_{T-1} = 0)
//   dr_t = S_{t-1} dy_t + u.k_t (v_t.dy_t)
//   dk_t = G_t v_t + u.r_t (v_t.dy_t)
//   dv_t = G_t^T k_t + (sum_i u_i r_ti k_ti) dy_t
//   dw_t[i] = sum_j G_t[i,j] S_{t-1}[i,j]
//   du = sum_{b,t} r_t.k_t (v_t.dy_t)
//
// Replaces: no TPU kernel.  The JAX package differentiates its chunked jnp
// formula (src/repro/models/rwkv.py); the port's card path runs the
// per-step kernel of rwkv6.cu (src/repro/kernels/rwkv6/kernel.py::
// rwkv6_call) in its place, so its gradient is a kernel too.
//
// What bounds it on an H100: ~17 fp32 operations per state element per
// step (the forward's 5 recomputed twice less the y sum, the reverse
// recurrence and four contractions) against ~12 values in and out per
// head and step: at rwkv6-3b's B = 2, T = 512, H = 40, D = 64, 2.9 GFLOP
// (0.04 ms at the fp32 rate) against ~58 MB (0.02 ms), so the operations.
//
// Design:
//  * the APR pattern runs backwards: the state gradient G is a decaying
//    accumulator kept in registers across the reverse time loop and never
//    written to memory, as the forward keeps S;
//  * rows i of S and of G are independent in both sweeps, and dr, dk, dw
//    are sums along a row.  A block owns one (b, h); DP / 4 lanes share a
//    row (DP, D rounded up to a power of two, at least 16), each holding 4
//    adjacent columns of RT = DP / 16 rows, 4·DP threads; a row's sums are
//    one butterfly over its lanes.  dv (a sum over rows) is a butterfly
//    over the warp's row groups, then a fixed-order sum over the warps;
//  * the forward states are not invertible (w reaches ~1e-24), so the
//    reverse sweep takes S_{t-1} from a recompute: a forward sweep writes
//    S at each chunk's start (CH steps, as many as shared memory holds)
//    to `ckpt` and forms dr (which needs S_{t-1} and dy only) and du's
//    per-row sums; the reverse sweep walks the chunks last to first,
//    recomputes a chunk's states from its checkpoint into shared memory
//    (each thread reads back only what it wrote), then steps back through
//    them.  The prefix-sum identity for dw (no states paired, two sums of
//    T terms subtracted) was not taken: it cancels over long T, where the
//    recompute is exact to the forward's own roundings;
//  * no float atomics: every sum is in a fixed order (butterflies, warps in
//    order, steps in order, and du's batch rows in order by a second
//    kernel over the per-block partials), so two runs give the same bits;
//  * inputs of a chunk are staged into shared memory in fp32 (zeros past
//    D); the gradients are written in fp32 (the wrapper casts them).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_D = 128;
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

// Sum over the LN lanes that share a row (lane ids differing in the low
// bits); every lane gets the same bits.
template <int LN>
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 1; off < LN; off *= 2) {
    v = __fadd_rn(v, __shfl_xor_sync(FULL, v, off));
  }
  return v;
}

// Shared memory of a launch, in floats, at `ch` steps a chunk: the chunk's
// states (ch·DP·DP), dv's per-warp partials (ch·warps·DP), u, the staged
// r, k, v, w, dy (5·ch·DP) and the per-step v·dy and bonus.
__host__ __device__ constexpr int smem_floats(int ch, int dp) {
  return ch * dp * dp + ch * (dp / 8) * dp + dp + 5 * ch * dp + 2 * ch;
}

template <typename T, int DP>
__global__ void __launch_bounds__(4 * DP) wkv_bwd_kernel(
    const T* __restrict__ r,        // (B, T, H, D)
    const T* __restrict__ k,
    const T* __restrict__ v,
    const float* __restrict__ w,    // (B, T, H, D) decay in (0, 1)
    const T* __restrict__ u,        // (H, D)
    const T* __restrict__ dy,       // (B, T, H, D)
    float4* __restrict__ ckpt,      // (B·H, chunks, RT, 4·DP) float4
    float* __restrict__ dr,         // (B, T, H, D) fp32, as dk, dv, dw
    float* __restrict__ dk,
    float* __restrict__ dv,
    float* __restrict__ dw,
    float* __restrict__ du_part,    // (B, H, D): each batch row's du
    int tlen, int nh, int d, int ch) {
  constexpr int LN = DP / 4, RT = DP / 16, THREADS = 4 * DP;
  constexpr int WARPS = THREADS / 32;
  const int bh = blockIdx.x, b = bh / nh, h = bh % nh;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int j0 = 4 * (lane % LN);                    // the lane's columns
  const int i0 = (warp * (32 / LN) + lane / LN) * RT;  // and rows
  const bool lead = lane % LN == 0;                  // writes a row's sums
  const int chunks = (tlen + ch - 1) / ch;
  const size_t step = (size_t)nh * d;                // one time step
  extern __shared__ __align__(16) float sm[];
  float4* sst = reinterpret_cast<float4*>(sm);       // (ch, RT, THREADS)
  float* sdv = sm + ch * DP * DP;                    // (ch, WARPS, DP)
  float* su = sdv + ch * WARPS * DP;                 // (DP)
  float* sr = su + DP;                               // (ch, DP) each
  float* sk = sr + ch * DP;
  float* sv = sk + ch * DP;
  float* sw = sv + ch * DP;
  float* sdy = sw + ch * DP;
  float* svdy = sdy + ch * DP;                       // (ch): v_t · dy_t
  float* sbeta = svdy + ch;                          // (ch): sum u r k
  for (int i = tid; i < DP; i += THREADS) {
    su[i] = i < d ? widen(u[(size_t)h * d + i]) : 0.f;
  }
  // stages steps t0 .. t0 + n - 1 (zeros past D) and their two scalars,
  // each one thread's sum over i in order
  auto stage = [&](int t0, int n) {
    const size_t base = ((size_t)b * tlen + t0) * step + (size_t)h * d;
    for (int e = tid; e < n * DP; e += THREADS) {
      const int s = e / DP, i = e - s * DP;
      const size_t at = base + s * step + i;
      const bool live = i < d;
      sr[e] = live ? widen(r[at]) : 0.f;
      sk[e] = live ? widen(k[at]) : 0.f;
      sv[e] = live ? widen(v[at]) : 0.f;
      sw[e] = live ? w[at] : 0.f;
      sdy[e] = live ? widen(dy[at]) : 0.f;
    }
    __syncthreads();
    if (tid < n) {
      float vd = 0.f, be = 0.f;
      for (int i = 0; i < d; ++i) {
        vd = __fmaf_rn(sv[tid * DP + i], sdy[tid * DP + i], vd);
        be = __fmaf_rn(__fmul_rn(sr[tid * DP + i], su[i]), sk[tid * DP + i],
                       be);
      }
      svdy[tid] = vd;
      sbeta[tid] = be;
    }
    __syncthreads();
  };
  auto update = [&](float4 (&st)[RT], int s) {   // S <- diag(w) S + k v^T
    const float4 vv = *reinterpret_cast<const float4*>(sv + s * DP + j0);
#pragma unroll
    for (int m = 0; m < RT; ++m) {
      const float wi = sw[s * DP + i0 + m], ki = sk[s * DP + i0 + m];
      st[m].x = __fmaf_rn(wi, st[m].x, __fmul_rn(ki, vv.x));
      st[m].y = __fmaf_rn(wi, st[m].y, __fmul_rn(ki, vv.y));
      st[m].z = __fmaf_rn(wi, st[m].z, __fmul_rn(ki, vv.z));
      st[m].w = __fmaf_rn(wi, st[m].w, __fmul_rn(ki, vv.w));
    }
  };
  float4* my_ckpt = ckpt + (size_t)bh * chunks * RT * THREADS + tid;

  // forward sweep: checkpoints, dr, du's per-row sums
  float4 st[RT];
  float duacc[RT];
#pragma unroll
  for (int m = 0; m < RT; ++m) {
    st[m] = make_float4(0.f, 0.f, 0.f, 0.f);
    duacc[m] = 0.f;
  }
  for (int c = 0; c < chunks; ++c) {
    const int t0 = c * ch, n = min(ch, tlen - t0);
#pragma unroll
    for (int m = 0; m < RT; ++m) {
      my_ckpt[((size_t)c * RT + m) * THREADS] = st[m];
    }
    stage(t0, n);
    for (int s = 0; s < n; ++s) {
      const float4 dyv = *reinterpret_cast<const float4*>(sdy + s * DP + j0);
      float part[RT];
#pragma unroll
      for (int m = 0; m < RT; ++m) part[m] = row_sum<LN>(dot4(st[m], dyv));
      update(st, s);
      if (lead) {
        const size_t out = ((size_t)b * tlen + t0 + s) * step +
                           (size_t)h * d;
#pragma unroll
        for (int m = 0; m < RT; ++m) {
          const int i = i0 + m;
          if (i < d) {
            const float ki = sk[s * DP + i];
            dr[out + i] =
                __fmaf_rn(__fmul_rn(su[i], ki), svdy[s], part[m]);
            duacc[m] =
                __fmaf_rn(__fmul_rn(sr[s * DP + i], ki), svdy[s], duacc[m]);
          }
        }
      }
    }
    __syncthreads();   // the chunk's reads are done before the next stage
  }
  if (lead) {
#pragma unroll
    for (int m = 0; m < RT; ++m) {
      if (i0 + m < d) du_part[(size_t)bh * d + i0 + m] = duacc[m];
    }
  }

  // reverse sweep: G in registers, each chunk's states recomputed
  float4 g[RT];
#pragma unroll
  for (int m = 0; m < RT; ++m) g[m] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = chunks - 1; c >= 0; --c) {
    const int t0 = c * ch, n = min(ch, tlen - t0);
    stage(t0, n);
#pragma unroll
    for (int m = 0; m < RT; ++m) {
      st[m] = my_ckpt[((size_t)c * RT + m) * THREADS];
    }
    for (int s = 0; s < n; ++s) {        // sst[s] = S_{t0 + s - 1}
#pragma unroll
      for (int m = 0; m < RT; ++m) sst[(s * RT + m) * THREADS + tid] = st[m];
      update(st, s);
    }
    for (int s = n - 1; s >= 0; --s) {   // g holds G_{t0 + s}
      const float4 vv = *reinterpret_cast<const float4*>(sv + s * DP + j0);
      const float4 dyv = *reinterpret_cast<const float4*>(sdy + s * DP + j0);
      float pk[RT], pw[RT];
      float4 col = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int m = 0; m < RT; ++m) {
        const float4 sp = sst[(s * RT + m) * THREADS + tid];
        const float ki = sk[s * DP + i0 + m];
        pk[m] = row_sum<LN>(dot4(g[m], vv));
        pw[m] = row_sum<LN>(dot4(g[m], sp));
        col.x = __fmaf_rn(g[m].x, ki, col.x);
        col.y = __fmaf_rn(g[m].y, ki, col.y);
        col.z = __fmaf_rn(g[m].z, ki, col.z);
        col.w = __fmaf_rn(g[m].w, ki, col.w);
      }
#pragma unroll
      for (int off = LN; off < 32; off *= 2) {   // the warp's row groups
        col.x = __fadd_rn(col.x, __shfl_xor_sync(FULL, col.x, off));
        col.y = __fadd_rn(col.y, __shfl_xor_sync(FULL, col.y, off));
        col.z = __fadd_rn(col.z, __shfl_xor_sync(FULL, col.z, off));
        col.w = __fadd_rn(col.w, __shfl_xor_sync(FULL, col.w, off));
      }
      if (lane < LN) {
        *reinterpret_cast<float4*>(sdv + (s * WARPS + warp) * DP + j0) = col;
      }
      if (lead) {
        const size_t out = ((size_t)b * tlen + t0 + s) * step +
                           (size_t)h * d;
#pragma unroll
        for (int m = 0; m < RT; ++m) {
          const int i = i0 + m;
          if (i < d) {
            dk[out + i] = __fmaf_rn(__fmul_rn(su[i], sr[s * DP + i]),
                                    svdy[s], pk[m]);
            dw[out + i] = pw[m];
          }
        }
      }
#pragma unroll
      for (int m = 0; m < RT; ++m) {     // G_{t-1} = w_t G_t + r_t dy_t^T
        const float wi = sw[s * DP + i0 + m], ri = sr[s * DP + i0 + m];
        g[m].x = __fmaf_rn(wi, g[m].x, __fmul_rn(ri, dyv.x));
        g[m].y = __fmaf_rn(wi, g[m].y, __fmul_rn(ri, dyv.y));
        g[m].z = __fmaf_rn(wi, g[m].z, __fmul_rn(ri, dyv.z));
        g[m].w = __fmaf_rn(wi, g[m].w, __fmul_rn(ri, dyv.w));
      }
    }
    __syncthreads();
    for (int e = tid; e < n * DP; e += THREADS) {   // dv: warps in order
      const int s = e / DP, j = e - s * DP;
      if (j < d) {
        float acc = 0.f;
        for (int q = 0; q < WARPS; ++q) {
          acc = __fadd_rn(acc, sdv[(s * WARPS + q) * DP + j]);
        }
        dv[((size_t)b * tlen + t0 + s) * step + (size_t)h * d + j] =
            __fmaf_rn(sbeta[s], sdy[s * DP + j], acc);
      }
    }
    __syncthreads();
  }
}

// du[h, i] = sum over the batch rows of du_part, in order.
__global__ void du_reduce(const float* __restrict__ du_part,
                          float* __restrict__ du, int bsz, int hd) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= hd) return;
  float acc = 0.f;
  for (int b = 0; b < bsz; ++b) acc = __fadd_rn(acc, du_part[(size_t)b * hd + e]);
  du[e] = acc;
}

template <typename T, int DP>
int launch_dp(const void* r, const void* k, const void* v, const void* w,
              const void* u, const void* dy, void* ckpt, void* dr, void* dk,
              void* dv, void* dw, void* du_part, void* du, int b, int t,
              int h, int d, int ch, cudaStream_t stream) {
  const int smem = smem_floats(ch, DP) * 4;
  if (smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t attr = cudaFuncSetAttribute(
      wkv_bwd_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      MAX_SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  wkv_bwd_kernel<T, DP><<<b * h, 4 * DP, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(w),
      static_cast<const T*>(u), static_cast<const T*>(dy),
      static_cast<float4*>(ckpt), static_cast<float*>(dr),
      static_cast<float*>(dk), static_cast<float*>(dv),
      static_cast<float*>(dw), static_cast<float*>(du_part), t, h, d, ch);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  du_reduce<<<(h * d + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(du_part), static_cast<float*>(du), b, h * d);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* dy, void* ckpt, void* dr, void* dk,
           void* dv, void* dw, void* du_part, void* du, int b, int t, int h,
           int d, int ch, void* stream) {
  if (d % 16 != 0 || d < 16 || d > MAX_D || ch < 1 || t < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b * h == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  int dp = 16;
  while (dp < d) dp *= 2;
#define REPRO_WKV_BWD(DPV)                                                  \
  if (dp == DPV)                                                            \
    return launch_dp<T, DPV>(r, k, v, w, u, dy, ckpt, dr, dk, dv, dw,       \
                             du_part, du, b, t, h, d, ch, s);
  REPRO_WKV_BWD(16)
  REPRO_WKV_BWD(32)
  REPRO_WKV_BWD(64)
  REPRO_WKV_BWD(128)
#undef REPRO_WKV_BWD
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int rwkv6_wkv_bwd_bf16(const void* r, const void* k, const void* v,
                                  const void* w, const void* u,
                                  const void* dy, void* ckpt, void* dr,
                                  void* dk, void* dv, void* dw,
                                  void* du_part, void* du, int b, int t,
                                  int h, int d, int chunk, void* stream) {
  return launch<__nv_bfloat16>(r, k, v, w, u, dy, ckpt, dr, dk, dv, dw,
                               du_part, du, b, t, h, d, chunk, stream);
}

extern "C" int rwkv6_wkv_bwd_f32(const void* r, const void* k, const void* v,
                                 const void* w, const void* u,
                                 const void* dy, void* ckpt, void* dr,
                                 void* dk, void* dv, void* dw, void* du_part,
                                 void* du, int b, int t, int h, int d,
                                 int chunk, void* stream) {
  return launch<float>(r, k, v, w, u, dy, ckpt, dr, dk, dv, dw, du_part, du,
                       b, t, h, d, chunk, stream);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
