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
// This kernel issues 10 fp32 instructions an element and step, and it
// moves more than the streams: each state checkpoint is written and read
// once (B·H·D·D·4 bytes a chunk), and dv's per-tile partials go through
// device memory to the reduce.  At these shapes a chunk's fixed cost (its
// staging copies, barriers, checkpoint round trip and partial stores),
// not the arithmetic, takes most of a block's time: so the chunk is as
// long as shared memory allows, and the copies are issued where the
// block has work to hide them behind.
//
// Design:
//  * rows i of S and of G are independent in both sweeps (w_t is one
//    decay a row), and so are the columns; dr, dk and dw are sums along a
//    row, dv a sum over rows and du a sum over batch rows and steps.  So
//    each (b, h) state is cut into tiles of ROWS = 16 rows, one block a
//    tile, all DP columns (D rounded up to a power of two, at least 16,
//    zeros past D): DP / 4 lanes share a row, each holding one float4 of
//    columns of RT = 4 rows (2 at DP = 16), 16 / RT · DP / 4 threads.  At
//    rwkv6-3b that is 320 blocks of 2 warps, one wave at 3 blocks an SM,
//    where the first design ran 80 blocks of 8 warps on 80 of 132 SMs.
//    Fewer rows a thread (more warps) was slower: each thread then carries
//    more of a chunk's fixed cost for less arithmetic;
//  * a row tile completes dr, dk and dw of its rows and du's per-row sums;
//    dv becomes a per-tile partial (tiles x B·T·H·D fp32) and the bonus
//    sum_i u_i r_i k_i a per-tile partial (tiles x B·T·H), which
//    wkv_bwd_reduce sums in one fixed order (tiles in order, du's batch
//    rows in order): no float atomics, so two calls give the same bits,
//    and the tiling follows from the shape alone (the wrapper's
//    `bwd_geometry`), so the bits depend on the shape and nothing else;
//  * the APR pattern runs backwards: the state gradient G is a decaying
//    accumulator kept in registers across the reverse time loop and never
//    written to memory, as the forward keeps S;
//  * the forward states are not invertible (w reaches ~1e-24), so the
//    reverse sweep takes S_{t-1} from a recompute: a forward sweep writes
//    S at each chunk's start (`ch` steps) to `ckpt` and forms dr (which
//    needs S_{t-1} and dy only) and du's per-row sums; the reverse sweep
//    walks the chunks last to first, recomputes a chunk's states from its
//    checkpoint into shared memory (each thread reads back only what it
//    wrote), then steps back through them.  The prefix-sum identity for
//    dw (no states paired, two sums of T terms subtracted) was not taken:
//    it cancels over long T, where the recompute is exact to the forward's
//    own roundings;
//  * the stash of a chunk's states is the shared memory that binds: at
//    one wave every block's tile is resident, and the stash holds `ch`
//    states of each, so `ch` is the most steps that fit the blocks an SM
//    one wave needs (at least 2): 12 at rwkv6-3b (3 blocks an SM);
//  * v, dy and the tile's r, k, w of a chunk are staged by cp.async into
//    a double buffer, the next chunk's copies in flight while the block
//    walks the current one, each thread issuing its share after the
//    chunk's rows have landed and been widened to fp32 (and, in the
//    reverse sweep, after the recompute); the reverse sweep loads the
//    next chunk's checkpoint a chunk ahead;
//  * the lane sums leave the per-step chain: a run of RUN = 4 steps'
//    partials (each row's dr, dk or dw term and v·dy over the row's lanes,
//    each column's dv term and the rows' bonus u r k over the warp's row
//    groups) are reduced together (scan::reduce_slots, one fixed tree a
//    slot), then the warps' partials are summed in order; every output
//    is written as whole rows;
//  * per element the arithmetic is the plain version's, each rounding
//    explicit: S = fma(w_i, S, k_i · v_j), G = fma(w_i, G, r_i · dy_j).
#include <type_traits>

#include "scan_bwd.cuh"

namespace {

using scan::widen;
using scan_bwd::dot4;

constexpr int MAX_D = 128, ROWS = 16;
constexpr int RUN = 4;   // steps whose lane sums are reduced together

// Shared memory of a launch, in floats, at `ch` steps a chunk, head size
// d padded to dp columns, `w` warps and `es`-byte inputs: the stash of the
// chunk's states (ch·ROWS·dp), the warps' dv partials (ch·w·dp), the
// tile's dr, dk and dw row sums (3·ch·ROWS), fp32 rows of v, dy (dp each,
// zeros past d) and of the tile's r, k, w (ROWS each), two raw buffers of
// v, dy, r, k and w (each rounded up to 16 bytes), the per-step v·dy, the
// warps' bonus partials and the tile's u.
__host__ __device__ constexpr int smem_floats(int ch, int d, int dp, int w,
                                              int es) {
  return ch * 16 * dp + ch * w * dp + 3 * ch * 16 + ch * (2 * dp + 3 * 16) +
         2 * ((ch * (2 * d * es + 2 * 16 * es + 16 * 4) + 15) / 16 * 4) +
         ch + ch * w + 16;
}

// The rows a lane holds at DP columns: 4, or 2 at 16 columns (a whole warp).
__host__ __device__ constexpr int rows_per_lane(int dp) {
  return dp >= 32 ? 4 : 2;
}
__host__ __device__ constexpr int block_threads(int dp) {
  return ROWS / rows_per_lane(dp) * (dp / 4);
}

// T: the element type of r, k, v, u and dy (bf16 or fp32); w is fp32;
// every tensor is contiguous.  Block blockIdx.x = (b·H + h)·tiles + tile
// owns rows [tile·ROWS, tile·ROWS + ROWS) of the (b, h) state, all DP
// columns.
template <typename T, int DP>
__global__ void __launch_bounds__(block_threads(DP)) wkv_bwd_kernel(
    const T* __restrict__ r,        // (B, T, H, D)
    const T* __restrict__ k,
    const T* __restrict__ v,
    const float* __restrict__ w,    // (B, T, H, D) decay in (0, 1)
    const T* __restrict__ u,        // (H, D)
    const T* __restrict__ dy,       // (B, T, H, D)
    float4* __restrict__ ckpt,      // (blocks, chunks, RT, threads) float4
    float* __restrict__ dv_part,    // (tiles, B, T, H, D)
    float* __restrict__ beta_part,  // (tiles, B, T, H): sum u r k
    float* __restrict__ du_part,    // (B, H, D): each batch row's du
    float* __restrict__ dr,         // (B, T, H, D) fp32, as dk, dw
    float* __restrict__ dk,
    float* __restrict__ dw,
    int bsz, int tlen, int nh, int d, int ch) {
  constexpr int LN = DP / 4, RT = rows_per_lane(DP);
  constexpr int THREADS = block_threads(DP), WARPS = THREADS / 32;
  constexpr int GROUPS = 32 / LN, ES = sizeof(T);
  const int tiles = d / ROWS;
  const int tile = blockIdx.x % tiles, bh = blockIdx.x / tiles;
  const int b = bh / nh, h = bh % nh, r0 = tile * ROWS;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int j0 = 4 * (lane % LN);       // the lane's columns
  const int l0 = tid / LN * RT;         // and its rows in the tile
  const int chunks = (tlen + ch - 1) / ch;
  const size_t rows = (size_t)bsz * tlen * nh;   // (b, t, h) rows
  const size_t step = (size_t)nh * d;            // one time step
  extern __shared__ __align__(16) float sm[];
  float4* sst = reinterpret_cast<float4*>(sm);   // (ch, RT, THREADS)
  float* sdv = sm + ch * ROWS * DP;              // (ch, WARPS, DP)
  float* sdr = sdv + ch * WARPS * DP;            // (ch, ROWS) each
  float* spk = sdr + ch * ROWS;
  float* spw = spk + ch * ROWS;
  float* wv = spw + ch * ROWS;                   // (ch, DP) each
  float* wdy = wv + ch * DP;
  float* wr = wdy + ch * DP;                     // (ch, ROWS) each
  float* wk = wr + ch * ROWS;
  float* ww = wk + ch * ROWS;
  float* raw0 = ww + ch * ROWS;
  const int raw_floats =
      (ch * (2 * d * ES + 2 * ROWS * ES + ROWS * 4) + 15) / 16 * 4;
  float* svdy = raw0 + 2 * raw_floats;           // (ch): v_t · dy_t
  float* sbeta = svdy + ch;                      // (ch, WARPS): u r k
  float* su = sbeta + ch * WARPS;                // (ROWS)
  for (int i = tid; i < ROWS; i += THREADS) {
    su[i] = widen(u[(size_t)h * d + r0 + i]);
  }
  const size_t base = (size_t)b * tlen * step + (size_t)h * d;
  const long long ss = (long long)step * ES;
  const int wvw = scan::copy_width(v + base, ss, d * ES);
  const int wdw = scan::copy_width(dy + base, ss, d * ES);
  const int wrw = scan::copy_width(r + base + r0, ss, ROWS * ES);
  const int wkw = scan::copy_width(k + base + r0, ss, ROWS * ES);
  const int www = scan::copy_width(w + base + r0, (long long)step * 4,
                                   ROWS * 4);
  // raw buffer `buf`: v, dy (ch, D), the tile's r, k (ch, ROWS) in T, its
  // w (ch, ROWS) fp32
  auto raw_v = [&](int buf) {
    return reinterpret_cast<T*>(raw0 + buf * raw_floats);
  };
  int issued = 0, used = 0;             // staging rounds issued, consumed
  auto issue = [&](int c) {
    const int t0 = c * ch, nst = min(ch, tlen - t0);
    T* rv = raw_v(issued++ & 1);
    T* rdy = rv + ch * d;
    T* rr = rdy + ch * d;
    T* rk = rr + ch * ROWS;
    float* rw = reinterpret_cast<float*>(rk + ch * ROWS);
    const size_t at = base + (size_t)t0 * step;
    scan::stage(rv, d * ES, v + at, ss, d * ES, nst, wvw);
    scan::stage(rdy, d * ES, dy + at, ss, d * ES, nst, wdw);
    scan::stage(rr, ROWS * ES, r + at + r0, ss, ROWS * ES, nst, wrw);
    scan::stage(rk, ROWS * ES, k + at + r0, ss, ROWS * ES, nst, wkw);
    scan::stage(rw, ROWS * 4, w + at + r0, (long long)step * 4, ROWS * 4,
                nst, www);
    scan::cp_commit();
  };
  // waits for the oldest round issued (this thread's copies, then the
  // block's); its buffer
  auto consume = [&]() {
    scan::cp_wait_all();
    __syncthreads();
    return used++ & 1;
  };
  // chunk c's rows in fp32 (zeros past D)
  auto land = [&](int c, int buf) {
    const int nst = min(ch, tlen - c * ch);
    const T* rv = raw_v(buf);
    const T* rdy = rv + ch * d;
    const T* rr = rdy + ch * d;
    const T* rk = rr + ch * ROWS;
    const float* rw = reinterpret_cast<const float*>(rk + ch * ROWS);
    if (d == DP) {
      scan_bwd::to_f32(wv, rv, nst * DP);
      scan_bwd::to_f32(wdy, rdy, nst * DP);
    } else {
      for (int e = tid; e < nst * DP; e += THREADS) {
        const int s = e / DP, j = e - s * DP;
        const bool live = j < d;
        wv[e] = live ? widen(rv[s * d + j]) : 0.f;
        wdy[e] = live ? widen(rdy[s * d + j]) : 0.f;
      }
    }
    scan_bwd::to_f32(wr, rr, nst * ROWS);
    scan_bwd::to_f32(wk, rk, nst * ROWS);
    scan_bwd::to_f32(ww, rw, nst * ROWS);
    __syncthreads();
  };
  // v_t · dy_t of the run's steps: each lane's 4 columns, then the row's
  // lanes (the same tree in both sweeps); the first row group writes it
  auto put_vdy = [&](float (&vd)[RUN], int s0, int nst, auto tail) {
    constexpr bool TAIL = decltype(tail)::value;
    scan_bwd::flush<RUN, 1, LN, 1>(vd, lane, [&](int u, int, float x) {
      if (tid < LN && (!TAIL || (s0 + u >= 0 && s0 + u < nst))) {
        svdy[s0 + u] = x;
      }
    });
  };
  auto update = [&](float4 (&st)[RT], int s) {   // S <- diag(w) S + k v^T
    const float4 vv = *reinterpret_cast<const float4*>(wv + s * DP + j0);
#pragma unroll
    for (int m = 0; m < RT; ++m) {
      const float wi = ww[s * ROWS + l0 + m], ki = wk[s * ROWS + l0 + m];
      st[m].x = __fmaf_rn(wi, st[m].x, __fmul_rn(ki, vv.x));
      st[m].y = __fmaf_rn(wi, st[m].y, __fmul_rn(ki, vv.y));
      st[m].z = __fmaf_rn(wi, st[m].z, __fmul_rn(ki, vv.z));
      st[m].w = __fmaf_rn(wi, st[m].w, __fmul_rn(ki, vv.w));
    }
  };
  float4* my_ckpt = ckpt + (size_t)blockIdx.x * chunks * RT * THREADS + tid;

  // forward sweep: checkpoints, dr, du's per-row sums, the bonus
  float4 st[RT];
#pragma unroll
  for (int m = 0; m < RT; ++m) st[m] = make_float4(0.f, 0.f, 0.f, 0.f);
  float duacc = 0.f;                    // thread i < ROWS: row r0 + i
  issue(0);
  for (int c = 0; c < chunks; ++c) {
    const int t0 = c * ch, nst = min(ch, tlen - t0);
    land(c, consume());   // chunk c landed; chunk c - 1's reads are done,
                          // so its buffer takes c + 1 while c runs
    if (c + 1 < chunks) issue(c + 1);
#pragma unroll
    for (int m = 0; m < RT; ++m) {
      my_ckpt[((size_t)c * RT + m) * THREADS] = st[m];
    }
    // per step: each row's S_{t-1} dy (lanes), v·dy, and the rows' bonus
    // u r k (row groups)
    auto run = [&](int s0, auto tail) {
      constexpr bool TAIL = decltype(tail)::value;
      float ps[RUN * RT], vd[RUN], bt[RUN];
#pragma unroll
      for (int u = 0; u < RUN; ++u) {
        const int s = s0 + u;
        vd[u] = bt[u] = 0.f;
#pragma unroll
        for (int m = 0; m < RT; ++m) ps[u * RT + m] = 0.f;
        if (!TAIL || s < nst) {
          const float4 dyv =
              *reinterpret_cast<const float4*>(wdy + s * DP + j0);
          const float4 vv = *reinterpret_cast<const float4*>(wv + s * DP + j0);
          vd[u] = dot4(vv, dyv);
#pragma unroll
          for (int m = 0; m < RT; ++m) {
            ps[u * RT + m] = dot4(st[m], dyv);
            const float be = __fmul_rn(__fmul_rn(wr[s * ROWS + l0 + m],
                                                 su[l0 + m]),
                                       wk[s * ROWS + l0 + m]);
            bt[u] = m == 0 ? be : __fadd_rn(bt[u], be);
          }
          update(st, s);
        }
      }
      scan_bwd::flush<RUN * RT, RT, LN, 1>(
          ps, lane, [&](int u, int m, float x) {
            if (!TAIL || s0 + u < nst) sdr[(s0 + u) * ROWS + l0 + m] = x;
          });
      put_vdy(vd, s0, nst, tail);
      scan_bwd::flush<RUN, 1, GROUPS, LN>(bt, lane, [&](int u, int, float x) {
        if (lane % LN == 0 && (!TAIL || s0 + u < nst)) {
          sbeta[(s0 + u) * WARPS + warp] = x;
        }
      });
    };
    int s0 = 0;
    for (; s0 + RUN <= nst; s0 += RUN) run(s0, std::false_type{});
    if (s0 < nst) run(s0, std::true_type{});
    __syncthreads();
    for (int e = tid; e < nst * ROWS; e += THREADS) {   // whole tile rows
      const int s = e / ROWS, l = e - s * ROWS;
      dr[((size_t)b * tlen + t0 + s) * step + (size_t)h * d + r0 + l] =
          __fmaf_rn(__fmul_rn(su[l], wk[e]), svdy[s], sdr[e]);
    }
    if (tid < ROWS) {
      for (int s = 0; s < nst; ++s) {
        duacc = __fmaf_rn(__fmul_rn(wr[s * ROWS + tid], wk[s * ROWS + tid]),
                          svdy[s], duacc);
      }
    }
    for (int s = tid; s < nst; s += THREADS) {     // warps in order
      float be = sbeta[s * WARPS];
      for (int q = 1; q < WARPS; ++q) be = __fadd_rn(be, sbeta[s * WARPS + q]);
      beta_part[(size_t)tile * rows + ((size_t)b * tlen + t0 + s) * nh + h] =
          be;
    }
  }
  if (tid < ROWS) du_part[((size_t)b * nh + h) * d + r0 + tid] = duacc;
  __syncthreads();   // the forward's reads are done before its buffers refill

  // reverse sweep: G in registers, each chunk's states recomputed
  float4 g[RT];
#pragma unroll
  for (int m = 0; m < RT; ++m) g[m] = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 nxt[RT];                       // the next chunk's checkpoint
#pragma unroll
  for (int m = 0; m < RT; ++m) {
    nxt[m] = my_ckpt[((size_t)(chunks - 1) * RT + m) * THREADS];
  }
  issue(chunks - 1);
  for (int c = chunks - 1; c >= 0; --c) {
    const int t0 = c * ch, nst = min(ch, tlen - t0);
    land(c, consume());
#pragma unroll
    for (int m = 0; m < RT; ++m) {
      st[m] = nxt[m];
    }
    for (int s = 0; s < nst; ++s) {        // sst[s] = S_{t0 + s - 1}
#pragma unroll
      for (int m = 0; m < RT; ++m) sst[(s * RT + m) * THREADS + tid] = st[m];
      update(st, s);
    }
    if (c > 0) {   // after the recompute, which they would delay
      issue(c - 1);
#pragma unroll
      for (int m = 0; m < RT; ++m) {
        nxt[m] = my_ckpt[((size_t)(c - 1) * RT + m) * THREADS];
      }
    }
    // steps s0 + RUN - 1 down to s0 (g holds G of the step); those below
    // 0 are absent (TAIL)
    auto run = [&](int s0, auto tail) {
      constexpr bool TAIL = decltype(tail)::value;
      float ks[RUN * RT], ws[RUN * RT], cs[RUN * 4], vd[RUN];
#pragma unroll
      for (int u = RUN - 1; u >= 0; --u) {
        const int s = s0 + u;
        float4 col = make_float4(0.f, 0.f, 0.f, 0.f);
        vd[u] = 0.f;
#pragma unroll
        for (int m = 0; m < RT; ++m) ks[u * RT + m] = ws[u * RT + m] = 0.f;
        if (!TAIL || s >= 0) {
          const float4 vv = *reinterpret_cast<const float4*>(wv + s * DP + j0);
          const float4 dyv =
              *reinterpret_cast<const float4*>(wdy + s * DP + j0);
          vd[u] = dot4(vv, dyv);
#pragma unroll
          for (int m = 0; m < RT; ++m) {
            const float ki = wk[s * ROWS + l0 + m];
            ks[u * RT + m] = dot4(g[m], vv);
            ws[u * RT + m] = dot4(g[m], sst[(s * RT + m) * THREADS + tid]);
            if (m == 0) {
              col = make_float4(__fmul_rn(g[0].x, ki), __fmul_rn(g[0].y, ki),
                                __fmul_rn(g[0].z, ki), __fmul_rn(g[0].w, ki));
            } else {
              col.x = __fmaf_rn(g[m].x, ki, col.x);
              col.y = __fmaf_rn(g[m].y, ki, col.y);
              col.z = __fmaf_rn(g[m].z, ki, col.z);
              col.w = __fmaf_rn(g[m].w, ki, col.w);
            }
          }
#pragma unroll
          for (int m = 0; m < RT; ++m) {   // G_{t-1} = w_t G_t + r_t dy_t^T
            const float wi = ww[s * ROWS + l0 + m];
            const float ri = wr[s * ROWS + l0 + m];
            g[m].x = __fmaf_rn(wi, g[m].x, __fmul_rn(ri, dyv.x));
            g[m].y = __fmaf_rn(wi, g[m].y, __fmul_rn(ri, dyv.y));
            g[m].z = __fmaf_rn(wi, g[m].z, __fmul_rn(ri, dyv.z));
            g[m].w = __fmaf_rn(wi, g[m].w, __fmul_rn(ri, dyv.w));
          }
        }
        cs[4 * u] = col.x;
        cs[4 * u + 1] = col.y;
        cs[4 * u + 2] = col.z;
        cs[4 * u + 3] = col.w;
      }
      scan_bwd::flush<RUN * RT, RT, LN, 1>(
          ks, lane, [&](int u, int m, float x) {
            if (!TAIL || s0 + u >= 0) spk[(s0 + u) * ROWS + l0 + m] = x;
          });
      scan_bwd::flush<RUN * RT, RT, LN, 1>(
          ws, lane, [&](int u, int m, float x) {
            if (!TAIL || s0 + u >= 0) spw[(s0 + u) * ROWS + l0 + m] = x;
          });
      scan_bwd::flush<RUN * 4, 4, GROUPS, LN>(
          cs, lane, [&](int u, int q, float x) {
            if (!TAIL || s0 + u >= 0) {
              sdv[((s0 + u) * WARPS + warp) * DP + j0 + q] = x;
            }
          });
      put_vdy(vd, s0, nst, tail);
    };
    int hi = nst;
    for (; hi >= RUN; hi -= RUN) run(hi - RUN, std::false_type{});
    if (hi > 0) run(hi - RUN, std::true_type{});
    __syncthreads();
    for (int e = tid; e < nst * ROWS; e += THREADS) {   // whole tile rows
      const int s = e / ROWS, l = e - s * ROWS;
      const size_t out =
          ((size_t)b * tlen + t0 + s) * step + (size_t)h * d + r0 + l;
      dk[out] = __fmaf_rn(__fmul_rn(su[l], wr[e]), svdy[s], spk[e]);
      dw[out] = spw[e];
    }
    for (int e = tid; e < nst * d; e += THREADS) {      // dv: warps in order
      const int s = e / d, j = e - s * d;
      float acc = sdv[s * WARPS * DP + j];
      for (int q = 1; q < WARPS; ++q) {
        acc = __fadd_rn(acc, sdv[(s * WARPS + q) * DP + j]);
      }
      dv_part[(size_t)tile * rows * d +
              ((size_t)b * tlen + t0 + s) * step + (size_t)h * d + j] = acc;
    }
  }
}

// dv: the tiles' partials summed in order, plus the bonus (the tiles'
// partials summed in order) times dy; du[h, i]: the batch rows' du_part in
// order.
template <typename T>
__global__ void wkv_bwd_reduce(const float* __restrict__ dv_part,
                               const float* __restrict__ beta_part,
                               const float* __restrict__ du_part,
                               const T* __restrict__ dy,
                               float* __restrict__ dv, float* __restrict__ du,
                               int bsz, int tlen, int nh, int d, int tiles) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long rows = (long long)bsz * tlen * nh;
  if (e < rows * d) {
    const long long row = e / d;
    float acc = dv_part[e], beta = beta_part[row];
    for (int t = 1; t < tiles; ++t) {
      acc = __fadd_rn(acc, dv_part[(size_t)t * rows * d + e]);
      beta = __fadd_rn(beta, beta_part[(size_t)t * rows + row]);
    }
    dv[e] = __fmaf_rn(beta, widen(dy[e]), acc);
  }
  if (e < (long long)nh * d) {
    float acc = du_part[e];
    for (int b = 1; b < bsz; ++b) {
      acc = __fadd_rn(acc, du_part[(size_t)b * nh * d + e]);
    }
    du[e] = acc;
  }
}

struct Bufs {
  const void *r, *k, *v, *w, *u, *dy;
  void *ckpt, *dv_part, *beta_part, *du_part, *dr, *dk, *dv, *dw, *du;
};

template <typename T, int DP>
int launch_dp(const Bufs& x, int b, int t, int h, int d, int ch,
              cudaStream_t stream) {
  constexpr int THREADS = block_threads(DP);
  const int smem = smem_floats(ch, d, DP, THREADS / 32, sizeof(T)) * 4;
  if (smem > scan_bwd::MAX_SMEM) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static const cudaError_t attr = cudaFuncSetAttribute(
      wkv_bwd_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      scan_bwd::MAX_SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int tiles = d / ROWS;
  wkv_bwd_kernel<T, DP><<<b * h * tiles, THREADS, smem, stream>>>(
      static_cast<const T*>(x.r), static_cast<const T*>(x.k),
      static_cast<const T*>(x.v), static_cast<const float*>(x.w),
      static_cast<const T*>(x.u), static_cast<const T*>(x.dy),
      static_cast<float4*>(x.ckpt), static_cast<float*>(x.dv_part),
      static_cast<float*>(x.beta_part), static_cast<float*>(x.du_part),
      static_cast<float*>(x.dr), static_cast<float*>(x.dk),
      static_cast<float*>(x.dw), b, t, h, d, ch);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long work = (long long)b * t * h * d;
  wkv_bwd_reduce<T><<<static_cast<unsigned>((work + 255) / 256), 256, 0,
                      stream>>>(
      static_cast<const float*>(x.dv_part),
      static_cast<const float*>(x.beta_part),
      static_cast<const float*>(x.du_part), static_cast<const T*>(x.dy),
      static_cast<float*>(x.dv), static_cast<float*>(x.du), b, t, h, d,
      tiles);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const Bufs& x, int b, int t, int h, int d, int ch, void* stream) {
  if (d % ROWS != 0 || d < 16 || d > MAX_D || ch < 1 || t < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b * h == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  int dp = 16;
  while (dp < d) dp *= 2;
  switch (dp) {
    case 16: return launch_dp<T, 16>(x, b, t, h, d, ch, s);
    case 32: return launch_dp<T, 32>(x, b, t, h, d, ch, s);
    case 64: return launch_dp<T, 64>(x, b, t, h, d, ch, s);
    case 128: return launch_dp<T, 128>(x, b, t, h, d, ch, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

#define REPRO_WKV_BWD_ENTRY(NAME, T)                                         \
  extern "C" int NAME(const void* r, const void* k, const void* v,           \
                      const void* w, const void* u, const void* dy,          \
                      void* ckpt, void* dv_part, void* beta_part,            \
                      void* du_part, void* dr, void* dk, void* dv, void* dw, \
                      void* du, int b, int t, int h, int d, int chunk,       \
                      void* stream) {                                        \
    const Bufs x{r,  k,       v,         w,       u,  dy, ckpt, dv_part,     \
                 beta_part, du_part, dr, dk, dv, dw, du};                    \
    return launch<T>(x, b, t, h, d, chunk, stream);                          \
  }
REPRO_WKV_BWD_ENTRY(rwkv6_wkv_bwd_bf16, __nv_bfloat16)
REPRO_WKV_BWD_ENTRY(rwkv6_wkv_bwd_f32, float)
#undef REPRO_WKV_BWD_ENTRY

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
