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
// What bounds it on an H100: the function needs ~15 fp32 operations per
// state element per step (the update recomputed twice, dc's, dx's, q's and
// db's contractions, G's two updates): at mamba2-2.7b's B = 2, T = 512,
// H = 80, P = 64, N = 128, 10 GFLOP (0.15 ms at the fp32 rate) against
// ~30 MB of streams, so the operations.  This kernel issues 12 fp32
// instructions an element and step, and it moves more than the streams:
// each state checkpoint is written once and read once (B·H·P·N·4 bytes a
// chunk), the reverse sweep keeps a chunk's states in shared memory, and
// the per-tile partials go through device memory to the reduce.  At these
// shapes a chunk's fixed cost (its staging copies, barriers, checkpoint
// round trip and partial stores), not the arithmetic, takes most of a
// block's time: so the chunk is as long as shared memory allows, and the
// copies are issued where the block has work to hide them behind.
//
// Design:
//  * every element of h and of G evolves on its own in both sweeps (the
//    decay is one scalar a head); only the gradients' contractions couple
//    elements.  So each (b, h) state is cut into column tiles of NC = 4·LN
//    of its N columns (32, or 16 where 32 does not divide N), one block a
//    tile, all P rows: LN lanes share a row, each holding one float4 of
//    columns of RT rows (RT = 4, or 2 where 4 leaves a partial warp), P /
//    RT · LN threads.  At mamba2-2.7b that is 640 blocks of 4 warps, one
//    wave at 5 blocks an SM, where the first design ran 160 blocks of 8
//    warps in two waves at one block an SM.  Fewer rows a thread (more
//    warps) was slower at every training shape: each thread then carries
//    more of a chunk's fixed cost for less arithmetic;
//  * a column tile completes dc's and db's sums over the rows of its
//    columns; dx's row sums (G b) and the sums behind q and ddt become
//    per-tile partials (tiles x B·T·H·P fp32 for dx, tiles x B·T·H for q
//    and s), and db and dc per-head partials (B·T·H·N each), which
//    ssd_bwd_reduce sums in one fixed order (tiles in order, heads in
//    order) and ssd_bwd_heads sums over batch rows and steps (a fixed
//    stride and tree): no float atomics, so two calls give the same bits,
//    and the tiling follows from the shape alone (the wrapper's
//    `bwd_geometry`), so the bits depend on the shape and nothing else;
//  * the APR pattern runs backwards: G is a decaying accumulator kept in
//    registers across the reverse time loop and never written to memory;
//  * the forward states are not invertible (decay_t underflows), so the
//    reverse sweep takes h_{t-1} from a recompute: a forward sweep writes
//    h at each chunk's start (`ch` steps) to `ckpt` and forms dc (which
//    needs h_t and dy only); the reverse sweep walks the chunks last to
//    first, recomputes a chunk's states from its checkpoint into shared
//    memory (each thread reads back only what it wrote), then steps back
//    through them.  The decay's gradient is taken with respect to a·dt
//    (q_t), never by dividing by the decay;
//  * the stash of a chunk's states is the shared memory that binds: at
//    one wave every block's tile is resident, and the stash holds `ch`
//    states of each, so `ch` is the most steps that fit the blocks an SM
//    one wave needs (at least 2): 4 at mamba2-2.7b (5 blocks an SM), 10
//    at zamba2-1.2b;
//  * x, dy, the tile's b and c and dt of a chunk are staged by cp.async
//    into a double buffer, the next chunk's copies in flight while the
//    block walks the current one, each thread issuing its share after the
//    chunk's rows have landed and been widened once to fp32 (and, in the
//    reverse sweep, after the recompute); exp(a dt) is formed once a step;
//    outside the WAVE body the reverse sweep loads the next chunk's
//    checkpoint a chunk ahead;
//  * the lane sums leave the per-step chain: a run of RUN steps' partials
//    (each row's G b over the row's lanes; the lane's q, s = x (G b) and
//    x·dy terms over the warp; each column's dc or db term over the
//    warp's row groups) are reduced together (scan::reduce_slots, one
//    fixed tree a slot, so RUN does not move a bit), then the warps'
//    partials are summed in order and written as whole rows of the tile,
//    and dx's partials as whole rows of P;
//  * two bodies: where one wave needs 3 or more blocks an SM (WAVE, as at
//    mamba2-2.7b), registers are capped at 640 threads an SM and RUN = 2
//    keeps the cap nearly free of spills; elsewhere RUN = 4 and no cap;
//  * per element the arithmetic is the plain version's, each rounding
//    explicit: h = fma(exp(a dt), h, dt · (x_p · b_n)), G = fma(dy_p, c_n,
//    carry), carry = decay · G;
//  * tensor cores: the per-step form is elementwise recurrence work, which
//    they do not take.  The chunked (SSD) matrix form would map onto
//    them, but TF32 or bf16 products cannot hold the backward's 2e-5 gate
//    against the fp32 plain version, and 3xTF32 split products triple the
//    work of a form that already recomputes the chunk's decays; the
//    per-step form stays.
#include <type_traits>

#include "scan_bwd.cuh"

namespace {

using scan_bwd::dot4;
using scan_bwd::load_rows;

constexpr int MAX_P = 64, MAX_N = 128, MAX_THREADS = 128;

// Shared memory of a launch, in floats, at `ch` steps a chunk, P rows, a
// tile of `nc` columns, `w` warps and `es`-byte inputs: the stash of the
// chunk's states (ch·P·nc), the warps' column partials (ch·w·nc), the
// tile's row sums G b (ch·P), fp32 copies of bf16 x, dy, b and c, two raw
// buffers of x, dy, b, c and dt (each rounded up to 16 bytes), and the
// per-step decay and the warps' partials of q, s and x·dy (4 slots each).
__host__ __device__ constexpr int smem_floats(int ch, int p, int nc, int w,
                                              int es) {
  return ch * p * nc + ch * w * nc + ch * p +
         (4 - es) / 2 * 2 * ch * (p + nc) +
         2 * ((ch * (2 * p + 2 * nc) * es + 4 * ch + 15) / 16 * 4) + ch +
         4 * ch * w;
}

// The threads a block of LN lanes a row and RT rows a lane runs at P = 64.
__host__ __device__ constexpr int block_threads(int ln, int rt) {
  return MAX_P / rt * ln;
}

// T: the element type of x, b, c and dy (bf16 or fp32); dt, a, d are fp32;
// every tensor is contiguous.  Block blockIdx.x = (b·H + h)·tiles + ct
// owns columns [ct·NC, ct·NC + NC) of the (b, h) state, all P rows.
// WAVE: the body for a wave of 3 or more blocks an SM, whose registers are
// capped at 640 threads an SM (96 a thread) and whose runs are RUN = 2
// steps, which keeps that cap free of most spills; else RUN = 4 steps and
// no cap.
template <typename T, int LN, int RT, bool WAVE>
__global__ void __launch_bounds__(block_threads(LN, RT),
                                  WAVE ? 640 / block_threads(LN, RT) : 1)
    ssd_bwd_kernel(
    const T* __restrict__ x,        // (B, T, H, P)
    const T* __restrict__ bm,       // (B, T, N)
    const T* __restrict__ cm,       // (B, T, N)
    const float* __restrict__ dt,   // (B, T, H)
    const float* __restrict__ a,    // (H,)
    const float* __restrict__ dsk,  // (H,)
    const T* __restrict__ dy,       // (B, T, H, P)
    float4* __restrict__ ckpt,      // (blocks, chunks, RT, threads) float4
    float* __restrict__ dx_part,    // (tiles, B, T, H, P)
    float* __restrict__ db_part,    // (B, T, H, N): each head's db
    float* __restrict__ dc_part,    // (B, T, H, N): each head's dc
    float* __restrict__ q_part,     // (tiles, B, T, H): sum G . h_{t-1}
    float* __restrict__ s_part,     // (tiles, B, T, H): sum x (G b)
    float* __restrict__ xdy,        // (B, T, H): sum x . dy
    int bsz, int tlen, int nh, int p, int n, int ch) {
  constexpr int NC = 4 * LN, ES = sizeof(T), GROUPS = 32 / LN;
  constexpr int RUN = WAVE ? 2 : 4;   // steps whose lane sums reduce at once
  const int tiles = n / NC, threads = p / RT * LN, warps = threads / 32;
  const int ct = blockIdx.x % tiles, bh = blockIdx.x / tiles;
  const int b = bh / nh, h = bh % nh;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int j0 = 4 * (lane % LN);       // the lane's columns in the tile
  const int i0 = tid / LN * RT;         // and its rows
  const int chunks = (tlen + ch - 1) / ch;
  const size_t rows = (size_t)bsz * tlen * nh;   // (b, t, h) rows
  const float ah = a[h], dh = dsk[h];
  extern __shared__ __align__(16) float sm[];
  float4* sst = reinterpret_cast<float4*>(sm);   // (ch, RT, threads)
  float* scol = sm + ch * p * NC;                // (ch, warps, NC)
  float* sgb = scol + ch * warps * NC;           // (ch, P)
  float* wide = sgb + ch * p;                    // x, dy (ch, P); b, c (ch, NC)
  float* raw0 = wide + (ES == 4 ? 0 : 2 * ch * (p + NC));
  const int raw_floats = (ch * (2 * p + 2 * NC) * ES + 4 * ch + 15) / 16 * 4;
  float* sdec = raw0 + 2 * raw_floats;           // (ch)
  float* ssc = sdec + ch;                        // (ch, warps, 4)
  const T* xb = x + ((size_t)b * tlen * nh + h) * p;    // step stride H·P
  const T* dyb = dy + ((size_t)b * tlen * nh + h) * p;
  const T* bb = bm + (size_t)b * tlen * n + ct * NC;    // step stride N
  const T* cb = cm + (size_t)b * tlen * n + ct * NC;
  const float* dtb = dt + (size_t)b * tlen * nh + h;    // step stride H
  const long long xs = (long long)nh * p * ES, bs = (long long)n * ES;
  const int wx = scan::copy_width(xb, xs, p * ES);
  const int wdy = scan::copy_width(dyb, xs, p * ES);
  const int wb = scan::copy_width(bb, bs, NC * ES);
  const int wc = scan::copy_width(cb, bs, NC * ES);
  // raw buffer `buf`: x, dy (ch, P), b, c (ch, NC) in T, dt (ch)
  auto raw_x = [&](int buf) {
    return reinterpret_cast<T*>(raw0 + buf * raw_floats);
  };
  int issued = 0, used = 0;             // staging rounds issued, consumed
  auto issue = [&](int c) {
    const int t0 = c * ch, nst = min(ch, tlen - t0);
    T* rx = raw_x(issued++ & 1);
    T* rdy = rx + ch * p;
    T* rb = rdy + ch * p;
    T* rc = rb + ch * NC;
    float* rdt = reinterpret_cast<float*>(rc + ch * NC);
    scan::stage(rx, p * ES, xb + (size_t)t0 * nh * p, xs, p * ES, nst, wx);
    scan::stage(rdy, p * ES, dyb + (size_t)t0 * nh * p, xs, p * ES, nst,
                wdy);
    scan::stage(rb, NC * ES, bb + (size_t)t0 * n, bs, NC * ES, nst, wb);
    scan::stage(rc, NC * ES, cb + (size_t)t0 * n, bs, NC * ES, nst, wc);
    scan::stage(rdt, 4, dtb + (size_t)t0 * nh, (long long)nh * 4, 4, nst, 4);
    scan::cp_commit();
  };
  // waits for the oldest round issued (this thread's copies, then the
  // block's); its buffer
  auto consume = [&]() {
    scan::cp_wait_all();
    __syncthreads();
    return used++ & 1;
  };
  // chunk c's fp32 rows (bf16 widened once) and its decays
  const float *fx, *fdy, *fb, *fc, *fdt;
  auto land = [&](int c, int buf) {
    const int nst = min(ch, tlen - c * ch);
    const T* rx = raw_x(buf);
    const T* rdy = rx + ch * p;
    const T* rb = rdy + ch * p;
    const T* rc = rb + ch * NC;
    fdt = reinterpret_cast<const float*>(rc + ch * NC);
    if constexpr (ES == 4) {
      fx = reinterpret_cast<const float*>(rx);
      fdy = reinterpret_cast<const float*>(rdy);
      fb = reinterpret_cast<const float*>(rb);
      fc = reinterpret_cast<const float*>(rc);
    } else {
      float* wx_ = wide;
      float* wdy_ = wx_ + ch * p;
      float* wb_ = wdy_ + ch * p;
      float* wc_ = wb_ + ch * NC;
      scan_bwd::to_f32(wx_, rx, nst * p);
      scan_bwd::to_f32(wdy_, rdy, nst * p);
      scan_bwd::to_f32(wb_, rb, nst * NC);
      scan_bwd::to_f32(wc_, rc, nst * NC);
      fx = wx_;
      fdy = wdy_;
      fb = wb_;
      fc = wc_;
    }
    for (int s = tid; s < nst; s += threads) {
      sdec[s] = expf(__fmul_rn(ah, fdt[s]));
    }
    __syncthreads();
  };
  // h <- decay h + dt x b^T, the forward kernel's form
  auto update = [&](float4 (&st)[RT], int s) {
    const float4 bq = *reinterpret_cast<const float4*>(fb + s * NC + j0);
    float xp[RT];
    load_rows<RT>(xp, fx + s * p + i0);
    const float dec = sdec[s], dtt = fdt[s];
#pragma unroll
    for (int m = 0; m < RT; ++m) {
      st[m].x = __fmaf_rn(dec, st[m].x, __fmul_rn(dtt, __fmul_rn(xp[m], bq.x)));
      st[m].y = __fmaf_rn(dec, st[m].y, __fmul_rn(dtt, __fmul_rn(xp[m], bq.y)));
      st[m].z = __fmaf_rn(dec, st[m].z, __fmul_rn(dtt, __fmul_rn(xp[m], bq.z)));
      st[m].w = __fmaf_rn(dec, st[m].w, __fmul_rn(dtt, __fmul_rn(xp[m], bq.w)));
    }
  };
  // the warps' column partials of steps 0 .. nst - 1, summed in order
  auto col_sum = [&](int s, int j) {
    float acc = scol[s * warps * NC + j];
    for (int w = 1; w < warps; ++w) {
      acc = __fadd_rn(acc, scol[(s * warps + w) * NC + j]);
    }
    return acc;
  };
  float4* my_ckpt = ckpt + (size_t)blockIdx.x * chunks * RT * threads + tid;

  // forward sweep: checkpoints, dc's per-head partials
  float4 st[RT];
#pragma unroll
  for (int m = 0; m < RT; ++m) st[m] = make_float4(0.f, 0.f, 0.f, 0.f);
  issue(0);
  for (int c = 0; c < chunks; ++c) {
    const int t0 = c * ch, nst = min(ch, tlen - t0);
    land(c, consume());   // chunk c landed; chunk c - 1's reads are done,
                          // so its buffer takes c + 1 while c runs
    if (c + 1 < chunks) issue(c + 1);
#pragma unroll
    for (int m = 0; m < RT; ++m) {
      my_ckpt[((size_t)c * RT + m) * threads] = st[m];
    }
    auto run = [&](int s0, auto tail) {
      constexpr bool TAIL = decltype(tail)::value;
      float cs[RUN * 4];
#pragma unroll
      for (int u = 0; u < RUN; ++u) {
        const int s = s0 + u;
        float4 col = make_float4(0.f, 0.f, 0.f, 0.f);
        if (!TAIL || s < nst) {
          update(st, s);
          float dyp[RT];
          load_rows<RT>(dyp, fdy + s * p + i0);
          col = make_float4(__fmul_rn(st[0].x, dyp[0]),
                            __fmul_rn(st[0].y, dyp[0]),
                            __fmul_rn(st[0].z, dyp[0]),
                            __fmul_rn(st[0].w, dyp[0]));
#pragma unroll
          for (int m = 1; m < RT; ++m) {
            col.x = __fmaf_rn(st[m].x, dyp[m], col.x);
            col.y = __fmaf_rn(st[m].y, dyp[m], col.y);
            col.z = __fmaf_rn(st[m].z, dyp[m], col.z);
            col.w = __fmaf_rn(st[m].w, dyp[m], col.w);
          }
        }
        cs[4 * u] = col.x;
        cs[4 * u + 1] = col.y;
        cs[4 * u + 2] = col.z;
        cs[4 * u + 3] = col.w;
      }
      scan_bwd::flush<RUN * 4, 4, GROUPS, LN>(
          cs, lane, [&](int u, int k, float v) {
            if (!TAIL || s0 + u < nst) {
              scol[((s0 + u) * warps + warp) * NC + j0 + k] = v;
            }
          });
    };
    int s0 = 0;
    for (; s0 + RUN <= nst; s0 += RUN) run(s0, std::false_type{});
    if (s0 < nst) run(s0, std::true_type{});
    __syncthreads();
    for (int e = tid; e < nst * NC; e += threads) {   // whole tile rows
      const int s = e / NC, j = e - s * NC;
      dc_part[(((size_t)b * tlen + t0 + s) * nh + h) * n + ct * NC + j] =
          col_sum(s, j);
    }
  }
  __syncthreads();   // the forward's reads are done before its buffers refill

  // reverse sweep: G in registers (`carry` = decay_{t+1} G_{t+1}), each
  // chunk's states recomputed
  float4 carry[RT];
#pragma unroll
  for (int m = 0; m < RT; ++m) carry[m] = make_float4(0.f, 0.f, 0.f, 0.f);
  // the next chunk's checkpoint, loaded a chunk ahead (not in the WAVE
  // body, whose capped registers would spill)
  float4 nxt[RT];
  if constexpr (!WAVE) {
#pragma unroll
    for (int m = 0; m < RT; ++m) {
      nxt[m] = my_ckpt[((size_t)(chunks - 1) * RT + m) * threads];
    }
  }
  issue(chunks - 1);
  for (int c = chunks - 1; c >= 0; --c) {
    const int t0 = c * ch, nst = min(ch, tlen - t0);
    land(c, consume());
#pragma unroll
    for (int m = 0; m < RT; ++m) {
      st[m] = WAVE ? my_ckpt[((size_t)c * RT + m) * threads] : nxt[m];
    }
    for (int s = 0; s < nst; ++s) {      // sst[s] = h_{t0 + s - 1}
#pragma unroll
      for (int m = 0; m < RT; ++m) sst[(s * RT + m) * threads + tid] = st[m];
      update(st, s);
    }
    if (c > 0) {   // after the recompute, which they would delay
      issue(c - 1);
      if constexpr (!WAVE) {
#pragma unroll
        for (int m = 0; m < RT; ++m) {
          nxt[m] = my_ckpt[((size_t)(c - 1) * RT + m) * threads];
        }
      }
    }
    // steps s0 + RUN - 1 down to s0; those below 0 are absent (TAIL)
    auto run = [&](int s0, auto tail) {
      constexpr bool TAIL = decltype(tail)::value;
      // per step: each row's G b (lanes), each column's G x (row groups),
      // and the lane's q, s and x·dy terms (the warp)
      float gs[RUN * RT], cs[RUN * 4], sc[RUN * 4];
#pragma unroll
      for (int u = RUN - 1; u >= 0; --u) {
        const int s = s0 + u;
        float4 col = make_float4(0.f, 0.f, 0.f, 0.f);
        float qacc = 0.f, sacc = 0.f, xacc = 0.f;
#pragma unroll
        for (int m = 0; m < RT; ++m) gs[u * RT + m] = 0.f;
        if (!TAIL || s >= 0) {
          const float4 bq = *reinterpret_cast<const float4*>(fb + s * NC + j0);
          const float4 cq = *reinterpret_cast<const float4*>(fc + s * NC + j0);
          float xp[RT], dyp[RT];
          load_rows<RT>(xp, fx + s * p + i0);
          load_rows<RT>(dyp, fdy + s * p + i0);
          const float dec = sdec[s];
#pragma unroll
          for (int m = 0; m < RT; ++m) {
            float4 g;                               // G_t
            g.x = __fmaf_rn(dyp[m], cq.x, carry[m].x);
            g.y = __fmaf_rn(dyp[m], cq.y, carry[m].y);
            g.z = __fmaf_rn(dyp[m], cq.z, carry[m].z);
            g.w = __fmaf_rn(dyp[m], cq.w, carry[m].w);
            gs[u * RT + m] = dot4(g, bq);
            const float hq = dot4(g, sst[(s * RT + m) * threads + tid]);
            qacc = m == 0 ? hq : __fadd_rn(qacc, hq);
            if (m == 0) {
              col = make_float4(__fmul_rn(g.x, xp[0]), __fmul_rn(g.y, xp[0]),
                                __fmul_rn(g.z, xp[0]), __fmul_rn(g.w, xp[0]));
            } else {
              col.x = __fmaf_rn(g.x, xp[m], col.x);
              col.y = __fmaf_rn(g.y, xp[m], col.y);
              col.z = __fmaf_rn(g.z, xp[m], col.z);
              col.w = __fmaf_rn(g.w, xp[m], col.w);
            }
            carry[m] = make_float4(__fmul_rn(dec, g.x), __fmul_rn(dec, g.y),
                                   __fmul_rn(dec, g.z), __fmul_rn(dec, g.w));
            sacc = m == 0 ? __fmul_rn(xp[0], gs[u * RT])
                          : __fmaf_rn(xp[m], gs[u * RT + m], sacc);
            xacc = m == 0 ? __fmul_rn(xp[0], dyp[0])
                          : __fmaf_rn(xp[m], dyp[m], xacc);
          }
          if (j0 != 0) xacc = 0.f;   // one lane a row group
        }
        sc[4 * u] = qacc;
        sc[4 * u + 1] = sacc;
        sc[4 * u + 2] = xacc;
        sc[4 * u + 3] = 0.f;
        cs[4 * u] = col.x;
        cs[4 * u + 1] = col.y;
        cs[4 * u + 2] = col.z;
        cs[4 * u + 3] = col.w;
      }
      scan_bwd::flush<RUN * RT, RT, LN, 1>(
          gs, lane, [&](int u, int m, float v) {
            if (!TAIL || s0 + u >= 0) sgb[(s0 + u) * p + i0 + m] = v;
          });
      scan_bwd::flush<RUN * 4, 4, 32, 1>(sc, lane, [&](int u, int k, float v) {
        if (!TAIL || s0 + u >= 0) ssc[((s0 + u) * warps + warp) * 4 + k] = v;
      });
      scan_bwd::flush<RUN * 4, 4, GROUPS, LN>(
          cs, lane, [&](int u, int k, float v) {
            if (!TAIL || s0 + u >= 0) {
              scol[((s0 + u) * warps + warp) * NC + j0 + k] = v;
            }
          });
    };
    int hi = nst;
    for (; hi >= RUN; hi -= RUN) run(hi - RUN, std::false_type{});
    if (hi > 0) run(hi - RUN, std::true_type{});
    __syncthreads();
    for (int e = tid; e < nst * NC; e += threads) {   // db: whole tile rows
      const int s = e / NC, j = e - s * NC;
      db_part[(((size_t)b * tlen + t0 + s) * nh + h) * n + ct * NC + j] =
          __fmul_rn(fdt[s], col_sum(s, j));
    }
    for (int e = tid; e < nst * p; e += threads) {    // dx: whole rows of P
      const int s = e / p, i = e - s * p;
      const size_t row = ((size_t)b * tlen + t0 + s) * nh + h;
      dx_part[((size_t)ct * rows + row) * p + i] =
          ct == 0 ? __fmaf_rn(fdt[s], sgb[e], __fmul_rn(dh, fdy[e]))
                  : __fmul_rn(fdt[s], sgb[e]);
    }
    for (int s = tid; s < nst; s += threads) {         // warps in order
      float v[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        v[k] = ssc[s * warps * 4 + k];
        for (int w = 1; w < warps; ++w) {
          v[k] = __fadd_rn(v[k], ssc[(s * warps + w) * 4 + k]);
        }
      }
      const size_t row = ((size_t)b * tlen + t0 + s) * nh + h;
      q_part[(size_t)ct * rows + row] = v[0];
      s_part[(size_t)ct * rows + row] = v[1];
      if (ct == 0) xdy[row] = v[2];
    }
  }
}

// dx: the tiles' partials summed in order; db, dc (B, T, N): the heads'
// partials summed in order; ddt and dt·q of each (b, t, h) from the tiles'
// q and s partials summed in order.
__global__ void ssd_bwd_reduce(const float* __restrict__ dx_part,
                               const float* __restrict__ db_part,
                               const float* __restrict__ dc_part,
                               const float* __restrict__ q_part,
                               const float* __restrict__ s_part,
                               const float* __restrict__ dt,
                               const float* __restrict__ a,
                               float* __restrict__ dx, float* __restrict__ db,
                               float* __restrict__ dc,
                               float* __restrict__ ddt,
                               float* __restrict__ dterm, int bsz, int tlen,
                               int nh, int p, int n, int tiles) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long rows = (long long)bsz * tlen * nh;
  if (e < rows * p) {
    float acc = dx_part[e];
    for (int t = 1; t < tiles; ++t) {
      acc = __fadd_rn(acc, dx_part[(size_t)t * rows * p + e]);
    }
    dx[e] = acc;
  }
  if (e < (long long)bsz * tlen * n) {
    const long long bt = e / n, j = e - bt * n;
    float sb = db_part[(size_t)bt * nh * n + j];
    float sc = dc_part[(size_t)bt * nh * n + j];
    for (int h = 1; h < nh; ++h) {
      const size_t at = ((size_t)bt * nh + h) * n + j;
      sb = __fadd_rn(sb, db_part[at]);
      sc = __fadd_rn(sc, dc_part[at]);
    }
    db[e] = sb;
    dc[e] = sc;
  }
  if (e < rows) {
    float qs = q_part[e], ss = s_part[e];
    for (int t = 1; t < tiles; ++t) {
      qs = __fadd_rn(qs, q_part[(size_t)t * rows + e]);
      ss = __fadd_rn(ss, s_part[(size_t)t * rows + e]);
    }
    const float ah = a[e % nh], dtt = dt[e];
    const float q = __fmul_rn(expf(__fmul_rn(ah, dtt)), qs);
    ddt[e] = __fmaf_rn(ah, q, ss);
    dterm[e] = __fmul_rn(dtt, q);
  }
}

// da, dd (H,): each head's dt·q and x·dy over the B·T steps in a fixed
// order: thread k sums steps k, k + 256, ... in order, then a fixed tree.
__global__ void ssd_bwd_heads(const float* __restrict__ dterm,
                              const float* __restrict__ xdy,
                              float* __restrict__ da, float* __restrict__ dd,
                              int steps, int nh) {
  __shared__ float sa[256], sd[256];
  const int h = blockIdx.x, tid = threadIdx.x;
  float va = 0.f, vd = 0.f;
  for (int r = tid; r < steps; r += 256) {
    va = __fadd_rn(va, dterm[(size_t)r * nh + h]);
    vd = __fadd_rn(vd, xdy[(size_t)r * nh + h]);
  }
  sa[tid] = va;
  sd[tid] = vd;
  __syncthreads();
  for (int off = 128; off > 0; off /= 2) {
    if (tid < off) {
      sa[tid] = __fadd_rn(sa[tid], sa[tid + off]);
      sd[tid] = __fadd_rn(sd[tid], sd[tid + off]);
    }
    __syncthreads();
  }
  if (tid == 0) {
    da[h] = sa[0];
    dd[h] = sd[0];
  }
}

struct Bufs {
  const void *x, *bm, *cm, *dt, *a, *d, *dy;
  void *ckpt, *dx_part, *db_part, *dc_part, *q_part, *s_part, *xdy, *dterm;
  void *dx, *db, *dc, *ddt, *da, *dd;
};

template <typename T, int LN, int RT, bool WAVE>
int launch_tile(const Bufs& v, int bsz, int t, int h, int p, int n, int ch,
                cudaStream_t stream) {
  constexpr int NC = 4 * LN;
  const int threads = p / RT * LN, tiles = n / NC;
  const int smem = smem_floats(ch, p, NC, threads / 32, sizeof(T)) * 4;
  if (threads % 32 != 0 || threads > MAX_THREADS || n % NC != 0 ||
      smem > scan_bwd::MAX_SMEM) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static const cudaError_t attr = cudaFuncSetAttribute(
      ssd_bwd_kernel<T, LN, RT, WAVE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, scan_bwd::MAX_SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  ssd_bwd_kernel<T, LN, RT, WAVE><<<bsz * h * tiles, threads, smem, stream>>>(
      static_cast<const T*>(v.x), static_cast<const T*>(v.bm),
      static_cast<const T*>(v.cm), static_cast<const float*>(v.dt),
      static_cast<const float*>(v.a), static_cast<const float*>(v.d),
      static_cast<const T*>(v.dy), static_cast<float4*>(v.ckpt),
      static_cast<float*>(v.dx_part), static_cast<float*>(v.db_part),
      static_cast<float*>(v.dc_part), static_cast<float*>(v.q_part),
      static_cast<float*>(v.s_part), static_cast<float*>(v.xdy), bsz, t, h, p,
      n, ch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows = (long long)bsz * t * h;
  const long long work = rows * p > (long long)bsz * t * n
                             ? rows * p : (long long)bsz * t * n;
  ssd_bwd_reduce<<<static_cast<unsigned>((work + 255) / 256), 256, 0,
                   stream>>>(
      static_cast<const float*>(v.dx_part),
      static_cast<const float*>(v.db_part),
      static_cast<const float*>(v.dc_part),
      static_cast<const float*>(v.q_part),
      static_cast<const float*>(v.s_part), static_cast<const float*>(v.dt),
      static_cast<const float*>(v.a), static_cast<float*>(v.dx),
      static_cast<float*>(v.db), static_cast<float*>(v.dc),
      static_cast<float*>(v.ddt), static_cast<float*>(v.dterm), bsz, t, h, p,
      n, tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_heads<<<h, 256, 0, stream>>>(
      static_cast<const float*>(v.dterm), static_cast<const float*>(v.xdy),
      static_cast<float*>(v.da), static_cast<float*>(v.dd), bsz * t, h);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const Bufs& v, int bsz, int t, int h, int p, int n, int lanes,
           int rt, int wave, int ch, void* stream) {
  if (p % 16 != 0 || n % 16 != 0 || p < 16 || p > MAX_P || n < 16 ||
      n > MAX_N || ch < 1 || t < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (bsz * h == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  // 2 rows a lane only at 4 lanes a row and P = 16, never a full wave
#define REPRO_SSD_BWD_TILE(L, R, W)                                \
  if (lanes == L && rt == R && (wave != 0) == W)                   \
    return launch_tile<T, L, R, W>(v, bsz, t, h, p, n, ch, s);
  REPRO_SSD_BWD_TILE(8, 4, true)
  REPRO_SSD_BWD_TILE(8, 4, false)
  REPRO_SSD_BWD_TILE(4, 4, true)
  REPRO_SSD_BWD_TILE(4, 4, false)
  REPRO_SSD_BWD_TILE(4, 2, false)
#undef REPRO_SSD_BWD_TILE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

#define REPRO_SSD_BWD_ENTRY(NAME, T)                                          \
  extern "C" int NAME(const void* x, const void* b, const void* c,            \
                      const void* dt, const void* a, const void* d,           \
                      const void* dy, void* ckpt, void* dx_part,              \
                      void* db_part, void* dc_part, void* q_part,             \
                      void* s_part, void* xdy, void* dterm, void* dx,         \
                      void* db, void* dc, void* ddt, void* da, void* dd,      \
                      int bsz, int t, int h, int p, int n, int lanes, int rt, \
                      int wave, int chunk, void* stream) {                    \
    const Bufs v{x,      b,       c,       dt,     a,      d,     dy,         \
                 ckpt,   dx_part, db_part, dc_part, q_part, s_part, xdy,      \
                 dterm,  dx,      db,      dc,     ddt,    da,    dd};        \
    return launch<T>(v, bsz, t, h, p, n, lanes, rt, wave, chunk, stream);    \
  }
REPRO_SSD_BWD_ENTRY(mamba2_ssd_bwd_bf16, __nv_bfloat16)
REPRO_SSD_BWD_ENTRY(mamba2_ssd_bwd_f32, float)
#undef REPRO_SSD_BWD_ENTRY

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
