// The register-tiled f32 decode loop of mla_decode.cu at 32- and 16-row
// cache tiles ("group32", "tiled16"), the combine of split spans that every
// decode loop shares, the cp.async helpers, and the phase stamps of a
// measurement launch.
//
// attend_tiles: one block owns Sh::ROWS query rows, keeps their (ROWS, D)
// f32 tile resident in shared memory for its whole span of positions, and
// streams the span in (BS, D) cache tiles copied with cp.async in 16-byte
// units, in the cache's own element type T (attend.cuh: a bf16 tile takes
// half an f32 tile's room, each value becomes f32 where it is used). A
// `Rows` functor (attend.cuh) maps a span position to the cache row it
// reads: DenseRows (mla_decode) reads row s at position s; BlockRows
// (sparse_select) looks the row up in a block table. A gathered tile's rows
// are looked up once, one lane a row, into a table in shared memory while
// the previous tile's copies are in flight, so each tile row is still one
// contiguous run of 16-byte units. A position that holds no row (past the
// span, or a table entry of -1) is zero-filled and scores -inf. Per tile,
// three phases:
// * Scores, by the first SW warps. A thread owns an RI x CJ micro-tile:
//   rows srow + 8 i, columns scol + 4 j. Each score is one FMA chain over
//   c = 0, 1, 2, ... from 0, multiplied by `scale` after the chain: the
//   chain of attend.cuh (and of the cuBLAS product in the plain version at
//   the group shapes), so the scores are bit-identical to its. A warp's
//   8 row groups and 4 column groups read 8 consecutive Q rows and 4
//   consecutive K rows per 16-byte load, which the pitch of 16 mod 128
//   bytes keeps on distinct banks; but each such load still delivers 512
//   bytes to the warp's registers, 4 clocks of the SM's 128 bytes a clock,
//   so shared memory, not the FMA pipes, sets the pace unless a thread does
//   about 4 FMAs per float it loads: at a 32-row cache tile the 4 x 4
//   micro-tile (2 FMAs per float) in 4 of the 8 warps beats a 4 x 2 one in
//   all 8. (decode_group.cuh's 256-row tile does 4 in all 8.) The
//   scores go to shared memory transposed, P (BS, ROWS + 4).
// * Online softmax. Warp w owns rows [w RPW, (w + 1) RPW), 32 / RPW lanes
//   a row, all rows at once, with (m, l) in registers and attend.cuh's
//   -inf pin: a row with nothing to attend returns the identity (o = 0,
//   m = -inf, l = 0).
// * PV. The same warp owns the same rows for all d_v <= 512 columns, lane
//   j the columns 4 j + 128 k + u: per cache row RPW weights in broadcast
//   loads and 16 values in four loads that together read the V row once,
//   for RPW x 16 FMAs into RPW x 16 accumulators, rescaled by alpha first
//   and summed in s order (again attend.cuh's order). V is the first d_v
//   columns of the same cache tile, so each cache row is copied from L2
//   once per block.
//
// combine_spans: after every span's partial (o, m, l) is written and the
// grid synchronised, block (x, b, z) merges the rows of its own row tile
// over the n spans, for the columns of chunk z (d_v / n of them): every
// block reads about 1/n of the partials of its row tile, in an order fixed
// by slot, never by arrival, so two calls on the same inputs give the same
// bits.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include "attend.cuh"
#include "merge.cuh"

// Per-block phase stamps of a measurement launch (mla_decode.cu's
// mla_decode_stamped): thread 0 reads %globaltimer at the block's start
// and end and clock64 at each phase boundary, and adds each interval's
// cycles to its phase. A boundary after a barrier charges the slowest
// warp's lag to the phase before it. Clock<false> compiles to nothing.
namespace stamp {

enum Phase { WAIT, SCORES, SOFTMAX, PV, COMBINE, N_PHASE };
// a block's words: start ns, end ns, clock64 cycles in all, then by phase
constexpr int WORDS = 3 + N_PHASE;

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

template <bool kOn>
struct Clock {
  __device__ __forceinline__ void start() {}
  __device__ __forceinline__ void mark(int) {}
  __device__ __forceinline__ void finish(unsigned long long*) {}
};

template <>
struct Clock<true> {
  unsigned long long g0;
  long long c0, last, acc[N_PHASE];
  __device__ __forceinline__ void start() {
    if (threadIdx.x != 0) return;
    g0 = globaltimer();
    c0 = last = clock64();
#pragma unroll
    for (int i = 0; i < N_PHASE; ++i) acc[i] = 0;
  }
  __device__ __forceinline__ void mark(int phase) {
    if (threadIdx.x != 0) return;
    const long long now = clock64();
#pragma unroll
    for (int i = 0; i < N_PHASE; ++i)     // constant indices: registers
      if (i == phase) acc[i] += now - last;
    last = now;
  }
  __device__ __forceinline__ void finish(unsigned long long* out) {
    if (threadIdx.x != 0 || out == nullptr) return;
    const long blk = ((long)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x
                     + blockIdx.x;
    unsigned long long* w = out + blk * WORDS;
    w[0] = g0;
    w[1] = globaltimer();
    w[2] = (unsigned long long)(clock64() - c0);
#pragma unroll
    for (int i = 0; i < N_PHASE; ++i) w[3 + i] = (unsigned long long)acc[i];
  }
};

}  // namespace stamp

namespace tiled {

constexpr int MAX_DV = 512;               // 32 lanes x 16 PV columns

// ROWS query rows, BS cache rows per tile, WARPS warps (MIN_BLOCKS blocks
// an SM); the scores are computed by the first SW warps, each thread
// an RI x CJ micro-tile.
template <int ROWS_, int BS_, int WARPS_, int RI_, int CJ_, int MIN_BLOCKS_>
struct Shape {
  static constexpr int ROWS = ROWS_, BS = BS_, WARPS = WARPS_;
  static constexpr int THREADS = 32 * WARPS_, RI = RI_, CJ = CJ_;
  static constexpr int MIN_BLOCKS = MIN_BLOCKS_;
  static constexpr int WROWS = 8 * RI, WCOLS = 4 * CJ;   // a warp's scores
  static constexpr int WC = BS / WCOLS;   // score warps along the columns
  static constexpr int SW = ROWS / WROWS * WC;           // score warps
  static constexpr int RPW = ROWS / WARPS;  // softmax and PV rows of a warp
  static constexpr int PP = ROWS + 4;     // pitch of P: 16-byte row loads
  static_assert(ROWS % WROWS == 0 && BS % WCOLS == 0 && SW <= WARPS,
                "score tiles cover the tile");
  static_assert(32 % RPW == 0 && BS % (32 / RPW) == 0,
                "softmax lanes split each row's columns evenly");
};


// A small ROUTE group: 64 rows, 32-row cache tiles, 8 warps; 4 of them
// compute the scores in 4 x 4 micro-tiles.
using Group32 = Shape<64, 32, 8, 4, 4, 1>;
// A single request: 16 rows, 16-row cache tiles (so that its spans fill
// the card), 8 warps (so that the combine has many lanes), 4 of them
// computing the scores in 2 x 1 micro-tiles; one block an SM, as the plan
// fills it.
using Single = Shape<16, 16, 8, 2, 1, 1>;

// Dynamic shared memory of attend_tiles; a gathered span adds the row
// tables of two tiles (this one and the next).
template <class Sh, class T>
inline int smem_bytes(int D, bool table = false) {
  return (int)(Sh::ROWS * attend::pitch_of<float>(D) * sizeof(float)
               + Sh::BS * attend::pitch_of<T>(D) * sizeof(T)
               + Sh::BS * Sh::PP * sizeof(float)
               + (table ? 2 * Sh::BS * sizeof(int) : 0));
}

// Shared memory of combine_spans for `rows` rows over n spans.
inline int combine_smem_bytes(int rows, int n, int threads) {
  const int floats = (2 * rows * n + 3) / 4 * 4;
  return (int)((floats + 4 * threads) * sizeof(float));
}

// 16 bytes from src to shared dst, or 16 zero bytes where !valid.
__device__ __forceinline__ void cp16(void* dst, const void* src,
                                     bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's copy groups are in flight.
template <int N = 0>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// The scores of one tile, S = (Q K^T) * scale, into ps transposed, -inf
// at positions at or past s_end (kTable: at positions whose entry in the
// tile's row table tab is -1). Score warp w owns rows (w / WC) WROWS +
// lane % 8 + 8 i and columns (w % WC) WCOLS + lane / 8 + 4 j.
template <class Sh, class T, bool kTable>
__device__ __forceinline__ void scores(const float* qs, const T* ks,
                                       float* ps, int D, int DP, int KP,
                                       float scale, int s0, int s_end,
                                       const int* tab, int warp, int lane) {
  constexpr int RI = Sh::RI, CJ = Sh::CJ, PP = Sh::PP;
  const int srow = (warp / Sh::WC) * Sh::WROWS + lane % 8;
  const int scol = (warp % Sh::WC) * Sh::WCOLS + lane / 8;
  float sc[RI][CJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) sc[i][j] = 0.f;
  const float* qp = qs + srow * DP;
  const T* kp = ks + scol * KP;
  constexpr int UNROLL = RI * CJ >= 16 ? 2 : 4;   // loads ahead of the FMAs
#pragma unroll UNROLL
  for (int c = 0; c < D; c += 4) {
    float4 x[RI], k[CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
      x[i] = *reinterpret_cast<const float4*>(qp + 8 * i * DP + c);
#pragma unroll
    for (int j = 0; j < CJ; ++j) k[j] = attend::load4(kp + 4 * j * KP + c);
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        sc[i][j] = fmaf(x[i].x, k[j].x, sc[i][j]);
        sc[i][j] = fmaf(x[i].y, k[j].y, sc[i][j]);
        sc[i][j] = fmaf(x[i].z, k[j].z, sc[i][j]);
        sc[i][j] = fmaf(x[i].w, k[j].w, sc[i][j]);
      }
  }
#pragma unroll
  for (int j = 0; j < CJ; ++j) {
    const int col = scol + 4 * j;
    bool ok;
    if constexpr (kTable) ok = tab[col] >= 0;
    else ok = s0 + col < s_end;
#pragma unroll
    for (int i = 0; i < RI; ++i)
      ps[col * PP + srow + 8 * i] = ok ? sc[i][j] * scale : -CUDART_INF_F;
  }
}

// Attend query rows [r0, r0 + ROWS) of qb (row stride q_r) over span
// positions [s_begin, s_end), cache rows from cb (row stride c_r, in
// elements of T) through `rows`. Writes o (R-row slab at out_base, d_v
// columns, d_v % 4 == 0), m and l.
template <class Sh, class T, class Rows, class Clk>
__device__ __forceinline__ void attend_tiles(
    const float* __restrict__ qb, long q_r, const T* __restrict__ cb,
    long c_r, int R, int r0, int D, int d_v, float scale, int s_begin,
    int s_end, Rows rows, float* __restrict__ o, float* __restrict__ m_out,
    float* __restrict__ l_out, long out_base, Clk& clk) {
  constexpr int ROWS = Sh::ROWS, BS = Sh::BS, THREADS = Sh::THREADS;
  constexpr int RPW = Sh::RPW, PP = Sh::PP, PER16 = 16 / sizeof(T);
  const int DP = attend::pitch_of<float>(D), KP = attend::pitch_of<T>(D);
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                       // (ROWS, DP), resident
  T* ks = reinterpret_cast<T*>(qs + ROWS * DP);   // (BS, KP), a cache tile
  float* ps = reinterpret_cast<float*>(ks + BS * KP);  // (BS, PP): S, then P
  // kTable: (2, BS) cache rows of this tile and the next, -1 for none
  int* tab = reinterpret_cast<int*>(ps + BS * PP);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int D4 = D / 4, U = D / PER16;    // a row's float4s / 16-byte units
  // the Q copies complete with the first tile's (none for an empty span,
  // whose shared memory the combine may take over)
  for (int i = tid; s_begin < s_end && i < ROWS * D4; i += THREADS) {
    const int r = i / D4, c = (i % D4) * 4;
    const bool ok = r0 + r < R;           // rows past R stay zero
    tiled::cp16(qs + r * DP + c, ok ? qb + (long)(r0 + r) * q_r + c : qb,
                ok);
  }

  const int prow = warp * RPW;            // softmax / PV rows of this warp
  float acc[RPW][16];
  float m_own = -CUDART_INF_F, l_own = 0.f;   // of this lane's softmax row
#pragma unroll
  for (int i = 0; i < RPW; ++i)
#pragma unroll
    for (int k = 0; k < 16; ++k) acc[i][k] = 0.f;

  if constexpr (Rows::kTable) {          // the first tile's rows
    if (tid < BS && s_begin < s_end)
      tab[tid] = s_begin + tid < s_end ? rows(s_begin + tid) : -1;
  }
  int cur = 0;                            // kTable: this tile's half of tab

  for (int s0 = s_begin; s0 < s_end; s0 += BS) {
    __syncthreads();                      // the previous tile is consumed
    clk.mark(stamp::PV);
    const int* rows_s = tab + cur * BS;
    for (int i = tid; i < BS * U; i += THREADS) {
      const int s = i / U, c = (i % U) * PER16;
      if constexpr (Rows::kTable) {
        const int r = rows_s[s];
        cp16(ks + s * KP + c, r >= 0 ? cb + (long)r * c_r + c : cb, r >= 0);
      } else {
        const bool ok = s0 + s < s_end;
        cp16(ks + s * KP + c, ok ? cb + (long)(s0 + s) * c_r + c : cb, ok);
      }
    }
    cp_commit();
    if constexpr (Rows::kTable) {
      // the next tile's rows, looked up while this tile's copies fly; the
      // other half of tab was last read before this iteration's barrier
      const int t = s0 + BS + tid;
      if (tid < BS && s0 + BS < s_end)
        tab[(cur ^ 1) * BS + tid] = t < s_end ? rows(t) : -1;
    }
    cp_wait();
    __syncthreads();
    clk.mark(stamp::WAIT);

    if (warp < Sh::SW)
      scores<Sh, T, Rows::kTable>(qs, ks, ps, D, DP, KP, scale, s0, s_end,
                                  rows_s, warp, lane);
    __syncthreads();
    clk.mark(stamp::SCORES);

    // online softmax of this warp's RPW rows: LPR lanes a row, each taking
    // the columns part + LPR j in order, the LPR partial maxima and sums
    // meeting in a butterfly; (m, l) live in the row's lanes, and each
    // row's alpha is broadcast to the whole warp for PV
    float alpha[RPW];
    {
      constexpr int LPR = 32 / RPW, CPL = BS / LPR;
      const int ir = lane / LPR, part = lane % LPR, r = prow + ir;
      float v[CPL];
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        v[j] = ps[(part + LPR * j) * PP + r];
        mx = fmaxf(mx, v[j]);
      }
#pragma unroll
      for (int off = LPR / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m_own, mx);
      const float safe = isfinite(mn) ? mn : 0.f;
      const float al = expf(m_own - safe);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const float p = expf(v[j] - safe);
        ps[(part + LPR * j) * PP + r] = p;
        psum += p;
      }
#pragma unroll
      for (int off = LPR / 2; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l_own = l_own * al + psum;
      m_own = mn;
#pragma unroll
      for (int i = 0; i < RPW; ++i)
        alpha[i] = __shfl_sync(0xffffffffu, al, i * LPR);
    }
    __syncwarp();
    clk.mark(stamp::SOFTMAX);

    // acc = acc * alpha + P V, V = the first d_v columns of the same tile
#pragma unroll
    for (int i = 0; i < RPW; ++i)
#pragma unroll
      for (int k = 0; k < 16; ++k) acc[i][k] *= alpha[i];
#pragma unroll 4
    for (int s = 0; s < BS; ++s) {
      float p[RPW];
      if constexpr (RPW % 4 == 0) {
#pragma unroll
        for (int i4 = 0; i4 < RPW / 4; ++i4) {
          const float4 t =
              *reinterpret_cast<const float4*>(ps + s * PP + prow + 4 * i4);
          p[4 * i4] = t.x; p[4 * i4 + 1] = t.y;
          p[4 * i4 + 2] = t.z; p[4 * i4 + 3] = t.w;
        }
      } else {
#pragma unroll
        for (int i = 0; i < RPW; ++i) p[i] = ps[s * PP + prow + i];
      }
      float4 v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int c = 4 * lane + 128 * k;
        v[k] = c < d_v ? attend::load4(ks + s * KP + c)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int i = 0; i < RPW; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          acc[i][4 * k] = fmaf(p[i], v[k].x, acc[i][4 * k]);
          acc[i][4 * k + 1] = fmaf(p[i], v[k].y, acc[i][4 * k + 1]);
          acc[i][4 * k + 2] = fmaf(p[i], v[k].z, acc[i][4 * k + 2]);
          acc[i][4 * k + 3] = fmaf(p[i], v[k].w, acc[i][4 * k + 3]);
        }
    }
    cur ^= 1;
  }
  clk.mark(stamp::PV);

  float m_r[RPW], l_r[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    m_r[i] = __shfl_sync(0xffffffffu, m_own, i * (32 / RPW));
    l_r[i] = __shfl_sync(0xffffffffu, l_own, i * (32 / RPW));
  }
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = r0 + prow + i;
    if (r >= R) break;
    const float denom = l_r[i] > 0.f ? l_r[i] : 1.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = 4 * lane + 128 * k;
      if (c < d_v)
        *reinterpret_cast<float4*>(o + (out_base + r) * d_v + c) =
            make_float4(acc[i][4 * k] / denom, acc[i][4 * k + 1] / denom,
                        acc[i][4 * k + 2] / denom, acc[i][4 * k + 3] / denom);
    }
    if (lane == 0) {
      m_out[out_base + r] = m_r[i];
      l_out[out_base + r] = l_r[i];
    }
  }
}

// Lanes that share one row in combine_spans: a power of two <= 32, so
// they sit in one warp.
template <int THREADS>
__device__ __forceinline__ int row_lanes(int rows) {
  int p = 32;
  while (p > 1 && p * rows > THREADS) p >>= 1;
  return p;
}

// Merge rows [row0, row0 + rows) of the n span partials (o_part (n, n_rows,
// d_v), m_part and l_part (n, n_rows)) into o, m, l, for the columns of
// chunk z; the chunk-0 block also writes m and l. d_v % 4 == 0. The
// partials were written in this launch by other blocks, so they are read
// through the coherent path (no __restrict__, no read-only loads).
//
// m* = max m_i, w_i = l_i exp(m_i - m*), o* = sum_i (w_i / sum w) o_i
// (merge.cuh's arithmetic), each product and sum rounded alone, in a fixed
// order: lane p of a row's P lanes takes the slots i = p (mod P) in order
// and the P partial maxima and sums meet in a fixed butterfly; a column's
// sum takes its slots in order, split over tpi threads (slots i = q (mod
// tpi)) that then add up in order when the block has few (row, column)
// items. Memory latency bounds it, so loads go out BATCH at a time, and a
// thread of a few-item block loads its first BATCH partial values together
// with m and l.
template <int THREADS>
__device__ __forceinline__ void combine_spans(
    const float* o_part, const float* m_part, const float* l_part, int n,
    long n_rows, long row0, int rows, int d_v, int z, float* __restrict__ o,
    float* __restrict__ m, float* __restrict__ l) {
  constexpr int BATCH = 8;
  extern __shared__ __align__(16) float smem[];
  float* ms = smem;                       // (rows, n) m_i
  float* ws = ms + rows * n;              // (rows, n) l_i, w_i, w_i / sum w
  float4* red = reinterpret_cast<float4*>(smem + (2 * rows * n + 3) / 4 * 4);
  const int tid = threadIdx.x;
  const float4* o4 = reinterpret_cast<const float4*>(o_part);
  float4* out4 = reinterpret_cast<float4*>(o);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  // this block's columns: chunk z of ceil(d_v / 4 / n) 16-byte columns
  const int d4 = d_v / 4, per = (d4 + n - 1) / n;
  const int c_lo = z * per, nc = max(0, min(d4, c_lo + per) - c_lo);
  const int items = rows * nc;
  const bool few = 2 * items <= THREADS;
  const int tpi = few && items ? THREADS / items : 1;
  // a few-item thread's item and first slot: slots q, q + tpi, ...
  const bool mine = few && tid < items * tpi;
  const int f_row = mine ? tid / tpi / nc : 0;
  const int f_c = c_lo + (mine ? tid / tpi % nc : 0), q = tid % tpi;
  float4 pre[BATCH];
#pragma unroll
  for (int u = 0; u < BATCH; ++u)
    pre[u] = mine && q + u * tpi < n
                 ? o4[((long)(q + u * tpi) * n_rows + row0 + f_row) * d4 + f_c]
                 : zero;

  // the slot weights of each row
  const int P = row_lanes<THREADS>(rows);
  const int r = tid / P, p = tid % P;
  const bool active = r < rows;           // whole groups of P lanes
  float mx = -CUDART_INF_F;
  if (active)
    for (int i0 = p; i0 < n; i0 += BATCH * P) {
      float mv[BATCH], lv[BATCH];
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const long at = (long)(i0 + u * P) * n_rows + row0 + r;
        mv[u] = i0 + u * P < n ? m_part[at] : -CUDART_INF_F;
        lv[u] = i0 + u * P < n ? l_part[at] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < BATCH; ++u)
        if (i0 + u * P < n) {
          ms[r * n + i0 + u * P] = mv[u];
          ws[r * n + i0 + u * P] = lv[u];
          mx = fmaxf(mx, mv[u]);
        }
    }
  for (int off = P / 2; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  const float safe = isfinite(mx) ? mx : 0.f;
  float sw = 0.f;
  if (active)
    for (int i = p; i < n; i += P) {
      const float w = __fmul_rn(ws[r * n + i], expf(ms[r * n + i] - safe));
      ws[r * n + i] = w;
      sw = __fadd_rn(sw, w);
    }
  for (int off = P / 2; off > 0; off >>= 1)
    sw = __fadd_rn(sw, __shfl_xor_sync(0xffffffffu, sw, off));
  const float den = sw > 0.f ? sw : 1.f;
  if (active) {
    for (int i = p; i < n; i += P) ws[r * n + i] = __fdiv_rn(ws[r * n + i],
                                                             den);
    if (z == 0 && p == 0) {
      m[row0 + r] = sw > 0.f ? mx : -CUDART_INF_F;
      l[row0 + r] = sw;
    }
  }
  __syncthreads();
  if (items == 0) return;

  auto term = [&](int row, int i, float4 v) {
    const float w = ws[row * n + i];
    return make_float4(__fmul_rn(w, v.x), __fmul_rn(w, v.y),
                       __fmul_rn(w, v.z), __fmul_rn(w, v.w));
  };
  if (!few) {
    // items tid + j THREADS, each over every slot: the thread's (item,
    // slot) pairs in order
    const int nj = (items - tid + THREADS - 1) / THREADS;
    const int total = nj * n;
    float4 acc = zero;
    for (int f0 = 0; f0 < total; f0 += BATCH) {
      float4 v[BATCH];
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int f = f0 + u, t = tid + (f / n) * THREADS;
        v[u] = f < total ? o4[((long)(f % n) * n_rows + row0 + t / nc) * d4
                              + c_lo + t % nc]
                         : zero;
      }
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int f = f0 + u, t = tid + (f / n) * THREADS, i = f % n;
        if (f >= total) break;
        acc = add_rn(acc, term(t / nc, i, v[u]));
        if (i == n - 1) {
          out4[(row0 + t / nc) * d4 + c_lo + t % nc] = acc;
          acc = zero;
        }
      }
    }
    return;
  }
  float4 acc = zero;
  if (mine) {
#pragma unroll
    for (int u = 0; u < BATCH; ++u)
      if (q + u * tpi < n) acc = add_rn(acc, term(f_row, q + u * tpi, pre[u]));
    for (int i0 = q + BATCH * tpi; i0 < n; i0 += BATCH * tpi) {
      float4 v[BATCH];
#pragma unroll
      for (int u = 0; u < BATCH; ++u)
        v[u] = i0 + u * tpi < n
                   ? o4[((long)(i0 + u * tpi) * n_rows + row0 + f_row) * d4
                        + f_c]
                   : zero;
#pragma unroll
      for (int u = 0; u < BATCH; ++u)
        if (i0 + u * tpi < n)
          acc = add_rn(acc, term(f_row, i0 + u * tpi, v[u]));
    }
  }
  red[tid] = acc;
  __syncthreads();
  if (tid < items) {
    float4 t = red[tid * tpi];
    for (int k = 1; k < tpi; ++k) t = add_rn(t, red[tid * tpi + k]);
    out4[(row0 + tid / nc) * d4 + c_lo + tid % nc] = t;
  }
}

}  // namespace tiled
