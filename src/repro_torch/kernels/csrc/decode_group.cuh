// The ROUTE-group decode loop ("group") of mla_decode.cu and
// sparse_select.cu: 64 query rows a block over 256-row cache tiles.
//
// Why this tiling. A score is one FMA chain over the D columns of its
// query row and cache row (the cuBLAS order of the plain version, which
// holds the kernel to 1e-5; see mla_decode.cu), and PV one chain over the
// tile's rows in s order. Shared memory hands an SM's warps 32 floats a
// clock and the FMA pipes take 128, so a loop keeps the pipes fed only
// near 4 FMAs for each float a lane loads from shared memory. A lane whose
// micro-tile is RI rows x CJ columns loads RI + CJ floats a column for
// RI CJ FMAs: 8 x 4 gives 2.67, 8 x 8 gives 4. 8 warps of 32 lanes at
// 8 x 8 cover 16 384 scores a step, so the tile is 64 query rows x 256
// cache rows: the warps 2 x 4 over the scores, a warp 32 rows x 64
// columns, its lanes 4 x 8 as in an SGEMM (a load fetches 4 or 8 distinct
// 16-byte runs that the other lanes share). PV keeps a lane's 8 rows and
// takes 16 output columns (8 + 16 floats for 128 FMAs, 5.33).
//
// What the tile costs. P of a (64, 256) tile is 64 KB of shared memory,
// which leaves no room for the block's (64, d_v) f32 output tile (128 KB)
// beside the operand ring: the running output lives in its own rows of the
// output slab (o, or the span's partial), read back before a tile's PV and
// written after it by the lane that owns it (L2 holds it between tiles).
// Neither a 256-row tile of the cache at full D nor a resident (64, D) Q
// tile fits either, so both operands stream, as in a GEMM, through a ring
// of STAGES stages filled with cp.async two chunks ahead of use, in the
// cache's own element type T (attend.cuh): a stage holds a K chunk (the
// tile's 256 rows x KC columns) with its Q chunk (the block's 64 query
// rows x the same columns, f32), or a V chunk (VR whole value rows: 16 in
// f32, 32 in 16 bits). Both chunks' rows are padded 16 bytes, so that
// consecutive rows' 16-byte runs fall on distinct banks. Each cache row is
// read twice from L2 (its K columns, then its V columns) and Q once a
// tile, per block.
//
// Per tile, warp (wr, wc) owns query rows [WROWS wr, WROWS (wr + 1)):
// * Scores, over the tile's K chunks: lane (lr, lc) owns rows lr + SLR i
//   of the warp's block and tile columns BS / WC wc + lc + SLC j; each
//   score is one FMA chain over c = 0, 1, 2, ... in order, multiplied by
//   `scale` after the chain, as in decode_tiled.cuh and attend.cuh.
// * Online softmax: each row's maximum over the tile is a butterfly over
//   the SLC lanes of its warp, then over the WC warps of its row block
//   through shared memory (one barrier); every lane keeps the rows' running
//   maximum and its warp's share of l, summed over the WC warps at the
//   end. P goes to shared memory, lane (lr, *)'s RI rows contiguous. The
//   -inf pin of attend.cuh holds: a row with nothing to attend returns the
//   identity (o = 0, m = -inf, l = 0).
// * PV, over the tile's V chunks: lane (lr, lc) owns the same rows and
//   columns MAX_DV / WC wc + 4 lc + 4 SLC k (k < PK), accumulators read
//   from the output slab and rescaled by its rows' alpha, summed in s
//   order, and written back; the end divides them by l in place.
// The chunk copies are a fixed set of 16-byte units a thread, with no
// branch, since the issue code runs once a chunk in every thread. A
// position that holds no row (past the span's end, or a table entry of
// -1) is zero-filled and scores -inf, so its weight is 0.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include <type_traits>

#include "attend.cuh"
#include "decode_tiled.cuh"

namespace group {

constexpr int ROWS = 64;                  // query rows a block
constexpr int BS = 256;                   // cache rows a tile
constexpr int KC = 32;                    // columns of a K (and Q) chunk
constexpr int VB = 32768;                 // bytes of a V chunk
constexpr int STAGES = 3;                 // the ring's stages
constexpr int MAX_DV = tiled::MAX_DV;
constexpr int QPB = KC * 4 + 16;          // Q chunk row pitch, bytes

// WARPS warps, WR x WC over the (ROWS, BS) scores and the (ROWS, MAX_DV)
// output; a warp's lanes SLR x SLC.
template <int WARPS_, int WR_, int SLR_>
struct Shape {
  static constexpr int WARPS = WARPS_, THREADS = 32 * WARPS_;
  static constexpr int WR = WR_, WC = WARPS_ / WR_, WROWS = ROWS / WR_;
  static constexpr int SLR = SLR_, SLC = 32 / SLR_;
  static constexpr int RI = WROWS / SLR;             // a lane's rows
  static constexpr int CJ = BS / WC / SLC;           // its score columns
  static constexpr int PK = MAX_DV / WC / (4 * SLC); // its PV float4s
  static_assert(WARPS % WR == 0 && ROWS % WR == 0 && WROWS % SLR == 0 &&
                RI % 4 == 0 && BS % (WC * SLC) == 0 &&
                MAX_DV % (WC * 4 * SLC) == 0, "lanes tile the block");
};
using Wide = Shape<8, 2, 4>;             // a lane 8 x 8 scores, 8 x 16 PV

// The chunks of a T cache. A stage holds a K chunk (BS rows x KC columns)
// and its Q chunk (ROWS rows x KC f32), rows padded 16 bytes, or a V chunk
// (VR rows x MAX_DV).
template <class T>
struct Chunks {
  static constexpr int KPB = KC * (int)sizeof(T) + 16;   // K row pitch
  static constexpr int K_BYTES = BS * KPB;
  static constexpr int Q_BYTES = ROWS * QPB;
  static constexpr int VR = VB / (MAX_DV * (int)sizeof(T));
  static constexpr int STAGE =
      K_BYTES + Q_BYTES > VB ? K_BYTES + Q_BYTES : VB;
};

// Dynamic shared memory of attend_group over a T cache: P, the row maxima
// of the WC warps, the ring; a gathered span adds the row tables of two
// tiles.
template <class Sh, class T>
inline int smem_bytes(bool table) {
  return (int)((BS * ROWS + Sh::WC * ROWS) * sizeof(float)
               + STAGES * Chunks<T>::STAGE
               + (table ? 2 * BS * sizeof(int) : 0));
}

// Attend query rows [r0, r0 + ROWS) of qb (row stride q_r) over span
// positions [s_begin, s_end), cache rows from cb (row stride c_r, in
// elements of T) through `rows`. Writes o (R-row slab at out_base, d_v
// columns, d_v % 4 == 0 and a whole number of 16-byte units), m and l.
// The chunk schedule: tile t's NK K chunks, then its NV V chunks, chunk g
// of the span copied STAGES - 1 chunks ahead of its use.
template <class Sh, class T, class Rows, class Clk>
__device__ __forceinline__ void attend_group(
    const float* __restrict__ qb, long q_r, const T* __restrict__ cb,
    long c_r, int R, int r0, int D, int d_v, float scale, int s_begin,
    int s_end, Rows rows, float* o, float* __restrict__ m_out,
    float* __restrict__ l_out, long out_base, Clk& clk) {
  using C = Chunks<T>;
  constexpr int THREADS = Sh::THREADS, RI = Sh::RI, CJ = Sh::CJ;
  constexpr int SLR = Sh::SLR, SLC = Sh::SLC, PK = Sh::PK, WC = Sh::WC;
  constexpr int PER16 = 16 / sizeof(T);
  constexpr int KU = KC / PER16;          // 16-byte units of a K chunk row
  constexpr int KPE = C::KPB / sizeof(T); // the K chunk's pitch in elements
  constexpr int QU = KC / 4;              // 16-byte units of a Q chunk row
  constexpr int QPF = QPB / 4;            // the Q chunk's pitch in floats
  constexpr int VR = C::VR;               // rows of a V chunk
  constexpr int UV = MAX_DV / PER16;      // 16-byte units of a V row
  constexpr int NV = BS / VR;             // V chunks a tile
  constexpr int SB = C::STAGE;
  const int NK = (D + KC - 1) / KC;       // K chunks a tile
  const int NST = NK + NV;                // chunks a tile
  extern __shared__ __align__(16) float smem[];
  float* ps = smem;                                   // (BS, ROWS)
  float* red = ps + BS * ROWS;                        // (WC, ROWS)
  char* ring = reinterpret_cast<char*>(red + WC * ROWS);
  int* tab = reinterpret_cast<int*>(ring + STAGES * SB);  // kTable: (2, BS)

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wr = warp / WC, wc = warp % WC;
  const int lr = lane / SLC, lc = lane % SLC;
  const int row0 = wr * Sh::WROWS + lr;   // the lane's rows: row0 + SLR i
  const int prow = wr * Sh::WROWS + RI * lr;  // their run in P
  const int scol = wc * (BS / WC) + lc;   // its score columns: + SLC j
  const int vcol = wc * (MAX_DV / WC) + 4 * lc;  // its PV columns: + 4 SLC k
  // the lane's output float4 k of row i, and whether the row is one of R
  auto out_at = [&](int i, int k) {
    return o + (out_base + r0 + row0 + SLR * i) * d_v + vcol + 4 * SLC * k;
  };
  auto row_ok = [&](int i) { return r0 + row0 + SLR * i < R; };
  const int n_tiles = s_begin < s_end ? (s_end - s_begin + BS - 1) / BS : 0;
  const int G = n_tiles * NST;            // chunks of the span

  // The cache row of tile position s of tile t, or -1.
  auto row_of = [&](int t, int s) {
    if constexpr (Rows::kTable) {
      return tab[(t & 1) * BS + s];
    } else {
      const int p = s_begin + t * BS + s;
      return p < s_end ? p : -1;
    }
  };
  // Copy chunk k of tile t into stage `st`: whole 16-byte units, a fixed
  // number a thread.
  constexpr int K_UNITS = BS * KU, Q_UNITS = ROWS * QU;
  constexpr int V_UNITS = VR * UV;
  static_assert(K_UNITS % THREADS == 0 && Q_UNITS % THREADS == 0 &&
                V_UNITS % THREADS == 0 && THREADS % KU == 0 &&
                THREADS % QU == 0 && THREADS % UV == 0,
                "copies split evenly, a thread's unit fixed");
  // a thread's fixed unit of each copy: K row tid / KU + n (THREADS / KU)
  // at unit tid % KU, Q row tid / QU + ..., V row tid / UV + ...
  const int k_s = tid / KU, k_u = tid % KU, q_r0 = tid / QU, q_u = tid % QU;
  const int v_s = tid / UV, v_u = tid % UV;
  const bool v_col = v_u * PER16 < d_v;   // past d_v: zeros
  auto issue = [&](int t, int k, int st) {
    char* buf = ring + st * SB;
    if (k < NK) {                         // K: BS rows x KU units, then Q
      const int c = k * KC + k_u * PER16;
#pragma unroll
      for (int n = 0; n < K_UNITS / THREADS; ++n) {
        const int s = k_s + n * (THREADS / KU), r = row_of(t, s);
        const bool ok = r >= 0 && c < D;
        tiled::cp16(buf + s * C::KPB + k_u * 16,
                    cb + (long)(ok ? r : 0) * c_r + (ok ? c : 0), ok);
      }
      char* qbuf = buf + C::K_BYTES;      // Q: ROWS rows x QU units
      const int qc = k * KC + q_u * 4;
#pragma unroll
      for (int n = 0; n < Q_UNITS / THREADS; ++n) {
        const int r = q_r0 + n * (THREADS / QU);
        const bool ok = r0 + r < R && qc < D;  // rows past R stay zero
        tiled::cp16(qbuf + r * QPB + q_u * 16,
                    qb + (ok ? (long)(r0 + r) * q_r + qc : 0), ok);
      }
    } else {                              // V: VR rows x MAX_DV columns
      const int s_lo = (k - NK) * VR;
#pragma unroll
      for (int n = 0; n < V_UNITS / THREADS; ++n) {
        const int sl = v_s + n * (THREADS / UV), r = row_of(t, s_lo + sl);
        const bool ok = v_col && r >= 0;
        tiled::cp16(buf + sl * (MAX_DV * (int)sizeof(T)) + v_u * 16,
                    cb + (long)(ok ? r : 0) * c_r + (ok ? v_u * PER16 : 0),
                    ok);
      }
    }
  };

  // the prologue: the first STAGES - 1 chunks
  if (G > 0) {
    if constexpr (Rows::kTable) {
      for (int s = tid; s < BS; s += THREADS)
        tab[s] = s_begin + s < s_end ? rows(s_begin + s) : -1;
      __syncthreads();
    }
  }
#pragma unroll
  for (int g = 0; g < STAGES - 1; ++g) {
    if (g < G) issue(g / NST, g % NST, g);
    tiled::cp_commit();
  }
  int g = 0;                              // the chunk consumed next
  int it = (STAGES - 1) / NST, ik = (STAGES - 1) % NST;  // issued next
  // Wait for chunk g, issue chunk g + STAGES - 1: its stage was chunk
  // g - 1's, which every thread has consumed past the barrier.
  auto next_chunk = [&]() {
    tiled::cp_wait<STAGES - 2>();
    __syncthreads();
    clk.mark(stamp::WAIT);
    if (g + STAGES - 1 < G) issue(it, ik, (g + STAGES - 1) % STAGES);
    tiled::cp_commit();
    if (++ik == NST) { ++it; ik = 0; }
    return reinterpret_cast<const char*>(ring + (g++ % STAGES) * SB);
  };

  // the running maximum of the lane's rows, and its warp's share of l
  float m_run[RI], l_run[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m_run[i] = -CUDART_INF_F;
    l_run[i] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    // the scores of tile t, one FMA chain each over its K chunks
    float sc[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) sc[i][j] = 0.f;
    for (int k = 0; k < NK; ++k) {
      const char* buf = next_chunk();
      if constexpr (Rows::kTable) {
        // tile t + 1's rows into tile t - 1's half of tab: that tile's
        // last chunk was issued a tile ago, tile t + 1's first is issued
        // STAGES - 1 chunks before its use, past this tile's K chunks
        if (k == 0 && t + 1 < n_tiles)
          for (int s = tid; s < BS; s += THREADS) {
            const int p = s_begin + (t + 1) * BS + s;
            tab[((t + 1) & 1) * BS + s] = p < s_end ? rows(p) : -1;
          }
      }
      const T* kb = reinterpret_cast<const T*>(buf) + scol * KPE;
      const float* qw =
          reinterpret_cast<const float*>(buf + C::K_BYTES) + row0 * QPF;
      auto chain = [&](auto full) {       // the chunk's columns in order
        constexpr bool kFull = decltype(full)::value;
#pragma unroll
        for (int c = 0; c < KC; c += 4) {
          if (!kFull && k * KC + c >= D) break;
          float4 kv[CJ];
#pragma unroll
          for (int j = 0; j < CJ; ++j)
            kv[j] = attend::load4(kb + SLC * j * KPE + c);
#pragma unroll
          for (int i = 0; i < RI; ++i) {
            const float4 x =
                *reinterpret_cast<const float4*>(qw + SLR * i * QPF + c);
#pragma unroll
            for (int j = 0; j < CJ; ++j) {
              sc[i][j] = fmaf(x.x, kv[j].x, sc[i][j]);
              sc[i][j] = fmaf(x.y, kv[j].y, sc[i][j]);
              sc[i][j] = fmaf(x.z, kv[j].z, sc[i][j]);
              sc[i][j] = fmaf(x.w, kv[j].w, sc[i][j]);
            }
          }
        }
      };
      if ((k + 1) * KC <= D) chain(std::true_type{});
      else chain(std::false_type{});
      clk.mark(stamp::SCORES);
    }

    // the tile's online softmax: the rows' maxima across the WC warps,
    // P to shared memory, alpha a row
    float alpha[RI];
    {
      bool ok[CJ];
#pragma unroll
      for (int j = 0; j < CJ; ++j) ok[j] = row_of(t, scol + SLC * j) >= 0;
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        float mx = -CUDART_INF_F;
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          sc[i][j] = ok[j] ? sc[i][j] * scale : -CUDART_INF_F;
          mx = fmaxf(mx, sc[i][j]);
        }
#pragma unroll
        for (int off = 1; off < SLC; off <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        if (lc == 0) red[wc * ROWS + row0 + SLR * i] = mx;
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        float mx = red[row0 + SLR * i];
#pragma unroll
        for (int w = 1; w < WC; ++w)
          mx = fmaxf(mx, red[w * ROWS + row0 + SLR * i]);
        const float mn = fmaxf(m_run[i], mx);
        const float safe = isfinite(mn) ? mn : 0.f;
        alpha[i] = expf(m_run[i] - safe);
        float psum = 0.f;
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          sc[i][j] = expf(sc[i][j] - safe);
          psum += sc[i][j];
        }
#pragma unroll
        for (int off = 1; off < SLC; off <<= 1)
          psum += __shfl_xor_sync(0xffffffffu, psum, off);
        l_run[i] = l_run[i] * alpha[i] + psum;
        m_run[i] = mn;
      }
      // P[s][prow + i]: the lane's rows contiguous; read past the next
      // chunk's barrier
#pragma unroll
      for (int j = 0; j < CJ; ++j)
#pragma unroll
        for (int i = 0; i < RI; i += 4)
          *reinterpret_cast<float4*>(ps + (scol + SLC * j) * ROWS + prow + i)
              = make_float4(sc[i][j], sc[i + 1][j], sc[i + 2][j],
                            sc[i + 3][j]);
    }
    clk.mark(stamp::SOFTMAX);

    // PV: the lane's output rows from the output slab (zero before tile
    // 0; rows past R and columns past d_v stay zero), rescaled by alpha,
    // then summed in s order over the V chunks
    float acc[RI][4 * PK];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int k = 0; k < PK; ++k) {
        float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
        if (t > 0 && row_ok(i) && vcol + 4 * SLC * k < d_v)
          a = *reinterpret_cast<const float4*>(out_at(i, k));
        acc[i][4 * k] = a.x * alpha[i];
        acc[i][4 * k + 1] = a.y * alpha[i];
        acc[i][4 * k + 2] = a.z * alpha[i];
        acc[i][4 * k + 3] = a.w * alpha[i];
      }
    for (int v = 0; v < NV; ++v) {
      const T* vb = reinterpret_cast<const T*>(next_chunk()) + vcol;
      const float* pv = ps + v * VR * ROWS + prow;
#pragma unroll 4
      for (int sl = 0; sl < VR; ++sl) {
        float p[RI];
#pragma unroll
        for (int i = 0; i < RI; i += 4) {
          const float4 pp =
              *reinterpret_cast<const float4*>(pv + sl * ROWS + i);
          p[i] = pp.x;
          p[i + 1] = pp.y;
          p[i + 2] = pp.z;
          p[i + 3] = pp.w;
        }
        float4 vv[PK];
#pragma unroll
        for (int k = 0; k < PK; ++k)
          vv[k] = attend::load4(vb + sl * MAX_DV + 4 * SLC * k);
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int k = 0; k < PK; ++k) {
            acc[i][4 * k] = fmaf(p[i], vv[k].x, acc[i][4 * k]);
            acc[i][4 * k + 1] = fmaf(p[i], vv[k].y, acc[i][4 * k + 1]);
            acc[i][4 * k + 2] = fmaf(p[i], vv[k].z, acc[i][4 * k + 2]);
            acc[i][4 * k + 3] = fmaf(p[i], vv[k].w, acc[i][4 * k + 3]);
          }
      }
      clk.mark(stamp::PV);
    }
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int k = 0; k < PK; ++k)
        if (row_ok(i) && vcol + 4 * SLC * k < d_v)
          *reinterpret_cast<float4*>(out_at(i, k)) =
              make_float4(acc[i][4 * k], acc[i][4 * k + 1],
                          acc[i][4 * k + 2], acc[i][4 * k + 3]);
  }

  // l: the WC warps' shares of each row, summed in warp order (red is
  // free: every warp read the last tile's maxima before its V chunks)
#pragma unroll
  for (int i = 0; i < RI; ++i)
    if (lc == 0) red[wc * ROWS + row0 + SLR * i] = l_run[i];
  __syncthreads();
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    float l_i = red[row0 + SLR * i];
#pragma unroll
    for (int w = 1; w < WC; ++w) l_i += red[w * ROWS + row0 + SLR * i];
    const int r = r0 + row0 + SLR * i;
    if (r >= R) continue;
    const float denom = l_i > 0.f ? l_i : 1.f;
#pragma unroll
    for (int k = 0; k < PK; ++k) {
      const int c = vcol + 4 * SLC * k;
      if (c >= d_v) continue;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
      if (n_tiles > 0) a = *reinterpret_cast<const float4*>(out_at(i, k));
      *reinterpret_cast<float4*>(out_at(i, k)) =
          make_float4(a.x / denom, a.y / denom, a.z / denom, a.w / denom);
    }
    if (wc == 0 && lc == 0) {
      m_out[out_base + r] = m_run[i];
      l_out[out_base + r] = l_i;
    }
  }
}

}  // namespace group

