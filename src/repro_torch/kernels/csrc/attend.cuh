// The 16-row attention tile loop ("attend16") of mla_decode.cu (a
// contiguous span of the cache) and sparse_select.cu (the cache rows that
// selected blocks cover), through decode_launch.cuh, and what every decode
// loop shares: the cache's element types, the row maps and the pitch.
//
// One block owns ROWS query rows and walks its span of positions in BS-row
// tiles, carrying the online-softmax state (m, l, acc) in registers. A
// `Rows` functor maps a span position to the cache row it reads, or to -1
// when the position holds no row (past the valid length, or a row of a
// selected tail block beyond the chunk); such positions score -inf and add
// nothing. Dense spans map position s to row s; gathered spans look their
// rows up once per tile into shared memory, so each tile row is still one
// contiguous run of D elements, read in 16-byte units.
//
// * The cache is read in its own type T (f32, bf16 or f16): a tile holds
//   the rows' raw bytes (a bf16 tile half an f32 one's room), and each
//   value becomes f32, exactly, where it is used, so the result is bit for
//   bit that of the f32 loop on the cache cast to f32. q is f32.
// * The (ROWS, D) query tile and each (BS, D) cache tile sit in shared
//   memory (~111 KB at D = 576 in f32, so two blocks fit on an SM). The PV
//   product reads the first d_v columns of the same cache tile: each cache
//   row is read from device memory once per block.
// * Scores: warp w owns rows 2w and 2w+1, lane j owns tile row j; 16-byte
//   shared loads with the row pitch padded to 16 mod 128 bytes keep the
//   lanes on distinct banks. Each score is one FMA chain in column order,
//   the order in which the plain version's cuBLAS product accumulates (four
//   interleaved partial sums doubled the disagreement at D = 576 and saved
//   no time). PV: thread t owns output columns t and t + 256 for all ROWS
//   rows (32 accumulators in registers).
// * A row with nothing to attend returns the merge identity (o = 0,
//   m = -inf, l = 0): the reference point of exp is pinned to 0 while the
//   running max is -inf, so no (-inf) - (-inf) arises.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace attend {

constexpr int ROWS = 16;                  // query rows per block
constexpr int BS = 32;                    // span positions per tile (= warp)
constexpr int THREADS = 256;              // 8 warps: 2 score rows each
constexpr int MAX_DV = 512;
constexpr int COLS = MAX_DV / THREADS;    // output columns per thread

// The cache's element types, each read as f32 where it is used.
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

// Four consecutive elements at p (16-byte aligned in f32, 8 in 16 bits).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}
__device__ __forceinline__ float4 load4(const __half* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&u.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Position s of the span reads cache row s.
struct DenseRows {
  static constexpr bool kTable = false;
  __device__ __forceinline__ int operator()(int s) const { return s; }
};

// Position t reads row idx[t / bt] * bt + t % bt of the block table `idx`;
// a negative block id, or a row at or past `len`, holds nothing.
struct BlockRows {
  static constexpr bool kTable = true;
  const int* idx;
  int bt;
  int len;
  __device__ __forceinline__ int operator()(int t) const {
    const int blk = __ldg(idx + t / bt);
    const long r = (long)blk * bt + t % bt;
    return (blk >= 0 && r < len) ? (int)r : -1;
  }
};

// The row pitch, in elements of T, of a shared tile of D columns: whole
// 16-byte units, 16 mod 128 bytes, so that 16-byte loads of 8 consecutive
// rows at one column fall on distinct banks.
template <class T>
__host__ __device__ constexpr int pitch_of(int D) {
  int dp = (D * (int)sizeof(T) + 15) / 16 * 16;
  while (dp % 128 != 16) dp += 16;
  return dp / (int)sizeof(T);
}

// Dynamic shared memory of one block; a gathered span adds its row table.
template <class T>
inline int smem_bytes(int D, bool table) {
  return (int)(ROWS * pitch_of<float>(D) * sizeof(float)
               + BS * pitch_of<T>(D) * sizeof(T)
               + (ROWS * BS + 2 * ROWS) * sizeof(float)
               + (table ? BS * sizeof(int) : 0));
}

// Attend query rows [r0, r0 + ROWS) of qb (row stride q_r) over span
// positions [s_begin, s_end), cache rows from cb (row stride c_r, in
// elements) through `rows`. Writes o (R-row slab at out_base, d_v
// columns), m and l.
template <class T, class Rows>
__device__ __forceinline__ void attend_span(
    const float* __restrict__ qb, long q_r, const T* __restrict__ cb,
    long c_r, int R, int r0, int D, int d_v, float scale, int s_begin,
    int s_end, Rows rows, float* __restrict__ o, float* __restrict__ m_out,
    float* __restrict__ l_out, long out_base) {
  constexpr int PER16 = 16 / sizeof(T);   // elements in a 16-byte unit
  const int DP = pitch_of<float>(D), KP = pitch_of<T>(D);
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                       // (ROWS, DP)
  T* ks = reinterpret_cast<T*>(qs + ROWS * DP);   // (BS, KP)
  float* ps = reinterpret_cast<float*>(ks + BS * KP);  // (ROWS, BS)
  float* alpha_s = ps + ROWS * BS;        // (ROWS,) rescale of this tile
  float* l_s = alpha_s + ROWS;            // (ROWS,) final denominators
  int* rows_s = reinterpret_cast<int*>(l_s + ROWS);  // (BS,) if kTable

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int D4 = D / 4, U = D / PER16;    // a row's float4s / 16-byte units

  // query tile -> shared (rows past R are zero and never written out)
  for (int i = tid; i < ROWS * D4; i += THREADS) {
    const int r = i / D4, c = (i % D4) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < R)
      v = __ldg(reinterpret_cast<const float4*>(qb + (r0 + r) * q_r + c));
    *reinterpret_cast<float4*>(qs + r * DP + c) = v;
  }

  const int ra = 2 * warp, rb = ra + 1;   // this warp's score rows
  float m_a = -CUDART_INF_F, m_b = -CUDART_INF_F;
  float l_a = 0.f, l_b = 0.f;
  float acc[ROWS][COLS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int j = 0; j < COLS; ++j) acc[r][j] = 0.f;

  for (int s0 = s_begin; s0 < s_end; s0 += BS) {
    __syncthreads();                      // previous tile fully consumed
    if constexpr (Rows::kTable) {
      if (tid < BS) rows_s[tid] = s0 + tid < s_end ? rows(s0 + tid) : -1;
      __syncthreads();
    }
    for (int i = tid; i < BS * U; i += THREADS) {
      const int s = i / U, u = i % U;
      int r;
      if constexpr (Rows::kTable) r = rows_s[s];
      else r = s0 + s < s_end ? rows(s0 + s) : -1;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r >= 0)
        v = __ldg(reinterpret_cast<const uint4*>(cb + (long)r * c_r) + u);
      *reinterpret_cast<uint4*>(ks + s * KP + u * PER16) = v;
    }
    __syncthreads();

    // scores of rows ra, rb against tile row `lane`, one FMA chain each
    float sa = 0.f, sb = 0.f;
    const T* kp = ks + lane * KP;
    const float* qa = qs + ra * DP;
    const float* qbp = qs + rb * DP;
    for (int c = 0; c < D; c += 4) {
      const float4 k = load4(kp + c);
      const float4 x = *reinterpret_cast<const float4*>(qa + c);
      const float4 y = *reinterpret_cast<const float4*>(qbp + c);
      sa = fmaf(x.x, k.x, sa); sa = fmaf(x.y, k.y, sa);
      sa = fmaf(x.z, k.z, sa); sa = fmaf(x.w, k.w, sa);
      sb = fmaf(y.x, k.x, sb); sb = fmaf(y.y, k.y, sb);
      sb = fmaf(y.z, k.z, sb); sb = fmaf(y.w, k.w, sb);
    }
    bool valid;
    if constexpr (Rows::kTable) valid = rows_s[lane] >= 0;
    else valid = s0 + lane < s_end;
    sa = valid ? sa * scale : -CUDART_INF_F;
    sb = valid ? sb * scale : -CUDART_INF_F;

    // online softmax for the two rows; every lane keeps the same (m, l)
    const float mna = fmaxf(m_a, warp_max(sa));
    const float mnb = fmaxf(m_b, warp_max(sb));
    const float safe_a = isfinite(mna) ? mna : 0.f;
    const float safe_b = isfinite(mnb) ? mnb : 0.f;
    const float alpha_a = expf(m_a - safe_a), alpha_b = expf(m_b - safe_b);
    const float pa = expf(sa - safe_a), pb = expf(sb - safe_b);
    l_a = l_a * alpha_a + warp_sum(pa);
    l_b = l_b * alpha_b + warp_sum(pb);
    m_a = mna; m_b = mnb;
    ps[ra * BS + lane] = pa;
    ps[rb * BS + lane] = pb;
    if (lane == 0) { alpha_s[ra] = alpha_a; alpha_s[rb] = alpha_b; }
    __syncthreads();

    // acc = acc * alpha + p @ V, V = first d_v columns of the same tile
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float al = alpha_s[r];
#pragma unroll
      for (int j = 0; j < COLS; ++j) acc[r][j] *= al;
    }
    for (int s = 0; s < BS; s += 4) {
      float v[COLS][4];
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const int c = tid + j * THREADS;
#pragma unroll
        for (int u = 0; u < 4; ++u)
          v[j][u] = c < d_v ? to_f32(ks[(s + u) * KP + c]) : 0.f;
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float4 p = *reinterpret_cast<const float4*>(ps + r * BS + s);
#pragma unroll
        for (int j = 0; j < COLS; ++j) {
          acc[r][j] = fmaf(p.x, v[j][0], acc[r][j]);
          acc[r][j] = fmaf(p.y, v[j][1], acc[r][j]);
          acc[r][j] = fmaf(p.z, v[j][2], acc[r][j]);
          acc[r][j] = fmaf(p.w, v[j][3], acc[r][j]);
        }
      }
    }
  }

  if (lane == 0) { l_s[ra] = l_a; l_s[rb] = l_b; }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (r0 + r >= R) break;
    const float l = l_s[r];
    const float denom = l > 0.f ? l : 1.f;
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      const int c = tid + j * THREADS;
      if (c < d_v) o[(out_base + r0 + r) * d_v + c] = acc[r][j] / denom;
    }
  }
  if (lane == 0) {
    if (r0 + ra < R) {
      m_out[out_base + r0 + ra] = m_a;
      l_out[out_base + r0 + ra] = l_a;
    }
    if (r0 + rb < R) {
      m_out[out_base + r0 + rb] = m_b;
      l_out[out_base + r0 + rb] = l_b;
    }
  }
}

}  // namespace attend
