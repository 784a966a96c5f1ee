// mla_decode: absorbed-MLA flash decode on Hopper, f32 on CUDA cores.
//
// Replaces: src/repro/kernels/mla_decode/kernel.py, mla_decode_pallas (body
// _kernel): q (B, R, D) attends ckv (B, S, D) under a per-batch valid
// length; the values are the first d_v columns of the same cache rows.
// Returns the partial (o (B, R, d_v), m (B, R), l (B, R)).
//
// Bound on this card. For R query rows over S cache rows the work is
// R S (D + d_v) multiply-adds against S D + R D floats read. A single
// request (R = 16 heads) over a 2048-token chunk at D = 576 is byte-bound
// (~4.8 MB, ~1.4 us at 3.35 TB/s); a ROUTE group of 256 requests
// (R = 4096) is operation-bound (~18 GFLOP, ~270 us at 67 TFLOP/s f32).
//
// Design.
// * The Pallas grid swept S in order and carried the online-softmax state
//   in VMEM scratch. Here a block owns ROWS query rows and loops over its
//   span of S in BS-row tiles, carrying (m, l, acc) in registers.
// * The (ROWS, D) query tile and each (BS, D) cache tile sit in shared
//   memory (~111 KB at D = 576, so two blocks fit on an SM). The PV product
//   reads the first d_v columns of the same cache tile: the cache is read
//   from device memory once per block.
// * Scores: warp w owns rows 2w and 2w+1, lane j owns tile row j; 16-byte
//   shared loads with the row pitch padded to 4 mod 32 words keep the lanes
//   on distinct banks. PV: thread t owns output columns t and t + 256 for
//   all ROWS rows (32 accumulators in registers).
// * Blocks run in parallel and in no order. A few row tiles (a single
//   decode request) cannot fill 132 SMs, so S is split into n_split spans
//   across blocks; each span writes its own partial and a second kernel
//   merges the spans exactly with the softmax merge of merge.cuh.
// * A row with no valid cache entries returns the merge identity
//   (o = 0, m = -inf, l = 0), as partial_from_logits does: the reference
//   point of exp is pinned to 0 while the running max is -inf. (The Pallas
//   kernel computes exp(-inf - -inf) there and returns NaN.)
// * f32 throughout, on CUDA cores: TF32 tensor cores cannot hold the f32
//   tolerance. wgmma/TMA with a bf16 cache are later work.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "merge.cuh"

namespace {

constexpr int ROWS = 16;                  // query rows per block
constexpr int BS = 32;                    // cache rows per tile (= warp size)
constexpr int THREADS = 256;              // 8 warps: 2 score rows each
constexpr int MAX_DV = 512;
constexpr int COLS = MAX_DV / THREADS;    // output columns per thread

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

__global__ void __launch_bounds__(THREADS, 2)
mla_decode_kernel(const float* __restrict__ q, long q_b, long q_r,
                  const float* __restrict__ ckv, long c_b, long c_r,
                  const int* __restrict__ lengths, int B, int R, int S, int D,
                  int DP, int d_v, float scale, int split_len,
                  float* __restrict__ o, float* __restrict__ m_out,
                  float* __restrict__ l_out) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                       // (ROWS, DP)
  float* ks = qs + ROWS * DP;             // (BS, DP)
  float* ps = ks + BS * DP;               // (ROWS, BS) probabilities
  float* alpha_s = ps + ROWS * BS;        // (ROWS,) rescale of this tile
  float* l_s = alpha_s + ROWS;            // (ROWS,) final denominators

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int r0 = blockIdx.x * ROWS;
  const int b = blockIdx.y;
  const int z = blockIdx.z;               // which span of S
  const int D4 = D / 4;

  int len = lengths ? lengths[b] : S;
  len = len < 0 ? 0 : (len > S ? S : len);
  const int s_begin = z * split_len;
  const int s_end = min(len, s_begin + split_len);

  // query tile -> shared (rows past R are zero and never written out)
  const float* qb = q + b * q_b;
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

  const float* cb = ckv + b * c_b;
  for (int s0 = s_begin; s0 < s_end; s0 += BS) {
    __syncthreads();                      // previous tile fully consumed
    for (int i = tid; i < BS * D4; i += THREADS) {
      const int s = i / D4, c = (i % D4) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (s0 + s < s_end)
        v = __ldg(reinterpret_cast<const float4*>(cb + (long)(s0 + s) * c_r
                                                  + c));
      *reinterpret_cast<float4*>(ks + s * DP + c) = v;
    }
    __syncthreads();

    // scores of rows ra, rb against tile row `lane`: one FMA chain per
    // score in column order, the order in which the plain version's cuBLAS
    // product accumulates (four interleaved partial sums doubled the
    // disagreement at D = 576 and saved no time)
    float sa = 0.f, sb = 0.f;
    const float* kp = ks + lane * DP;
    const float* qa = qs + ra * DP;
    const float* qbp = qs + rb * DP;
    for (int c = 0; c < D; c += 4) {
      const float4 k = *reinterpret_cast<const float4*>(kp + c);
      const float4 x = *reinterpret_cast<const float4*>(qa + c);
      const float4 y = *reinterpret_cast<const float4*>(qbp + c);
      sa = fmaf(x.x, k.x, sa); sa = fmaf(x.y, k.y, sa);
      sa = fmaf(x.z, k.z, sa); sa = fmaf(x.w, k.w, sa);
      sb = fmaf(y.x, k.x, sb); sb = fmaf(y.y, k.y, sb);
      sb = fmaf(y.z, k.z, sb); sb = fmaf(y.w, k.w, sb);
    }
    const bool valid = s0 + lane < s_end;
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
          v[j][u] = c < d_v ? ks[(s + u) * DP + c] : 0.f;
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
  const long out_base = ((long)z * B + b) * R;
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

int pitch_of(int D) {
  int dp = (D + 3) / 4 * 4;
  while (dp % 32 != 4) dp += 4;           // 16-byte lanes on distinct banks
  return dp;
}

}  // namespace

extern "C" int mla_decode_smem_bytes(int D) {
  return (int)(((ROWS + BS) * pitch_of(D) + ROWS * BS + 2 * ROWS)
               * sizeof(float));
}

// With n_split == 1 the kernel writes o/m/l directly and the *_part
// buffers are unused; otherwise it writes n_split partials of
// (B, R) rows each into them, and the merge kernel combines those.
extern "C" int mla_decode_f32(const float* q, long q_b, long q_r,
                              const float* ckv, long c_b, long c_r,
                              const int* lengths, int B, int R, int S, int D,
                              int d_v, float scale, int split_len,
                              int n_split, float* o, float* m, float* l,
                              float* o_part, float* m_part, float* l_part,
                              void* stream) {
  if (d_v > MAX_DV || D % 4 != 0 || split_len % BS != 0 ||
      n_split > MERGE_MAX_SLOTS)
    return -1;
  cudaStream_t st = (cudaStream_t)stream;
  const int smem = mla_decode_smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      mla_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || R == 0) return (int)cudaGetLastError();
  dim3 grid((R + ROWS - 1) / ROWS, B, n_split);
  const bool direct = n_split == 1;
  mla_decode_kernel<<<grid, THREADS, smem, st>>>(
      q, q_b, q_r, ckv, c_b, c_r, lengths, B, R, S, D, pitch_of(D), d_v,
      scale, split_len, direct ? o : o_part, direct ? m : m_part,
      direct ? l : l_part);
  err = cudaGetLastError();
  if (err != cudaSuccess || direct) return (int)err;
  const long n_rows = (long)B * R;
  merge_rows_kernel<<<(unsigned)n_rows, MERGE_THREADS, 0, st>>>(
      o_part, m_part, l_part, n_split, n_rows, d_v, o, m, l);
  return (int)cudaGetLastError();
}
