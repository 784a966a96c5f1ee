// The exact M-way online-softmax merge of one row, shared by softmax_merge.cu
// (the per-request merge) and mla_decode.cu (the combine of its S splits).
//
//   m* = max_i m_i ;  w_i = l_i exp(m_i - m*) ;  o* = sum_i (w_i / sum w) o_i
//
// Identity slots (m = -inf, l = 0) weigh 0. A row whose slots are all
// identity stays the identity (o = 0, m = -inf, l = 0): the reference point
// is pinned to 0 when m* is not finite, so no (-inf) - (-inf) arises.
// Products and sums are rounded one at a time (no fused multiply-add), and
// the sums over the M slots keep four interleaved partial sums (slot i
// into sum i mod 4, then ((s0 + s1) + s2) + s3), the order PyTorch's CUDA
// reduction takes over a leading dimension: the kernel then reproduces the
// plain version on the card bit for bit.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

constexpr int MERGE_THREADS = 128;
constexpr int MERGE_MAX_SLOTS = 256;      // slot weights kept in shared memory

__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}

__device__ __forceinline__ float4 add_rn(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

// sum over i < M of f(i), in the interleaved order described above
template <class T, class F>
__device__ __forceinline__ T sum_slots(int M, F f) {
  T s0{}, s1{}, s2{}, s3{};
  int i = 0;
  for (; i + 3 < M; i += 4) {
    s0 = add_rn(s0, f(i));
    s1 = add_rn(s1, f(i + 1));
    s2 = add_rn(s2, f(i + 2));
    s3 = add_rn(s3, f(i + 3));
  }
  if (i < M) s0 = add_rn(s0, f(i));
  if (i + 1 < M) s1 = add_rn(s1, f(i + 1));
  if (i + 2 < M) s2 = add_rn(s2, f(i + 2));
  return add_rn(add_rn(add_rn(s0, s1), s2), s3);
}

// o: (M, n_rows, d_v); m, l: (M, n_rows), all contiguous f32; M <=
// MERGE_MAX_SLOTS. One block per row. The M slot weights are computed once
// per block into shared memory; each thread then merges four adjacent
// columns with one 16-byte load per slot (a scalar loop when d_v % 4 != 0),
// so the slots cost the block a few memory latencies, not one per column.
__device__ __forceinline__ void merge_row(const float* __restrict__ o,
                                          const float* __restrict__ m,
                                          const float* __restrict__ l,
                                          int M, long n_rows, long row,
                                          int d_v,
                                          float* __restrict__ o_out,
                                          float* __restrict__ m_out,
                                          float* __restrict__ l_out) {
  __shared__ float w_s[MERGE_MAX_SLOTS];
  float m_star = -CUDART_INF_F;
  for (int i = 0; i < M; ++i) m_star = fmaxf(m_star, m[i * n_rows + row]);
  const float safe = isfinite(m_star) ? m_star : 0.0f;
  for (int i = threadIdx.x; i < M; i += blockDim.x) {
    const long at = i * n_rows + row;
    w_s[i] = __fmul_rn(l[at], expf(m[at] - safe));
  }
  __syncthreads();
  const float l_star = sum_slots<float>(M, [&](int i) { return w_s[i]; });
  const float denom = l_star > 0.0f ? l_star : 1.0f;
  if (d_v % 4 == 0) {
    const float4* o4 = reinterpret_cast<const float4*>(o);
    float4* out4 = reinterpret_cast<float4*>(o_out);
    const int d4 = d_v / 4;
    for (int c = threadIdx.x; c < d4; c += blockDim.x) {
      out4[row * d4 + c] = sum_slots<float4>(M, [&](int i) {
        const float k = __fdiv_rn(w_s[i], denom);
        const float4 v = o4[(i * n_rows + row) * d4 + c];
        return make_float4(__fmul_rn(k, v.x), __fmul_rn(k, v.y),
                           __fmul_rn(k, v.z), __fmul_rn(k, v.w));
      });
    }
  } else {
    for (int c = threadIdx.x; c < d_v; c += blockDim.x) {
      o_out[row * d_v + c] = sum_slots<float>(M, [&](int i) {
        return __fmul_rn(__fdiv_rn(w_s[i], denom),
                         o[(i * n_rows + row) * d_v + c]);
      });
    }
  }
  if (threadIdx.x == 0) {
    m_out[row] = l_star > 0.0f ? m_star : -CUDART_INF_F;
    l_out[row] = l_star;
  }
}

__global__ void merge_rows_kernel(const float* __restrict__ o,
                                  const float* __restrict__ m,
                                  const float* __restrict__ l, int M,
                                  long n_rows, int d_v,
                                  float* __restrict__ o_out,
                                  float* __restrict__ m_out,
                                  float* __restrict__ l_out) {
  merge_row(o, m, l, M, n_rows, blockIdx.x, d_v, o_out, m_out, l_out);
}
