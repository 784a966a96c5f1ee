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
//   span of S in BS-row tiles, carrying (m, l, acc) in registers: the tile
//   loop of attend.cuh (shared with sparse_select.cu), which describes the
//   shared-memory tiles and the score and PV layouts.
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

#include "attend.cuh"
#include "merge.cuh"

namespace {

using attend::BS;
using attend::MAX_DV;
using attend::ROWS;
using attend::THREADS;

__global__ void __launch_bounds__(THREADS, 2)
mla_decode_kernel(const float* __restrict__ q, long q_b, long q_r,
                  const float* __restrict__ ckv, long c_b, long c_r,
                  const int* __restrict__ lengths, int B, int R, int S, int D,
                  int DP, int d_v, float scale, int split_len,
                  float* __restrict__ o, float* __restrict__ m_out,
                  float* __restrict__ l_out) {
  const int b = blockIdx.y;
  const int z = blockIdx.z;               // which span of S
  int len = lengths ? lengths[b] : S;
  len = len < 0 ? 0 : (len > S ? S : len);
  const int s_begin = z * split_len;
  const int s_end = min(len, s_begin + split_len);
  attend::attend_span(q + b * q_b, q_r, ckv + b * c_b, c_r, R,
                      blockIdx.x * ROWS, D, DP, d_v, scale, s_begin, s_end,
                      attend::DenseRows{}, o, m_out, l_out,
                      ((long)z * B + b) * R);
}

}  // namespace

extern "C" int mla_decode_smem_bytes(int D) {
  return attend::smem_bytes(D, false);
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
      q, q_b, q_r, ckv, c_b, c_r, lengths, B, R, S, D, attend::pitch_of(D),
      d_v, scale, split_len, direct ? o : o_part, direct ? m : m_part,
      direct ? l : l_part);
  err = cudaGetLastError();
  if (err != cudaSuccess || direct) return (int)err;
  const long n_rows = (long)B * R;
  merge_rows_kernel<<<(unsigned)n_rows, MERGE_THREADS, 0, st>>>(
      o_part, m_part, l_part, n_split, n_rows, d_v, o, m, l);
  return (int)cudaGetLastError();
}
