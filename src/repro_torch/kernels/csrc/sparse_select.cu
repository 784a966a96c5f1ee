// sparse_select: block-sparse selected attention on Hopper, f32 on CUDA
// cores.
//
// Replaces: src/repro/kernels/sparse_select/kernel.py, sparse_select_pallas
// (body _kernel): query rows attend the cache rows that a list of selected
// blocks covers, at their canonical positions (no re-rotation), values the
// first d_v columns of the same rows. Returns the partial (o (B, R, d_v),
// m (B, R), l (B, R)).
//
// Interface, shaped for the serving call: q (B, R, D) with the request's
// m_q x H rows folded into R; ckv (B, S, D) read in place through its row
// and batch strides (a holder's chunk is never copied); block_idx (B, KB)
// int32 with kb (B,) valid ids per row (ragged); lengths (B,) valid cache
// rows; block_tokens rows per block.
//
// Bound on this card. For R rows over T selected rows the work is
// R T (D + d_v) multiply-adds against T D + R D floats read: one request
// (R = 16) over 512 selected rows at D = 576 moves 1.25 MB (0.37 us at
// 3.35 TB/s) and does 17.8 MFLOP (0.27 us at 67 TFLOP/s f32), byte-bound;
// 256 rows over 2048 selected rows do 1.14 GFLOP, operation-bound (17 us).
//
// Design.
// * The Pallas kernel walks the KB selected blocks as a sequential grid
//   axis, one (64, D) block per step, with the softmax state in VMEM. Here
//   the selected rows form one position axis t in [0, kb * block_tokens);
//   a block owns ROWS query rows and walks its span of t in BS-row tiles
//   with the tile loop of attend.cuh. Tile row t reads cache row
//   block_idx[t / bt] * bt + t % bt: one contiguous run of D floats (2304
//   bytes at D = 576), loaded with 16-byte loads, its row looked up once
//   per tile into shared memory.
// * Rows past the chunk's length hold nothing and score -inf, so a selected
//   partial tail block is exact (the Pallas kernel needs S % 64 == 0 and
//   returns non-finite output there). A row with kb = 0 returns the merge
//   identity (o = 0, m = -inf, l = 0). block_tokens = 1 is token-level
//   selection: any token mask is this kernel over the mask's indices.
// * A few row tiles (one request) cannot fill 132 SMs, so the t axis is
//   split into n_split spans across blocks, as in mla_decode; spans past a
//   row's kb are identities, and the spans merge exactly through merge.cuh.
// * f32 on CUDA cores, each score one FMA chain in column order, as in
//   mla_decode, to hold 1e-5 against the cuBLAS-based plain version.

#include <cuda_runtime.h>

#include "attend.cuh"
#include "merge.cuh"

namespace {

using attend::BS;
using attend::MAX_DV;
using attend::ROWS;
using attend::THREADS;

__global__ void __launch_bounds__(THREADS, 2)
sparse_select_kernel(const float* __restrict__ q, long q_b, long q_r,
                     const float* __restrict__ ckv, long c_b, long c_r,
                     const int* __restrict__ block_idx, long i_b,
                     const int* __restrict__ kb, const int* __restrict__ lengths,
                     int B, int R, int S, int D, int DP, int d_v, float scale,
                     int bt, int kb_max, int split_len,
                     float* __restrict__ o, float* __restrict__ m_out,
                     float* __restrict__ l_out) {
  const int b = blockIdx.y;
  const int z = blockIdx.z;               // which span of the selected rows
  int len = lengths ? lengths[b] : S;
  len = len < 0 ? 0 : (len > S ? S : len);
  int k = kb ? kb[b] : kb_max;
  k = k < 0 ? 0 : (k > kb_max ? kb_max : k);
  const int s_begin = z * split_len;
  const int s_end = min(k * bt, s_begin + split_len);
  attend::attend_span(q + b * q_b, q_r, ckv + b * c_b, c_r, R,
                      blockIdx.x * ROWS, D, DP, d_v, scale, s_begin, s_end,
                      attend::BlockRows{block_idx + b * i_b, bt, len}, o,
                      m_out, l_out, ((long)z * B + b) * R);
}

}  // namespace

// With n_split == 1 the kernel writes o/m/l directly and the *_part
// buffers are unused; otherwise it writes n_split partials of (B, R) rows
// each into them, and the merge kernel combines those. kb and lengths may
// be null (every row has kb_max ids; every cache row is valid).
extern "C" int sparse_select_f32(const float* q, long q_b, long q_r,
                                 const float* ckv, long c_b, long c_r,
                                 const int* block_idx, long i_b,
                                 const int* kb, const int* lengths, int B,
                                 int R, int S, int D, int d_v, float scale,
                                 int bt, int kb_max, int split_len,
                                 int n_split, float* o, float* m, float* l,
                                 float* o_part, float* m_part, float* l_part,
                                 void* stream) {
  if (d_v > MAX_DV || D % 4 != 0 || bt < 1 || split_len % BS != 0 ||
      n_split > MERGE_MAX_SLOTS)
    return -1;
  cudaStream_t st = (cudaStream_t)stream;
  const int smem = attend::smem_bytes(D, true);
  cudaError_t err = cudaFuncSetAttribute(
      sparse_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || R == 0) return (int)cudaGetLastError();
  dim3 grid((R + ROWS - 1) / ROWS, B, n_split);
  const bool direct = n_split == 1;
  sparse_select_kernel<<<grid, THREADS, smem, st>>>(
      q, q_b, q_r, ckv, c_b, c_r, block_idx, i_b, kb, lengths, B, R, S, D,
      attend::pitch_of(D), d_v, scale, bt, kb_max, split_len,
      direct ? o : o_part, direct ? m : m_part, direct ? l : l_part);
  err = cudaGetLastError();
  if (err != cudaSuccess || direct) return (int)err;
  const long n_rows = (long)B * R;
  merge_rows_kernel<<<(unsigned)n_rows, MERGE_THREADS, 0, st>>>(
      o_part, m_part, l_part, n_split, n_rows, d_v, o, m, l);
  return (int)cudaGetLastError();
}
