// flash_prefill: causal latent flash attention (absorbed-MLA prefill) on
// Hopper, f32 on CUDA cores.
//
// Replaces: src/repro/kernels/flash_prefill/kernel.py, flash_prefill_pallas
// (body _kernel): absorbed queries q (B, Sq, H, D) attend the latent cache
// ckv (B, Sk, D) causally, tail-aligned (query i sees cache rows
// [0, Sk - Sq + i]); the values are the first d_v columns of the same rows.
// Returns o (B, Sq, H, d_v).
//
// Bound on this card. Query row i attends Sk - Sq + i + 1 cache rows, at
// D + d_v multiply-adds each: one 2048-token sequence at V2-Lite width
// (H = 16, D = 576, d_v = 512) is 2 * 16 * (2048 * 2049 / 2) * 1088
// ~ 73 GFLOP against ~80 MB moved, so it is operation-bound (~1.09 ms at
// 67 TFLOP/s f32).
//
// Design.
// * The Pallas kernel folds heads into a (BQ * H, D) query tile and walks
//   the cache in BK-row tiles, skipping tiles above the diagonal. Here the
//   (position, head) pairs are the query rows of mla_decode's tile loop
//   (attend.cuh): q (B, Sq, H, D) is (B, Sq * H, D), row r is position
//   r / H, and a block of ROWS = 16 rows is one position's 16 heads at
//   V2-Lite width. Each cache tile is read into shared memory once for all
//   of the block's rows, each score is one FMA chain in column order.
// * Causality is a per-row limit (CausalLimit): position r / H sees rows
//   below Sk - Sq + r / H + 1, and a block walks the cache only up to the
//   furthest reach of its rows, so tiles above the diagonal cost nothing.
// * Blocks are issued longest first (the last positions reach furthest),
//   so the short blocks fill the tail of the grid. When the row tiles alone
//   cannot fill the SMs (a short prefill), the cache span is split across
//   blocks as in mla_decode and the spans merge exactly (merge.cuh); a span
//   past a row's reach is the merge identity.
// * Sq and Sk need not be multiples of a tile (the Pallas kernel requires
//   multiples of its blocks): the tile loop masks the ragged edges.

#include <cuda_runtime.h>

#include "attend.cuh"
#include "merge.cuh"

namespace {

using attend::BS;
using attend::MAX_DV;
using attend::ROWS;
using attend::THREADS;

// Row r is query position r / H; it sees cache rows below offset + r/H + 1.
struct CausalLimit {
  int H;
  int offset;  // Sk - Sq
  __device__ __forceinline__ int operator()(int r) const {
    return offset + r / H + 1;
  }
};

__global__ void __launch_bounds__(THREADS, 2)
flash_prefill_kernel(const float* __restrict__ q, long q_b,
                     const float* __restrict__ ckv, long c_b, long c_r,
                     int B, int R, int Sk, int D, int DP, int d_v,
                     float scale, int H, int offset, int split_len,
                     float* __restrict__ o, float* __restrict__ m_out,
                     float* __restrict__ l_out) {
  const int b = blockIdx.y;
  const int z = blockIdx.z;                     // which span of the cache
  const int r0 = (gridDim.x - 1 - blockIdx.x) * ROWS;   // longest first
  const int last = min(r0 + ROWS, R) - 1;
  const int reach = min(Sk, offset + last / H + 1);
  const int s_begin = z * split_len;
  const int s_end = min(reach, s_begin + split_len);
  attend::attend_span(q + b * q_b, D, ckv + b * c_b, c_r, R, r0, D, DP, d_v,
                      scale, s_begin, s_end, attend::DenseRows{}, o, m_out,
                      l_out, ((long)z * B + b) * R, CausalLimit{H, offset});
}

}  // namespace

// q (B, Sq, H, D) contiguous, R = Sq * H rows per batch row; ckv row and
// batch strides c_r, c_b. With n_split == 1 the kernel writes o/m/l
// directly and the *_part buffers are unused; otherwise it writes n_split
// partials of (B, R) rows each into them, and the merge kernel combines
// those. m and l are the softmax statistics of each row.
extern "C" int flash_prefill_f32(const float* q, long q_b, const float* ckv,
                                 long c_b, long c_r, int B, int R, int Sk,
                                 int D, int d_v, float scale, int H,
                                 int offset, int split_len, int n_split,
                                 float* o, float* m, float* l, float* o_part,
                                 float* m_part, float* l_part, void* stream) {
  if (d_v > MAX_DV || D % 4 != 0 || H < 1 || offset < 0 ||
      split_len % BS != 0 || n_split > MERGE_MAX_SLOTS)
    return -1;
  cudaStream_t st = (cudaStream_t)stream;
  const int smem = attend::smem_bytes(D, false);
  cudaError_t err = cudaFuncSetAttribute(
      flash_prefill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || R == 0) return (int)cudaGetLastError();
  dim3 grid((R + ROWS - 1) / ROWS, B, n_split);
  const bool direct = n_split == 1;
  flash_prefill_kernel<<<grid, THREADS, smem, st>>>(
      q, q_b, ckv, c_b, c_r, B, R, Sk, D, attend::pitch_of(D), d_v, scale, H,
      offset, split_len, direct ? o : o_part, direct ? m : m_part,
      direct ? l : l_part);
  err = cudaGetLastError();
  if (err != cudaSuccess || direct) return (int)err;
  const long n_rows = (long)B * R;
  merge_rows_kernel<<<(unsigned)n_rows, MERGE_THREADS, 0, st>>>(
      o_part, m_part, l_part, n_split, n_rows, d_v, o, m, l);
  return (int)cudaGetLastError();
}
