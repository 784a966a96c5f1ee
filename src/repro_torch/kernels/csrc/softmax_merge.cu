// softmax_merge: the exact M-way (o, m, l) merge on Hopper, f32.
//
// Replaces: src/repro/kernels/softmax_merge/kernel.py, softmax_merge_pallas
// (a grid over B, each step holding the (M, H, d_v) stack of one batch row
// in VMEM).
//
// Bound on this card: bytes. Each row reads M (d_v + 2) floats and writes
// d_v + 2; there are about 3 M operations per byte of o, far below the
// H100's ~20 f32 operations per byte. Design: one block per (b, h) row;
// the M slot weights are computed once per block into shared memory, and
// each of 128 threads merges four adjacent columns of d_v = 512 with one
// 16-byte load per slot, so each warp reads 512 consecutive bytes of o_i
// per slot and a slot costs the block one memory latency. Nothing is kept
// across rows, so the blocks need no order (the Pallas grid's sequential B
// sweep does not carry over to the card).

#include "merge.cuh"

extern "C" int softmax_merge_f32(const float* o, const float* m,
                                 const float* l, int M, long n_rows, int d_v,
                                 float* o_out, float* m_out, float* l_out,
                                 void* stream) {
  if (M < 1 || M > MERGE_MAX_SLOTS) return -1;
  if (n_rows > 0)
    merge_rows_kernel<<<(unsigned)n_rows, MERGE_THREADS, 0,
                        (cudaStream_t)stream>>>(o, m, l, M, n_rows, d_v,
                                                o_out, m_out, l_out);
  return (int)cudaGetLastError();
}
