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
// Design: mla_decode's decode loops over a gathered row table.
// * The Pallas kernel walks the KB selected blocks as a sequential grid
//   axis, one (64, D) block per step, with the softmax state in VMEM. Here
//   the selected rows form one position axis t in [0, kb * block_tokens),
//   and the kernel is mla_decode's (decode_launch.cuh) with the position ->
//   row map attend::BlockRows: tile row t reads cache row
//   block_idx[t / bt] * bt + t % bt, one contiguous run of D floats (2304
//   bytes at D = 576) copied with 16-byte copies, its row looked up once
//   per tile, one lane a row, while the previous tile's copies fly.
// * The wrapper's plan is mla_decode's decode_plan over T = KB bt
//   positions: the 64-row register-tiled group loop from 64 query rows,
//   below it the 16-row loop whose busiest SM walks fewer rows (tiled16,
//   16-row tiles, for one request: 32 spans of one tile over 512 selected
//   rows), and spans of whole tiles that fill the card, merged after a
//   cooperative grid sync in the same launch, in slot order: one launch a
//   call, and the same bits on every call. Spans past a row's kb are
//   identities and merge as no-ops.
// * Rows past the chunk's length hold nothing and score -inf, so a selected
//   partial tail block is exact (the Pallas kernel needs S % 64 == 0 and
//   returns non-finite output there). A row with kb = 0 returns the merge
//   identity (o = 0, m = -inf, l = 0). block_tokens = 1 is token-level
//   selection: any token mask is this kernel over the mask's indices.
// * f32 on CUDA cores, each score one FMA chain in column order, as in
//   mla_decode, to hold 1e-5 against the cuBLAS-based plain version.

#include <cuda_runtime.h>

#include "attend.cuh"
#include "decode_launch.cuh"

// loop: 0 "group", 1 "tiled16", 2 "attend16" (mla_decode's codes). With
// n_split == 1 the kernel writes o/m/l directly and the *_part buffers are
// unused; otherwise it writes n_split span partials of (B, R) rows each
// into them and merges them in the same (cooperative) launch. kb and
// lengths may be null (every row has kb_max ids; every cache row is
// valid).
extern "C" int sparse_select_f32(const float* q, long q_b, long q_r,
                                 const float* ckv, long c_b, long c_r,
                                 const int* block_idx, long i_b,
                                 const int* kb, const int* lengths, int B,
                                 int R, int S, int D, int d_v, float scale,
                                 int bt, int kb_max, int loop, int n_split,
                                 float* o, float* m, float* l, float* o_part,
                                 float* m_part, float* l_part, void* stream) {
  if (d_v > tiled::MAX_DV || d_v % 4 != 0 || D % 4 != 0 || bt < 1 ||
      kb_max < 0 || (long)kb_max * bt >= (1L << 31) || n_split < 1 ||
      loop < 0 || loop > 2)
    return -1;
  if (B == 0 || R == 0) return 0;
  const decode::Args a{q, q_b, q_r, ckv, c_b, c_r, lengths, block_idx, i_b,
                       kb, bt, kb_max, B, R, S, kb_max * bt, D,
                       attend::pitch_of(D), d_v, scale, n_split,
                       o, m, l, o_part, m_part, l_part};
  return decode::run<true>(loop, a, (cudaStream_t)stream);
}

// Dynamic shared memory of loop `loop`'s block at D into *smem; returns the
// blocks one SM holds (0 on an error).
extern "C" int sparse_select_resources(int loop, int D, int* smem) {
  if (loop < 0 || loop > 2 || D % 4 != 0) return 0;
  return decode::resources<true>(loop, D, smem);
}
