// mla_decode: absorbed-MLA flash decode on Hopper, f32 on CUDA cores.
//
// Replaces: src/repro/kernels/mla_decode/kernel.py:69, mla_decode_pallas
// (body _kernel): q (B, R, D) attends ckv (B, S, D) under a per-batch valid
// length; the values are the first d_v columns of the same cache rows.
// Returns the partial (o (B, R, d_v), m (B, R), l (B, R)).
//
// Bound on this card, by regime. For R query rows over S cache rows the
// work is R S (D + d_v) multiply-adds against S D + R D floats read.
// * A single request (R = 16 heads) over a 2048-token chunk at D = 576 is
//   byte-bound: ~4.8 MB, ~1.4 us at 3.35 TB/s, against 71 MFLOP (~1.1 us at
//   67 TFLOP/s f32).
// * A ROUTE group folds every query row of the group into R: 4096 rows
//   (256 requests) are operation-bound, ~18 GFLOP, ~270 us; the 16 384 rows
//   of four 1024-row requests on one chunk ~1.09 ms.
//
// Design. The Pallas grid swept S in order and carried the online-softmax
// state in VMEM scratch. Here a block owns a tile of query rows and loops
// over its span of S in cache tiles, carrying (m, l, acc) in registers. It
// stays f32: the serving path holds it to 1e-5 of the oracle, which neither
// bf16 nor TF32 tensor-core products can meet.
// * Three loops, picked per call by the wrapper's decode_plan:
//   - "group" (R >= 64), the register-tiled loop of decode_tiled.cuh: 64
//     query rows resident in shared memory, 32-row cache tiles, 256
//     threads; 4 warps compute the scores in 4 x 4 micro-tiles, all 8 do
//     the softmax and PV with 8 x 16 accumulators a thread. Q 148 480 B +
//     a tile 74 240 B + P 8 704 B = 231 424 B: one block an SM. D > 576
//     does not fit (the wrapper raises).
//   - "tiled16" (R < 64), the same loop at 16 rows, 16-row cache tiles
//     (128 spans for one request over 2048 positions), 256 threads, one
//     block an SM;
//   - "attend16" (R < 64), attend.cuh's 16-row loop, 32-row tiles, two blocks
//     an SM. Below 64 rows the plan takes the 16-row loop whose busiest SM
//     walks fewer cache rows, attend16 on a tie: tiled16 for a single
//     request, whose spans of one 16-row tile each fill the card;
//     attend16 once every SM walks two tiles or more (model decode at
//     B = 2), where its two blocks an SM hide each other's latency.
// * Each score stays one FMA chain in column order, the order of the
//   cuBLAS product in the plain version, which holds the kernel to 1e-5:
//   scores summed in another order move each row's maximum, and l with
//   it, against the plain version (f64 tensor-core scores, exact products
//   summed in f64, were tried and missed 1e-5 on l at 16 384 rows). That
//   leaves the scores bound by shared memory (decode_tiled.cuh).
// * Filling the card. When the row tiles leave room for more co-resident
//   blocks, S is split into n balanced spans of whole tiles (span z holds
//   tiles [z T / n, (z + 1) T / n) of the T tiles of S): at most as many
//   blocks as fit on the card at once, so the launch is cooperative. Each
//   block writes its span's partial, the grid synchronises, and block
//   (x, b, z) merges its row tile's rows over the n spans for 1/n of the
//   columns (decode_tiled.cuh combine_spans), in slot order: one launch, no
//   block reading more than ~1/n of the partials, and the same bits on
//   every call.
// * The three loops, the spans, the combine and the launch live in
//   decode_launch.cuh, which sparse_select.cu instantiates over a block
//   table of selected rows; here they read the dense rows (DenseRows).
// * A row with no valid cache entries returns the merge identity (o = 0,
//   m = -inf, l = 0), as partial_from_logits does: the reference point of
//   exp is pinned to 0 while the running max is -inf. (The Pallas kernel
//   computes exp(-inf - -inf) there and returns NaN.)

#include <cuda_runtime.h>

#include "attend.cuh"
#include "decode_launch.cuh"

// loop: 0 "group", 1 "tiled16", 2 "attend16". With n_split == 1 the
// kernel writes o/m/l directly and the *_part buffers are unused;
// otherwise it writes n_split span partials of (B, R) rows each into them
// and merges them in the same (cooperative) launch.
extern "C" int mla_decode_f32(const float* q, long q_b, long q_r,
                              const float* ckv, long c_b, long c_r,
                              const int* lengths, int B, int R, int S, int D,
                              int d_v, float scale, int loop, int n_split,
                              float* o, float* m, float* l, float* o_part,
                              float* m_part, float* l_part, void* stream) {
  if (d_v > tiled::MAX_DV || d_v % 4 != 0 || D % 4 != 0 || n_split < 1 ||
      loop < 0 || loop > 2)
    return -1;
  if (B == 0 || R == 0) return 0;
  const decode::Args a{q, q_b, q_r, ckv, c_b, c_r, lengths, nullptr, 0,
                       nullptr, 1, 0, B, R, S, S, D, attend::pitch_of(D),
                       d_v, scale, n_split, o, m, l, o_part, m_part, l_part};
  return decode::run<false>(loop, a, (cudaStream_t)stream);
}
