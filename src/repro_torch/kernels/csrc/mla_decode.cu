// mla_decode: absorbed-MLA flash decode on Hopper, f32 arithmetic on CUDA
// cores over a cache read in its own type (f32, bf16 or f16).
//
// Replaces: src/repro/kernels/mla_decode/kernel.py:69, mla_decode_pallas
// (body _kernel): q (B, R, D) attends ckv (B, S, D) under a per-batch valid
// length; the values are the first d_v columns of the same cache rows.
// Returns the partial (o (B, R, d_v), m (B, R), l (B, R)).
//
// Bound on this card, by regime. For R query rows over S cache rows the
// work is R S (D + d_v) multiply-adds against S D cache elements + R D
// floats read.
// * A single request (R = 16 heads) over a 2048-token chunk at D = 576 is
//   byte-bound: ~4.8 MB in f32 (~2.4 MB in bf16), ~1.4 us at 3.35 TB/s,
//   against 71 MFLOP (~1.1 us at 67 TFLOP/s f32).
// * A ROUTE group folds every query row of the group into R: 4096 rows
//   (256 requests) are operation-bound, ~18 GFLOP, ~270 us; the 16 384 rows
//   of four 1024-row requests on one chunk ~1.09 ms.
//
// Design. The Pallas grid swept S in order and carried the online-softmax
// state in VMEM scratch, casting each bf16 block to f32 inside. Here a
// block owns a tile of query rows and loops over its span of S in cache
// tiles, carrying (m, l, acc) in registers (the group loop keeps acc in
// shared memory between tiles).
// * The cache is read in place in its own type: each loop copies a tile's
//   raw 16-byte units to shared memory and turns each value into f32 where
//   it is used (attend.cuh), so a bf16 or f16 cache is read once, in half
//   the bytes, with no f32 copy, and the result is bit for bit that of the
//   f32 kernel on the cache cast to f32. q is f32 (the wrapper casts it:
//   it is R x D, small beside the cache).
// * The arithmetic stays f32 on the CUDA cores: the serving path holds the
//   kernel to 1e-5 of its plain version, which neither bf16 nor TF32
//   tensor-core products can meet. Each score stays one FMA chain in
//   column order, the order of the cuBLAS product in the plain version:
//   scores summed in another order move each row's maximum, and l with
//   it, against the plain version (f64 tensor-core scores, exact products
//   summed in f64, were tried and missed 1e-5 on l at 16 384 rows). PV is
//   summed in s order.
// * Four loops, picked per call by the wrapper's decode_plan:
//   - "group", decode_group.cuh: 64 query rows over 256-row cache tiles,
//     K with Q and V streamed through a 3-stage ring of 32-column K chunks
//     and 16-row V chunks, the 8 warps laid out 2 x 4 over the scores and
//     the output and their lanes 4 x 8, as in an SGEMM: a lane's 8 x 8
//     micro-tile of scores does 4 FMAs a float it loads from shared memory
//     in every warp (the rows' maxima meet across the 4 warps of a row
//     block in shared memory); the running output in the block's own rows
//     of the output slab, P 64 KB + the ring 135 KB, one block an SM.
//     Large ROUTE groups.
//   - "group32", decode_tiled.cuh at 64 rows over resident 32-row tiles
//     (Q 148 480 B + a tile 74 240 B + P 8 704 B; D > 576 does not fit and
//     the wrapper raises), 4 x 4 micro-tiles in 4 of its 8 warps (2 FMAs a
//     value): a smaller group, where "group"'s 256-row tiles would leave
//     SMs idle (256 rows over 2048).
//   - "tiled16" (R < 64), the same loop at 16 rows, 16-row cache tiles
//     (128 spans for one request over 2048 positions), 256 threads, one
//     block an SM;
//   - "attend16" (R < 64), attend.cuh's 16-row loop, 32-row tiles, two blocks
//     an SM.
//   From 64 rows the plan takes group32 when its busiest SM walks fewer
//   cache rows, else "group"; below, the 16-row loop whose busiest SM
//   walks fewer cache rows, attend16 on a tie unless its spans outnumber
//   the SMs (ops.py).
// * Filling the card. When the row tiles leave room for more co-resident
//   blocks, S is split into n balanced spans of whole tiles (span z holds
//   tiles [z T / n, (z + 1) T / n) of the T tiles of S): at most as many
//   blocks as fit on the card at once, so the launch is cooperative. Each
//   block writes its span's partial, the grid synchronises, and block
//   (x, b, z) merges its row tile's rows over the n spans for 1/n of the
//   columns (decode_tiled.cuh combine_spans), in slot order: one launch, no
//   block reading more than ~1/n of the partials, and the same bits on
//   every call.
// * The loops, the spans, the combine and the launch live in
//   decode_launch.cuh, which sparse_select.cu instantiates over a block
//   table of selected rows; here they read the dense rows (DenseRows).
// * A row with no valid cache entries returns the merge identity (o = 0,
//   m = -inf, l = 0), as partial_from_logits does: the reference point of
//   exp is pinned to 0 while the running max is -inf. (The Pallas kernel
//   computes exp(-inf - -inf) there and returns NaN.)

#include <cuda_runtime.h>

#include "decode_launch.cuh"

// dtype: the cache's element type, 0 f32, 1 bf16, 2 f16 (c_b, c_r in
// elements). loop: 0 "group", 1 "tiled16", 2 "attend16", 3 "group32".
// With n_split == 1 the kernel writes o/m/l directly and the *_part buffers
// are unused; otherwise it writes n_split span partials of (B, R) rows each
// into them and merges them in the same (cooperative) launch.
extern "C" int mla_decode(const float* q, long q_b, long q_r,
                          const void* ckv, long c_b, long c_r, int dtype,
                          const int* lengths, int B, int R, int S, int D,
                          int d_v, float scale, int loop, int n_split,
                          float* o, float* m, float* l, float* o_part,
                          float* m_part, float* l_part, void* stream) {
  if (!decode::shapes_ok(dtype, D, d_v, loop, n_split)) return -1;
  if (B == 0 || R == 0) return 0;
  const decode::Args a{q, q_b, q_r, ckv, c_b, c_r, lengths, nullptr, 0,
                       nullptr, 1, 0, B, R, S, S, D, d_v, scale, n_split,
                       o, m, l, o_part, m_part, l_part, nullptr};
  return decode::run<false>(loop, dtype, a, (cudaStream_t)stream);
}

// A measurement launch of a group loop (0 "group" or 3 "group32") over an
// f32 cache: the same arguments, and per block stamp::WORDS words into
// `stamps` (decode_tiled.cuh: start and end %globaltimer ns, clock64 cycles
// in all and by phase: the copies' wait, scores, softmax, PV, combine).
extern "C" int mla_decode_stamped(const float* q, long q_b, long q_r,
                                  const float* ckv, long c_b, long c_r,
                                  const int* lengths, int B, int R, int S,
                                  int D, int d_v, float scale, int loop,
                                  int n_split, float* o, float* m, float* l,
                                  float* o_part, float* m_part,
                                  float* l_part, unsigned long long* stamps,
                                  void* stream) {
  if (!decode::shapes_ok(0, D, d_v, loop, n_split) ||
      (loop != decode::GROUP && loop != decode::GROUP32) || !stamps)
    return -1;
  if (B == 0 || R == 0) return 0;
  const decode::Args a{q, q_b, q_r, ckv, c_b, c_r, lengths, nullptr, 0,
                       nullptr, 1, 0, B, R, S, S, D, d_v, scale, n_split,
                       o, m, l, o_part, m_part, l_part, stamps};
  return decode::launch(
      decode::kernel_for<float, false, true>(loop, D, n_split), a,
      (cudaStream_t)stream);
}
