// The decode kernels that mla_decode.cu (a dense span of the cache) and
// sparse_select.cu (the cache rows that selected blocks cover) share: their
// arguments, the span a block walks, the three loops, the in-launch combine
// of split spans, and the launch.
//
// Both attend q (B, R, D) over a position axis of T positions per batch
// row: mla_decode's positions are cache rows [0, S) (T = S), ended at the
// row's length; sparse_select's are t in [0, kb_max bt), position t reading
// cache row block_idx[b, t / bt] bt + t % bt (attend::BlockRows), ended at
// the row's kb[b] bt, and rows at or past the row's length hold nothing.
// The wrapper's decode_plan picks one of three loops and a split of the T
// positions into n_split spans of whole tiles (span z holds tiles
// [z tiles / n, (z + 1) tiles / n)); a split launch is cooperative, writes
// each span's partial, synchronises the grid and merges the spans in slot
// order (decode_tiled.cuh combine_spans). A span past a row's end is the
// identity and merges as a no-op.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <mutex>

#include "attend.cuh"
#include "decode_tiled.cuh"

namespace decode {

struct Args {
  const float* q;
  long q_b, q_r;
  const float* ckv;
  long c_b, c_r;
  const int* lengths;        // (B,) valid cache rows, or null: all S
  const int* block_idx;      // sparse: (B, KB) selected block ids
  long i_b;                  // its batch stride
  const int* kb;             // sparse: (B,) ids that count, or null: all
  int bt, kb_max;            // sparse: rows a block, ids a row
  int B, R, S, T, D, DP, d_v;
  float scale;
  int n_split;
  float *o, *m, *l, *o_part, *m_part, *l_part;
};

__device__ __forceinline__ int clamp_to(int v, int hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

// The cache rows of batch row b that hold data.
__device__ __forceinline__ int length_of(const Args& a, int b) {
  return a.lengths ? clamp_to(a.lengths[b], a.S) : a.S;
}

// Span z of batch row b for `tile`-position tiles: [s_begin, s_end).
template <bool kSparse>
__device__ __forceinline__ void span_of(const Args& a, int tile, int b,
                                        int z, int& s_begin, int& s_end) {
  int end;
  if constexpr (kSparse)
    end = (a.kb ? clamp_to(a.kb[b], a.kb_max) : a.kb_max) * a.bt;
  else
    end = length_of(a, b);
  const long tiles = (a.T + tile - 1) / tile;
  s_begin = (int)((long)z * tiles / a.n_split) * tile;
  s_end = min(end, (int)((long)(z + 1) * tiles / a.n_split) * tile);
}

// The position -> cache row map of batch row b.
template <bool kSparse>
__device__ __forceinline__ auto rows_of(const Args& a, int b) {
  if constexpr (kSparse)
    return attend::BlockRows{a.block_idx + b * a.i_b, a.bt,
                             length_of(a, b)};
  else
    return attend::DenseRows{};
}

// After every span's partial is written: merge them (split launches only).
template <int THREADS, int ROWS>
__device__ __forceinline__ void combine(const Args& a, int b, int z,
                                        int r0) {
  cooperative_groups::this_grid().sync();
  tiled::combine_spans<THREADS>(
      a.o_part, a.m_part, a.l_part, a.n_split, (long)a.B * a.R,
      (long)b * a.R + r0, min(ROWS, a.R - r0), a.d_v, z, a.o, a.m, a.l);
}

template <class Sh, bool kSplit, bool kSparse>
__global__ void __launch_bounds__(Sh::THREADS, Sh::MIN_BLOCKS)
tiled_kernel(Args a) {
  const int b = blockIdx.y, z = blockIdx.z, r0 = blockIdx.x * Sh::ROWS;
  int s_begin, s_end;
  span_of<kSparse>(a, Sh::BS, b, z, s_begin, s_end);
  tiled::attend_tiles<Sh>(
      a.q + b * a.q_b, a.q_r, a.ckv + b * a.c_b, a.c_r, a.R, r0, a.D, a.DP,
      a.d_v, a.scale, s_begin, s_end, rows_of<kSparse>(a, b),
      kSplit ? a.o_part : a.o, kSplit ? a.m_part : a.m,
      kSplit ? a.l_part : a.l, ((long)z * a.B + b) * a.R);
  if constexpr (kSplit) combine<Sh::THREADS, Sh::ROWS>(a, b, z, r0);
}

template <bool kSplit, bool kSparse>
__global__ void __launch_bounds__(attend::THREADS, 2) attend_kernel(Args a) {
  const int b = blockIdx.y, z = blockIdx.z, r0 = blockIdx.x * attend::ROWS;
  int s_begin, s_end;
  span_of<kSparse>(a, attend::BS, b, z, s_begin, s_end);
  attend::attend_span(a.q + b * a.q_b, a.q_r, a.ckv + b * a.c_b, a.c_r,
                      a.R, r0, a.D, a.DP, a.d_v, a.scale, s_begin, s_end,
                      rows_of<kSparse>(a, b), kSplit ? a.o_part : a.o,
                      kSplit ? a.m_part : a.m, kSplit ? a.l_part : a.l,
                      ((long)z * a.B + b) * a.R);
  if constexpr (kSplit) combine<attend::THREADS, attend::ROWS>(a, b, z, r0);
}

// Raise `kernel`'s dynamic shared memory limit to at least `smem` bytes on
// the current device: one cudaFuncSetAttribute per kernel, device and
// larger size, not one per call.
inline cudaError_t allow_smem(const void* kernel, int smem) {
  struct Set {
    int dev;
    const void* kernel;
    int smem;
  };
  static std::mutex mu;
  static Set done[64];
  static int n_done = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  Set* hit = nullptr;
  for (int i = 0; i < n_done; ++i)
    if (done[i].dev == dev && done[i].kernel == kernel) hit = &done[i];
  if (hit && hit->smem >= smem) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  if (hit)
    hit->smem = smem;
  else if (n_done < 64)
    done[n_done++] = Set{dev, kernel, smem};
  return cudaSuccess;
}

template <class Kernel>
int launch(Kernel kernel, int rows, int threads, int loop_smem, Args a,
           cudaStream_t st) {
  const bool split = a.n_split > 1;
  const int merge_smem =
      split ? tiled::combine_smem_bytes(rows, a.n_split, threads) : 0;
  const int smem = loop_smem > merge_smem ? loop_smem : merge_smem;
  cudaError_t err = allow_smem((const void*)kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.R + rows - 1) / rows, a.B, a.n_split);
  if (split) {                            // every block co-resident
    void* args[] = {&a};
    err = cudaLaunchCooperativeKernel((const void*)kernel, grid,
                                      dim3(threads), args, smem, st);
    if (err != cudaSuccess) return (int)err;
  } else {
    kernel<<<grid, threads, smem, st>>>(a);
  }
  return (int)cudaGetLastError();
}

// Launch loop 0 "group", 1 "tiled16" or 2 "attend16" on checked arguments.
template <bool kSparse>
int run(int loop, const Args& a, cudaStream_t st) {
  const bool split = a.n_split > 1;
  if (loop == 0) {
    using Sh = tiled::Group;
    return launch(split ? tiled_kernel<Sh, true, kSparse>
                        : tiled_kernel<Sh, false, kSparse>,
                  Sh::ROWS, Sh::THREADS, tiled::smem_bytes<Sh>(a.D, kSparse),
                  a, st);
  }
  if (loop == 1) {
    using Sh = tiled::Single;
    return launch(split ? tiled_kernel<Sh, true, kSparse>
                        : tiled_kernel<Sh, false, kSparse>,
                  Sh::ROWS, Sh::THREADS, tiled::smem_bytes<Sh>(a.D, kSparse),
                  a, st);
  }
  return launch(split ? attend_kernel<true, kSparse>
                      : attend_kernel<false, kSparse>,
                attend::ROWS, attend::THREADS,
                attend::smem_bytes(a.D, kSparse), a, st);
}

// The dynamic shared memory of loop `loop`'s split kernel at D (its loop;
// the combine of n_split <= 132 spans needs less) and the blocks one SM
// holds with it, as the occupancy API reports them; 0 on an error.
template <bool kSparse>
int resources(int loop, int D, int* smem) {
  const void* kernel;
  int threads;
  if (loop == 0) {
    kernel = (const void*)tiled_kernel<tiled::Group, true, kSparse>;
    threads = tiled::Group::THREADS;
    *smem = tiled::smem_bytes<tiled::Group>(D, kSparse);
  } else if (loop == 1) {
    kernel = (const void*)tiled_kernel<tiled::Single, true, kSparse>;
    threads = tiled::Single::THREADS;
    *smem = tiled::smem_bytes<tiled::Single>(D, kSparse);
  } else {
    kernel = (const void*)attend_kernel<true, kSparse>;
    threads = attend::THREADS;
    *smem = attend::smem_bytes(D, kSparse);
  }
  int n = 0;
  if (allow_smem(kernel, *smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads,
                                                    *smem) != cudaSuccess)
    return 0;
  return n;
}

}  // namespace decode
