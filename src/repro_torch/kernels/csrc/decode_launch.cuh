// The decode kernels that mla_decode.cu (a dense span of the cache) and
// sparse_select.cu (the cache rows that selected blocks cover) share: their
// arguments, the span a block walks, the four loops, the in-launch combine
// of split spans, and the launch.
//
// Both attend q (B, R, D) over a position axis of T positions per batch
// row: mla_decode's positions are cache rows [0, S) (T = S), ended at the
// row's length; sparse_select's are t in [0, kb_max bt), position t reading
// cache row block_idx[b, t / bt] bt + t % bt (attend::BlockRows), ended at
// the row's kb[b] bt, and rows at or past the row's length hold nothing.
// The cache is read in its own element type (dtype 0 f32, 1 bf16, 2 f16;
// attend.cuh), q in f32. The wrapper's decode_plan picks one of four loops
// and a split of the T positions into n_split spans of whole tiles (span z
// holds tiles [z tiles / n, (z + 1) tiles / n)); a split launch is
// cooperative, writes each span's partial, synchronises the grid and
// merges the spans in slot order (decode_tiled.cuh combine_spans). A span
// past a row's end is the identity and merges as a no-op.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <mutex>

#include "attend.cuh"
#include "decode_group.cuh"
#include "decode_tiled.cuh"

namespace decode {

// The loops' codes in the C entries (kernels/mla_decode/ops.py LOOPS).
enum Loop { GROUP = 0, TILED16 = 1, ATTEND16 = 2, GROUP32 = 3 };

struct Args {
  const float* q;
  long q_b, q_r;
  const void* ckv;           // in its own element type
  long c_b, c_r;             // its strides, in elements
  const int* lengths;        // (B,) valid cache rows, or null: all S
  const int* block_idx;      // sparse: (B, KB) selected block ids
  long i_b;                  // its batch stride
  const int* kb;             // sparse: (B,) ids that count, or null: all
  int bt, kb_max;            // sparse: rows a block, ids a row
  int B, R, S, T, D, d_v;
  float scale;
  int n_split;
  float *o, *m, *l, *o_part, *m_part, *l_part;
  unsigned long long* stamps;  // stamped launches: stamp::WORDS a block
};

// The element size of dtype code `dtype`, or 0 for none.
inline int elem_bytes(int dtype) {
  return dtype == 0 ? 4 : (dtype == 1 || dtype == 2 ? 2 : 0);
}

// The checks every entry makes: D and d_v whole 16-byte units of the
// cache's type (the copies' unit), d_v within the PV lanes, a known loop.
inline bool shapes_ok(int dtype, int D, int d_v, int loop, int n_split) {
  const int eb = elem_bytes(dtype);
  return eb && d_v <= tiled::MAX_DV && d_v % 4 == 0 && D % 4 == 0 &&
         (D * eb) % 16 == 0 && (d_v * eb) % 16 == 0 && n_split >= 1 &&
         loop >= GROUP && loop <= GROUP32;
}

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

template <class T>
__device__ __forceinline__ const T* cache_of(const Args& a, int b) {
  return static_cast<const T*>(a.ckv) + b * a.c_b;
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

// Each kernel writes its span's partial straight to o, m, l when the launch
// has one span (kSplit false), and otherwise to the *_part slabs, then
// merges them: the split is a template parameter, so a one-span launch
// carries none of the combine's registers.
template <class Sh, class T, bool kSplit, bool kSparse, bool kStamp>
__global__ void __launch_bounds__(Sh::THREADS, 1) group_kernel(Args a) {
  stamp::Clock<kStamp> clk;
  clk.start();
  const int b = blockIdx.y, z = blockIdx.z, r0 = blockIdx.x * group::ROWS;
  int s_begin, s_end;
  span_of<kSparse>(a, group::BS, b, z, s_begin, s_end);
  group::attend_group<Sh, T>(
      a.q + b * a.q_b, a.q_r, cache_of<T>(a, b), a.c_r, a.R, r0, a.D,
      a.d_v, a.scale, s_begin, s_end, rows_of<kSparse>(a, b),
      kSplit ? a.o_part : a.o, kSplit ? a.m_part : a.m,
      kSplit ? a.l_part : a.l, ((long)z * a.B + b) * a.R, clk);
  if constexpr (kSplit) combine<Sh::THREADS, group::ROWS>(a, b, z, r0);
  clk.mark(stamp::COMBINE);
  clk.finish(a.stamps);
}

template <class Sh, class T, bool kSplit, bool kSparse, bool kStamp>
__global__ void __launch_bounds__(Sh::THREADS, Sh::MIN_BLOCKS)
tiled_kernel(Args a) {
  stamp::Clock<kStamp> clk;
  clk.start();
  const int b = blockIdx.y, z = blockIdx.z, r0 = blockIdx.x * Sh::ROWS;
  int s_begin, s_end;
  span_of<kSparse>(a, Sh::BS, b, z, s_begin, s_end);
  tiled::attend_tiles<Sh, T>(
      a.q + b * a.q_b, a.q_r, cache_of<T>(a, b), a.c_r, a.R, r0, a.D,
      a.d_v, a.scale, s_begin, s_end, rows_of<kSparse>(a, b),
      kSplit ? a.o_part : a.o, kSplit ? a.m_part : a.m,
      kSplit ? a.l_part : a.l, ((long)z * a.B + b) * a.R, clk);
  if constexpr (kSplit) combine<Sh::THREADS, Sh::ROWS>(a, b, z, r0);
  clk.mark(stamp::COMBINE);
  clk.finish(a.stamps);
}

template <class T, bool kSplit, bool kSparse>
__global__ void __launch_bounds__(attend::THREADS, 2) attend_kernel(Args a) {
  const int b = blockIdx.y, z = blockIdx.z, r0 = blockIdx.x * attend::ROWS;
  int s_begin, s_end;
  span_of<kSparse>(a, attend::BS, b, z, s_begin, s_end);
  attend::attend_span<T>(
      a.q + b * a.q_b, a.q_r, cache_of<T>(a, b), a.c_r, a.R, r0, a.D,
      a.d_v, a.scale, s_begin, s_end, rows_of<kSparse>(a, b),
      kSplit ? a.o_part : a.o, kSplit ? a.m_part : a.m,
      kSplit ? a.l_part : a.l, ((long)z * a.B + b) * a.R);
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
  static Set done[256];
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
  else if (n_done < 256)
    done[n_done++] = Set{dev, kernel, smem};
  return cudaSuccess;
}

// A loop's kernel, its query rows and threads a block, and its shared
// memory at D.
struct Kernel {
  const void* fn;
  int rows, threads, smem;
};

template <class T, bool kSplit, bool kSparse, bool kStamp>
Kernel kernel_of(int loop, int D) {
  switch (loop) {
    case GROUP: {
      using Sh = group::Wide;
      return {(const void*)group_kernel<Sh, T, kSplit, kSparse, kStamp>,
              group::ROWS, Sh::THREADS, group::smem_bytes<Sh, T>(kSparse)};
    }
    case GROUP32: {
      using Sh = tiled::Group32;
      return {(const void*)tiled_kernel<Sh, T, kSplit, kSparse, kStamp>,
              Sh::ROWS, Sh::THREADS, tiled::smem_bytes<Sh, T>(D, kSparse)};
    }
    case TILED16: {
      using Sh = tiled::Single;
      return {(const void*)tiled_kernel<Sh, T, kSplit, kSparse, false>,
              Sh::ROWS, Sh::THREADS, tiled::smem_bytes<Sh, T>(D, kSparse)};
    }
    default:
      return {(const void*)attend_kernel<T, kSplit, kSparse>, attend::ROWS,
              attend::THREADS, attend::smem_bytes<T>(D, kSparse)};
  }
}

// The kernel of `loop` for a launch of n_split spans.
template <class T, bool kSparse, bool kStamp>
Kernel kernel_for(int loop, int D, int n_split) {
  return n_split > 1 ? kernel_of<T, true, kSparse, kStamp>(loop, D)
                     : kernel_of<T, false, kSparse, kStamp>(loop, D);
}

inline int launch(const Kernel& k, Args a, cudaStream_t st) {
  const bool split = a.n_split > 1;
  const int merge_smem =
      split ? tiled::combine_smem_bytes(k.rows, a.n_split, k.threads) : 0;
  const int smem = k.smem > merge_smem ? k.smem : merge_smem;
  cudaError_t err = allow_smem(k.fn, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.R + k.rows - 1) / k.rows, a.B, a.n_split);
  void* args[] = {&a};
  if (split)                              // every block co-resident
    err = cudaLaunchCooperativeKernel(k.fn, grid, dim3(k.threads), args,
                                      smem, st);
  else
    err = cudaLaunchKernel(k.fn, grid, dim3(k.threads), args, smem, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Launch `loop` over a cache of element type `dtype` on checked arguments;
// kStamp: the stamped build of the group loops (a.stamps set).
template <bool kSparse, bool kStamp = false>
int run(int loop, int dtype, const Args& a, cudaStream_t st) {
  if (dtype == 1)
    return launch(
        kernel_for<__nv_bfloat16, kSparse, kStamp>(loop, a.D, a.n_split), a,
        st);
  if (dtype == 2)
    return launch(kernel_for<__half, kSparse, kStamp>(loop, a.D, a.n_split),
                  a, st);
  return launch(kernel_for<float, kSparse, kStamp>(loop, a.D, a.n_split), a,
                st);
}

// The dynamic shared memory of loop `loop`'s block over an f32 cache at D
// (its loop; the combine of n_split <= 132 spans needs less) and the blocks
// one SM holds with it, as the occupancy API reports them; 0 on an error.
template <bool kSparse>
int resources(int loop, int D, int* smem) {
  const Kernel k = kernel_of<float, true, kSparse, false>(loop, D);
  *smem = k.smem;
  int n = 0;
  if (allow_smem(k.fn, k.smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, k.fn, k.threads,
                                                    k.smem) != cudaSuccess)
    return 0;
  return n;
}

}  // namespace decode
