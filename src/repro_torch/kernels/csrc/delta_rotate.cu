// delta_rotate: the FETCH splice (paper §2.2) in one launch. Every row of
// the fetched chunk is copied into the moved copy, its d_c latent columns
// as they are and its decoupled-RoPE band (d_r = 2 d2 columns at d_c)
// rotated by one fixed position delta; f32 or bf16. With d_c = 0 it is the
// band rotation alone.
//
// Replaces: src/repro/kernels/delta_rotate/kernel.py, delta_rotate_pallas
// ((BS, d_r) tiles streamed through VMEM with cos/sin broadcast); the
// latent copy is the jnp.concatenate of src/repro/core/splice.py.
//
// NeoX half-split pairing: with the band x = [x1 | x2] (d2 each),
//   y1 = x1 cos - x2 sin ;  y2 = x2 cos + x1 sin
// with one (cos, sin) per frequency, the same for every row: the angle
// depends on delta only. The band is widened to f32, each product and the
// difference / sum is rounded on its own (no fused multiply-add) and the
// result is rounded to the storage type once at the store: the rounding of
// the plain PyTorch version (models/layers.py apply_rope), so the kernel
// reproduces it bit for bit. The latent columns are copied bit for bit.
// Delta 0 still rotates (cos = 1, sin = 0), as the reference does.
//
// Bound on this card: bytes (the band's 6 operations per pair are nothing
// beside the 2 x 576 x 4 bytes a V2-Lite row moves in f32). A 2048-row
// chunk is 4.7 MB each way in f32, so the kernel is a copy, and a copy is
// paced by the bytes each SM keeps in flight: by Little's law 3.35 TB/s x
// ~0.6 us of latency is ~2 MB across 132 SMs, ~15 KB an SM.
//
// Design.
// * A row is cut into items of 16 bytes (4 f32 or 8 bf16): d_c / W latent
//   vectors, then d2 / W band pairs (vector k of x1 with vector k of x2).
//   Items are numbered row by row; thread t of the grid takes items t,
//   t + G, t + 2G, ... (G threads in the grid), so neighbouring threads
//   touch neighbouring 16-byte vectors and every warp access is whole
//   lines. A thread issues the loads of UNROLL items (up to 2 UNROLL
//   16-byte loads) before its first store. The grid is sized to the work
//   and to the SM count (splice_plan in ops.py): one round of UNROLL items
//   a thread where that fills the card, blocks past what the card holds
//   at once running in waves (a grid capped at the resident blocks, its
//   threads walking on round after round, ran 10% slower over 27 layers
//   on an H100: each round waits out its loads, where a new block's loads
//   overlap an old block's stores). The kernel itself walks on for any
//   grid; (row, item) advances by the grid's stride with one carry, no
//   division in the loop.
// * Rows are addressed through a row pitch on each side, so the source
//   can be the band slice of wider rows and the destination a slice of a
//   pool; the kernel writes in place when the two are the same rows (each
//   thread loads what it stores).
// * cos / sin travel by value in the launch parameters (nothing is
//   allocated on the device) and each block copies them to shared memory
//   before it waits for the kernel before it.
// * The 16-byte path needs both base pointers 16-byte aligned, both row
//   pitches multiples of 16 bytes and d_c, d2 multiples of W; otherwise
//   the same kernel runs with one element an item (VEC = false) and gives
//   the same bits. ops.py's plan makes the choice.
// * Programmatic dependent launch: the launch overlaps the tail of the
//   kernel before it in the stream, and griddepcontrol.wait holds the first
//   load until that kernel has finished and its writes are visible.
// * Plain stores: the moved copy is read right after by mla_decode, so it
//   is left in L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int MAX_PAIRS = 64;             // d_r <= 128
constexpr int UNROLL = 4;                 // items a thread loads at once

struct Angles {
  float c[MAX_PAIRS];
  float s[MAX_PAIRS];
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <class T>
__device__ __forceinline__ T narrow(float v) {
  if constexpr (std::is_same_v<T, float>)
    return v;
  else
    return __float2bfloat16_rn(v);
}

// One item's storage: a 16-byte vector of W = 16 / sizeof(T) elements, or
// one element.
template <class T, bool VEC>
struct Item {
  using Raw = std::conditional_t<VEC, uint4, T>;
  static constexpr int W = sizeof(Raw) / sizeof(T);

  // the W elements widened to f32 (exactly)
  static __device__ __forceinline__ void unpack(const Raw& r, float (&f)[W]) {
    if constexpr (!VEC) {
      f[0] = widen(r);
    } else {
      const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (std::is_same_v<T, float>) {
          f[i] = __uint_as_float(w[i]);
        } else {                          // bf16: element 2i low, 2i+1 high
          f[2 * i] = __uint_as_float(w[i] << 16);
          f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
        }
      }
    }
  }

  // f32 values rounded to T (to nearest even) and packed
  static __device__ __forceinline__ Raw pack(const float (&f)[W]) {
    if constexpr (!VEC) {
      return narrow<T>(f[0]);
    } else {
      unsigned w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (std::is_same_v<T, float>) {
          w[i] = __float_as_uint(f[i]);
        } else {
          const unsigned lo =
              __bfloat16_as_ushort(__float2bfloat16_rn(f[2 * i]));
          const unsigned hi =
              __bfloat16_as_ushort(__float2bfloat16_rn(f[2 * i + 1]));
          w[i] = lo | (hi << 16);
        }
      }
      return make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
};

// y1 = x1 c - x2 s, y2 = x2 c + x1 s on W pairs, in place; c and s point
// at the pairs' W angles in shared memory (16-byte aligned when W >= 4).
template <class T, bool VEC>
__device__ __forceinline__ void rotate(typename Item<T, VEC>::Raw& a,
                                       typename Item<T, VEC>::Raw& b,
                                       const float* c, const float* s) {
  using It = Item<T, VEC>;
  constexpr int W = It::W;
  float x1[W], x2[W], cv[W], sv[W];
  if constexpr (W >= 4) {
#pragma unroll
    for (int i = 0; i < W; i += 4) {
      const float4 c4 = *reinterpret_cast<const float4*>(c + i);
      const float4 s4 = *reinterpret_cast<const float4*>(s + i);
      cv[i] = c4.x, cv[i + 1] = c4.y, cv[i + 2] = c4.z, cv[i + 3] = c4.w;
      sv[i] = s4.x, sv[i + 1] = s4.y, sv[i + 2] = s4.z, sv[i + 3] = s4.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i) cv[i] = c[i], sv[i] = s[i];
  }
  It::unpack(a, x1);
  It::unpack(b, x2);
  float y1[W], y2[W];
#pragma unroll
  for (int i = 0; i < W; ++i) {
    y1[i] = __fsub_rn(__fmul_rn(x1[i], cv[i]), __fmul_rn(x2[i], sv[i]));
    y2[i] = __fadd_rn(__fmul_rn(x2[i], cv[i]), __fmul_rn(x1[i], sv[i]));
  }
  a = It::pack(y1);
  b = It::pack(y2);
}

// x, y: row r of the source at x + r ldx, of the destination at y + r ldy
// (elements); y may be x (in place), no other overlap.
template <class T, bool VEC>
__global__ void __launch_bounds__(256)
splice_kernel(const T* x, long ldx, T* y, long ldy, long S, int d_c, int d2,
              const __grid_constant__ Angles a) {
  using It = Item<T, VEC>;
  using Raw = typename It::Raw;
  constexpr int W = It::W;
  __shared__ __align__(16) float sc[MAX_PAIRS], ss[MAX_PAIRS];
  for (int j = threadIdx.x; j < d2; j += blockDim.x) {
    sc[j] = a.c[j];
    ss[j] = a.s[j];
  }
  __syncthreads();
  // launched as a programmatic dependent: wait until the kernel before it
  // in the stream has finished and its writes are visible
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int lat = d_c / W, per_row = lat + d2 / W;
  const long stride = (long)gridDim.x * blockDim.x;
  const long d_row = stride / per_row;
  const int d_k = (int)(stride % per_row);
  const long i0 = (long)blockIdx.x * blockDim.x + threadIdx.x;
  long row = i0 / per_row;
  int k = (int)(i0 % per_row);
  while (row < S) {
    Raw v1[UNROLL], v2[UNROLL];
    long rows[UNROLL];
    int ks[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      rows[u] = row;
      ks[u] = k;
      if (row < S) {
        const T* xr = x + row * ldx;
        if (k < lat) {
          v1[u] = *reinterpret_cast<const Raw*>(xr + k * W);
        } else {
          const T* x1 = xr + d_c + (k - lat) * W;
          v1[u] = *reinterpret_cast<const Raw*>(x1);
          v2[u] = *reinterpret_cast<const Raw*>(x1 + d2);
        }
      }
      row += d_row;
      k += d_k;
      if (k >= per_row) {
        k -= per_row;
        ++row;
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (rows[u] >= S) continue;
      T* yr = y + rows[u] * ldy;
      if (ks[u] < lat) {
        *reinterpret_cast<Raw*>(yr + ks[u] * W) = v1[u];
      } else {
        const int p = (ks[u] - lat) * W;
        rotate<T, VEC>(v1[u], v2[u], sc + p, ss + p);
        *reinterpret_cast<Raw*>(yr + d_c + p) = v1[u];
        *reinterpret_cast<Raw*>(yr + d_c + d2 + p) = v2[u];
      }
    }
  }
}

template <class T, bool VEC>
int launch(const void* x, long ldx, void* y, long ldy, long S, int d_c,
           int d2, const Angles& a, int blocks, int threads,
           cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3((unsigned)threads);
  cfg.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, splice_kernel<T, VEC>,
                                 static_cast<const T*>(x), ldx,
                                 static_cast<T*>(y), ldy, S, d_c, d2, a);
}

bool aligned16(const void* p, long pitch_bytes) {
  return ((unsigned long)p % 16 == 0) && (pitch_bytes % 16 == 0);
}

}  // namespace

// The splice of S rows: y[r, :d_c] = x[r, :d_c], y[r, d_c:d_c + 2 d2] = the
// band rotated. dtype 0 = f32, 1 = bf16; ldx / ldy are row pitches in
// elements; vec = 1 takes the 16-byte path (its conditions are checked
// again here), 0 the one-element path; blocks x threads as ops.py's plan
// sized them (blocks = 0 launches nothing). cos_host / sin_host: d2 floats
// each in host memory, copied into the launch parameters.
extern "C" int delta_rotate_splice(int dtype, int vec, const void* x,
                                   long ldx, void* y, long ldy, long S,
                                   int d_c, int d2, const float* cos_host,
                                   const float* sin_host, int blocks,
                                   int threads, void* stream) {
  if (d2 <= 0 || d2 > MAX_PAIRS || d_c < 0 || S < 0 || blocks < 0 ||
      threads <= 0 || threads > 256 || threads % 32 ||
      (dtype != 0 && dtype != 1))
    return -1;
  const int esize = dtype == 0 ? 4 : 2;
  const int W = 16 / esize;
  if (vec && !(aligned16(x, ldx * esize) && aligned16(y, ldy * esize) &&
               d_c % W == 0 && d2 % W == 0))
    return -1;
  if (blocks == 0 || S == 0) return 0;
  Angles a;
  for (int j = 0; j < d2; ++j) {
    a.c[j] = cos_host[j];
    a.s[j] = sin_host[j];
  }
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return vec ? launch<float, true>(x, ldx, y, ldy, S, d_c, d2, a, blocks,
                                     threads, st)
               : launch<float, false>(x, ldx, y, ldy, S, d_c, d2, a, blocks,
                                      threads, st);
  return vec ? launch<__nv_bfloat16, true>(x, ldx, y, ldy, S, d_c, d2, a,
                                           blocks, threads, st)
             : launch<__nv_bfloat16, false>(x, ldx, y, ldy, S, d_c, d2, a,
                                            blocks, threads, st);
}
