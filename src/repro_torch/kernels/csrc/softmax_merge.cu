// softmax_merge: the exact M-way (o, m, l) merge on Hopper, f32.
//
// Replaces: src/repro/kernels/softmax_merge/kernel.py, softmax_merge_pallas
// (a grid over B, each step holding the (M, H, d_v) stack of one batch row
// in VMEM).
//
// Bound on this card: bytes. Each row reads M (d_v + 2) floats and writes
// d_v + 2; there are about 3 M operations per byte of o, far below the
// H100's ~20 f32 operations per byte. A serving request's merge is a few
// KB to a few hundred KB, so a call is one memory latency or two, not
// bandwidth: the design keeps it to one round trip.
//
// Design.
// * Two entries on one kernel. softmax_merge_f32 takes the stacked
//   (M, n_rows, d_v) partials, slot i at base + i x slot stride, up to
//   MERGE_MAX_SLOTS slots; softmax_merge_parts_f32 takes a table of up to
//   MAX_PARTS (o, m, l) pointers passed by value in the kernel's
//   parameters, so the serving path merges a request's partials where they
//   lie, with no stack copies before it.
// * A thread owns one (row, 4 columns) item. It loads its row's M (m, l)
//   pairs and its M 16-byte o values all at once, then computes the
//   weights in registers: one memory round trip, no shared memory, no
//   barrier. The (m, l) loads of a row's threads are the same addresses
//   and broadcast. The slots live in registers of a kernel sized for M
//   rounded up to 2, 4, 8 or 16 (a variant sized for 16 slots ran small M
//   markedly slower: the unused slots still cost registers and predicated
//   code). Past MAX_PARTS slots (the stacked entry only) the thread walks
//   the slots in order, four at a time.
// * 128 threads a block (one row of d_v = 512 a block: a serving request's
//   16 rows make 16 blocks), 256 when there are many rows (two a block).
// * A call is latency, not bytes (chip_smoke.py phase 3 times a launch
//   that does no work beside it). The kernel is launched with
//   programmatic stream serialization, so its launch overlaps the tail of
//   the kernel before it (the attention that wrote the partials); it waits
//   (griddepcontrol.wait) for that kernel's completion and writes before
//   its first load. Kernels after it launch as usual and wait for it to
//   finish.
// * Bits: merge.cuh's arithmetic. Each product and sum rounded alone, and
//   the sums over the slots keep four interleaved partial sums (slot i
//   into sum i mod 4, then ((s0 + s1) + s2) + s3), the order PyTorch's CUDA
//   reduction takes over a leading dimension: the kernel reproduces the
//   plain version on the card bit for bit, through either entry.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <type_traits>

#include "merge.cuh"

namespace {

constexpr int MAX_PARTS = 16;             // slots in registers / in place
constexpr long MANY_ITEMS = 128L * 132 * 4;   // from here 256 threads

// Slot i at o + i * o_slot (row r at + r * d_v), m + i * ml_slot, l + ...
struct Stacked {
  const float* o;
  const float* m;
  const float* l;
  long o_slot, ml_slot;
  __device__ __forceinline__ const float* o_of(int i) const {
    return o + i * o_slot;
  }
  __device__ __forceinline__ const float* m_of(int i) const {
    return m + i * ml_slot;
  }
  __device__ __forceinline__ const float* l_of(int i) const {
    return l + i * ml_slot;
  }
};

// Slot i at o[i], m[i], l[i]: M <= MAX_PARTS contiguous partials.
struct Table {
  const float* o[MAX_PARTS];
  const float* m[MAX_PARTS];
  const float* l[MAX_PARTS];
  __device__ __forceinline__ const float* o_of(int i) const { return o[i]; }
  __device__ __forceinline__ const float* m_of(int i) const { return m[i]; }
  __device__ __forceinline__ const float* l_of(int i) const { return l[i]; }
};

__device__ __forceinline__ float4 scaled(float k, float4 v) {
  return make_float4(__fmul_rn(k, v.x), __fmul_rn(k, v.y), __fmul_rn(k, v.z),
                     __fmul_rn(k, v.w));
}

__device__ __forceinline__ float scaled(float k, float v) {
  return __fmul_rn(k, v);
}

// V = float4 when d_v % 4 == 0 and every slot is 16-byte aligned, else
// float. K > 0: the M <= K slots in registers, loaded at once; K = 0: the
// slot loop (Stacked only, M > MAX_PARTS).
template <class Slots, class V, int K>
__global__ void __launch_bounds__(256)
merge_kernel(Slots s, int M, long n_rows, int d_v, float* __restrict__ o_out,
             float* __restrict__ m_out, float* __restrict__ l_out) {
  // launched as a programmatic dependent: wait until the kernel before it
  // in the stream (which wrote the partials) has finished and its writes
  // are visible
  asm volatile("griddepcontrol.wait;" ::: "memory");
  constexpr int W = sizeof(V) / sizeof(float);
  const int dw = d_v / W;
  const long item = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (item >= n_rows * dw) return;
  const long row = item / dw;
  const int c = (int)(item % dw);
  const long at = row * dw + c;
  float m_star = -CUDART_INF_F, l_star;
  V out;
  if constexpr (K > 0) {
    float mv[K], lv[K];
    V ov[K];
#pragma unroll
    for (int i = 0; i < K; ++i)
      if (i < M) {
        mv[i] = s.m_of(i)[row];
        lv[i] = s.l_of(i)[row];
        ov[i] = reinterpret_cast<const V*>(s.o_of(i))[at];
      }
#pragma unroll
    for (int i = 0; i < K; ++i)
      if (i < M) m_star = fmaxf(m_star, mv[i]);
    const float safe = isfinite(m_star) ? m_star : 0.0f;
    float ls[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < K; ++i)
      if (i < M) {
        lv[i] = __fmul_rn(lv[i], expf(mv[i] - safe));    // w_i
        ls[i % 4] = add_rn(ls[i % 4], lv[i]);
      }
    l_star = add_rn(add_rn(add_rn(ls[0], ls[1]), ls[2]), ls[3]);
    const float denom = l_star > 0.0f ? l_star : 1.0f;
    V os[4] = {};
#pragma unroll
    for (int i = 0; i < K; ++i)
      if (i < M)
        os[i % 4] =
            add_rn(os[i % 4], scaled(__fdiv_rn(lv[i], denom), ov[i]));
    out = add_rn(add_rn(add_rn(os[0], os[1]), os[2]), os[3]);
  } else {
    for (int i = 0; i < M; ++i) m_star = fmaxf(m_star, s.m_of(i)[row]);
    const float safe = isfinite(m_star) ? m_star : 0.0f;
    auto w = [&](int i) {
      return __fmul_rn(s.l_of(i)[row], expf(s.m_of(i)[row] - safe));
    };
    l_star = sum_slots<float>(M, w);
    const float denom = l_star > 0.0f ? l_star : 1.0f;
    out = sum_slots<V>(M, [&](int i) {
      return scaled(__fdiv_rn(w(i), denom),
                    reinterpret_cast<const V*>(s.o_of(i))[at]);
    });
  }
  reinterpret_cast<V*>(o_out)[at] = out;
  if (c == 0) {
    m_out[row] = l_star > 0.0f ? m_star : -CUDART_INF_F;
    l_out[row] = l_star;
  }
}

// One launch of merge_kernel<Slots, V, K>, with programmatic stream
// serialization: its launch overlaps the tail of the kernel before it.
template <class Slots, class V, int K>
int launch_k(const Slots& s, int M, long n_rows, int d_v, float* o_out,
             float* m_out, float* l_out, cudaStream_t st) {
  const long items = n_rows * (d_v / (int)(sizeof(V) / sizeof(float)));
  const int threads = items >= MANY_ITEMS ? 256 : 128;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((items + threads - 1) / threads));
  cfg.blockDim = dim3(threads);
  cfg.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, merge_kernel<Slots, V, K>, s, M,
                                 n_rows, d_v, o_out, m_out, l_out);
}

// The kernel for M slots: M rounded up to 2, 4, 8 or 16 slots in
// registers (past MAX_PARTS, the slot loop).
template <class Slots, class V>
int launch_m(const Slots& s, int M, long n_rows, int d_v, float* o_out,
             float* m_out, float* l_out, cudaStream_t st) {
  if (M <= 2)
    return launch_k<Slots, V, 2>(s, M, n_rows, d_v, o_out, m_out, l_out, st);
  if (M <= 4)
    return launch_k<Slots, V, 4>(s, M, n_rows, d_v, o_out, m_out, l_out, st);
  if (M <= 8)
    return launch_k<Slots, V, 8>(s, M, n_rows, d_v, o_out, m_out, l_out, st);
  if (M <= MAX_PARTS)
    return launch_k<Slots, V, MAX_PARTS>(s, M, n_rows, d_v, o_out, m_out,
                                         l_out, st);
  if constexpr (std::is_same_v<Slots, Stacked>)
    return launch_k<Slots, V, 0>(s, M, n_rows, d_v, o_out, m_out, l_out, st);
  return -1;
}

template <class Slots>
int launch(const Slots& s, bool vec4, int M, long n_rows, int d_v,
           float* o_out, float* m_out, float* l_out, cudaStream_t st) {
  if (n_rows == 0 || d_v == 0) return (int)cudaGetLastError();
  return vec4 ? launch_m<Slots, float4>(s, M, n_rows, d_v, o_out, m_out,
                                        l_out, st)
              : launch_m<Slots, float>(s, M, n_rows, d_v, o_out, m_out,
                                       l_out, st);
}

bool aligned16(const void* p) { return ((unsigned long)p & 15) == 0; }

}  // namespace

// o (M, n_rows, d_v), m and l (M, n_rows), contiguous f32; M <=
// MERGE_MAX_SLOTS.
extern "C" int softmax_merge_f32(const float* o, const float* m,
                                 const float* l, int M, long n_rows, int d_v,
                                 float* o_out, float* m_out, float* l_out,
                                 void* stream) {
  if (M < 1 || M > MERGE_MAX_SLOTS) return -1;
  const Stacked s{o, m, l, n_rows * d_v, n_rows};
  const bool vec4 = d_v % 4 == 0 && aligned16(o) && aligned16(o_out);
  return launch(s, vec4, M, n_rows, d_v, o_out, m_out, l_out,
                (cudaStream_t)stream);
}

// Slot i: o = ptrs[i] (n_rows, d_v), m = ptrs[M + i] and l = ptrs[2 M + i]
// (n_rows,), each contiguous f32, read in place; M <= MAX_PARTS. ptrs is a
// host array of 3 M device pointers.
extern "C" int softmax_merge_parts_f32(const float* const* ptrs, int M,
                                       long n_rows, int d_v, float* o_out,
                                       float* m_out, float* l_out,
                                       void* stream) {
  if (M < 1 || M > MAX_PARTS) return -1;
  Table t{};
  bool vec4 = d_v % 4 == 0 && aligned16(o_out);
  for (int i = 0; i < M; ++i) {
    t.o[i] = ptrs[i];
    t.m[i] = ptrs[M + i];
    t.l[i] = ptrs[2 * M + i];
    vec4 = vec4 && aligned16(t.o[i]);
  }
  return launch(t, vec4, M, n_rows, d_v, o_out, m_out, l_out,
                (cudaStream_t)stream);
}
