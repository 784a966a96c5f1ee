// flash_prefill_bf16: causal latent flash attention (absorbed-MLA prefill)
// on Hopper's tensor cores: bf16 operands, f32 accumulation, f32 output.
//
// Replaces: src/repro/kernels/flash_prefill/kernel.py:74,
// flash_prefill_pallas (body _kernel), for bf16 operands; flash_prefill.cu
// stays the f32 path. Absorbed queries q (B, Sq, H, D) attend the latent
// cache ckv (B, Sk, D) causally, tail-aligned (query i sees cache rows
// [0, Sk - Sq + i]); the values are the first d_v columns of the same rows.
// Returns o (B, Sq, H, d_v) in f32.
//
// Bound on this card. One 2048-token sequence at V2-Lite width (H = 16,
// D = 576, d_v = 512) is 2 * 16 * (2048 * 2049 / 2) * 1088 = 73.1 GFLOP:
// 0.074 ms at 989 TFLOP/s bf16. Its bytes (2-byte q and ckv read once, the
// 4-byte o written once) are ~107 MB, 0.032 ms at 3.35 TB/s: operation-bound.
//
// Design.
// * Rows. q (B, Sq, H, D) is (B, Sq * H, D); row r is position r / H. A
//   block owns BM = 64 rows (four positions x 16 heads at V2-Lite width)
//   and reads each cache tile once for all of them (attend.cuh's f32 loop
//   reads it once per 16 rows). Blocks are issued longest first.
// * Tiles by TMA. The query tile (64 x 576 bf16 = 72 KB) is loaded once;
//   cache tiles of BN = 64 rows (72 KB) stream through a ring of two
//   stages. A 128-byte swizzle makes a box 64 columns wide, so a 576-wide
//   tile is nine boxes of 8 KB, each loaded by one 3-D TMA copy (column,
//   row, batch): past the end of Sq * H or Sk the copy fills zeros, and the
//   stage's mbarrier still expects the whole boxes' bytes. One producer
//   thread keeps the next tile in flight with full/empty mbarrier pairs.
//   Shared memory: Q 72 KB + 2 stages x 72 KB + P 8 KB + row exchange 1 KB
//   + barriers + 1 KB of alignment slack = 231,464 B of 232,448: one block
//   (three warpgroups) per SM.
// * Two consumer warpgroups share the 64 rows and split the work by
//   columns. S = Q K^T: warpgroup w computes the tile's cache rows
//   [32w, 32w + 32) with m64n32k16 over 36 k-steps (A = Q, B = the K rows,
//   both K-major), bf16 x bf16 products exact in f32. The online softmax
//   runs on the f32 S in base 2 (scale * log2 e folded in): each warpgroup
//   takes its rows' max over its 32 columns, the two exchange it through
//   shared memory (named barrier 1), and while the running max is -inf the
//   reference point is pinned to 0, so no (-inf) - (-inf) arises and a row
//   with nothing to attend returns the merge identity. l is summed from the
//   f32 p. P is rounded to bf16 into one shared 64 x 64 tile in the same
//   swizzled K-major layout TMA writes; fence.proxy.async makes the
//   generic-proxy stores visible to wgmma, named barrier 2 waits for both
//   halves. O = P V: V is the first d_v columns of the same cache tile, an
//   MN-major B operand (transpose bit set; LBO = 8 KB between 64-column
//   boxes, SBO = 1 KB between 8-row groups); warpgroup w owns output
//   columns [256w, 256w + 256): m64n256k16, 128 f32 accumulators a thread.
//   After its PV wait each consumer warp releases the stage (empty barrier
//   of 8 arrivals). setmaxnreg gives the consumers 240 registers and the
//   producer 24.
// * Causality. A block walks the cache only to its last row's reach; only
//   a tile that crosses its first row's limit is masked, per row (row r
//   sees rows below Sk - Sq + r / H + 1). When the row tiles cannot fill
//   the SMs (a short or tail-aligned prefill), the cache span is split
//   across blocks and the pieces merge exactly (merge.cuh), as in
//   flash_prefill.cu; a span past a row's reach is the merge identity.
// * Limits: D <= 576 and D % 8 == 0 (16-byte TMA strides), d_v <= 512 and
//   d_v % 16 == 0, ckv with unit column stride and row/batch strides
//   divisible by 8 elements. The wrapper checks them and raises.
//
// ptxas -v (sm_90a, CUDA 12.8; chip_smoke.py's build phase prints it): 168
// registers at entry (the launch bound of 384 threads; setmaxnreg then
// moves 240 to each consumer thread, 24 to each producer thread), 0 bytes
// of spill stores and loads, 3 barriers. It notes (C7519) that it injects
// warpgroup.arrive before three wgmma uses of the accumulator registers.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "merge.cuh"

namespace {

constexpr int BM = 64;                    // query rows per block
constexpr int BN = 64;                    // cache rows per tile
constexpr int BOX = 64;                   // bf16 columns per 128-byte box
constexpr int MAX_BOXES = 9;              // D <= 576
constexpr int BOX_BYTES = 64 * 128;       // one box of 64 rows
constexpr int TILE_BYTES = MAX_BOXES * BOX_BYTES;
constexpr int STAGES = 2;
constexpr int MAX_DV = 512;
constexpr int CONSUMERS = 2;              // warpgroups
constexpr float kLn2 = 0.6931471805599453f;
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int Q_OFF = 0;
constexpr int KV_OFF = TILE_BYTES;
constexpr int P_OFF = KV_OFF + STAGES * TILE_BYTES;
constexpr int RED_OFF = P_OFF + BM * BN * 2;    // row max, row sum: [2][BM]
constexpr int BAR_OFF = RED_OFF + 2 * CONSUMERS * BM * 4;
constexpr int SMEM_BYTES = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;
static_assert(SMEM_BYTES <= 232448, "one block must fit in an SM");
static_assert(BM == BN, "one box shape for the q and the cache tiles");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Wait for the completion of the barrier's phase of parity `parity`.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// One box of a 3-D tensor map (column, row, batch) into shared memory.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2) : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1 (B128).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keeps the compiler from moving accesses of accumulators across the
// asynchronous wgmma that writes them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// S += A B, m64n32k16: A and B K-major (16 accumulators a thread)
__device__ __forceinline__ void wgmma_s(float (&d)[16], uint64_t a,
                                        uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

// O += P V, m64n256k16: A K-major, B MN-major (128 accumulators)
__device__ __forceinline__ void wgmma_pv(float (&d)[128], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(1));
}

// Byte offset of element (row, col) in a 64-column box with the 128-byte
// swizzle (16-byte chunk index XOR row % 8), as TMA writes it.
__device__ __forceinline__ uint32_t swz(int row, int col) {
  return row * 128 + ((((col >> 3) ^ row) & 7) << 4) + (col & 7) * 2;
}

__global__ void __launch_bounds__(THREADS, 1)
flash_prefill_bf16_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap c_map, int B,
                          int R, int Sk, int n_box, int d_v, float scale_log2,
                          int H, int offset, int split_len,
                          float* __restrict__ o, float* __restrict__ m_out,
                          float* __restrict__ l_out) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* smem = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  const uint32_t q_s = base + Q_OFF, kv_s = base + KV_OFF, p_s = base + P_OFF;
  float* red_max = reinterpret_cast<float*>(smem + RED_OFF);   // [2][BM]
  float* red_sum = red_max + CONSUMERS * BM;                    // [2][BM]
  const uint32_t q_full = base + BAR_OFF;
  const uint32_t full0 = q_full + 8, empty0 = full0 + 8 * STAGES;

  const int b = blockIdx.y;
  const int z = blockIdx.z;                          // which span of the cache
  const int r0 = (gridDim.x - 1 - blockIdx.x) * BM;  // longest first
  const int last = min(r0 + BM, R) - 1;
  const int reach = min(Sk, offset + last / H + 1);
  const int s_begin = z * split_len;
  const int s_end = min(reach, s_begin + split_len);
  const int t_begin = s_begin / BN;
  const int n_tiles = s_end > s_begin ? (s_end - s_begin + BN - 1) / BN : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, CONSUMERS * 4);    // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {
    // ---- producer: one thread issues every TMA copy ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == CONSUMERS * 128 && n_tiles > 0) {
      const uint32_t bytes = n_box * BOX_BYTES;
      mbar_expect_tx(q_full, bytes);
      for (int k = 0; k < n_box; ++k)
        tma_load(q_s + k * BOX_BYTES, &q_map, q_full, k * BOX, r0, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % STAGES;
        if (it >= STAGES)                // wait for both warpgroups' release
          mbar_wait(empty0 + 8 * s, ((it / STAGES) - 1) & 1);
        mbar_expect_tx(full0 + 8 * s, bytes);
        for (int k = 0; k < n_box; ++k)
          tma_load(kv_s + s * TILE_BYTES + k * BOX_BYTES, &c_map,
                   full0 + 8 * s, k * BOX, (t_begin + it) * BN, b);
      }
    }
  } else {
    // ---- consumers: warpgroup wg, rows rl and rl + 8 of each thread ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int rl = 16 * warp + lane / 4;
    const int cq = 2 * (lane % 4);     // column pair within an 8-column block
    const int lim0 = min(offset + (r0 + rl) / H + 1, s_end);
    const int lim1 = min(offset + (r0 + rl + 8) / H + 1, s_end);
    const int lim_first = min(offset + r0 / H + 1, s_end);
    float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f;
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    if (n_tiles > 0) mbar_wait(q_full, 0);

    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % STAGES;
      const uint32_t kv = kv_s + s * TILE_BYTES;
      mbar_wait(full0 + 8 * s, (it / STAGES) & 1);

      // S = Q K^T over this warpgroup's 32 cache rows of the tile
      float sc[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) sc[i] = 0.f;
      fence_regs(sc);
      wg_fence();
      for (int k = 0; k < n_box; ++k) {
#pragma unroll
        for (int kk = 0; kk < BOX / 16; ++kk)
          wgmma_s(sc, desc(q_s + k * BOX_BYTES + kk * 32, 16, 1024),
                  desc(kv + k * BOX_BYTES + wg * 32 * 128 + kk * 32, 16,
                       1024));
      }
      wg_commit();
      wg_wait_all();
      fence_regs(sc);

      // scale (base 2), causal mask where the tile crosses a row's limit
      const int c0 = (t_begin + it) * BN + 32 * wg + cq;
      const bool edge = (t_begin + it) * BN + BN > lim_first;
      float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float v = sc[4 * i + e] * scale_log2;
          if (edge && c0 + 8 * i + (e & 1) >= (e < 2 ? lim0 : lim1))
            v = -CUDART_INF_F;
          sc[4 * i + e] = v;
        }
        mx0 = fmaxf(mx0, fmaxf(sc[4 * i], sc[4 * i + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[4 * i + 2], sc[4 * i + 3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      if (lane % 4 == 0) {
        red_max[wg * BM + rl] = mx0;
        red_max[wg * BM + rl + 8] = mx1;
      }
      named_sync(1, CONSUMERS * 128);
      mx0 = fmaxf(mx0, red_max[(1 - wg) * BM + rl]);
      mx1 = fmaxf(mx1, red_max[(1 - wg) * BM + rl + 8]);

      // online softmax; the reference point is 0 while the max is -inf
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float sf0 = mn0 == -CUDART_INF_F ? 0.f : mn0;
      const float sf1 = mn1 == -CUDART_INF_F ? 0.f : mn1;
      const float al0 = exp2f(m0 - sf0), al1 = exp2f(m1 - sf1);
      m0 = mn0;
      m1 = mn1;
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        sc[4 * i] = exp2f(sc[4 * i] - sf0);
        sc[4 * i + 1] = exp2f(sc[4 * i + 1] - sf0);
        sc[4 * i + 2] = exp2f(sc[4 * i + 2] - sf1);
        sc[4 * i + 3] = exp2f(sc[4 * i + 3] - sf1);
        ps0 += sc[4 * i] + sc[4 * i + 1];
        ps1 += sc[4 * i + 2] + sc[4 * i + 3];
        // P rounded to bf16, into the swizzled K-major tile
        const int col = 32 * wg + 8 * i + cq;
        const __nv_bfloat162 p0 = __floats2bfloat162_rn(sc[4 * i],
                                                        sc[4 * i + 1]);
        const __nv_bfloat162 p1 = __floats2bfloat162_rn(sc[4 * i + 2],
                                                        sc[4 * i + 3]);
        *reinterpret_cast<__nv_bfloat162*>(smem + P_OFF + swz(rl, col)) = p0;
        *reinterpret_cast<__nv_bfloat162*>(smem + P_OFF + swz(rl + 8, col)) =
            p1;
      }
      l0 = l0 * al0 + ps0;
      l1 = l1 * al1 + ps1;
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        acc[4 * i] *= al0;
        acc[4 * i + 1] *= al0;
        acc[4 * i + 2] *= al1;
        acc[4 * i + 3] *= al1;
      }
      named_sync(2, CONSUMERS * 128);   // both halves of P are in place

      // O += P V: V = the first columns of the same tile, MN-major
      fence_regs(acc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wgmma_pv(acc, desc(p_s + kk * 32, 16, 1024),
                 desc(kv + wg * 4 * BOX_BYTES + kk * 16 * 128, BOX_BYTES,
                      1024));
      wg_commit();
      wg_wait_all();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(empty0 + 8 * s);   // this warp is done
    }

    // l: the four lanes of a row, then the two warpgroups' halves
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    if (lane % 4 == 0) {
      red_sum[wg * BM + rl] = l0;
      red_sum[wg * BM + rl + 8] = l1;
    }
    named_sync(1, CONSUMERS * 128);
    l0 += red_sum[(1 - wg) * BM + rl];
    l1 += red_sum[(1 - wg) * BM + rl + 8];

    const float d0 = l0 > 0.f ? l0 : 1.f, d1 = l1 > 0.f ? l1 : 1.f;
    const long out = ((long)z * B + b) * R;
    const int g0 = r0 + rl, g1 = g0 + 8;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = 256 * wg + 8 * i + cq;
      if (col < d_v) {
        if (g0 < R)
          *reinterpret_cast<float2*>(o + (out + g0) * d_v + col) =
              make_float2(acc[4 * i] / d0, acc[4 * i + 1] / d0);
        if (g1 < R)
          *reinterpret_cast<float2*>(o + (out + g1) * d_v + col) =
              make_float2(acc[4 * i + 2] / d1, acc[4 * i + 3] / d1);
      }
    }
    if (wg == 0 && lane % 4 == 0) {    // m back to natural-log units
      if (g0 < R) {
        m_out[out + g0] = m0 * kLn2;
        l_out[out + g0] = l0;
      }
      if (g1 < R) {
        m_out[out + g1] = m1 * kLn2;
        l_out[out + g1] = l1;
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, looked up through the runtime so that
// nothing links libcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (cols, rows, batches) bf16 tensor with unit column stride, cut into
// 64 x 64 boxes with the 128-byte swizzle; zeros past every edge.
bool encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, long cols,
            long rows, long batches, long row_bytes, long batch_bytes) {
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)batches};
  const cuuint64_t strides[2] = {(cuuint64_t)row_bytes,
                                 (cuuint64_t)batch_bytes};
  const cuuint32_t box[3] = {BOX, BM, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// q (B, Sq, H, D) contiguous bf16, R = Sq * H rows per batch row; ckv bf16
// with unit column stride, row and batch strides c_r, c_b (elements). With
// n_split == 1 the kernel writes o/m/l directly and the *_part buffers are
// unused; otherwise it writes n_split partials of (B, R) rows each into
// them, and the merge kernel combines those. Returns a cudaError_t, or -1
// for arguments the kernel does not take, -2 when libcuda has no
// cuTensorMapEncodeTiled, -3 when a tensor map is refused.
extern "C" int flash_prefill_bf16(const void* q, const void* ckv, long c_b,
                                  long c_r, int B, int R, int Sk, int D,
                                  int d_v, float scale, int H, int offset,
                                  int split_len, int n_split, float* o,
                                  float* m, float* l, float* o_part,
                                  float* m_part, float* l_part,
                                  void* stream) {
  if (D % 8 != 0 || D > MAX_BOXES * BOX || d_v > MAX_DV || d_v % 16 != 0 ||
      d_v > D || H < 1 || offset < 0 || split_len % BN != 0 || n_split < 1 ||
      n_split > MERGE_MAX_SLOTS || c_r % 8 != 0 || (B > 1 && c_b % 8 != 0))
    return -1;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaFuncSetAttribute(
      flash_prefill_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || R == 0) return (int)cudaGetLastError();
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return -2;
  CUtensorMap q_map, c_map;
  // a single batch row never moves the batch coordinate: any valid stride
  const long cb_bytes = B > 1 ? c_b * 2 : (long)Sk * c_r * 2;
  if (!encode(fn, &q_map, q, D, R, B, (long)D * 2, (long)R * D * 2) ||
      !encode(fn, &c_map, ckv, D, Sk, B, c_r * 2, cb_bytes))
    return -3;
  const float scale_log2 = scale * 1.4426950408889634f;
  dim3 grid((R + BM - 1) / BM, B, n_split);
  const bool direct = n_split == 1;
  flash_prefill_bf16_kernel<<<grid, THREADS, SMEM_BYTES, st>>>(
      q_map, c_map, B, R, Sk, (D + BOX - 1) / BOX, d_v, scale_log2, H, offset,
      split_len, direct ? o : o_part, direct ? m : m_part,
      direct ? l : l_part);
  err = cudaGetLastError();
  if (err != cudaSuccess || direct) return (int)err;
  const long n_rows = (long)B * R;
  merge_rows_kernel<<<(unsigned)n_rows, MERGE_THREADS, 0, st>>>(
      o_part, m_part, l_part, n_split, n_rows, d_v, o, m, l);
  return (int)cudaGetLastError();
}
