// flash_prefill: causal latent flash attention (absorbed-MLA prefill) on
// Hopper, f32 operands, the products on the tensor cores in split TF32.
//
// Replaces: src/repro/kernels/flash_prefill/kernel.py:74,
// flash_prefill_pallas (body _kernel), for f32 operands
// (flash_prefill_bf16.cu takes bf16): absorbed queries q (B, Sq, H, D)
// attend the latent cache ckv (B, Sk, D) causally, tail-aligned (query i
// sees cache rows [0, Sk - Sq + i]); the values are the first d_v columns
// of the same rows. Returns o (B, Sq, H, d_v).
//
// Bound on this card. Query row i attends Sk - Sq + i + 1 cache rows, at
// D + d_v multiply-adds each: one 2048-token sequence at V2-Lite width
// (H = 16, D = 576, d_v = 512) is 2 * 16 * (2048 * 2049 / 2) * 1088
// = 73.1 GFLOP against ~80 MB moved. At 67 TFLOP/s of f32 FMAs that is
// 1.09 ms; as three TF32 products at 495 TFLOP/s, 0.44 ms: operation-bound
// either way.
//
// Arithmetic. S = Q K^T and O += P V run as split-TF32 products
// (tf32x3.cuh: each f32 operand big + small, three TF32 products a step,
// the small terms first), each product within ~3 * 2^-22 of the f32 one.
// The tensor cores sum one chunk of two mma steps (16 columns or cache
// rows, x3 products) from zero; the chunk is added to the f32 accumulator
// with one rounded add, so they never carry a running sum. (A variant of
// this source that let them carry it put o past the 1e-5 bound at 2048
// tokens on the H100: their own accumulation rounds more coarsely.)
// tests/test_torch_tf32x3.py emulates the products on the CPU at V2-Lite
// width and holds o within 1e-5 of the plain version; one TF32 product
// misses it by ~100x. The online softmax (max, exp, l) runs in f32 on the
// S fragments.
//
// Design.
// * Rows. q (B, Sq, H, D) is (B, Sq * H, D); row r is position r / H (the
//   Pallas kernel folds heads into its query tile the same way). A block
//   owns BM = 64 rows (four positions at V2-Lite width), eight warps.
// * Shared memory is the constraint: one 576-wide f32 row is 2.3 KB. The
//   64-row Q tile stays resident (145 KB at pitch 580); one cache tile of
//   BN = 32 rows (73 KB) at a time, by cp.async; with P (64 x 32) and the
//   row statistics: 232,448 B, all a block may have, one block an SM. The
//   next tile's copy starts when this one is consumed and waits at the top
//   of the next step (the tile comes from L2: the whole cache of one
//   sequence is 4.7 MB). A ring of two 16-row stages hid that copy but
//   gave each warp half the S columns and twice the softmax, rescale and
//   barriers per cache row, and ran ~15% slower on the H100 (PERF.md,
//   PR 16). Q streamed in D-slices would reread Q from L2 for every tile.
// * S (64 x 32 a tile): warp w takes rows [16 (w % 4), +16) and half of the
//   D columns (w / 4), all four 8-column tiles of the tile, so each A
//   fragment of Q serves four products; fragments come by ldmatrix (four
//   8 x 4 f32 blocks an instruction). The second half's warps hand their
//   partial sums over through the P buffer, the first half's add them and
//   run the softmax for their 16 rows (quad shuffles for the row max and
//   sum).
// * O (64 x 512 f32): warp w owns output columns [64 w, 64 w + 64) for all
//   64 rows, 128 accumulators a thread; P V runs in two chunks of 16 cache
//   rows. A 16 x 8 B fragment of V reads
//   V[k][n] with k on the quad index: to keep the 32 lanes on 32 banks
//   (pitch = 4 mod 32), the 8 columns n of a fragment are four adjacent
//   columns and the four 16 columns further on; the output store applies
//   the same map. P's fragments come by ldmatrix.
// * Registers: the 128 O accumulators take most of 255, so 8 warps an SM;
//   16 warps of half the accumulators spilled under the 128-register cap
//   and ran slower (a variant of this source on the H100).
// * Causality is a per-row limit: position r / H sees cache rows below
//   Sk - Sq + r / H + 1. A block walks the cache only to its last row's
//   reach; a score past its row's limit is -inf, so tiles above the
//   diagonal cost nothing. While a row's running max is -inf the reference
//   point of exp is pinned to 0, so no (-inf) - (-inf) arises and a row
//   with nothing to attend returns the merge identity (o = 0, m = -inf,
//   l = 0).
// * Blocks are issued longest first. When the row tiles cannot fill the
//   SMs (a short or tail-aligned prefill), the cache span is split across
//   blocks and the spans merge exactly (merge.cuh); a span past a row's
//   reach is the merge identity.
// * Sq and Sk need not be multiples of a tile (the Pallas kernel needs
//   multiples of its blocks): rows past R load as zeros, cache rows past
//   the span as zeros and score -inf. Limits: D <= 576, D % 4 == 0, d_v <=
//   512 (the wrapper checks and raises).

#include <cuda_runtime.h>
#include <math_constants.h>

#include "merge.cuh"
#include "tf32x3.cuh"

namespace {

constexpr int BM = 64;                    // query rows per block
constexpr int BN = 32;                    // cache rows per tile
constexpr int THREADS = 256;              // 8 warps
constexpr int PP = BN + 4;                // pitch of P: 8 rows on 32 banks
constexpr int MAX_DV = 512;               // 8 warps x 64 output columns
constexpr int MAX_PITCH = 580;            // D <= 576

// the row pitch of Q and the cache tiles: holds D rounded up to 16 (two
// halves of whole 8-column steps) and d_v rounded up to 32 (whole column
// groups of the PV map), = 4 mod 32 so 8 rows x 4 columns hit 32 banks
int pitch_of(int D, int d_v) {
  int need = (D + 31) / 32 * 32;
  const int dv = (d_v + 31) / 32 * 32;
  if (dv > need) need = dv;
  int p = need;
  while (p % 32 != 4) ++p;
  return p;
}

int smem_bytes(int DP) {
  return (int)(((BM + BN) * DP + BM * PP + 2 * BM) * sizeof(float));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// physical column of logical column n (0..7) of output n-tile j of warp w:
// four adjacent columns, then the four 16 further on
__device__ __forceinline__ int pv_col(int w, int j, int n) {
  return 32 * (2 * w + (j >> 2)) + 4 * (j & 3) + (n < 4 ? n : n + 12);
}

__global__ void __launch_bounds__(THREADS, 1)
flash_prefill_kernel(const float* __restrict__ q, long q_b,
                     const float* __restrict__ ckv, long c_b, long c_r,
                     int B, int R, int Sk, int D, int DK, int DP, int d_v,
                     float scale, int H, int offset, int split_len,
                     float* __restrict__ o, float* __restrict__ m_out,
                     float* __restrict__ l_out) {
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                       // (BM, DP)
  float* Ks = Qs + BM * DP;               // (BN, DP)
  float* Ps = Ks + BN * DP;               // (BM, PP) S partials, then P
  float* alpha_s = Ps + BM * PP;          // (BM,) rescale of this tile
  float* l_s = alpha_s + BM;              // (BM,) final denominators

  const int b = blockIdx.y;
  const int z = blockIdx.z;               // which span of the cache
  const int r0 = (gridDim.x - 1 - blockIdx.x) * BM;     // longest first
  const int last = min(r0 + BM, R) - 1;
  const int reach = min(Sk, offset + last / H + 1);
  const int s_begin = z * split_len;
  const int s_end = min(reach, s_begin + split_len);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, qd = lane % 4;
  const float* qb = q + b * q_b;
  const float* cb = ckv + b * c_b;
  const int D4 = D / 4;

  // padding columns [D, DP) of Q and the cache tile: zero (never copied)
  for (int i = tid; i < (BM + BN) * (DP - D); i += THREADS)
    smem[(i / (DP - D)) * DP + D + i % (DP - D)] = 0.f;
  for (int i = tid; i < BM * D4; i += THREADS) {
    const int r = i / D4, c = (i % D4) * 4;
    const bool ok = r0 + r < R;
    cp_async16(Qs + r * DP + c, ok ? qb + (long)(r0 + r) * D + c : qb, ok);
  }
  auto load_tile = [&](int s0) {
    for (int i = tid; i < BN * D4; i += THREADS) {
      const int s = i / D4, c = (i % D4) * 4;
      const bool ok = s0 + s < s_end;
      cp_async16(Ks + s * DP + c, ok ? cb + (long)(s0 + s) * c_r + c : cb,
                 ok);
    }
  };

  const int mt = warp & 3;                // S: rows [16 mt, 16 mt + 16)
  const int kh = warp >> 2;               // S: D columns of this half
  const int half = DK / 2;
  const int row_a = 16 * mt + g, row_b = row_a + 8;
  const int lim_a = offset + (r0 + row_a) / H + 1;
  const int lim_b = offset + (r0 + row_b) / H + 1;
  float m_a = -CUDART_INF_F, m_b = -CUDART_INF_F, l_a = 0.f, l_b = 0.f;

  float acc[4][8][4];                     // O: 4 row tiles x 8 column tiles
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int n_tiles = s_end > s_begin ? (s_end - s_begin + BN - 1) / BN : 0;
  if (n_tiles > 0) load_tile(s_begin);
  cp_async_commit();                      // Q and the first tile

  for (int t = 0; t < n_tiles; ++t) {
    const int s0 = s_begin + t * BN;
    cp_async_wait<0>();                   // tile t landed
    __syncthreads();

    // S partial over this warp's half of D: rows row_a / row_b, columns
    // 8 nt + 2 qd (+1)
    float s[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
    // ldmatrix rows: Q rows 16 mt + (0-7 | 8-15), columns (+0 | +4); cache
    // rows (0-7 | 8-15) of the tile, columns (+0 | +4)
    const float* qa = Qs + (16 * mt + lane % 8 + 8 * ((lane / 8) & 1)) * DP +
                      4 * (lane / 16);
    const float* ka = Ks + (8 * (lane / 16) + lane % 8) * DP +
                      4 * ((lane / 8) & 1);
#pragma unroll 2
    for (int k0 = kh * half; k0 < kh * half + half; k0 += 16) {
      tf32x3::FragA a[2];                 // a chunk: two mma steps
      tf32x3::FragB bf[4][2];             // [n tile][step]
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        uint32_t r[4];
        tf32x3::ldsm_x4(r, qa + k0 + 8 * h2);
#pragma unroll
        for (int i = 0; i < 4; ++i) a[h2].set(i, __uint_as_float(r[i]));
#pragma unroll
        for (int np = 0; np < 2; ++np) {  // n tiles 2 np, 2 np + 1
          tf32x3::ldsm_x4(r, ka + 16 * np * DP + k0 + 8 * h2);
          bf[2 * np][h2].set(0, __uint_as_float(r[0]));
          bf[2 * np][h2].set(1, __uint_as_float(r[1]));
          bf[2 * np + 1][h2].set(0, __uint_as_float(r[2]));
          bf[2 * np + 1][h2].set(1, __uint_as_float(r[3]));
        }
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        float step[4];
        tf32x3::mma3_fresh(step, a[0], bf[nt][0]);
        tf32x3::mma3(step, a[1], bf[nt][1]);
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] += step[e];
      }
    }
    if (kh == 1) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int c = 8 * nt + 2 * qd;
        Ps[row_a * PP + c] = s[nt][0];
        Ps[row_a * PP + c + 1] = s[nt][1];
        Ps[row_b * PP + c] = s[nt][2];
        Ps[row_b * PP + c + 1] = s[nt][3];
      }
    }
    __syncthreads();

    if (kh == 0) {                        // online softmax of 16 rows
      float mx_a = -CUDART_INF_F, mx_b = -CUDART_INF_F;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * nt + 2 * qd + (e & 1);
          const int row = e < 2 ? row_a : row_b;
          const int pos = s0 + c;
          const bool ok = pos < s_end && pos < (e < 2 ? lim_a : lim_b);
          const float v = s[nt][e] + Ps[row * PP + c];
          s[nt][e] = ok ? v * scale : -CUDART_INF_F;
        }
        mx_a = fmaxf(mx_a, fmaxf(s[nt][0], s[nt][1]));
        mx_b = fmaxf(mx_b, fmaxf(s[nt][2], s[nt][3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
      }
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
      const float safe_a = isfinite(mn_a) ? mn_a : 0.f;
      const float safe_b = isfinite(mn_b) ? mn_b : 0.f;
      const float al_a = expf(m_a - safe_a), al_b = expf(m_b - safe_b);
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int c = 8 * nt + 2 * qd;
        const float p0 = expf(s[nt][0] - safe_a), p1 = expf(s[nt][1] - safe_a);
        const float p2 = expf(s[nt][2] - safe_b), p3 = expf(s[nt][3] - safe_b);
        sum_a += p0 + p1;
        sum_b += p2 + p3;
        Ps[row_a * PP + c] = p0;
        Ps[row_a * PP + c + 1] = p1;
        Ps[row_b * PP + c] = p2;
        Ps[row_b * PP + c + 1] = p3;
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        sum_a += __shfl_xor_sync(0xffffffffu, sum_a, off);
        sum_b += __shfl_xor_sync(0xffffffffu, sum_b, off);
      }
      l_a = l_a * al_a + sum_a;
      l_b = l_b * al_b + sum_b;
      m_a = mn_a;
      m_b = mn_b;
      if (qd == 0) {
        alpha_s[row_a] = al_a;
        alpha_s[row_b] = al_b;
      }
    }
    __syncthreads();

    // O = O * alpha + P V, V the first d_v columns of the same tile
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float aa = alpha_s[16 * i + g], ab = alpha_s[16 * i + g + 8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[i][j][0] *= aa;
        acc[i][j][1] *= aa;
        acc[i][j][2] *= ab;
        acc[i][j][3] *= ab;
      }
    }
#pragma unroll 1
    for (int kc = 0; kc < BN; kc += 16) { // chunks of two mma steps
      tf32x3::FragA pa[2][4];
      const float* pl = Ps + (lane % 8 + 8 * ((lane / 8) & 1)) * PP +
                        4 * (lane / 16) + kc;
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          uint32_t r[4];
          tf32x3::ldsm_x4(r, pl + 16 * i * PP + 8 * h2);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            pa[h2][i].set(e, __uint_as_float(r[e]));
        }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (32 * (2 * warp + (j >> 2)) >= d_v) continue;   // warp-uniform
        const int col = pv_col(warp, j, g);
        tf32x3::FragB vb[2];
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          vb[h2].set(0, Ks[(kc + 8 * h2 + qd) * DP + col]);
          vb[h2].set(1, Ks[(kc + 8 * h2 + qd + 4) * DP + col]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float step[4];
          tf32x3::mma3_fresh(step, pa[0][i], vb[0]);
          tf32x3::mma3(step, pa[1][i], vb[1]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += step[e];
        }
      }
    }
    __syncthreads();                      // the tile and P consumed
    if (t + 1 < n_tiles) {
      load_tile(s0 + BN);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();

  if (kh == 0 && qd == 0) {
    l_s[row_a] = l_a;
    l_s[row_b] = l_b;
  }
  __syncthreads();
  const long out_base = ((long)z * B + b) * R + r0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int row = 16 * i + g + 8 * hi;
      if (r0 + row >= R) continue;
      const float l = l_s[row];
      const float denom = l > 0.f ? l : 1.f;
      float* orow = o + (out_base + row) * d_v;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = pv_col(warp, j, 2 * qd);    // c, c + 1 adjacent
        const float v0 = acc[i][j][2 * hi] / denom;
        const float v1 = acc[i][j][2 * hi + 1] / denom;
        if (c + 1 < d_v && d_v % 2 == 0) {        // an aligned pair
          *reinterpret_cast<float2*>(orow + c) = make_float2(v0, v1);
        } else if (c < d_v) {
          orow[c] = v0;
          if (c + 1 < d_v) orow[c + 1] = v1;
        }
      }
    }
  }
  if (kh == 0 && qd == 0) {
    if (r0 + row_a < R) {
      m_out[out_base + row_a] = m_a;
      l_out[out_base + row_a] = l_a;
    }
    if (r0 + row_b < R) {
      m_out[out_base + row_b] = m_b;
      l_out[out_base + row_b] = l_b;
    }
  }
}

}  // namespace

// Dynamic shared memory of one block at (D, d_v); -1 past the limits.
extern "C" int flash_prefill_f32_smem_bytes(int D, int d_v) {
  if (D < 4 || D % 4 != 0 || d_v < 1 || d_v > MAX_DV) return -1;
  const int DP = pitch_of(D, d_v);
  return DP > MAX_PITCH ? -1 : smem_bytes(DP);
}

// Blocks of the kernel one SM holds at (D, d_v), as the occupancy API
// reports it (0 on an error).
extern "C" int flash_prefill_f32_occupancy(int D, int d_v) {
  const int smem = flash_prefill_f32_smem_bytes(D, d_v);
  if (smem < 0) return 0;
  if (cudaFuncSetAttribute(flash_prefill_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess)
    return 0;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, flash_prefill_kernel, THREADS, smem) != cudaSuccess)
    return 0;
  return n;
}

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
  const int smem = flash_prefill_f32_smem_bytes(D, d_v);
  if (smem < 0 || H < 1 || offset < 0 || split_len % BN != 0 ||
      n_split > MERGE_MAX_SLOTS)
    return -1;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaFuncSetAttribute(
      flash_prefill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || R == 0) return (int)cudaGetLastError();
  dim3 grid((R + BM - 1) / BM, B, n_split);
  const bool direct = n_split == 1;
  flash_prefill_kernel<<<grid, THREADS, smem, st>>>(
      q, q_b, ckv, c_b, c_r, B, R, Sk, D, (D + 31) / 32 * 32,
      pitch_of(D, d_v), d_v, scale, H, offset, split_len,
      direct ? o : o_part, direct ? m : m_part, direct ? l : l_part);
  err = cudaGetLastError();
  if (err != cudaSuccess || direct) return (int)err;
  const long n_rows = (long)B * R;
  merge_rows_kernel<<<(unsigned)n_rows, MERGE_THREADS, 0, st>>>(
      o_part, m_part, l_part, n_split, n_rows, d_v, o, m, l);
  return (int)cudaGetLastError();
}
