// ssd_chunk: the Mamba2 SSD intra-chunk step on Hopper, f32 on CUDA cores.
//
// Replaces: src/repro/kernels/ssd_chunk/kernel.py, ssd_intra_chunk_pallas
// (body _kernel). Per (batch, chunk) and head h, over the chunk's Q steps:
//   cum[t]      = sum_{u <= t} dt[u] A[h]
//   CB[t][u]    = C[t] . B[u]                               (shared by heads)
//   y[t][p]     = sum_{u <= t} CB[t][u] exp(cum[t] - cum[u]) dt[u] x[u][p]
//   state[p][n] = sum_u exp(cum[Q-1] - cum[u]) dt[u] x[u][p] B[u][n]
// Inputs x (b, nc, Q, H, P), dt (b, nc, Q, H), A (H,), B and C
// (b, nc, Q, N); outputs y (b, nc, Q, H, P), states (b, nc, H, P, N) and
// cum (b, nc, Q, H), all contiguous f32.
//
// Bound on this card. Per chunk and head the work is Q(Q+1)/2 P (y) plus
// Q P N (state) multiply-adds, plus Q^2 N per chunk for CB; at mamba2-370m
// (Q = 128, H = 32, P = 64, N = 128) one 2048-token sequence is ~1.7 GFLOP
// against ~53 MB of inputs and outputs: operation-bound (~0.025 ms at
// 67 TFLOP/s f32), with no (Q, Q, H) tensor in device memory.
//
// Design.
// * One block per (batch, chunk) and block of hb heads (the Pallas grid's
//   (b, nc, H / hb), with hb free: a last head block may be short, where
//   the Pallas kernel needs H % hb == 0). The block reads B and C once,
//   computes CB once into shared memory for its heads (each thread an 8 x 8
//   register tile of it), then per head: dt and the prefix sum cum (one
//   thread, in step order), dt x into shared memory, y, the chunk state.
// * The decay exponent cum[t] - cum[u] is formed only for u <= t: the
//   terms above the diagonal, whose exponents are positive and overflow,
//   are never computed (the plain version masks them to -inf before exp,
//   which makes them exactly 0).
// * y: a thread owns one step t and 16 adjacent columns p; in a warp the 32
//   threads hold 32 steps of one column group, so dt x[u] is a broadcast
//   read and CB[t][u] (row pitch Q + 1) hits 32 banks. The state: a thread
//   owns one n and 8 columns p, so B[u][n] (pitch N + 1) is conflict-free
//   and dt x[u] a broadcast. Each sum is one FMA chain in u order.
// * Shared memory Q (N+1) [B] + Q (Q+1) [CB] + max(Q (N+1), Q P) [C, then
//   dt x] + 3 Q floats: 195 KB at mamba2-370m, one block per SM.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 128;    // CB is computed in 128 x 128 tiles
constexpr int YG = 16;       // y columns per thread
constexpr int SG = 8;        // state columns per thread

__global__ void __launch_bounds__(THREADS, 1)
ssd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const float* __restrict__ Bm,
                 const float* __restrict__ Cm, int Q, int H, int P, int N,
                 int hb, float* __restrict__ y, float* __restrict__ states,
                 float* __restrict__ cum) {
  extern __shared__ __align__(16) float smem[];
  const int NP = N + 1, QP = Q + 1;
  float* Bs = smem;                       // (Q, NP)
  float* CBs = Bs + Q * NP;               // (Q, QP)
  float* Us = CBs + Q * QP;               // C (Q, NP), then dt x (Q, P)
  const int u_size = Q * NP > Q * P ? Q * NP : Q * P;
  float* dts = Us + u_size;               // (Q,)
  float* cums = dts + Q;                  // (Q,)
  float* ws = cums + Q;                   // (Q,) exp(seg - cum)

  const long bc = blockIdx.x;             // batch * nc + chunk
  const int h0 = blockIdx.y * hb;
  const int h1 = min(H, h0 + hb);
  const int tid = threadIdx.x;
  const float* xb = x + bc * Q * H * P;
  const float* dtb = dt + bc * Q * H;
  const float* Bb = Bm + bc * Q * N;
  const float* Cb = Cm + bc * Q * N;

  for (int i = tid; i < Q * N; i += THREADS) {
    const int u = i / N, n = i % N;
    Bs[u * NP + n] = Bb[i];
    Us[u * NP + n] = Cb[i];
  }
  __syncthreads();

  // CB[t][u] = sum_n C[t][n] B[u][n], an 8 x 8 register tile per thread
  const int ty = tid / 16, tx = tid % 16;
  for (int tb = 0; tb < Q; tb += TILE) {
    for (int ub = 0; ub < Q; ub += TILE) {
      float acc[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      for (int n = 0; n < N; ++n) {
        float c[8], bv[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int t = tb + ty + 16 * i;
          c[i] = t < Q ? Us[t * NP + n] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int u = ub + tx + 16 * j;
          bv[j] = u < Q ? Bs[u * NP + n] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(c[i], bv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int t = tb + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int u = ub + tx + 16 * j;
          if (t < Q && u < Q) CBs[t * QP + u] = acc[i][j];
        }
      }
    }
  }

  const int y_groups = (P + YG - 1) / YG;
  const int s_groups = (P + SG - 1) / SG;
  for (int h = h0; h < h1; ++h) {
    __syncthreads();                      // C / the previous head consumed
    for (int u = tid; u < Q; u += THREADS) dts[u] = dtb[u * H + h];
    __syncthreads();
    if (tid == 0) {                       // cum = cumsum(dt A), step order
      const float a = A[h];
      float run = 0.f;
      for (int u = 0; u < Q; ++u) {
        run = __fadd_rn(run, __fmul_rn(dts[u], a));
        cums[u] = run;
      }
    }
    __syncthreads();
    const float seg = cums[Q - 1];
    for (int u = tid; u < Q; u += THREADS) {
      ws[u] = expf(seg - cums[u]);
      cum[(bc * Q + u) * H + h] = cums[u];
    }
    for (int i = tid; i < Q * P; i += THREADS) {
      const int u = i / P, p = i % P;
      Us[i] = dts[u] * xb[(u * H + h) * P + p];
    }
    __syncthreads();

    // y[t][p0 .. p0 + YG)
    for (int item = tid; item < Q * y_groups; item += THREADS) {
      const int t = item % Q, p0 = (item / Q) * YG;
      const float ct = cums[t];
      float acc[YG];
#pragma unroll
      for (int j = 0; j < YG; ++j) acc[j] = 0.f;
      for (int u = 0; u <= t; ++u) {
        const float g = CBs[t * QP + u] * expf(ct - cums[u]);
        const float* row = Us + u * P + p0;
#pragma unroll
        for (int j = 0; j < YG; ++j)
          if (p0 + j < P) acc[j] = fmaf(g, row[j], acc[j]);
      }
      float* out = y + ((bc * Q + t) * H + h) * P + p0;
#pragma unroll
      for (int j = 0; j < YG; ++j)
        if (p0 + j < P) out[j] = acc[j];
    }

    // state[p0 .. p0 + SG)[n]
    for (int item = tid; item < N * s_groups; item += THREADS) {
      const int n = item % N, p0 = (item / N) * SG;
      float acc[SG];
#pragma unroll
      for (int j = 0; j < SG; ++j) acc[j] = 0.f;
      for (int u = 0; u < Q; ++u) {
        const float bw = ws[u] * Bs[u * NP + n];
        const float* row = Us + u * P + p0;
#pragma unroll
        for (int j = 0; j < SG; ++j)
          if (p0 + j < P) acc[j] = fmaf(row[j], bw, acc[j]);
      }
      float* out = states + ((bc * H + h) * P + p0) * N + n;
#pragma unroll
      for (int j = 0; j < SG; ++j)
        if (p0 + j < P) out[(long)j * N] = acc[j];
    }
  }
}

}  // namespace

extern "C" int ssd_chunk_smem_bytes(int Q, int P, int N) {
  const long u = (long)Q * (N + 1) > (long)Q * P ? (long)Q * (N + 1)
                                                 : (long)Q * P;
  const long floats = (long)Q * (N + 1) + (long)Q * (Q + 1) + u + 3L * Q;
  return floats * 4 > 0x7fffffff ? -1 : (int)(floats * 4);
}

// n_chunks = b * nc; hb heads per block (the last block may hold fewer).
extern "C" int ssd_chunk_f32(const float* x, const float* dt, const float* A,
                             const float* B, const float* C, long n_chunks,
                             int Q, int H, int P, int N, int hb, float* y,
                             float* states, float* cum, void* stream) {
  if (Q < 1 || H < 1 || P < 1 || N < 1 || hb < 1 || n_chunks > 0x7fffffff)
    return -1;
  const int smem = ssd_chunk_smem_bytes(Q, P, N);
  if (smem < 0) return -1;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if (n_chunks == 0) return (int)cudaGetLastError();
  dim3 grid((unsigned)n_chunks, (H + hb - 1) / hb);
  ssd_chunk_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      x, dt, A, B, C, Q, H, P, N, hb, y, states, cum);
  return (int)cudaGetLastError();
}
