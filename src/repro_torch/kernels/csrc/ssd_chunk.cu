// ssd_chunk: the Mamba2 SSD intra-chunk step on Hopper, f32 in and out, the
// three chunk products on the tensor cores in split TF32.
//
// Replaces: src/repro/kernels/ssd_chunk/kernel.py:66, ssd_intra_chunk_pallas
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
// (Q = 128, H = 32, P = 64, N = 128) one 2048-token sequence is 1.68 GFLOP
// against ~53 MB of inputs and outputs: 0.025 ms at 67 TFLOP/s of f32 FMAs,
// but as three TF32 products at 495 TFLOP/s only ~0.010 ms, under the
// bytes' 0.016 ms at 3.35 TB/s: on the tensor cores the kernel is
// byte-bound. No (Q, Q, H) tensor reaches device memory.
//
// Arithmetic. The three products (CB = C B^T; y_h = (CB o Gamma_h)(dt_h
// x_h); state_h = (w_h o dt_h x_h)^T B, with w_h[u] = exp(cum[Q-1] -
// cum[u])) run as split-TF32 products (tf32x3.cuh), each chunk of two mma
// steps (16 terms, x3 products) summed by the tensor cores from zero and
// added to the f32 accumulator with one rounded add. tests/test_torch_tf32x3.py
// emulates them on the CPU at mamba2-370m's chunk and holds y, states and
// cum within 1e-4 of the plain version; one TF32 product misses it. cum
// stays one f32 add a step in step order: on the card that is bit for bit
// the plain version's torch.cumsum (a sequential f32 scan along a dimension
// that is not the innermost), and the same test shows that a reordered
// scan (a few ulps at |cum| ~ 200) alone takes y past 1e-4.
//
// Design.
// * One block of 8 warps per (batch, chunk) and block of hb heads (the
//   Pallas grid's (b, nc, H / hb), with hb free: a last head block may be
//   short, where the Pallas kernel needs H % hb == 0).
// * CB once per block: the 16 x 32 tiles that reach the diagonal are dealt
//   to the 8 warps in turn (at most 3 each), K = N; each warp keeps its
//   tiles in registers until every warp has read C, then CB replaces C in
//   shared memory (rows t, pitch = 8 mod 32).
// * Heads go to two groups of 4 warps: group k takes heads h0 + k,
//   h0 + k + 2, ..., each at its own pace (named barriers, not the block's),
//   so one group's loads and scan overlap the other's products. Each
//   group's first head is loaded with B and C and lands while CB is
//   computed; the next one is prefetched into L2. dt has a commit group of
//   its own: the group's first lane scans cum while x lands, then the
//   group scales x to dt x in place; then y and the state.
// * y: warp i of a group owns the row tiles i and Q/16 - 1 - i, so the
//   causal triangle splits evenly (9 column steps of 16 each at Q = 128),
//   and all P columns, so each gate exp(cum[t] - cum[u]) is computed once
//   per (t, u, head), on the A fragment, and only for the column steps on
//   or below the diagonal. Above the diagonal the gate is selected to an
//   exact 0 (never exp(positive) times 0, which would be inf * 0 = NaN).
//   The A fragment's 8 k of a step map to the physical steps u0 + 2q and
//   u0 + 2q + 1 (tf32x3.cuh), so each thread reads two adjacent CB
//   entries and cum values, and dt x rows u0 + 2q, u0 + 2q + 1 on 32
//   banks (pitch = 4 mod 32).
// * state: warp i of a group owns N columns [32 i, 32 i + 32) and all P
//   rows; A = (w o dt x)^T read from the same dt x tile, B from B, both
//   under the same k map.
// * y and the states leave as aligned pairs of floats (float2): stored one
//   float at a time (a variant of this source) they were one of the
//   kernel's largest costs on the H100.
// * Shared memory at mamba2-370m: B 66 KB, C then CB 68 KB, two heads of
//   dt x 68 KB, dt / cum / w 3 KB: 209,920 B, one block an SM. At one
//   sequence the grid is 16 x 8 = 128 blocks, one wave on 132 SMs, so a
//   second block an SM would find no work; at model (c)'s two sequences it
//   is two waves.
// * Limits: Q <= 128, P <= 64, N <= 128 (the wrapper checks and raises).

#include <cuda_runtime.h>
#include <math_constants.h>

#include "tf32x3.cuh"

namespace {

constexpr int THREADS = 256;              // 8 warps, two groups of 4
constexpr int MAX_Q = 128;
constexpr int MAX_P = 64;                 // 8 column tiles of y
constexpr int MAX_N = 128;                // 4 warps x 32 state columns

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// barrier of one group of 4 warps (ids 1 and 2; 0 is __syncthreads)
__device__ __forceinline__ void group_sync(int grp) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(grp + 1));
}

// x rows of head h (Q rows of P floats, row stride H P) into L2, one
// prefetch per 128-byte line, spread over the 128 threads of a group
__device__ __forceinline__ void prefetch_head(const float* xb, int Q, int H,
                                              int P, int h, int gtid) {
  const int lines = (P * 4 + 127) / 128;
  for (int i = gtid; i < Q * lines; i += 128) {
    const float* p = xb + ((long)(i / lines) * H + h) * P + 32 * (i % lines);
    asm volatile("prefetch.global.L2 [%0];\n" :: "l"(p));
  }
}

int pitch_to(int need, int mod) {         // >= need, = mod (mod 32)
  int p = need;
  while (p % 32 != mod) ++p;
  return p;
}

struct Geometry {
  int QT, NP, CP, XP;                     // padded Q, pitches of B/C, CB, dt x
  int c_floats;                           // C, then CB
  int floats;
};

Geometry geometry(int Q, int P, int N) {
  Geometry g;
  g.QT = (Q + 31) / 32 * 32;
  g.NP = pitch_to((N + 15) / 16 * 16, 4);
  g.CP = pitch_to(g.QT, 8);
  g.XP = pitch_to((P + 15) / 16 * 16, 4);
  const int c = g.QT * g.NP, cb = g.QT * g.CP;
  g.c_floats = c > cb ? c : cb;
  g.floats = g.QT * g.NP + g.c_floats + 2 * g.QT * g.XP + 6 * g.QT;
  return g;
}

__global__ void __launch_bounds__(THREADS, 1)
ssd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const float* __restrict__ Bm,
                 const float* __restrict__ Cm, int Q, int H, int P, int N,
                 int hb, Geometry geo, float* __restrict__ y,
                 float* __restrict__ states, float* __restrict__ cum) {
  extern __shared__ __align__(16) float smem[];
  const int QT = geo.QT, NP = geo.NP, CP = geo.CP, XP = geo.XP;
  float* Bs = smem;                       // (QT, NP)
  float* CBs = Bs + QT * NP;              // C (QT, NP), then CB (QT, CP)
  float* Xs = CBs + geo.c_floats;         // dt x of each group (2, QT, XP)
  float* dts = Xs + 2 * QT * XP;          // (2, QT)
  float* cums = dts + 2 * QT;             // (2, QT)
  float* ws = cums + 2 * QT;              // (2, QT) exp(cum[Q-1] - cum)

  const long bc = blockIdx.x;             // batch * nc + chunk
  const int h0 = blockIdx.y * hb;
  const int h1 = min(H, h0 + hb);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, qd = lane % 4;
  const float* xb = x + bc * Q * H * P;
  const float* dtb = dt + bc * Q * H;
  const float* Bb = Bm + bc * Q * N;
  const float* Cb = Cm + bc * Q * N;

  const int grp = warp / 4, wi = warp % 4;  // heads h0 + grp + 2i
  const int gtid = tid % 128;
  float* xs = Xs + grp * QT * XP;         // this group's dt x (QT, XP)
  float* dtg = dts + grp * QT;
  float* cg = cums + grp * QT;
  float* wg = ws + grp * QT;
  // dt and x of head h by cp.async, zero-padded: dt (by warp 0 of the
  // group) in a commit group of its own, so the scan can start before x
  // lands; the caller commits x
  auto load_head = [&](int h) {
    if (wi == 0)
      for (int u = lane; u < QT; u += 32)
        cp_async4(dtg + u, u < Q ? dtb + u * H + h : dtb, u < Q);
    cp_async_commit();
    for (int u = wi; u < QT; u += 4)
      for (int p = lane; p < XP; p += 32) {
        const bool ok = u < Q && p < P;
        cp_async4(xs + u * XP + p, ok ? xb + ((long)u * H + h) * P + p : xb,
                  ok);
      }
  };

  // B and C by cp.async, zero past Q rows and N columns; then each
  // group's first head, which lands while CB is computed
  for (int u = warp; u < QT; u += THREADS / 32)
    for (int n = lane; n < NP; n += 32) {
      const bool ok = u < Q && n < N;
      cp_async4(Bs + u * NP + n, ok ? Bb + u * N + n : Bb, ok);
      cp_async4(CBs + u * NP + n, ok ? Cb + u * N + n : Cb, ok);
    }
  cp_async_commit();
  if (h0 + grp < h1) load_head(h0 + grp);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  // CB: 16 x 32 tiles (ti, tj), 32 tj <= 16 ti, dealt to the warps in turn
  const int MT = QT / 16;
  const int NK = (N + 15) / 16 * 16;
  const int n_cb = (MT / 2) * (MT / 2 + 1);
  auto tile_of = [](int f, int& ti, int& tj) {
    ti = 0;
    tj = f;
    while (tj > ti / 2) {
      tj -= ti / 2 + 1;
      ++ti;
    }
  };
  // C and CB share their space: each warp keeps its (at most 3: 20 tiles
  // over 8 warps at Q = 128) tiles in registers until C is consumed
  float cbr[3][4][4];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int f = warp + 8 * i;
    if (f >= n_cb) break;
    int ti, tj;
    tile_of(f, ti, tj);
    float (&s)[4][4] = cbr[i];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
    const float* ca = CBs + (16 * ti + g) * NP + qd;
    for (int k0 = 0; k0 < NK; k0 += 16) {  // a chunk: two mma steps
      tf32x3::FragA a[2];
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int k = k0 + 8 * h2;
        a[h2].set(0, ca[k]);
        a[h2].set(1, ca[8 * NP + k]);
        a[h2].set(2, ca[k + 4]);
        a[h2].set(3, ca[8 * NP + k + 4]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float* bp = Bs + (32 * tj + 8 * nt + g) * NP + k0 + qd;
        tf32x3::FragB bf[2];
        bf[0].set(0, bp[0]);
        bf[0].set(1, bp[4]);
        bf[1].set(0, bp[8]);
        bf[1].set(1, bp[12]);
        float step[4];
        tf32x3::mma3_fresh(step, a[0], bf[0]);
        tf32x3::mma3(step, a[1], bf[1]);
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] += step[e];
      }
    }
  }
  __syncthreads();                        // C consumed
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int f = warp + 8 * i;
    if (f >= n_cb) break;
    int ti, tj;
    tile_of(f, ti, tj);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      float* out = CBs + (16 * ti + g) * CP + 32 * tj + 8 * nt + 2 * qd;
      *reinterpret_cast<float2*>(out) = make_float2(cbr[i][nt][0],
                                                    cbr[i][nt][1]);
      *reinterpret_cast<float2*>(out + 8 * CP) =
          make_float2(cbr[i][nt][2], cbr[i][nt][3]);
    }
  }
  __syncthreads();                        // CB written

  // each group walks its heads h0 + grp, h0 + grp + 2, ... at its own pace:
  // one group's loads and scan overlap the other's products
  for (int h = h0 + grp; h < h1; h += 2) {
    {
      if (h != h0 + grp) load_head(h);   // the first came with B and C
      cp_async_commit();
      if (h + 2 < h1) prefetch_head(xb, Q, H, P, h + 2, gtid);
      if (wi == 0) {                      // the scan while x lands
        cp_async_wait<1>();
        __syncwarp();
        if (lane == 0) {                  // cum = cumsum(dt A), step order
          const float a = A[h];
          float run = 0.f;
          for (int u0 = 0; u0 < QT; u0 += 8) {  // dt is 0 past Q
            float d[8];                   // 8 loads in flight, then the adds
#pragma unroll
            for (int k = 0; k < 8; ++k) d[k] = dtg[u0 + k];
#pragma unroll
            for (int k = 0; k < 8; ++k) {
              if (u0 + k < Q) run = __fadd_rn(run, __fmul_rn(d[k], a));
              cg[u0 + k] = run;
            }
          }
        }
      }
    }
    cp_async_wait<0>();
    group_sync(grp);
    for (int u = wi; u < QT; u += 4)      // x -> dt x, in place
      for (int p = lane; p < XP; p += 32)
        xs[u * XP + p] = __fmul_rn(dtg[u], xs[u * XP + p]);
    group_sync(grp);
    {
      const float seg = cg[Q - 1];
      for (int u = gtid; u < QT; u += 128) {
        wg[u] = u < Q ? expf(seg - cg[u]) : 0.f;
        if (u < Q) cum[(bc * Q + u) * H + h] = cg[u];
      }

      // y: row tiles wi and MT - 1 - wi
      const int n_y = wi < MT - 1 - wi ? 2 : (wi == MT - 1 - wi ? 1 : 0);
      for (int which = 0; which < n_y; ++which) {
        const int mt = which == 0 ? wi : MT - 1 - wi;
        const int ta = 16 * mt + g, tb = ta + 8;
        const float cta = cg[ta], ctb = cg[tb];
        float acc[MAX_P / 8][4] = {};
        for (int u0 = 0; u0 < 16 * mt + 16; u0 += 16) {  // two mma steps
          tf32x3::FragA a[2];
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            const int u = u0 + 8 * h2 + 2 * qd;
            const float2 cu = *reinterpret_cast<const float2*>(cg + u);
            const float2 ga = *reinterpret_cast<const float2*>(
                CBs + ta * CP + u);
            const float2 gb = *reinterpret_cast<const float2*>(
                CBs + tb * CP + u);
            // the gate, exactly 0 above the diagonal
            const float e0 = u <= ta ? expf(cta - cu.x) : 0.f;
            const float e1 = u + 1 <= ta ? expf(cta - cu.y) : 0.f;
            const float e2 = u <= tb ? expf(ctb - cu.x) : 0.f;
            const float e3 = u + 1 <= tb ? expf(ctb - cu.y) : 0.f;
            a[h2].set(0, u <= ta ? ga.x * e0 : 0.f);
            a[h2].set(2, u + 1 <= ta ? ga.y * e1 : 0.f);
            a[h2].set(1, u <= tb ? gb.x * e2 : 0.f);
            a[h2].set(3, u + 1 <= tb ? gb.y * e3 : 0.f);
          }
          const float* xr = xs + (u0 + 2 * qd) * XP + g;
#pragma unroll
          for (int j = 0; j < MAX_P / 8; ++j) {
            if (8 * j >= P) break;        // warp-uniform
            tf32x3::FragB bf[2];
            bf[0].set(0, xr[8 * j]);
            bf[0].set(1, xr[XP + 8 * j]);
            bf[1].set(0, xr[8 * XP + 8 * j]);
            bf[1].set(1, xr[9 * XP + 8 * j]);
            float step[4];
            tf32x3::mma3_fresh(step, a[0], bf[0]);
            tf32x3::mma3(step, a[1], bf[1]);
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[j][e] += step[e];
          }
        }
#pragma unroll
        for (int j = 0; j < MAX_P / 8; ++j) {
#pragma unroll
          for (int hi = 0; hi < 2; ++hi) {
            const int t = hi ? tb : ta, p = 8 * j + 2 * qd;
            float* out = y + ((bc * Q + t) * H + h) * P + p;
            if (t >= Q || p >= P) continue;
            if (P % 2 == 0)               // p even: an aligned pair
              *reinterpret_cast<float2*>(out) =
                  make_float2(acc[j][2 * hi], acc[j][2 * hi + 1]);
            else {
              out[0] = acc[j][2 * hi];
              if (p + 1 < P) out[1] = acc[j][2 * hi + 1];
            }
          }
        }
      }
    }
    group_sync(grp);                      // w written

    {
      // state[p][n], n in [32 wi, 32 wi + 32)
      float acc[4][4][4] = {};
      const int PM = (P + 15) / 16;
      for (int u0 = 0; u0 < QT; u0 += 16) {  // two mma steps
        tf32x3::FragB bf[4][2];
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const float* br = Bs + (u0 + 8 * h2 + 2 * qd) * NP + 32 * wi + g;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            bf[nt][h2].set(0, br[8 * nt]);
            bf[nt][h2].set(1, br[NP + 8 * nt]);
          }
        }
#pragma unroll
        for (int pm = 0; pm < 4; ++pm) {
          if (pm >= PM) break;            // warp-uniform
          tf32x3::FragA a[2];
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            const int u = u0 + 8 * h2 + 2 * qd;
            const float2 w = *reinterpret_cast<const float2*>(wg + u);
            const float* xr = xs + u * XP + g + 16 * pm;
            a[h2].set(0, w.x * xr[0]);
            a[h2].set(1, w.x * xr[8]);
            a[h2].set(2, w.y * xr[XP]);
            a[h2].set(3, w.y * xr[XP + 8]);
          }
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            if (32 * wi + 8 * nt >= N) break;   // warp-uniform
            float step[4];
            tf32x3::mma3_fresh(step, a[0], bf[nt][0]);
            tf32x3::mma3(step, a[1], bf[nt][1]);
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[pm][nt][e] += step[e];
          }
        }
      }
      float* sb = states + (bc * H + h) * (long)P * N;
#pragma unroll
      for (int pm = 0; pm < 4; ++pm)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int hi = 0; hi < 2; ++hi) {
            const int p = 16 * pm + g + 8 * hi;
            const int n = 32 * wi + 8 * nt + 2 * qd;
            float* out = sb + (long)p * N + n;
            if (p >= P || n >= N) continue;
            if (N % 2 == 0)               // n even: an aligned pair
              *reinterpret_cast<float2*>(out) =
                  make_float2(acc[pm][nt][2 * hi], acc[pm][nt][2 * hi + 1]);
            else {
              out[0] = acc[pm][nt][2 * hi];
              if (n + 1 < N) out[1] = acc[pm][nt][2 * hi + 1];
            }
          }
    }
    group_sync(grp);                      // dt x and w consumed
  }
}

}  // namespace

// Dynamic shared memory of one block; -1 past the kernel's limits.
extern "C" int ssd_chunk_smem_bytes(int Q, int P, int N) {
  if (Q < 1 || P < 1 || N < 1 || Q > MAX_Q || P > MAX_P || N > MAX_N)
    return -1;
  return geometry(Q, P, N).floats * (int)sizeof(float);
}

// Blocks of the kernel one SM holds at (Q, P, N), as the occupancy API
// reports it (0 on an error).
extern "C" int ssd_chunk_occupancy(int Q, int P, int N) {
  const int smem = ssd_chunk_smem_bytes(Q, P, N);
  if (smem < 0) return 0;
  if (cudaFuncSetAttribute(ssd_chunk_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess)
    return 0;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, ssd_chunk_kernel, THREADS, smem) != cudaSuccess)
    return 0;
  return n;
}

// n_chunks = b * nc; hb heads per block (the last block may hold fewer).
extern "C" int ssd_chunk_f32(const float* x, const float* dt, const float* A,
                             const float* B, const float* C, long n_chunks,
                             int Q, int H, int P, int N, int hb, float* y,
                             float* states, float* cum, void* stream) {
  if (H < 1 || hb < 1 || n_chunks > 0x7fffffff) return -1;
  const int smem = ssd_chunk_smem_bytes(Q, P, N);
  if (smem < 0) return -1;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if (n_chunks == 0) return (int)cudaGetLastError();
  dim3 grid((unsigned)n_chunks, (H + hb - 1) / hb);
  ssd_chunk_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      x, dt, A, B, C, Q, H, P, N, hb, geometry(Q, P, N), y, states, cum);
  return (int)cudaGetLastError();
}
