// delta_rotate: rotate the decoupled-RoPE band of every cache row by one
// fixed position delta (the FETCH splice re-home, paper §2.2), f32.
//
// Replaces: src/repro/kernels/delta_rotate/kernel.py, delta_rotate_pallas
// ((BS, d_r) tiles streamed through VMEM with cos/sin broadcast).
//
// NeoX half-split pairing: with x = [x1 | x2] (d_r/2 each),
//   y1 = x1 cos - x2 sin ;  y2 = x2 cos + x1 sin
// with one (cos, sin) per frequency, the same for every row: the angle
// depends on delta only.
//
// Bound on this card: bytes (6 operations per 8 bytes moved). A
// 2048-token chunk's band is 512 KB in and 512 KB out, well under a
// microsecond of device memory time, so at serving shapes the launch
// itself dominates. Design: one thread per (row, pair); neighbouring
// threads touch neighbouring floats of both halves, so each warp reads and
// writes whole 128-byte lines. The band is addressed through a row pitch:
// in the splice it is the column slice ckv[:, 512:] of 576-wide rows, and
// the kernel reads it in place from the source copy and writes it in place
// into the moved copy, with no contiguous staging buffer. cos/sin (computed
// once on the host, in f32, from the rope frequencies) travel by value in
// the launch parameters. Products and the difference/sum are rounded one
// at a time (no fused multiply-add), as the plain PyTorch version rounds
// them, so the kernel reproduces it bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_PAIRS = 64;             // d_r <= 128
constexpr int THREADS = 256;

struct Angles {
  float c[MAX_PAIRS];
  float s[MAX_PAIRS];
};

__global__ void delta_rotate_kernel(const float* __restrict__ x, long ldx,
                                    float* __restrict__ y, long ldy, long S,
                                    int d2, Angles a) {
  const long i = (long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= S * d2) return;
  const long row = i / d2;
  const int j = (int)(i % d2);
  const float x1 = x[row * ldx + j], x2 = x[row * ldx + j + d2];
  const float c = a.c[j], s = a.s[j];
  y[row * ldy + j] = __fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, s));
  y[row * ldy + j + d2] = __fadd_rn(__fmul_rn(x2, c), __fmul_rn(x1, s));
}

}  // namespace

// cos_host/sin_host: d2 floats each in host memory, copied into the launch
// parameters (nothing is allocated on the device).
extern "C" int delta_rotate_f32(const float* x, long ldx, float* y, long ldy,
                                long S, int d2, const float* cos_host,
                                const float* sin_host, void* stream) {
  if (d2 <= 0 || d2 > MAX_PAIRS) return -1;
  Angles a;
  for (int j = 0; j < d2; ++j) {
    a.c[j] = cos_host[j];
    a.s[j] = sin_host[j];
  }
  const long n = S * d2;
  if (n > 0)
    delta_rotate_kernel<<<(unsigned)((n + THREADS - 1) / THREADS), THREADS,
                          0, (cudaStream_t)stream>>>(x, ldx, y, ldy, S, d2,
                                                     a);
  return (int)cudaGetLastError();
}
