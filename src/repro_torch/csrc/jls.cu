// JPEG-Lossless predictor residuals of an unsigned-int stack.
//
// Replaces the TPU kernel src/repro/kernels/jls/jls.py::_jls_kernel
// (pallas_call in jls_residuals_pallas).
//
// Computes, for each pixel, the residual (x - pred) mod 2^bits, sign-wrapped
// into [-2^(bits-1), 2^(bits-1)), with the predictor of selection value sv
// (1..7) over the left (ra), above (rb) and above-left (rc) neighbours.
// Row 0 predicts ra, column 0 predicts rb, (0,0) predicts 2^(bits-1). It is
// fused.cu without the rectangle mask: the staged pipeline's second pass,
// after scrub.cu, and the residual stage of the kernel-assisted encode.
//
// Bound on the card: HBM bytes. One read of the uint8/uint16 plane and one
// int32 write: 2 + 4 = 6 B per pixel for uint16 (5 B for uint8). The row
// y-1 a thread also reads was read by the block of row y-1 and comes from L2.
// The arithmetic is a dozen integer operations per pixel, far below the
// card's integer rate.
//
// Design: one thread per pixel, blocks of 256 along a row, grid
// (ceil(W/256), H, N). Each thread reads its own three neighbours, so the
// TPU's one-row-shifted `above` input and its bh=64 H padding are gone, and
// the ragged right edge is masked in-kernel. Samples widen by value
// (uint16 >= 32768 stays positive); sv 5 and 6 shift a possibly negative
// int right, which is arithmetic, as in the reference; sv 4 may leave
// [0, 2^bits), and only the final mask brings it back. sv is uniform over
// the grid, so the switch never diverges. Indices are size_t: a DX stack
// is 20.5 M pixels.
#include <cuda_runtime.h>
#include <cstdint>

#include "pixels.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void jls_kernel(const T* __restrict__ in, int* __restrict__ out, int H, int W, int sv,
                           int bits) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  const int n = blockIdx.z;
  if (x >= W) return;
  const size_t row = (static_cast<size_t>(n) * H + y) * W;
  const T* cur = in + row;
  const T* up = y > 0 ? cur - W : cur;  // only read when y > 0

  const int xv = static_cast<int>(cur[x]);
  const int ra = x > 0 ? static_cast<int>(cur[x - 1]) : 0;
  const int rb = y > 0 ? static_cast<int>(up[x]) : 0;
  const int rc = (x > 0 && y > 0) ? static_cast<int>(up[x - 1]) : 0;

  int pred;
  if (y == 0 && x == 0) {
    pred = 1 << (bits - 1);
  } else if (y == 0) {
    pred = ra;
  } else if (x == 0) {
    pred = rb;
  } else {
    switch (sv) {
      case 1: pred = ra; break;
      case 2: pred = rb; break;
      case 3: pred = rc; break;
      case 4: pred = ra + rb - rc; break;
      case 5: pred = ra + ((rb - rc) >> 1); break;  // arithmetic shift
      case 6: pred = rb + ((ra - rc) >> 1); break;
      default: pred = (ra + rb) >> 1; break;        // sv == 7
    }
  }
  const int mask = (1 << bits) - 1;
  int r = (xv - pred) & mask;
  if (r >= (1 << (bits - 1))) r -= (1 << bits);
  out[row + x] = r;
}

template <typename T>
cudaError_t launch(const void* in, int* out, int N, int H, int W, int sv, int bits,
                   cudaStream_t stream) {
  const dim3 grid((W + kThreads - 1) / kThreads, H, N);
  jls_kernel<T><<<grid, kThreads, 0, stream>>>(static_cast<const T*>(in), out, H, W, sv, bits);
  return cudaGetLastError();
}

}  // namespace

extern "C" int jls_residuals_launch(const void* in, void* out, int N, int H, int W, int itemsize,
                                    int sv, int bits, void* stream) {
  if (N < 0 || H < 0 || W < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (sv < 1 || sv > 7 || bits < 1 || bits > 30) return static_cast<int>(cudaErrorInvalidValue);
  if (H > kMaxGridYZ || N > kMaxGridYZ) return static_cast<int>(cudaErrorInvalidValue);
  if (itemsize != 1 && itemsize != 2) return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0 || H == 0 || W == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* o = static_cast<int*>(out);
  return itemsize == 1 ? launch<uint8_t>(in, o, N, H, W, sv, bits, s)
                       : launch<uint16_t>(in, o, N, H, W, sv, bits, s);
}
