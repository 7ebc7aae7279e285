// Fused PHI-rectangle scrub + JPEG-Lossless predictor residuals, one pass.
//
// Replaces the TPU kernel src/repro/kernels/fused/fused.py::_fused_kernel
// (pallas_call in fused_scrub_jls_pallas).
//
// Computes, for each pixel of the *scrubbed* plane (rect pixels zeroed), the
// residual (x - pred) mod 2^bits, sign-wrapped into [-2^(bits-1), 2^(bits-1)),
// with the predictor of selection value sv (1..7) over the left (ra), above
// (rb) and above-left (rc) neighbours. Row 0 predicts ra, column 0 predicts
// rb, (0,0) predicts 2^(bits-1). Each neighbour is masked with its *own*
// coverage, exactly as if the blanked plane had been materialized first.
//
// Bound on the card: HBM bytes. One read of the uint8/uint16 plane and one
// int32 write: 2 + 4 = 6 B per pixel for uint16 (5 B for uint8). The rows
// y-1 a thread also reads were read by the block of row y-1 and come from L2.
//
// Design: one thread per pixel, blocks of 256 along a row, grid
// (ceil(W/256), H, N). A thread reads x[y-1, .] and x[y, x-1] itself, so the
// TPU's one-row-shifted `above` input and its bh=64 H padding are gone, and
// the ragged edge is masked in-kernel. sv is uniform over the grid, so the
// switch never diverges.
#include <cuda_runtime.h>
#include <cstdint>

#include "rects.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__device__ __forceinline__ int pix(const T* __restrict__ plane, const int4* __restrict__ rects,
                                   int R, int W, int x, int y) {
  return covered(rects, R, x, y) ? 0 : static_cast<int>(plane[static_cast<size_t>(y) * W + x]);
}

template <typename T>
__global__ void fused_kernel(const T* __restrict__ in, const int4* __restrict__ rects_all,
                             int* __restrict__ out, int R, int H, int W, int sv, int bits) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  const int n = blockIdx.z;
  if (x >= W) return;
  const T* plane = in + static_cast<size_t>(n) * H * W;
  const int4* rects = rects_all + static_cast<size_t>(n) * R;

  const int xv = pix(plane, rects, R, W, x, y);
  const int ra = x > 0 ? pix(plane, rects, R, W, x - 1, y) : 0;
  const int rb = y > 0 ? pix(plane, rects, R, W, x, y - 1) : 0;
  const int rc = (x > 0 && y > 0) ? pix(plane, rects, R, W, x - 1, y - 1) : 0;

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
  out[(static_cast<size_t>(n) * H + y) * W + x] = r;
}

template <typename T>
cudaError_t launch(const void* in, const void* rects, int* out, int N, int H, int W, int R,
                   int sv, int bits, cudaStream_t stream) {
  const dim3 grid((W + kThreads - 1) / kThreads, H, N);
  fused_kernel<T><<<grid, kThreads, 0, stream>>>(static_cast<const T*>(in),
                                                 static_cast<const int4*>(rects), out, R, H, W,
                                                 sv, bits);
  return cudaGetLastError();
}

}  // namespace

extern "C" int fused_scrub_residuals_launch(const void* in, const void* rects, void* out, int N,
                                            int H, int W, int R, int itemsize, int sv, int bits,
                                            void* stream) {
  if (N == 0 || H == 0 || W == 0) return 0;
  if (sv < 1 || sv > 7 || bits < 1 || bits > 30) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* o = static_cast<int*>(out);
  switch (itemsize) {
    case 1: return launch<uint8_t>(in, rects, o, N, H, W, R, sv, bits, s);
    case 2: return launch<uint16_t>(in, rects, o, N, H, W, R, sv, bits, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
