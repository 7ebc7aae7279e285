// Batched PHI-rectangle blanking: zero every pixel inside a rect, keep dtype.
//
// Replaces the TPU kernel src/repro/kernels/scrub/scrub.py::_scrub_kernel
// (pallas_call in scrub_pallas).
//
// Bound on the card: HBM bytes. Each pixel is read once and written once:
// 2 x itemsize bytes per pixel (4 B for uint16). The rect test is a handful
// of integer compares per pixel, far below the card's integer rate.
//
// Design: one thread per pixel, a block of 256 threads along one row, grid
// (ceil(W/256), H, N). Neighbouring threads touch neighbouring addresses, so
// loads and stores coalesce. The kernel masks the ragged right edge itself,
// so the wrapper pads nothing (the TPU version padded to (8,128)-aligned
// tiles). The rect list of image n (N, R, 4 int32) is read through the
// read-only cache. Zeroing is bitwise, so one kernel per itemsize serves
// uint8/uint16/float32 and any other dtype of that width.
#include <cuda_runtime.h>
#include <cstdint>

#include "rects.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void scrub_kernel(const T* __restrict__ in, T* __restrict__ out,
                             const int4* __restrict__ rects, int R, int H, int W) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  const int n = blockIdx.z;
  if (x >= W) return;
  const size_t idx = (static_cast<size_t>(n) * H + y) * W + x;
  const T v = in[idx];
  out[idx] = covered(rects + static_cast<size_t>(n) * R, R, x, y) ? T(0) : v;
}

template <typename T>
cudaError_t launch(const void* in, void* out, const void* rects, int N, int H, int W, int R,
                   cudaStream_t stream) {
  const dim3 grid((W + kThreads - 1) / kThreads, H, N);
  scrub_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(in), static_cast<T*>(out), static_cast<const int4*>(rects), R, H, W);
  return cudaGetLastError();
}

}  // namespace

extern "C" int scrub_launch(const void* in, void* out, const void* rects, int N, int H, int W,
                            int R, int itemsize, void* stream) {
  if (N == 0 || H == 0 || W == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (itemsize) {
    case 1: return launch<uint8_t>(in, out, rects, N, H, W, R, s);
    case 2: return launch<uint16_t>(in, out, rects, N, H, W, R, s);
    case 4: return launch<uint32_t>(in, out, rects, N, H, W, R, s);
    case 8: return launch<uint64_t>(in, out, rects, N, H, W, R, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
