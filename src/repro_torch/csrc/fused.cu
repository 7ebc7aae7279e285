// Fused PHI-rectangle scrub + JPEG-Lossless predictor residuals, one pass.
//
// Replaces the TPU kernel src/repro/kernels/fused/fused.py::_fused_kernel
// (pallas_call in fused_scrub_jls_pallas).
//
// Computes, for each pixel of the *scrubbed* plane (rect pixels zeroed), the
// residual (x - pred) mod 2^bits, sign-wrapped into [-2^(bits-1), 2^(bits-1)),
// with the predictor of selection value sv (1..7) over the left (ra), above
// (rb) and above-left (rc) neighbours, each masked with its own coverage.
//
// Bound on the card: HBM bytes. One read of the uint8/uint16 plane and one
// int32 write: 2 + 4 = 6 B per pixel for uint16 (5 B for uint8).
//
// What held the first design back (one thread per pixel, 2-byte loads) was
// neither: every thread read its pixel and three neighbours, and asked every
// rect four times whether it covered one of them. Design: the strip walker
// of residuals.cuh with its rect mask (a thread a 16-byte chunk walked down 8
// rows, the row above in registers, the left neighbour from lane - 1, each
// rect one bit mask of the chunk's columns, the warp's row staged for
// 512-byte stores), shared with jls.cu, which runs it with no rects.
//
// Registers (nvcc -Xptxas -v, sm_90a, logged by kernel_ab.py): 101-149 a
// thread across pixel types, selection values and paths, no spills
// (PERF.md §6).
#include <cuda_runtime.h>
#include <cstdint>

#include "residuals.cuh"

namespace {

template <typename T, int SV, bool kVec>
__global__ void __launch_bounds__(residuals::kThreads, 1)
fused_kernel(const T* __restrict__ in, const int4* __restrict__ rects, int* __restrict__ out,
             int R, int H, int W, int sv, int bits, int n0, int C, unsigned threads, Divider by_c) {
  residuals::walk<T, SV, kVec>(in, rects, out, R, H, W, sv, bits, n0 + blockIdx.y, C, threads,
                               by_c);
}

template <typename T>
cudaError_t launch_typed(const void* in, const void* rects, int* out, int N, int H, int W,
                         int R, int sv, int bits, cudaStream_t s) {
  // the pixel path, or the 16-byte path with sv = 1 fixed or read at run time
  residuals::Kernel<T> kernel = fused_kernel<T, 0, false>;
  if (residuals::vector_ok<T>(in, out, W))
    kernel = sv == 1 ? fused_kernel<T, 1, true> : fused_kernel<T, 0, true>;
  return residuals::launch<T>(kernel, in, rects, out, N, H, W, R, sv, bits, s);
}

}  // namespace

// Refuses (cudaErrorInvalidValue) what the reference refuses too: sv outside
// 1..7, bits outside 1..30, an item size other than 1 or 2.
extern "C" int fused_scrub_residuals_launch(const void* in, const void* rects, void* out, int N,
                                            int H, int W, int R, int itemsize, int sv, int bits,
                                            void* stream) {
  if (N == 0 || H == 0 || W == 0) return 0;
  if (N < 0 || H < 0 || W < 0 || R < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (sv < 1 || sv > 7 || bits < 1 || bits > 30) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* o = static_cast<int*>(out);
  switch (itemsize) {
    case 1: return launch_typed<uint8_t>(in, rects, o, N, H, W, R, sv, bits, s);
    case 2: return launch_typed<uint16_t>(in, rects, o, N, H, W, R, sv, bits, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
