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
// int32 write: 2 + 4 = 6 B per pixel for uint16 (5 B for uint8).
//
// What held the first design back (one thread per pixel, 2-byte loads, each
// thread reloading its three neighbours) is what held fused.cu back before
// its redesign. Design: fused's strip walker (residuals.cuh) run with no
// rects (R = 0): a thread a 16-byte chunk walked down 8 rows, the row above
// in registers, the left neighbour from lane - 1 by __shfl_up_sync, the
// warp's row staged in shared memory for 512-byte streaming stores, pixel
// loads for ragged or misaligned rows, sv = 1 a template argument on the
// 16-byte path. A walker specialized for no rects measured slower
// (residuals.cuh says why).
#include <cuda_runtime.h>
#include <cstdint>

#include "residuals.cuh"

namespace {

template <typename T, int SV, bool kVec>
__global__ void __launch_bounds__(residuals::kThreads, 1)
jls_kernel(const T* __restrict__ in, const int4* __restrict__ rects, int* __restrict__ out, int R,
           int H, int W, int sv, int bits, int n0, int C, unsigned threads, Divider by_c) {
  residuals::walk<T, SV, kVec>(in, rects, out, R, H, W, sv, bits, n0 + blockIdx.y, C, threads,
                               by_c);
}

template <typename T>
cudaError_t launch_typed(const void* in, int* out, int N, int H, int W, int sv, int bits,
                         cudaStream_t s) {
  // the pixel path, or the 16-byte path with sv = 1 fixed or read at run time
  residuals::Kernel<T> kernel = jls_kernel<T, 0, false>;
  if (residuals::vector_ok<T>(in, out, W))
    kernel = sv == 1 ? jls_kernel<T, 1, true> : jls_kernel<T, 0, true>;
  return residuals::launch<T>(kernel, in, nullptr, out, N, H, W, 0, sv, bits, s);
}

}  // namespace

// Refuses (cudaErrorInvalidValue) what the reference refuses too: sv outside
// 1..7, bits outside 1..30, an item size other than 1 or 2.
extern "C" int jls_residuals_launch(const void* in, void* out, int N, int H, int W, int itemsize,
                                    int sv, int bits, void* stream) {
  if (N < 0 || H < 0 || W < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (sv < 1 || sv > 7 || bits < 1 || bits > 30) return static_cast<int>(cudaErrorInvalidValue);
  if (itemsize != 1 && itemsize != 2) return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0 || H == 0 || W == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* o = static_cast<int*>(out);
  return itemsize == 1 ? launch_typed<uint8_t>(in, o, N, H, W, sv, bits, s)
                       : launch_typed<uint16_t>(in, o, N, H, W, sv, bits, s);
}
