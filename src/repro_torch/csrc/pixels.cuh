// Pixel reads shared by the detector kernels (textdetect.cu, phi_detect.cu).
#pragma once

#include <cuda_runtime.h>
#include <cstdint>

// Launch limits of the detector kernels' one-block-per-tile grids: the y
// and z grid dimensions, and the dynamic shared memory a block may take
// without opting in. The C entry points return cudaErrorInvalidValue past
// them, and the Python wrappers raise on that.
constexpr int kMaxGridYZ = 65535;
constexpr size_t kMaxSharedBytes = 48 * 1024;

// Calls f(T{}) for the pixel type of `code`, the code the Python wrappers
// pass (kernels/_launch.py PIXEL_CODES).
template <typename F>
cudaError_t with_pixel_type(int code, F&& f) {
  switch (code) {
    case 0: return f(uint8_t{});
    case 1: return f(uint16_t{});
    case 2: return f(int16_t{});
    case 3: return f(int32_t{});
    case 4: return f(float{});
    default: return cudaErrorInvalidValue;
  }
}

// Pixel (y, x) of one plane as float32, converted by value (uint16 is read
// as uint16_t and never sign-extends). A pixel past the frame reads as 0:
// that is the value the reference's zero padding up to tile multiples gives
// it, and the detectors binarize and difference it like any other pixel.
template <typename T>
__device__ __forceinline__ float pixel_f32(const T* __restrict__ plane, int H, int W, int y,
                                           int x) {
  return (y < H && x < W) ? static_cast<float>(plane[static_cast<size_t>(y) * W + x]) : 0.0f;
}

// Lanes of this thread's warp that exist in a block of `threads` threads.
__device__ __forceinline__ unsigned warp_lanes(int threads) {
  const int left = threads - (static_cast<int>(threadIdx.x) & ~31);
  return left >= 32 ? 0xffffffffu : ((1u << left) - 1u);
}
