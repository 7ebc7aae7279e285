// Pixel reads and launch plumbing shared by the kernels.
#pragma once

#include <cuda_runtime.h>
#include <cstdint>

// The y and z grid dimensions of a launch. A kernel that puts images (or
// rows, or tile rows) on one of them is launched in slabs of at most this
// many by its C entry point (for_each_slab), each slab a pointer or index
// offset, so no input is refused for its count.
constexpr int kMaxGridYZ = 65535;

// Calls launch(first, count) for consecutive slabs [first, first + count)
// of [0, total), count <= kMaxGridYZ, and returns the first error.
template <typename F>
cudaError_t for_each_slab(long long total, F&& launch) {
  for (long long first = 0; first < total; first += kMaxGridYZ) {
    const long long left = total - first;
    const cudaError_t e = launch(static_cast<int>(first),
                                 static_cast<int>(left < kMaxGridYZ ? left : kMaxGridYZ));
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

// n / d for 0 <= n < 2^31 and 1 <= d < 2^31, as a multiply-high and a
// shift (Granlund-Montgomery, the divisor fixed for the whole launch).
struct Divider {
  unsigned magic, shift;
  explicit Divider(unsigned d) {
    shift = 0;
    while ((1u << shift) < d) ++shift;
    magic = static_cast<unsigned>(((uint64_t{1} << 32) * ((uint64_t{1} << shift) - d)) / d + 1);
  }
  __device__ __forceinline__ unsigned div(unsigned n) const {
    return (__umulhi(n, magic) + n) >> shift;
  }
};

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

// Pixel i of a 16-byte chunk of T pixels, by value (the words are picked
// by constant indices once the caller's loop is unrolled). A 4-byte pixel
// keeps its bit pattern (int32, float).
__device__ __forceinline__ uint8_t from_bits(unsigned b, uint8_t) { return b & 0xffu; }
__device__ __forceinline__ uint16_t from_bits(unsigned b, uint16_t) { return b & 0xffffu; }
__device__ __forceinline__ int16_t from_bits(unsigned b, int16_t) {
  return static_cast<int16_t>(b & 0xffffu);
}
__device__ __forceinline__ int32_t from_bits(unsigned b, int32_t) { return static_cast<int>(b); }
__device__ __forceinline__ float from_bits(unsigned b, float) { return __uint_as_float(b); }

template <typename T>
__device__ __forceinline__ T chunk_value(const uint4& q, int i) {
  const int k = i * static_cast<int>(sizeof(T)) / 4;
  const unsigned word = k == 0 ? q.x : k == 1 ? q.y : k == 2 ? q.z : q.w;
  return from_bits(word >> (8 * (i * sizeof(T) % 4)), T{});
}

// Lanes of this thread's warp that exist in a block of `threads` threads.
__device__ __forceinline__ unsigned warp_lanes(int threads) {
  const int left = threads - (static_cast<int>(threadIdx.x) & ~31);
  return left >= 32 ? 0xffffffffu : ((1u << left) - 1u);
}
