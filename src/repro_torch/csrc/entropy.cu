// Golomb-Rice entropy plan on the card: two kernels.
//
// 1. rice_prepass: zigzag u = (r << 1) ^ (r >> 31) (arithmetic >>) of the
//    int32 residuals, and the int32 sum of u over each row.
//    Replaces src/repro/kernels/jls/entropy.py::_zigzag_rowsum_kernel
//    (pallas_call in _prepass).
//    Bound: HBM bytes, 4 B read + 4 B written per pixel (+4 B per row).
//    Design: one block of 256 threads per row, grid (H, N), images in
//    slabs of 65535 (any N); threads stride
//    along the row with coalesced loads, then a warp-shuffle reduction and a
//    second shuffle over the per-warp sums. Integer sums are exact in any
//    order; the accumulator is unsigned so an overflowing row wraps exactly
//    as the int32 sum of the JAX kernel does.
//
// 2. rice_len_rem: given the per-instance Rice parameter k (N int32), the
//    code length of each symbol, q + 1 + k with q = u >>logical k, or the
//    escape length (qmax + 2 + 64) when q > qmax, and the remainder
//    u & (2^k - 1).
//    Replaces src/repro/kernels/jls/entropy.py::_len_rem_kernel
//    (pallas_call in _len_rem).
//    Bound: HBM bytes, 4 B read + 8 B written per pixel.
//    Design: one thread per symbol, blocks of 256 along a row, grid
//    (ceil(W/256), H, N), rows and images in slabs of 65535; k is read
//    once per thread from a cached word.
//    qmax is an argument, so the one constant lives in the codec.
#include <cuda_runtime.h>
#include <cstdint>

#include "pixels.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void prepass_kernel(const int* __restrict__ res, int* __restrict__ u,
                               int* __restrict__ rs, int H, int W, int n0) {
  const int y = blockIdx.x;
  const int n = n0 + blockIdx.y;
  const size_t row = (static_cast<size_t>(n) * H + y) * W;
  unsigned acc = 0;
  for (int x = threadIdx.x; x < W; x += blockDim.x) {
    const int r = res[row + x];
    const unsigned z = (static_cast<unsigned>(r) << 1) ^ static_cast<unsigned>(r >> 31);
    u[row + x] = static_cast<int>(z);
    acc += z;
  }
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  __shared__ unsigned warp_sums[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = lane < static_cast<int>(blockDim.x >> 5) ? warp_sums[lane] : 0u;
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (lane == 0) rs[static_cast<size_t>(n) * H + y] = static_cast<int>(acc);
  }
}

__global__ void len_rem_kernel(const int* __restrict__ u, const int* __restrict__ ks,
                               int* __restrict__ lens, int* __restrict__ rem, int H, int W,
                               int qmax, int y0, int n0) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = y0 + blockIdx.y;
  const int n = n0 + blockIdx.z;
  if (x >= W) return;
  const size_t idx = (static_cast<size_t>(n) * H + y) * W + x;
  const int k = __ldg(ks + n);  // 0 <= k <= 30, checked by the wrapper
  const int uv = u[idx];
  const int q = static_cast<int>(static_cast<unsigned>(uv) >> k);  // logical shift
  lens[idx] = q > qmax ? qmax + 2 + 64 : q + 1 + k;
  rem[idx] = uv & ((1 << k) - 1);
}

}  // namespace

extern "C" int rice_prepass_launch(const void* res, void* u, void* rs, int N, int H, int W,
                                   void* stream) {
  if (N == 0 || H == 0 || W == 0) return 0;
  // images to grid y in slabs of 65535
  return static_cast<int>(for_each_slab(N, [&](int n0, int nn) {
    prepass_kernel<<<dim3(H, nn), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(res), static_cast<int*>(u), static_cast<int*>(rs), H, W, n0);
    return cudaGetLastError();
  }));
}

extern "C" int rice_len_rem_launch(const void* u, const void* ks, void* lens, void* rem, int N,
                                   int H, int W, int qmax, void* stream) {
  if (N == 0 || H == 0 || W == 0) return 0;
  // rows to grid y and images to grid z, in slabs of 65535
  return static_cast<int>(for_each_slab(H, [&](int y0, int nh) {
    return for_each_slab(N, [&](int n0, int nn) {
      const dim3 grid((W + kThreads - 1) / kThreads, nh, nn);
      len_rem_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const int*>(u), static_cast<const int*>(ks), static_cast<int*>(lens),
          static_cast<int*>(rem), H, W, qmax, y0, n0);
      return cudaGetLastError();
    });
  }));
}
