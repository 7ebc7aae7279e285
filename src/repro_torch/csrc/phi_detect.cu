// Burned-in-text edge density of the post-scrub PHI audit, per tile.
//
// Replaces the TPU kernel src/repro/kernels/phi_detect/phi_detect.py::_phi_kernel
// (pallas_call in phi_detect_pallas).
//
// For each (th, tw) tile of each image: the count of in-tile horizontal
// pairs (c, c + 1), c + 1 < tw, with |float32(x[r, c+1]) - float32(x[r, c])|
// >= thresh, divided by th * tw (not th * (tw - 1)), float32. thresh arrives
// as a float: the reference compares against a weakly typed float32. Pixels
// past the frame read as 0 (pixels.cuh): the pair (last real column, first
// padding column) is a strong edge whenever the last column is bright, as in
// the reference, which zero-pads before its kernel.
//
// Bound on the card: HBM bytes. Each pixel is read once (itemsize B) and
// each tile writes one float: for uint16 and the default (32, 128) tile,
// 2 + 4 / 4096 = 2.001 B per pixel. The subtract, abs and compare are far
// below the card's float32 rate.
//
// Design: one block per (tile column, tile row, image), tw threads. Thread
// c walks the th rows of its column and compares its pixel with its right
// neighbour (the neighbour's load is the next thread's, served by L1), as
// float subtraction and fabsf. The integer count is exact; a warp sum and a
// shared atomicAdd reduce it over the block, and thread 0 divides with
// __fdiv_rn, one IEEE float32 division as in the reference (whatever the
// compiler's division flags).
#include <cuda_runtime.h>
#include <cstdint>

#include "pixels.cuh"

namespace {

template <typename T>
__global__ void phi_detect_kernel(const T* __restrict__ in, float* __restrict__ out, int H, int W,
                                  int th, int tw, float thresh) {
  __shared__ int tile_hits;
  const int c = threadIdx.x;
  const int tx = blockIdx.x, ty = blockIdx.y, n = blockIdx.z;
  const size_t tile = (static_cast<size_t>(n) * gridDim.y + ty) * gridDim.x + tx;
  const T* plane = in + static_cast<size_t>(n) * H * W;
  if (c == 0) tile_hits = 0;
  __syncthreads();

  int count = 0;
  if (c + 1 < tw) {
    const int x = tx * tw + c;
    for (int r = 0; r < th; ++r) {
      const int y = ty * th + r;
      const float a = pixel_f32(plane, H, W, y, x);
      const float b = pixel_f32(plane, H, W, y, x + 1);
      count += fabsf(b - a) >= thresh ? 1 : 0;
    }
  }
  count = __reduce_add_sync(warp_lanes(blockDim.x), count);
  if ((c & 31) == 0 && count > 0) atomicAdd(&tile_hits, count);
  __syncthreads();
  if (c == 0) out[tile] = __fdiv_rn(static_cast<float>(tile_hits), static_cast<float>(th * tw));
}

}  // namespace

extern "C" int phi_detect_launch(const void* in, void* out, int N, int H, int W, int th, int tw,
                                 int pixel_code, float thresh, void* stream) {
  if (N == 0 || H == 0 || W == 0) return 0;
  if (th < 1 || tw < 1 || tw > 1024) return static_cast<int>(cudaErrorInvalidValue);
  const int Ht = (H + th - 1) / th, Wt = (W + tw - 1) / tw;
  if (Ht > kMaxGridYZ || N > kMaxGridYZ) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(Wt, Ht, N);
  return static_cast<int>(with_pixel_type(pixel_code, [&](auto tag) {
    using T = decltype(tag);
    phi_detect_kernel<T><<<grid, tw, 0, s>>>(static_cast<const T*>(in), static_cast<float*>(out),
                                             H, W, th, tw, thresh);
    return cudaGetLastError();
  }));
}
