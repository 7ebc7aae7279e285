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
// Design: one block per (tile column, tile row, image), tile rows and images
// on grid y and z in slabs of 65535, so any N and H run. A tile row is cut
// into C = ceil(tw / V) chunks of V = 16 / itemsize pixels (8 uint16), and
// the th x C chunks of the tile are spread over the block, kChunks chunks a
// thread a pass, each thread issuing all of its 16-byte loads before it
// counts (the (32, 128) uint16 tile is 512 chunks: 256 threads, one pass,
// every load of the tile in flight at once, which is what the audit's
// one-image launches, 40 tiles on 132 SMs, need, rather than 32 rows walked
// one after another). Chunk s of a pass is (row s / C, chunk s % C), and
// the chunks of one k sit in consecutive lanes, so a chunk's right
// neighbour, the first pixel of chunk s + 1,
// comes from __shfl_down_sync instead of a second global load; lane 31,
// whose next chunk is in another warp, loads that one pixel, and the last
// chunk of a tile row has no pair past it (c + 1 = tw). A chunk that lies
// inside the frame, is whole (not the short last chunk of a tile width that
// is no multiple of V) and sits on a 16-byte boundary is one uint4 load;
// any other (a ragged edge, a row that is no 16-byte multiple, a misaligned
// base) reads its pixels one by one in the same pass, zeros past the frame.
// A tile wider than the block's lanes (any tw) is the same walk over more
// passes: every hand-off is between chunk s and s + 1 of one pass, on
// neighbouring lanes or through lane 31's own load, wherever s falls.
// The integer count is exact: a warp sum, one shared slot per warp, and
// thread 0 divides with __fdiv_rn, one IEEE float32 division as in the
// reference (whatever the compiler's division flags; never a reciprocal
// product).
//
// Registers (nvcc -Xptxas -v, sm_90a, logged by chip_smoke.py): 35-48 a
// thread by pixel type (40 for uint16), no stack frame, no spills.
#include <cuda_runtime.h>
#include <cstdint>

#include "pixels.cuh"

namespace {

constexpr int kThreads = 256;  // at most, a block
constexpr int kChunks = 2;     // 16-byte chunks a thread a pass: loads in flight

template <typename T>
__global__ void __launch_bounds__(kThreads)
phi_detect_kernel(const T* __restrict__ in, float* __restrict__ out, int H, int W, int th,
                  int tw, float thresh, int Ht, int ty0, int n0) {
  constexpr int V = 16 / sizeof(T);  // pixels per chunk
  __shared__ int warp_hits[kThreads / 32];
  const int tx = blockIdx.x, ty = ty0 + blockIdx.y, n = n0 + blockIdx.z;
  const int lane = threadIdx.x & 31;
  const T* plane = in + static_cast<size_t>(n) * H * W;
  const int C = (tw + V - 1) / V;
  const int slots = th * C;

  int count = 0;
  for (int base = 0; base < slots; base += kChunks * blockDim.x) {
    // issue every 16-byte load of the pass first
    uint4 raw[kChunks];
    bool whole[kChunks];
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      const int s = base + k * blockDim.x + threadIdx.x;
      const int r = s / C, j = s - r * C;
      const int y = ty * th + r, x0 = tx * tw + j * V;
      const T* p = plane + static_cast<size_t>(y) * W + x0;
      whole[k] = s < slots && j * V + V <= tw && y < H && x0 + V <= W &&
                 (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
      if (whole[k]) raw[k] = __ldg(reinterpret_cast<const uint4*>(p));
    }
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      const int s = base + k * blockDim.x + threadIdx.x;
      const int r = s / C, j = s - r * C;
      const int y = ty * th + r, x0 = tx * tw + j * V;
      const int m = min(V, tw - j * V);  // pixels of the tile in this chunk
      float px[V];
      if (whole[k]) {
#pragma unroll
        for (int i = 0; i < V; ++i) px[i] = static_cast<float>(chunk_value<T>(raw[k], i));
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i)
          px[i] = (s < slots && i < m) ? pixel_f32(plane, H, W, y, x0 + i) : 0.0f;
      }
      // every lane shuffles; the next lane holds chunk s + 1
      const float next = __shfl_down_sync(0xffffffffu, px[0], 1);
      if (s < slots) {
#pragma unroll
        for (int i = 0; i + 1 < V; ++i) count += (i + 1 < m && fabsf(px[i + 1] - px[i]) >= thresh);
        if (j + 1 < C) {
          const float b = lane == 31 ? pixel_f32(plane, H, W, y, x0 + V) : next;
          count += fabsf(b - px[V - 1]) >= thresh;
        }
      }
    }
  }
  count = __reduce_add_sync(0xffffffffu, count);
  if (lane == 0) warp_hits[threadIdx.x >> 5] = count;
  __syncthreads();
  if (threadIdx.x < 32) {
    const int warps = blockDim.x >> 5;
    int hits = lane < warps ? warp_hits[lane] : 0;
    hits = __reduce_add_sync(0xffffffffu, hits);
    if (lane == 0) {
      const size_t tile = (static_cast<size_t>(n) * Ht + ty) * gridDim.x + tx;
      out[tile] = __fdiv_rn(static_cast<float>(hits), static_cast<float>(th * tw));
    }
  }
}

}  // namespace

// Refuses (cudaErrorInvalidValue) a tile dimension below 1, as the
// reference does (it divides by the tile), and a tile of 2^31 pixels or
// more: the reference sums a tile's hits in float32, which counts exactly
// only up to 2^24, so no exact result exists to hold such a tile to.
extern "C" int phi_detect_launch(const void* in, void* out, int N, int H, int W, int th, int tw,
                                 int pixel_code, float thresh, void* stream) {
  if (N == 0 || H == 0 || W == 0) return 0;
  if (N < 0 || H < 0 || W < 0 || th < 1 || tw < 1 || static_cast<int64_t>(th) * tw > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const int Ht = static_cast<int>((static_cast<int64_t>(H) + th - 1) / th);
  const int Wt = static_cast<int>((static_cast<int64_t>(W) + tw - 1) / tw);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(with_pixel_type(pixel_code, [&](auto tag) {
    using T = decltype(tag);
    constexpr int V = 16 / sizeof(T);
    const int64_t per_thread = (static_cast<int64_t>(th) * ((tw + V - 1) / V) + kChunks - 1) / kChunks;
    const int threads = static_cast<int>(per_thread >= kThreads ? kThreads : (per_thread + 31) / 32 * 32);
    // tile rows to grid y and images to grid z, in slabs of 65535
    return for_each_slab(Ht, [&](int ty0, int nty) {
      return for_each_slab(N, [&](int n0, int nn) {
        phi_detect_kernel<T><<<dim3(Wt, nty, nn), threads, 0, s>>>(
            static_cast<const T*>(in), static_cast<float*>(out), H, W, th, tw, thresh, Ht, ty0, n0);
        return cudaGetLastError();
      });
    });
  }));
}
