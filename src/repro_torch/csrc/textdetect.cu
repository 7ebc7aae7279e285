// Text-band detector statistics of the burned-in-PHI detector, per tile.
//
// Replaces the TPU kernel src/repro/kernels/textdetect/textdetect.py::_textdetect_kernel
// (pallas_call in textdetect_pallas).
//
// For each (th, tw) tile of each image: a pixel is a hit when
// float32(x) >= thresh (thresh arrives as a float, never a double: a double
// compare disagrees wherever float32 rounds the threshold across an
// integer); rows[n, i, j, r] counts the hits of tile row r, cols[n, i, j, c]
// those of tile column c, and runs[n, i, j] is the longest horizontal run of
// hits inside the tile (a run resets on a gap and never crosses a tile
// edge). Pixels past the frame read as 0 (pixels.cuh), so the ragged last
// tiles equal the reference's zero-padded ones, hits at thresh <= 0
// included.
//
// Bound on the card: HBM bytes. Each pixel is read once (itemsize B) and
// each tile writes (th + tw + 1) int32: for uint16 and the default (32, 128)
// tile, 2 + 644 / 4096 = 2.157 B per pixel. The compare and the counts are a
// few integer operations per pixel, far below the card's rate.
//
// Design: one block per (tile column, tile row, image), tw threads. Thread
// c walks the th rows of its column: neighbouring threads read neighbouring
// pixels, so loads coalesce. It counts its column's hits into `cols` and
// stores each hit as a byte in a shared th x (tw + 4) tile (the 4 spare
// bytes put the rows of a (32, 128) tile on distinct banks). After a
// barrier, one thread per tile row (warp 0 for th <= 32) scans its row
// serially: the row count, and the run recurrence run = (run + b) * b,
// best = max(best, run) of the TPU kernel's fori_loop. A warp max and a
// shared atomicMax give the tile's run. th and tw are run-time arguments
// (the detector policy's tile is a knob); the entry point refuses a tile
// that does not fit one block, and the wrapper raises on that.
#include <cuda_runtime.h>
#include <cstdint>

#include "pixels.cuh"

namespace {

constexpr int kRowPad = 4;

template <typename T>
__global__ void textdetect_kernel(const T* __restrict__ in, int* __restrict__ rows,
                                  int* __restrict__ cols, int* __restrict__ runs, int H, int W,
                                  int th, int tw, float thresh) {
  extern __shared__ unsigned char hits[];  // th rows of tw + kRowPad bytes
  __shared__ int tile_best;
  const int stride = tw + kRowPad;
  const int c = threadIdx.x;
  const int tx = blockIdx.x, ty = blockIdx.y, n = blockIdx.z;
  const size_t tile = (static_cast<size_t>(n) * gridDim.y + ty) * gridDim.x + tx;
  const T* plane = in + static_cast<size_t>(n) * H * W;
  if (c == 0) tile_best = 0;

  const int x = tx * tw + c;
  int col_hits = 0;
  for (int r = 0; r < th; ++r) {
    const int b = pixel_f32(plane, H, W, ty * th + r, x) >= thresh ? 1 : 0;
    col_hits += b;
    hits[r * stride + c] = static_cast<unsigned char>(b);
  }
  cols[tile * tw + c] = col_hits;
  __syncthreads();

  int best = 0;
  for (int r = c; r < th; r += blockDim.x) {
    const unsigned char* row = hits + r * stride;
    int row_hits = 0, run = 0;
    for (int j = 0; j < tw; ++j) {
      const int b = row[j];
      row_hits += b;
      run = (run + b) * b;
      best = max(best, run);
    }
    rows[tile * th + r] = row_hits;
  }
  best = __reduce_max_sync(warp_lanes(blockDim.x), best);
  if ((c & 31) == 0 && best > 0) atomicMax(&tile_best, best);
  __syncthreads();
  if (c == 0) runs[tile] = tile_best;
}

}  // namespace

extern "C" int textdetect_launch(const void* in, void* rows, void* cols, void* runs, int N, int H,
                                 int W, int th, int tw, int pixel_code, float thresh,
                                 void* stream) {
  if (N == 0 || H == 0 || W == 0) return 0;
  if (th < 1 || tw < 1 || tw > 1024) return static_cast<int>(cudaErrorInvalidValue);
  const int Ht = (H + th - 1) / th, Wt = (W + tw - 1) / tw;
  const size_t smem = static_cast<size_t>(th) * (tw + kRowPad);
  if (smem > kMaxSharedBytes || Ht > kMaxGridYZ || N > kMaxGridYZ) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(Wt, Ht, N);
  return static_cast<int>(with_pixel_type(pixel_code, [&](auto tag) {
    using T = decltype(tag);
    textdetect_kernel<T><<<grid, tw, smem, s>>>(static_cast<const T*>(in), static_cast<int*>(rows),
                                                static_cast<int*>(cols), static_cast<int*>(runs),
                                                H, W, th, tw, thresh);
    return cudaGetLastError();
  }));
}
