// Batched PHI-rectangle blanking: zero every pixel inside a rect, keep dtype.
//
// Replaces the TPU kernel src/repro/kernels/scrub/scrub.py::_scrub_kernel
// (pallas_call in scrub_pallas).
//
// Bound on the card: HBM bytes. Each pixel is read once and written once:
// 2 x itemsize bytes per pixel (4 B for uint16, 2 B for uint8). The rect
// test is a handful of integer compares per 16-byte chunk, far below the
// card's integer rate.
//
// Design: a streaming copy that moves 16-byte chunks. Each plane (image n,
// grid y, in slabs of 65535 images; a plane of 2^31 pixels or more in
// segments of whole rows under 2^31 pixels, one launch each) is cut into a
// scalar head up to its first 16-byte boundary, an aligned body of uint4
// chunks and a scalar tail; the head and tail (at most 15 bytes each) go to
// the first block of the segment, the body to all of its blocks, kChunks
// chunks a thread at a stride of the block, all loads issued before any
// store. A block copies image n's R rects into shared memory once (in
// batches of 3072, 48 KB, ORing each batch's coverage, so any R fits). For
// each chunk the thread finds the chunk's row and first column
// (division by W with a multiply-high, divisors computed on the host) and
// asks every rect for the bit mask of the chunk's pixels it covers: a chunk
// no rect meets (most chunks: the CT rects cover 102 of 512 rows) is stored
// as loaded, any other is ANDed with the byte mask of its uncovered pixels,
// 4 words and no per-pixel branch. A chunk that
// crosses a row end (rows that are not 16-byte multiples: 2022 uint16, 90
// uint8) tests each pixel at its own (x, y). Loads and stores are 16 bytes
// on both sides, so input and output must sit at the same offset from a
// 16-byte boundary: the wrapper allocates the output so (a view of a batch,
// such as images[1:], may start anywhere); the entry point refuses a pair
// that does not.
//
// Registers (nvcc -Xptxas -v, sm_90a, logged by chip_smoke.py): 43 a thread
// for every item size, no stack frame, no spills.
#include <cuda_runtime.h>
#include <cstdint>

#include "pixels.cuh"
#include "rects.cuh"

namespace {

// The bytes of 32-bit word w of a chunk whose pixels (of S bytes each) are
// not set in bits: the mask that zeroes the covered pixels' bytes.
template <unsigned S>
__device__ __forceinline__ unsigned keep_mask(unsigned bits, int w) {
  unsigned m = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (!(bits >> ((4 * w + i) / S) & 1u)) m |= 0xffu << (8 * i);
  return m;
}

constexpr int kThreads = 256;
constexpr int kChunks = 4;        // 16-byte chunks per thread: loads in flight
constexpr int kRectBatch = 3072;  // rects in shared memory at a time (48 KB)

// One launch copies a segment of rows y0 .. y0 + seg / W - 1 of each image
// of a slab (grid y), seg < 2^31 pixels; plane is the image stride.
template <typename T>
__global__ void __launch_bounds__(kThreads)
scrub_kernel(const T* __restrict__ in, T* __restrict__ out, const int4* __restrict__ rects,
             int R, int W, unsigned seg, int y0, size_t plane, int n0, Divider by_w) {
  constexpr unsigned kSize = sizeof(T);
  constexpr int V = 16 / kSize;  // pixels per chunk
  extern __shared__ int4 rect_s[];
  const int n = n0 + blockIdx.y;
  const size_t start = static_cast<size_t>(n) * plane + static_cast<size_t>(y0) * W;
  const T* src = in + start;
  T* dst = out + start;
  const unsigned misalign = static_cast<unsigned>(reinterpret_cast<uintptr_t>(src) & 15u);
  const unsigned head = min(seg, misalign ? (16u - misalign) / kSize : 0u);
  const unsigned chunks = (seg - head) / V;
  const unsigned tail = seg - head - chunks * V;
  const uint4* body_in = reinterpret_cast<const uint4*>(src + head);
  uint4* body_out = reinterpret_cast<uint4*>(dst + head);

  uint4 v[kChunks];
  const unsigned first = blockIdx.x * (kThreads * kChunks) + threadIdx.x;
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    const unsigned c = first + k * kThreads;
    if (c < chunks) v[k] = __ldcs(body_in + c);
  }
  // the row and first column of each chunk, and of this thread's pixel of
  // the scalar head and tail (block 0)
  int cy[kChunks], cx[kChunks];
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    const unsigned e = head + (first + k * kThreads) * V;  // first pixel of the chunk
    cy[k] = static_cast<int>(by_w.div(e));
    cx[k] = static_cast<int>(e) - cy[k] * W;
  }
  const bool edge = blockIdx.x == 0 && threadIdx.x < head + tail;
  const unsigned pe = threadIdx.x < head ? threadIdx.x : threadIdx.x + chunks * V;
  const int py = edge ? static_cast<int>(by_w.div(pe)) : 0;
  const int px = edge ? static_cast<int>(pe) - py * W : 0;

  // coverage, the rects a batch at a time through shared memory
  unsigned bits[kChunks] = {};
  unsigned pbit = 0;
  for (int r0 = 0; r0 < R; r0 += kRectBatch) {
    const int nb = min(kRectBatch, R - r0);
    if (r0 > 0) __syncthreads();
    for (int r = threadIdx.x; r < nb; r += blockDim.x)
      rect_s[r] = rects[static_cast<size_t>(n) * R + r0 + r];
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      if (first + k * kThreads >= chunks) break;
      const int x = cx[k], y = y0 + cy[k];
      if (x + V <= W) {
        bits[k] |= cover_bits<V>(rect_s, nb, x, y);
      } else {  // the chunk crosses a row end
        int qx = x, qy = y;
#pragma unroll
        for (int j = 0; j < V; ++j) {
          while (qx >= W) qx -= W, ++qy;
          bits[k] |= cover_bits<1>(rect_s, nb, qx, qy) << j;
          ++qx;
        }
      }
    }
    if (edge) pbit |= cover_bits<1>(rect_s, nb, px, y0 + py);
  }

#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    const unsigned c = first + k * kThreads;
    if (c >= chunks) break;
    if (bits[k]) {
      v[k].x &= keep_mask<kSize>(bits[k], 0);
      v[k].y &= keep_mask<kSize>(bits[k], 1);
      v[k].z &= keep_mask<kSize>(bits[k], 2);
      v[k].w &= keep_mask<kSize>(bits[k], 3);
    }
    body_out[c] = v[k];
  }
  // the scalar head and tail of the segment, pixel by pixel
  if (edge) dst[pe] = pbit ? T(0) : src[pe];
}

template <typename T>
cudaError_t launch(const void* in, void* out, const void* rects, int N, int H, int W, int R,
                   cudaStream_t stream) {
  constexpr unsigned V = 16 / sizeof(T);
  // rows a segment: fewer than 2^31 pixels, so a pixel's index is an int
  const int seg_rows = static_cast<int>(max(1LL, ((1LL << 31) - 1) / W));
  const size_t plane = static_cast<size_t>(H) * W;
  const size_t smem = static_cast<size_t>(min(R, kRectBatch)) * sizeof(int4);
  const Divider by_w(static_cast<unsigned>(W));
  for (int y0 = 0; y0 < H; y0 += seg_rows) {
    const unsigned seg = static_cast<unsigned>(min(seg_rows, H - y0)) * static_cast<unsigned>(W);
    const unsigned per_block = kThreads * kChunks;
    const unsigned blocks = (seg / V + per_block - 1) / per_block;
    const cudaError_t e = for_each_slab(N, [&](int n0, int nn) {
      scrub_kernel<T><<<dim3(blocks ? blocks : 1, nn), kThreads, smem, stream>>>(
          static_cast<const T*>(in), static_cast<T*>(out), static_cast<const int4*>(rects), R,
          W, seg, y0, plane, n0, by_w);
      return cudaGetLastError();
    });
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace

// Takes any N, H, W and R. Refuses (cudaErrorInvalidValue) only what the
// wrapper never passes: an item size other than 1, 2, 4 or 8, pointers off
// their item size, and an input and output at different offsets from a
// 16-byte boundary.
extern "C" int scrub_launch(const void* in, void* out, const void* rects, int N, int H, int W,
                            int R, int itemsize, void* stream) {
  if (N == 0 || H == 0 || W == 0) return 0;
  const auto bad = static_cast<int>(cudaErrorInvalidValue);
  if (N < 0 || H < 0 || W < 0 || R < 0) return bad;
  const auto a = reinterpret_cast<uintptr_t>(in), b = reinterpret_cast<uintptr_t>(out);
  if (itemsize < 1 || a % itemsize || b % itemsize || (a - b) % 16) return bad;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (itemsize) {
    case 1: return launch<uint8_t>(in, out, rects, N, H, W, R, s);
    case 2: return launch<uint16_t>(in, out, rects, N, H, W, R, s);
    case 4: return launch<uint32_t>(in, out, rects, N, H, W, R, s);
    case 8: return launch<uint64_t>(in, out, rects, N, H, W, R, s);
    default: return bad;
  }
}
