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
// grid z) is cut into a scalar head up to its first 16-byte boundary, an
// aligned body of uint4 chunks and a scalar tail; the head and tail (at most
// 15 bytes each) go to the first block of the plane, the body to all of its
// blocks, kChunks chunks a thread at a stride of the block, all loads issued
// before any store. A block copies image n's R rects into shared memory
// once. For each chunk the thread finds the chunk's row and first column
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
constexpr int kChunks = 4;  // 16-byte chunks per thread: loads in flight

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
scrub_kernel(const T* __restrict__ in, T* __restrict__ out, const int4* __restrict__ rects,
             int R, int W, unsigned plane, Divider by_w) {
  constexpr unsigned kSize = sizeof(T);
  constexpr int V = 16 / kSize;  // pixels per chunk
  extern __shared__ int4 rect_s[];
  const int n = blockIdx.z;
  for (int r = threadIdx.x; r < R; r += blockDim.x) rect_s[r] = rects[static_cast<size_t>(n) * R + r];
  __syncthreads();

  const T* src = in + static_cast<size_t>(n) * plane;
  T* dst = out + static_cast<size_t>(n) * plane;
  const unsigned misalign = static_cast<unsigned>(reinterpret_cast<uintptr_t>(src) & 15u);
  const unsigned head = min(plane, misalign ? (16u - misalign) / kSize : 0u);
  const unsigned chunks = (plane - head) / V;
  const unsigned tail = plane - head - chunks * V;
  const uint4* body_in = reinterpret_cast<const uint4*>(src + head);
  uint4* body_out = reinterpret_cast<uint4*>(dst + head);

  uint4 v[kChunks];
  const unsigned first = blockIdx.x * (kThreads * kChunks) + threadIdx.x;
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    const unsigned c = first + k * kThreads;
    if (c < chunks) v[k] = __ldcs(body_in + c);
  }
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    const unsigned c = first + k * kThreads;
    if (c >= chunks) break;
    const unsigned e = head + c * V;  // first pixel of the chunk in the plane
    const int y = static_cast<int>(by_w.div(e));
    const int x = static_cast<int>(e) - y * W;
    unsigned bits;
    if (x + V <= W) {
      bits = cover_bits<V>(rect_s, R, x, y);
    } else {  // the chunk crosses a row end
      bits = 0;
      int px = x, py = y;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        while (px >= W) px -= W, ++py;
        bits |= cover_bits<1>(rect_s, R, px, py) << j;
        ++px;
      }
    }
    if (bits) {
      v[k].x &= keep_mask<kSize>(bits, 0);
      v[k].y &= keep_mask<kSize>(bits, 1);
      v[k].z &= keep_mask<kSize>(bits, 2);
      v[k].w &= keep_mask<kSize>(bits, 3);
    }
    body_out[c] = v[k];
  }

  // the scalar head and tail of the plane, pixel by pixel
  if (blockIdx.x == 0 && threadIdx.x < head + tail) {
    const unsigned e = threadIdx.x < head ? threadIdx.x : threadIdx.x + chunks * V;
    const int y = static_cast<int>(by_w.div(e));
    const int x = static_cast<int>(e) - y * W;
    dst[e] = cover_bits<1>(rect_s, R, x, y) ? T(0) : src[e];
  }
}

template <typename T>
cudaError_t launch(const void* in, void* out, const void* rects, int N, int H, int W, int R,
                   cudaStream_t stream) {
  const unsigned plane = static_cast<unsigned>(H) * static_cast<unsigned>(W);
  constexpr unsigned V = 16 / sizeof(T);
  const unsigned per_block = kThreads * kChunks;
  const unsigned blocks = (plane / V + per_block - 1) / per_block;
  const dim3 grid(blocks ? blocks : 1, 1, N);
  scrub_kernel<T><<<grid, kThreads, R * sizeof(int4), stream>>>(
      static_cast<const T*>(in), static_cast<T*>(out), static_cast<const int4*>(rects), R, W,
      plane, Divider(static_cast<unsigned>(W)));
  return cudaGetLastError();
}

}  // namespace

// Refuses (cudaErrorInvalidValue) more than kMaxGridYZ images, a plane of
// 2^31 pixels or more, more rects than shared memory holds, an item size
// other than 1, 2, 4 or 8, pointers off their item size, and an input and
// output at different offsets from a 16-byte boundary.
extern "C" int scrub_launch(const void* in, void* out, const void* rects, int N, int H, int W,
                            int R, int itemsize, void* stream) {
  if (N == 0 || H == 0 || W == 0) return 0;
  const auto bad = static_cast<int>(cudaErrorInvalidValue);
  if (N < 0 || H < 0 || W < 0 || R < 0 || N > kMaxGridYZ) return bad;
  if (static_cast<int64_t>(H) * W >= (int64_t{1} << 31)) return bad;
  if (static_cast<size_t>(R) * sizeof(int4) > kMaxSharedBytes) return bad;
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
