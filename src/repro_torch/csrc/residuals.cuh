// JPEG-Lossless predictor residuals by strips of 16-byte chunks: the walker
// of fused.cu (with its rects) and jls.cu (with none, R = 0).
//
// For each pixel of a plane, with every rect pixel zeroed, the
// residual (x - pred) mod 2^bits, sign-wrapped into [-2^(bits-1),
// 2^(bits-1)), with the predictor of selection value sv (1..7) over the left
// (ra), above (rb) and above-left (rc) neighbours. Row 0 predicts ra, column
// 0 predicts rb, (0,0) predicts 2^(bits-1). Each neighbour is masked with its
// *own* coverage, exactly as if the blanked plane had been materialized
// first. The wrap (x - pred) << (32 - bits) >> (32 - bits) is exact for any
// bits in 1..30. Samples widen by value (uint16 >= 32768 stays positive); sv
// 5 and 6 shift a possibly negative int right, which is arithmetic, as in
// the reference.
//
// Bound on the card: HBM bytes. One read of the uint8/uint16 plane and one
// int32 write: 2 + 4 = 6 B per pixel for uint16 (5 B for uint8).
//
// A thread owns one chunk of V = 16 / itemsize pixels (8 uint16, 16 uint8) of
// a row and walks it down kRows rows, keeping row y - 1's V (masked) pixels
// in registers, so each input byte comes from HBM once and is read once more
// only at a strip's first row (row y0 - 1, 1/kRows of the reads, mostly from
// L2). Its kRows + 1 loads are issued before anything else. The chunks of a
// row sit on consecutive lanes, so a chunk's left neighbour is the last pixel
// of lane - 1's chunk (__shfl_up_sync, already masked); lane 0 loads its own.
// A block copies image n's rects into shared memory (in batches of
// kRectBatch, which fit beside the staged rows below, so any R runs) and each
// thread turns every rect that meets its strip into one bit mask of its V + 1
// columns (from x0 - 1, the left neighbour included) and ORs it into the rows
// it spans: a rect costs a thread a few operations, not four tests a pixel.
// jls runs the same walker with R = 0: its rect loop runs no batch and its
// masks stay 0. A copy specialized at compile time for no rects measured
// slower (H100, PERF.md §6: CT 0.0242 against 0.0228 ms, US 0.0322 against
// 0.0286): without the rect loop between them, the compiler interleaved the
// strip's loads with the first row's work and cut the registers, so fewer
// loads were in flight. Residuals leave as 16-byte streaming stores through
// a warp's row staged in shared memory: store w of lane L writes piece (L +
// 32 w) % P of lane (L + 32 w) / P (P = V / 4 pieces of 16 bytes a lane, 2
// uint16, 4 uint8), so a store instruction writes 512 contiguous bytes, whole
// sectors, where a lane's own pieces would sit 32 or 64 bytes apart across
// the warp. Rows whose byte length is no 16-byte multiple (2022 uint16, 70 or
// 90 uint8) or a view off a 16-byte boundary take the same walk with pixel
// loads and stores (kVec = false). Threads are numbered (strip, chunk) within
// an image, chunk fastest, so warps stay full at any width; images go to grid
// y in slabs of 65535 (for_each_slab), so any N runs. sv = 1, the one every
// product path launches, is a template argument on the vector path (read at
// run time it cost fused 1.5-5.8 %, PERF.md §6); other selection values and
// the pixel path read it at run time. __launch_bounds__(kThreads, 1) leaves
// the register count to the compiler: the default cap spilled the uint8 and
// ragged variants.
#pragma once

#include <cuda_runtime.h>
#include <cstdint>

#include "pixels.cuh"
#include "rects.cuh"

namespace residuals {

constexpr int kThreads = 128;
constexpr int kRows = 8;  // rows a thread walks down its strip
// rects in shared memory at a time: 32 KB, beside at most 8 KB of staged
// rows, within the 48 KB a block gets without opting in
constexpr int kRectBatch = 2048;
// (the uint8 stage: kThreads lanes x 4 pieces of 16 bytes)
static_assert(kRectBatch * 16 + kThreads * 4 * 16 <= 48 * 1024, "shared memory");

// The predictor of selection value SV (sv when SV is 0) over the left (a),
// above (b) and above-left (c) neighbours; >> is arithmetic on int. A chain
// of selects, not a switch: a jump table costs the kernel a stack frame.
template <int SV>
__device__ __forceinline__ int predict(int sv, int a, int b, int c) {
  const int s = SV ? SV : sv;
  return s == 1 ? a
       : s == 2 ? b
       : s == 3 ? c
       : s == 4 ? a + b - c
       : s == 5 ? a + ((b - c) >> 1)
       : s == 6 ? b + ((a - c) >> 1)
       : (a + b) >> 1;  // 7
}

// The kernel body: image n, thread t = blockIdx.x * kThreads + threadIdx.x
// of `threads` (strip, chunk) threads an image, C chunks a row; rects is (N,
// R) int4, unread when R = 0.
template <typename T, int SV, bool kVec>
__device__ __forceinline__ void walk(const T* __restrict__ in, const int4* __restrict__ rects,
                                     int* __restrict__ out, int R, int H, int W, int sv, int bits,
                                     int n, int C, unsigned threads, Divider by_c) {
  constexpr int V = 16 / sizeof(T);  // pixels per chunk
  __shared__ int4 stage_s[kVec ? kThreads * V / 4 : 1];  // a row's residuals, a warp's
  const unsigned t = blockIdx.x * kThreads + threadIdx.x;  // (strip, chunk) of image n
  const bool active = t < threads;
  const unsigned strip = by_c.div(t);
  const int j = static_cast<int>(t - strip * C);
  const int y0 = static_cast<int>(strip) * kRows;
  const int x0 = j * V;
  const int lane = threadIdx.x & 31;
  const T* plane = in + static_cast<size_t>(n) * H * W;

  // every load first: rows y0 - 1 .. y0 + kRows - 1 of the chunk, and lane
  // 0's left neighbours
  uint4 raw[kRows + 1];
  int left_raw[kRows + 1];
#pragma unroll
  for (int i = 0; i <= kRows; ++i) {
    const int y = y0 - 1 + i;
    const bool row_ok = active && y >= 0 && y < H;
    const T* p = plane + static_cast<size_t>(row_ok ? y : 0) * W + x0;
    if constexpr (kVec) raw[i] = row_ok ? __ldg(reinterpret_cast<const uint4*>(p)) : uint4{};
    left_raw[i] = row_ok && lane == 0 && j > 0 ? static_cast<int>(p[-1]) : 0;
  }

  // coverage of columns x0 - 1 .. x0 + V - 1 in each row of the strip
  unsigned cov[kRows + 1];
#pragma unroll
  for (int i = 0; i <= kRows; ++i) cov[i] = 0;
  extern __shared__ int4 rect_s[];
  for (int r0 = 0; r0 < R; r0 += kRectBatch) {
    const int nb = min(kRectBatch, R - r0);
    if (r0 > 0) __syncthreads();
    for (int r = threadIdx.x; r < nb; r += kThreads)
      rect_s[r] = rects[static_cast<size_t>(n) * R + r0 + r];
    __syncthreads();
    for (int r = 0; r < nb; ++r) {
      const int4 q = rect_s[r];
      if (q.z <= 0 || q.w <= 0) continue;
      const int yend = wrap_add(q.y, q.w);
      if (yend <= max(q.y, y0 - 1) || q.y > y0 + kRows - 1) continue;  // misses the strip
      const unsigned xb = span_bits<V + 1>(q, x0 - 1);
      if (xb == 0) continue;
#pragma unroll
      for (int i = 0; i <= kRows; ++i) {
        const int y = y0 - 1 + i;
        if (y >= q.y && y < yend) cov[i] |= xb;
      }
    }
  }

  const int half = 1 << (bits - 1);
  const int sh = 32 - bits;
  int prev[V];
  int prev_left = 0;
#pragma unroll
  for (int v = 0; v < V; ++v) prev[v] = 0;
#pragma unroll
  for (int i = 0; i <= kRows; ++i) {
    const int y = y0 - 1 + i;
    const bool row_ok = active && y >= 0 && y < H;
    int cur[V];
    if constexpr (kVec) {
#pragma unroll
      for (int v = 0; v < V; ++v) cur[v] = static_cast<int>(chunk_value<T>(raw[i], v));
    } else {
      const T* p = plane + static_cast<size_t>(row_ok ? y : 0) * W + x0;
#pragma unroll
      for (int v = 0; v < V; ++v) cur[v] = row_ok && x0 + v < W ? static_cast<int>(p[v]) : 0;
    }
#pragma unroll
    for (int v = 0; v < V; ++v)
      if (cov[i] >> (v + 1) & 1u) cur[v] = 0;
    // every lane shuffles; lane - 1 holds the chunk to the left (j > 0)
    const int from_left = __shfl_up_sync(0xffffffffu, cur[V - 1], 1);
    const int left = lane > 0 ? from_left : (cov[i] & 1u) ? 0 : left_raw[i];
    int res[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int a = v ? cur[v - 1] : left;
      const int b = prev[v];
      const int c = v ? prev[v - 1] : prev_left;
      int pred = y == 0 ? a : predict<SV>(sv, a, b, c);
      if (x0 + v == 0) pred = y == 0 ? half : b;
      res[v] = static_cast<int>(static_cast<unsigned>(cur[v] - pred) << sh) >> sh;
    }
    int* o = i > 0 && row_ok ? out + (static_cast<size_t>(n) * H + y) * W + x0 : nullptr;
    if constexpr (kVec) {
      // the warp's row through shared memory: store w of lane L writes
      // piece (L + 32 w) % P of lane (L + 32 w) / P, so each store
      // instruction writes 512 contiguous bytes wherever chunks are
      // neighbours (P = V / 4 pieces of 16 bytes a lane)
      constexpr int P = V / 4;
      int4* stage = stage_s + (threadIdx.x & ~31) * P;
#pragma unroll
      for (int w = 0; w < P; ++w)
        stage[lane * P + w] = make_int4(res[4 * w], res[4 * w + 1], res[4 * w + 2], res[4 * w + 3]);
      __syncwarp();
#pragma unroll
      for (int w = 0; w < P; ++w) {
        const int k = lane + 32 * w;
        int* dst = reinterpret_cast<int*>(
            __shfl_sync(0xffffffffu, reinterpret_cast<unsigned long long>(o), k / P));
        if (dst) __stcs(reinterpret_cast<int4*>(dst) + k % P, stage[k]);
      }
      __syncwarp();
    } else if (o) {
#pragma unroll
      for (int v = 0; v < V; ++v)
        if (x0 + v < W) o[v] = res[v];
    }
#pragma unroll
    for (int v = 0; v < V; ++v) prev[v] = cur[v];
    prev_left = left;
  }
}

// The signature of a kernel that runs walk() for image n0 + blockIdx.y.
template <typename T>
using Kernel = void (*)(const T*, const int4*, int*, int, int, int, int, int, int, int, unsigned,
                        Divider);

// The 16-byte path takes rows of whole chunks at 16-byte aligned bases.
template <typename T>
bool vector_ok(const void* in, const void* out, int W) {
  return W % (16 / sizeof(T)) == 0 && reinterpret_cast<uintptr_t>(in) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(out) % 16 == 0;
}

// Launches `kernel` over (N, H, W) with R rects an image (R = 0: none), the
// rects' shared memory sized for their first batch.
template <typename T>
cudaError_t launch(Kernel<T> kernel, const void* in, const void* rects, int* out, int N, int H,
                   int W, int R, int sv, int bits, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const long long C = (W + V - 1) / V;
  const long long threads = (H + kRows - 1) / kRows * C;  // per image
  // 2^31 - 2^16 threads is a plane of 2^37 pixels: past any card's memory
  if (threads > (1LL << 31) - (1LL << 16)) return cudaErrorInvalidValue;
  const unsigned blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  const size_t smem = static_cast<size_t>(min(R, kRectBatch)) * sizeof(int4);
  const Divider by_c(static_cast<unsigned>(C));
  return for_each_slab(N, [&](int n0, int nn) {
    kernel<<<dim3(blocks, nn), dim3(kThreads), smem, stream>>>(
        static_cast<const T*>(in), static_cast<const int4*>(rects), out, R, H, W, sv, bits, n0,
        static_cast<int>(C), static_cast<unsigned>(threads), by_c);
    return cudaGetLastError();
  });
}

}  // namespace residuals
