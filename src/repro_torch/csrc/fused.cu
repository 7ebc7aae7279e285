// Fused PHI-rectangle scrub + JPEG-Lossless predictor residuals, one pass.
//
// Replaces the TPU kernel src/repro/kernels/fused/fused.py::_fused_kernel
// (pallas_call in fused_scrub_jls_pallas).
//
// Computes, for each pixel of the *scrubbed* plane (rect pixels zeroed), the
// residual (x - pred) mod 2^bits, sign-wrapped into [-2^(bits-1), 2^(bits-1)),
// with the predictor of selection value sv (1..7) over the left (ra), above
// (rb) and above-left (rc) neighbours. Row 0 predicts ra, column 0 predicts
// rb, (0,0) predicts 2^(bits-1). Each neighbour is masked with its *own*
// coverage, exactly as if the blanked plane had been materialized first.
//
// Bound on the card: HBM bytes. One read of the uint8/uint16 plane and one
// int32 write: 2 + 4 = 6 B per pixel for uint16 (5 B for uint8).
//
// What held the first design back (one thread per pixel, 2-byte loads) was
// neither: every thread read its pixel and three neighbours, and asked every
// rect four times whether it covered one of them. Design: strips of 16-byte
// chunks. A thread owns one chunk of V = 16 / itemsize pixels (8 uint16, 16
// uint8) of a row and walks it down kRows rows, keeping row y - 1's V masked
// pixels in registers, so each input byte comes from HBM once and is read
// once more only at a strip's first row (row y0 - 1, 1/kRows of the reads,
// mostly from L2). Its kRows + 1 loads are issued before anything else. The
// chunks of a row sit on consecutive lanes, so a chunk's left neighbour is
// the last pixel of lane - 1's chunk (__shfl_up_sync, already masked); lane
// 0 loads its own. A block copies image n's rects into shared memory (in
// batches of kRectBatch, which fit beside the staged rows below, so any R
// runs) and each thread turns every rect that meets its strip into one bit
// mask of its V + 1 columns (from x0 - 1, the left neighbour included) and
// ORs it into the rows it spans: a rect costs a thread a few operations,
// not four tests a pixel. Residuals leave
// as 16-byte streaming stores through a warp's row staged in shared
// memory: store w of lane L writes piece (L + 32 w) % P of lane (L + 32 w)
// / P (P = V / 4 pieces of 16 bytes a lane, 2 uint16, 4 uint8), so a store
// instruction writes 512 contiguous bytes, whole sectors, where a lane's own
// pieces would sit 32 or 64 bytes apart across the warp (the uint8 chunk's
// time fell 1.75x). Rows whose byte length is no 16-byte multiple (2022
// uint16, 70 or 90 uint8) or a view off a 16-byte boundary take the same
// walk with pixel loads and stores (kVec = false). Threads are numbered
// (strip, chunk) within an image, chunk fastest, so warps stay full at any
// width; images go to grid y in slabs of 65535 (for_each_slab), so any N
// runs. sv = 1, the one every product path launches, is a template
// argument on the vector path: read at run time it cost 1.5-5.8 % there
// (PERF.md §6); other selection values and the pixel path read it at run
// time. __launch_bounds__(kThreads, 1) leaves the register count to the
// compiler: the default cap spilled the uint8 and ragged variants.
//
// Registers (nvcc -Xptxas -v, sm_90a, logged by kernel_ab.py): 101-149 a
// thread across pixel types, selection values and paths, no spills
// (PERF.md §6).
#include <cuda_runtime.h>
#include <cstdint>

#include "pixels.cuh"
#include "rects.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 8;          // rows a thread walks down its strip
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

template <typename T, int SV, bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
fused_kernel(const T* __restrict__ in, const int4* __restrict__ rects, int* __restrict__ out,
             int R, int H, int W, int sv, int bits, int n0, int C, unsigned threads, Divider by_c) {
  constexpr int V = 16 / sizeof(T);  // pixels per chunk
  extern __shared__ int4 rect_s[];
  __shared__ int4 stage_s[kVec ? kThreads * V / 4 : 1];  // a row's residuals, a warp's
  const int n = n0 + blockIdx.y;
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

template <typename T, int SV, bool kVec>
cudaError_t launch(const void* in, const void* rects, int* out, int N, int H, int W, int R,
                   int sv, int bits, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const long long C = (W + V - 1) / V;
  const long long threads = (H + kRows - 1) / kRows * C;  // per image
  // 2^31 - 2^16 threads is a plane of 2^37 pixels: past any card's memory
  if (threads > (1LL << 31) - (1LL << 16)) return cudaErrorInvalidValue;
  const dim3 block(kThreads);
  const unsigned blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  const size_t smem = static_cast<size_t>(min(R, kRectBatch)) * sizeof(int4);
  const Divider by_c(static_cast<unsigned>(C));
  return for_each_slab(N, [&](int n0, int nn) {
    fused_kernel<T, SV, kVec><<<dim3(blocks, nn), block, smem, stream>>>(
        static_cast<const T*>(in), static_cast<const int4*>(rects), out, R, H, W, sv, bits, n0,
        static_cast<int>(C), static_cast<unsigned>(threads), by_c);
    return cudaGetLastError();
  });
}

template <typename T>
cudaError_t launch_typed(const void* in, const void* rects, int* out, int N, int H, int W,
                         int R, int sv, int bits, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = W % V == 0 && reinterpret_cast<uintptr_t>(in) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (!vec) return launch<T, 0, false>(in, rects, out, N, H, W, R, sv, bits, s);
  return sv == 1 ? launch<T, 1, true>(in, rects, out, N, H, W, R, sv, bits, s)
                 : launch<T, 0, true>(in, rects, out, N, H, W, R, sv, bits, s);
}

}  // namespace

// Refuses (cudaErrorInvalidValue) what the reference refuses too: sv outside
// 1..7, bits outside 1..30, an item size other than 1 or 2.
extern "C" int fused_scrub_residuals_launch(const void* in, const void* rects, void* out, int N,
                                            int H, int W, int R, int itemsize, int sv, int bits,
                                            void* stream) {
  if (N == 0 || H == 0 || W == 0) return 0;
  if (N < 0 || H < 0 || W < 0 || R < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (sv < 1 || sv > 7 || bits < 1 || bits > 30) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* o = static_cast<int*>(out);
  switch (itemsize) {
    case 1: return launch_typed<uint8_t>(in, rects, o, N, H, W, R, sv, bits, s);
    case 2: return launch_typed<uint16_t>(in, rects, o, N, H, W, R, sv, bits, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
