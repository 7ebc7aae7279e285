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
// tile, 2 + 644 / 4096 = 2.157 B per pixel.
//
// What held the first design back (one thread per tile column walking th
// rows with 2-byte loads, every hit a byte in a th x tw shared tile, then
// one thread per tile row scanning tw bytes) was its serial scans and the
// shared tile, which also capped a tile at tw <= 1024 and 48 KB. Design: a
// tile row is Cw = ceil(tw / 32) words of 32 pixels (K = 32 / V chunks of V
// = 16 / itemsize pixels: 4 uint16 chunks, 2 uint8), and a thread owns one
// word of one row a pass: its K 16-byte loads go out first and become one
// 32-bit hit mask in registers (uint8/uint16/int16 compare as integers
// against ceil(thresh), the same test, since their values are exact in
// float32). From the mask: the word's hits (__popc), its leading and
// trailing runs (__clz of the reversed and the shifted complement) and its
// longest inner run (a binary search over S_k, the bits that start k or
// more hits). A row's words sit on Lw consecutive lanes (Cw rounded up to
// a power of two, at most 32), and a tree of joins over them, associative
// summaries of (hits, longest, leading, trailing, all hits), leaves the
// row's count and longest run on word lane 0, equal to the reference's
// recurrence run = (run + b) * b, best = max(best, run). Column counts are
// a byte a column (four columns a word, one multiply to spread a nibble),
// summed over the tile's rows in a warp by shuffles and over its warps
// through shared memory. A tile wider than 32 words is taken 32 words (a
// group) at a time with each row's count and carry in its lane-0 thread; a
// tile taller than a pass (G rows, a row a thread) adds each pass's column
// counts to the last pass's in cols. So any th and tw run, in at most 4.5
// KB of shared memory whatever the tile. A block is 128 threads; where a tile
// needs fewer (Lw x G < 128), it takes 128 / (Lw x G) tiles, so small
// tiles still fill the card. Images go to grid y in slabs of 65535 and
// tile rows to grid x, so any N, H and W run. Why a word of a row and not
// a chunk of several rows (a 16-lane tree each row, byte counters over
// the rows): four joins a chunk cost the card more than the loads
// (PERF.md §6).
//
// Registers (nvcc -Xptxas -v, sm_90a, logged by kernel_ab.py): 48 (uint8),
// 56 (uint16, int16), 72 with an 8-byte stack frame (int32, float32) a
// thread (PERF.md §6).
#include <cuda_runtime.h>
#include <climits>
#include <cmath>
#include <cstdint>

#include "pixels.cuh"

namespace {

constexpr int kThreads = 128;

// How a block cuts its tiles (computed on the host, passed by value).
struct Layout {
  int th, tw;
  int Cw;      // 32-pixel words of a tile row
  int lg_l;    // lanes of a row: Lw = 1 << lg_l
  int groups;  // word groups of Lw words: ceil(Cw / Lw)
  int lg_g;    // rows of a pass, one a thread: G = 1 << lg_g
  int tb;      // tiles a block: kThreads / (Lw * G)
};

Layout make_layout(int th, int tw) {
  Layout L{};
  L.th = th;
  L.tw = tw;
  L.Cw = static_cast<int>((static_cast<long long>(tw) + 31) / 32);
  while ((1 << L.lg_l) < L.Cw && L.lg_l < 5) ++L.lg_l;
  L.groups = (L.Cw + (1 << L.lg_l) - 1) >> L.lg_l;
  while ((1 << (L.lg_l + L.lg_g)) < kThreads && (1 << L.lg_g) < th) ++L.lg_g;
  L.tb = kThreads >> (L.lg_l + L.lg_g);
  return L;
}

// Rows of a tile in one warp, and a warp's share of the column counts.
__host__ __device__ __forceinline__ int rows_a_warp(const Layout& L) {
  return min(1 << L.lg_g, 32 >> L.lg_l);
}

// Shared-memory words of a block: per-tile bests and, for each warp, the
// column counts of its tiles' rows (32 columns a word of a row, one byte a
// column).
size_t smem_words(const Layout& L) {
  return L.tb + static_cast<size_t>(kThreads / rows_a_warp(L)) * 8;
}

// bits 0..3 of m to bytes 0..3 (each 0 or 1)
__device__ __forceinline__ unsigned spread4(unsigned m) { return (m * 0x00204081u) & 0x01010101u; }

template <typename T>
__device__ __forceinline__ bool is_hit(T v, float thresh, int ti) {
  if constexpr (sizeof(T) <= 2) {
    return static_cast<int>(v) >= ti;  // exact in float32: the same test
  } else {
    return static_cast<float>(v) >= thresh;
  }
}

// A run summary of consecutive pixels of a tile row, in two words: hits
// (bits 0-15) and longest run (16-31); leading run (0-14), trailing run
// (15-29) and all hits (30). Every field is at most 1024 (32 words of 32).
struct Runs {
  unsigned a, b;
};

// The longest run of ones in m: S_k, the bits that start a run of k or
// more, is S_{k/2} & S_{k/2} >> k/2, and S_{L+k} = S_L & S_k >> L, so a
// binary search down from 16 finds the longest L with S_L not empty.
__device__ __forceinline__ unsigned longest_run(unsigned m) {
  if (m == ~0u) return 32;
  if (m == 0) return 0;
  const unsigned s2 = m & m >> 1, s4 = s2 & s2 >> 2, s8 = s4 & s4 >> 4, s16 = s8 & s8 >> 8;
  unsigned cur = m, run = 1, c;  // cur = S_run
  if ((c = cur & s16 >> run)) cur = c, run += 16;
  if ((c = cur & s8 >> run)) cur = c, run += 8;
  if ((c = cur & s4 >> run)) cur = c, run += 4;
  if ((c = cur & s2 >> run)) cur = c, run += 2;
  if ((c = cur & m >> run)) cur = c, run += 1;
  return run;
}

// The summary of one word: m holds the hits of its len (1..32) tile pixels.
__device__ __forceinline__ Runs word_runs(unsigned m, int len) {
  const unsigned lead = __clz(__brev(~m));  // trailing ones of m: pixels from the left
  const unsigned trail = __clz(~(m << (32 - len)));
  const unsigned full = lead >= static_cast<unsigned>(len);
  return {__popc(m) | longest_run(m) << 16, lead | trail << 15 | full << 30};
}

// x then y, left to right: the reference's run recurrence over both.
__device__ __forceinline__ Runs join(Runs x, Runs y) {
  const unsigned xl = x.b & 0x7fffu, xt = x.b >> 15 & 0x7fffu, xf = x.b >> 30;
  const unsigned yl = y.b & 0x7fffu, yt = y.b >> 15 & 0x7fffu, yf = y.b >> 30;
  const unsigned most = max(max(x.a >> 16, y.a >> 16), xt + yl);
  const unsigned lead = xf ? xl + yl : xl;
  const unsigned trail = yf ? xt + yt : yt;
  return {((x.a + y.a) & 0xffffu) | most << 16, lead | trail << 15 | (xf & yf) << 30};
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
textdetect_kernel(const T* __restrict__ in, int* __restrict__ rows, int* __restrict__ cols,
                  int* __restrict__ runs, int H, int W, int Ht, int Wt, Layout L, float thresh,
                  int ti, int n0, int ty0, unsigned tiles, Divider by_wt) {
  constexpr int V = 16 / sizeof(T);  // pixels per chunk
  constexpr int K = 32 / V;          // chunks per word
  extern __shared__ int smem[];
  const int Lw = 1 << L.lg_l, G = 1 << L.lg_g;
  const int Rw = rows_a_warp(L);  // rows of a tile in one warp
  int* best = smem;
  unsigned* colpart = reinterpret_cast<unsigned*>(smem + L.tb);  // [slot][8 words of bytes]

  const int tid = threadIdx.x, lane = tid & 31;
  const int b = tid >> (L.lg_l + L.lg_g);   // tile of the block
  const int g = (tid >> L.lg_l) & (G - 1);  // row of the pass
  const int q = tid & (Lw - 1);             // word of the row (within a group)
  const int n = n0 + blockIdx.y;
  // launch tile t: tile row ty0 + t / Wt, column t % Wt, of image n
  auto tile_of = [&](unsigned t) {
    const unsigned tq = by_wt.div(t);
    return (static_cast<size_t>(n) * Ht + ty0 + tq) * Wt + (t - tq * Wt);
  };
  const unsigned t = blockIdx.x * L.tb + b;
  const bool tile_ok = t < tiles;
  const unsigned tq = by_wt.div(t);
  const long long Y0 = static_cast<long long>(ty0 + tq) * L.th;
  const long long X0 = static_cast<long long>(t - tq * Wt) * L.tw;
  // rows and columns of the tile inside the frame
  const int fy = tile_ok ? static_cast<int>(min(static_cast<long long>(L.th), H - Y0)) : 0;
  const int fx = tile_ok ? static_cast<int>(min(static_cast<long long>(L.tw), W - X0)) : 0;
  const T* origin = tile_ok ? in + static_cast<size_t>(n) * H * W + Y0 * W + X0 : in;
  const bool zero_hit = 0.0f >= thresh;  // a pixel past the frame
  const bool first_row = (g & (Rw - 1)) == 0;  // this warp's first row of the tile
  // this warp's counts of the tile's word q: slot (segment, q) of colpart
  unsigned* mycols = colpart + (tid / (Lw * Rw) * Lw + q) * 8;

  if (tid < L.tb) best[tid] = 0;  // ordered before its atomics by the first barrier

  int most = 0;  // longest run of this thread's rows (word 0 of a row)
  for (int p0 = 0; p0 < L.th; p0 += G) {  // a pass: tile rows p0 .. p0 + G - 1
    const int r = p0 + g;                 // this thread's row
    int count = 0, carry = 0;
    for (int k = 0; k < L.groups; ++k) {  // a group: words k * Lw .. k * Lw + Lw - 1
      const int wq = k * Lw + q;
      const int xoff = wq * 32;  // the word's first column in the tile
      const bool row_ok = tile_ok && wq < L.Cw && r < L.th;
      const int len = row_ok ? min(32, L.tw - xoff) : 0;
      const T* p = origin + static_cast<size_t>(r) * W + xoff;
      // the word's K 16-byte loads first
      uint4 raw[K];
      bool whole[K];
#pragma unroll
      for (int c = 0; c < K; ++c) {
        whole[c] = row_ok && r < fy && c * V + V <= len && xoff + c * V + V <= fx &&
                   (reinterpret_cast<uintptr_t>(p + c * V) & 15u) == 0;
        if (whole[c]) raw[c] = __ldg(reinterpret_cast<const uint4*>(p + c * V));
      }
      unsigned m = 0;  // hits of the word's pixels, bit x for column xoff + x
#pragma unroll
      for (int c = 0; c < K; ++c) {
        if (whole[c]) {
#pragma unroll
          for (int v = 0; v < V; ++v)
            m |= static_cast<unsigned>(is_hit(chunk_value<T>(raw[c], v), thresh, ti)) << (c * V + v);
        } else if (row_ok) {
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const int x = c * V + v;
            if (x < len) {
              const bool h = r < fy && xoff + x < fx ? is_hit(p[x], thresh, ti) : zero_hit;
              m |= static_cast<unsigned>(h) << x;
            }
          }
        }
      }
      // the row's words sit on Lw consecutive lanes: a tree of joins leaves
      // the group's summary of the row on word lane 0
      Runs s = row_ok ? word_runs(m, len) : Runs{0u, 0u};
      for (int o = 1; o < Lw; o <<= 1) {
        const Runs y{__shfl_down_sync(0xffffffffu, s.a, o), __shfl_down_sync(0xffffffffu, s.b, o)};
        s = join(s, y);
      }
      if (q == 0 && row_ok) {
        count += s.a & 0xffffu;
        const int lead = s.b & 0x7fffu, trail = s.b >> 15 & 0x7fffu;
        most = max(most, max(static_cast<int>(s.a >> 16), carry + lead));
        carry = s.b >> 30 ? carry + lead : trail;
        if (k + 1 == L.groups) {
          rows[tile_of(t) * L.th + r] = count;
          most = max(most, carry);
        }
      }
      unsigned colw[8];  // the word's 32 column hits, a byte each
#pragma unroll
      for (int w = 0; w < 8; ++w) colw[w] = spread4(m >> (4 * w) & 0xfu);
      // column counts: summed over the tile's rows in this warp by shuffles
      // (at most 32: a byte holds them), then over its warps through shared
      // memory
      for (int o = Lw; o < Lw * Rw; o <<= 1) {
#pragma unroll
        for (int w = 0; w < 8; ++w) colw[w] += __shfl_down_sync(0xffffffffu, colw[w], o);
      }
      if (first_row) {
#pragma unroll
        for (int w = 0; w < 8; ++w) mycols[w] = colw[w];
      }
      __syncthreads();
      // the group's column counts, summed over the tile's warps and added
      // to the earlier passes'
      for (int idx = tid; idx < L.tb * Lw * 32; idx += kThreads) {
        const int b2 = idx / (Lw * 32), c = idx - b2 * (Lw * 32), col = k * Lw * 32 + c;
        const unsigned t2 = blockIdx.x * L.tb + b2;
        if (t2 < tiles && col < L.tw) {
          int sum = 0;
          for (int g2 = 0; g2 < G; g2 += Rw) {
            const int owner = b2 * Lw * G + g2 * Lw;  // thread of word 0, row g2
            const unsigned* slot = colpart + (owner / (Lw * Rw) * Lw + c / 32) * 8;
            sum += slot[c % 32 / 4] >> (8 * (c % 4)) & 0xffu;
          }
          int* o = cols + tile_of(t2) * L.tw + col;
          *o = p0 > 0 ? *o + sum : sum;
        }
      }
      __syncthreads();
    }
  }
  if (q == 0 && tile_ok && most > 0) atomicMax(&best[b], most);
  __syncthreads();
  if (tid < L.tb && blockIdx.x * L.tb + tid < tiles) runs[tile_of(blockIdx.x * L.tb + tid)] = best[tid];
}

// ceil(thresh) as an int, clamped: for a pixel type whose every value is
// exact in float32, float32(x) >= thresh exactly when x >= ceil(thresh); a
// NaN threshold has no hits.
int int_thresh(float thresh) {
  if (std::isnan(thresh)) return INT_MAX;
  const double c = std::ceil(static_cast<double>(thresh));
  return c >= INT_MAX ? INT_MAX : c <= INT_MIN ? INT_MIN : static_cast<int>(c);
}

}  // namespace

// Refuses (cudaErrorInvalidValue) a tile dimension below 1, as the
// reference does (it divides by the tile).
extern "C" int textdetect_launch(const void* in, void* rows, void* cols, void* runs, int N, int H,
                                 int W, int th, int tw, int pixel_code, float thresh,
                                 void* stream) {
  if (N == 0 || H == 0 || W == 0) return 0;
  if (N < 0 || H < 0 || W < 0 || th < 1 || tw < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int Ht = static_cast<int>((static_cast<long long>(H) + th - 1) / th);
  const int Wt = static_cast<int>((static_cast<long long>(W) + tw - 1) / tw);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ti = int_thresh(thresh);
  // tile rows a launch: at most 2^30 tiles, so tile indices stay below 2^31
  const int per_launch = static_cast<int>(max(1LL, (1LL << 30) / Wt));
  return static_cast<int>(with_pixel_type(pixel_code, [&](auto tag) {
    using T = decltype(tag);
    const Layout L = make_layout(th, tw);
    const size_t smem = smem_words(L) * sizeof(int);
    const Divider by_wt(static_cast<unsigned>(Wt));
    for (int ty0 = 0; ty0 < Ht; ty0 += per_launch) {
      const int nty = min(per_launch, Ht - ty0);
      const unsigned tiles = static_cast<unsigned>(nty) * static_cast<unsigned>(Wt);
      const unsigned blocks = (tiles + L.tb - 1) / L.tb;
      const cudaError_t e = for_each_slab(N, [&](int n0, int nn) {
        textdetect_kernel<T><<<dim3(blocks, nn), kThreads, smem, s>>>(
            static_cast<const T*>(in), static_cast<int*>(rows), static_cast<int*>(cols),
            static_cast<int*>(runs), H, W, Ht, Wt, L, thresh, ti, n0, ty0, tiles, by_wt);
        return cudaGetLastError();
      });
      if (e != cudaSuccess) return e;
    }
    return cudaSuccess;
  }));
}
