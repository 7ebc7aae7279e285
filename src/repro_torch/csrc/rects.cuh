// Rectangle coverage shared by the scrub and fused kernels.
//
// A rect is (x, y, w, h) int32; one with w <= 0 or h <= 0 is padding and
// covers nothing. The ends x + w and y + h wrap like int32 arithmetic does
// in the JAX kernels (computed unsigned, so the C++ has no overflow).
#pragma once
#include <cstdint>

__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

// rects: the R rects of one image, read through the read-only cache (every
// thread of a block reads the same few words).
__device__ __forceinline__ bool covered(const int4* __restrict__ rects, int R, int x, int y) {
  bool hit = false;
  for (int r = 0; r < R; ++r) {
    const int4 q = __ldg(rects + r);
    hit |= (q.z > 0) & (q.w > 0) & (x >= q.x) & (x < wrap_add(q.x, q.z)) &
           (y >= q.y) & (y < wrap_add(q.y, q.w));
  }
  return hit;
}

// Bit j (0 <= j < V) set when pixel (x + j, y) lies inside one of the R
// rects: each rect that spans row y, as an x-interval cut to the V pixels.
// rects may live in shared memory. Same coverage as covered().
template <int V>
__device__ __forceinline__ unsigned cover_bits(const int4* rects, int R, int x, int y) {
  unsigned bits = 0;
  for (int r = 0; r < R; ++r) {
    const int4 q = rects[r];
    if ((q.z > 0) & (q.w > 0) & (y >= q.y) & (y < wrap_add(q.y, q.w))) {
      // 64-bit: q.x - x must not wrap
      const long long lo = max(0LL, static_cast<long long>(q.x) - x);
      const long long hi = min(static_cast<long long>(V),
                               static_cast<long long>(wrap_add(q.x, q.z)) - x);
      if (lo < hi) bits |= ((1u << hi) - 1u) ^ ((1u << lo) - 1u);
    }
  }
  return bits;
}
