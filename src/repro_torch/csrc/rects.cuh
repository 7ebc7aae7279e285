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

// Rect q spans row y (and is no padding rect).
__device__ __forceinline__ bool spans_row(const int4& q, int y) {
  return (q.z > 0) & (q.w > 0) & (y >= q.y) & (y < wrap_add(q.y, q.w));
}

// Bit j (0 <= j < V <= 31) set when column x + j lies in rect q's
// x-interval [q.x, q.x + q.w) (its rows not tested).
template <int V>
__device__ __forceinline__ unsigned span_bits(const int4& q, int x) {
  // 64-bit: q.x - x must not wrap
  const long long lo = max(0LL, static_cast<long long>(q.x) - x);
  const long long hi = min(static_cast<long long>(V),
                           static_cast<long long>(wrap_add(q.x, q.z)) - x);
  return lo < hi ? ((1u << hi) - 1u) ^ ((1u << lo) - 1u) : 0u;
}

// Bit j (0 <= j < V) set when pixel (x + j, y) lies inside one of the R
// rects: each rect that spans row y, as an x-interval cut to the V pixels.
// rects may live in shared memory.
template <int V>
__device__ __forceinline__ unsigned cover_bits(const int4* rects, int R, int x, int y) {
  unsigned bits = 0;
  for (int r = 0; r < R; ++r) {
    const int4 q = rects[r];
    if (spans_row(q, y)) bits |= span_bits<V>(q, x);
  }
  return bits;
}
