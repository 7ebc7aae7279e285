// Packed-bitmap predicate combine + popcount of the catalog's query engine.
//
// Replaces the TPU kernel src/repro/kernels/bitmap/bitmap.py::_combine_kernel
// (pallas_call in combine_pallas).
//
// leaves is (K, W) words, bit b of word w being row 32w + b. The compiled
// predicate is a stack program of leaf/and/or/not ops whose last two ops AND
// the validity leaf, so a NOT never leaks padding or tombstoned rows into the
// result or the count. For each word w the kernel runs the program over the
// K leaf words of w, writes the combined word to out[w] and, when count is
// not null, adds its popcount to *count.
//
// Bound on the card: HBM bytes, (K + 1) * W * 4 (each leaf word read once,
// one word written). The program is a few bitwise operations per leaf word
// and the popcount one per output word: operations bound nothing.
//
// What held the first design back (one word a thread, the stack a local
// array) was latency: the interpreter loop ran over a run-time stack pointer,
// so each leaf load was issued only when the loop reached it, K dependent
// DRAM latencies in a row, and every push and pop went to local memory.
// Design: a thread takes kWords = 4 words, as one 16-byte chunk when every
// leaf row and out are 16-byte aligned (W % 4 == 0, aligned bases) and as 4
// words a block stride apart otherwise (kVec = false; a ragged W such as 4097
// puts every row after row 0 off 16 bytes). The entry point lists the rows of
// the leaf ops in program order; before the program runs, a thread issues
// the cp.async copies of its words of the next kStage of them into its own
// slots of a shared-memory tile and waits once: one DRAM latency, not K. A
// launch of more leaf ops stages them kStage at a time. Each thread reads
// back only its own slots, so no barrier is needed. The stack lives in
// registers: the entry point gives every op the stack slot of its result (a
// leaf pushes at the depth before it, AND/OR read s and s + 1 and write s,
// NOT rewrites s), and the kernel is instantiated for depth classes 2, 4 and
// 8, so a slot read or write is a chain of uniform selects over D registers
// with constant indices and nothing goes to local memory. The
// program is a kernel parameter passed by value (the constant bank), so
// every thread reads the same op: nothing diverges. The count is __popc per
// word, a warp reduce, a shared reduce over the block's warps (in 32 bits: a
// block covers 16384 bits) and one 64-bit atomicAdd per block: integer and
// exact in any order the atomics land. The entry point validates the program
// against kMaxOps and kMaxDepth (the only copy of these limits) and refuses
// what the kernel does not take with cudaErrorInvalidValue; the Python
// wrapper (kernels/bitmap/ops.py) schedules any well-formed program into
// launches within them.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kMaxOps = 128;
// the wrapper's Sethi-Ullman order keeps a launch of L <= 64 leaf ops within
// floor(log2 L) + 1 = 7 values
constexpr int kMaxDepth = 8;
constexpr int kThreads = 128;
constexpr int kWords = 4;  // words a thread
// leaf rows in shared memory at a time: 32 KB a block
constexpr int kStage = 32 * 1024 / (kThreads * kWords * 4);
static_assert(kWords == 1 || kWords == 2 || kWords == 4, "a chunk is 4, 8 or 16 bytes");

enum Opcode : int { kLeaf = 0, kAnd = 1, kOr = 2, kNot = 3 };

// op[i]: opcode in bits 0-1, the stack slot of its result from bit 2;
// leaf[j]: the leaf row of the j-th leaf op
struct Program {
  int n, n_leaf;
  int op[kMaxOps];
  int leaf[kMaxOps];
};

__device__ __forceinline__ unsigned shared_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// B bytes into shared memory, asynchronously: 16 around L1 (cg), 4 and 8
// through it (ca), zero-filled when !ok
template <int B>
__device__ __forceinline__ void copy(void* dst, const void* src, bool ok) {
  if constexpr (B == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(shared_addr(dst)),
                 "l"(src), "r"(ok ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(shared_addr(dst)),
                 "l"(src), "n"(B), "r"(ok ? B : 0));
}
__device__ __forceinline__ void copies_done() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// Stack slot s of D register slots, by uniform selects (constant indices).
template <int D>
__device__ __forceinline__ void get(const uint32_t (&st)[D][kWords], int s, uint32_t (&v)[kWords]) {
#pragma unroll
  for (int w = 0; w < kWords; ++w) v[w] = st[0][w];
#pragma unroll
  for (int d = 1; d < D; ++d)
#pragma unroll
    for (int w = 0; w < kWords; ++w) v[w] = s == d ? st[d][w] : v[w];
}

template <int D>
__device__ __forceinline__ void put(uint32_t (&st)[D][kWords], int s, const uint32_t (&v)[kWords]) {
#pragma unroll
  for (int d = 0; d < D; ++d)
#pragma unroll
    for (int w = 0; w < kWords; ++w) st[d][w] = s == d ? v[w] : st[d][w];
}

template <int D, bool kVec>
__global__ void __launch_bounds__(kThreads)
combine_kernel(const uint32_t* __restrict__ leaves, uint32_t* __restrict__ out,
               unsigned long long* __restrict__ count, int W, const Program prog) {
  // a thread's words of a staged row: kWords neighbours at kWords * t on the
  // vector path, a block stride apart (t + v * kThreads) otherwise
  __shared__ __align__(16) uint32_t tile[kStage][kThreads * kWords];
  const long long base = static_cast<long long>(blockIdx.x) * (kThreads * kWords);
  long long word[kWords];  // this thread's words
  bool ok[kWords];
#pragma unroll
  for (int v = 0; v < kWords; ++v) {
    word[v] = kVec ? base + kWords * threadIdx.x + v : base + v * kThreads + threadIdx.x;
    ok[v] = word[v] < W;
  }

  uint32_t st[D][kWords];
#pragma unroll
  for (int d = 0; d < D; ++d)
#pragma unroll
    for (int w = 0; w < kWords; ++w) st[d][w] = 0;
  int i = 0;
  for (int first = 0; first < prog.n_leaf; first += kStage) {
    // every copy of the next kStage leaf ops first
    const int staged = min(kStage, prog.n_leaf - first);
#pragma unroll
    for (int j = 0; j < kStage; ++j) {
      if (j >= staged) break;
      const uint32_t* row = leaves + static_cast<size_t>(prog.leaf[first + j]) * W;
      if constexpr (kVec) {
        copy<4 * kWords>(&tile[j][kWords * threadIdx.x], row + (ok[0] ? word[0] : 0), ok[0]);
      } else {
#pragma unroll
        for (int v = 0; v < kWords; ++v)
          copy<4>(&tile[j][v * kThreads + threadIdx.x], row + (ok[v] ? word[v] : 0), ok[v]);
      }
    }
    copies_done();
    // then the ops, up to the first leaf op not staged
    for (int used = 0; i < prog.n; ++i) {
      const int code = prog.op[i] & 3, s = prog.op[i] >> 2;
      uint32_t r[kWords];
      if (code == kLeaf) {
        if (used == staged) break;
        if constexpr (kVec && kWords == 4) {
          const uint4 q = *reinterpret_cast<const uint4*>(&tile[used][4 * threadIdx.x]);
          r[0] = q.x, r[1] = q.y, r[2] = q.z, r[3] = q.w;
        } else if constexpr (kVec && kWords == 2) {
          const uint2 q = *reinterpret_cast<const uint2*>(&tile[used][2 * threadIdx.x]);
          r[0] = q.x, r[1] = q.y;
        } else {
#pragma unroll
          for (int v = 0; v < kWords; ++v) r[v] = tile[used][v * kThreads + threadIdx.x];
        }
        ++used;
      } else if (code == kNot) {
        get<D>(st, s, r);
#pragma unroll
        for (int w = 0; w < kWords; ++w) r[w] = ~r[w];
      } else {
        uint32_t b[kWords];
        get<D>(st, s, r);
        get<D>(st, s + 1, b);
#pragma unroll
        for (int w = 0; w < kWords; ++w) r[w] = code == kAnd ? r[w] & b[w] : r[w] | b[w];
      }
      put<D>(st, s, r);
    }
  }

  unsigned bits = 0;  // a block holds at most kThreads * kWords * 32 set bits
  if constexpr (kVec && kWords == 4) {
    if (ok[0])
      *reinterpret_cast<uint4*>(out + word[0]) = make_uint4(st[0][0], st[0][1], st[0][2], st[0][3]);
  } else if constexpr (kVec && kWords == 2) {
    if (ok[0]) *reinterpret_cast<uint2*>(out + word[0]) = make_uint2(st[0][0], st[0][1]);
  } else {
#pragma unroll
    for (int v = 0; v < kWords; ++v)
      if (ok[v]) out[word[v]] = st[0][v];
  }
#pragma unroll
  for (int v = 0; v < kWords; ++v)
    if (ok[v]) bits += __popc(st[0][v]);
  if (count == nullptr) return;  // uniform: an earlier launch of a split program
  for (int o = 16; o > 0; o >>= 1) bits += __shfl_down_sync(0xffffffffu, bits, o);
  __shared__ unsigned warp_bits[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_bits[warp] = bits;
  __syncthreads();
  if (warp == 0) {
    bits = lane < kThreads / 32 ? warp_bits[lane] : 0;
    for (int o = 16; o > 0; o >>= 1) bits += __shfl_down_sync(0xffffffffu, bits, o);
    if (lane == 0 && bits > 0) atomicAdd(count, static_cast<unsigned long long>(bits));
  }
}

// Checks the program (every op's operands exist, every leaf index is below
// K, the stack never exceeds kMaxDepth and ends holding one value) and packs
// it with each op's result slot and the leaf ops' rows in order; depth is
// the most values it holds at once.
bool pack_program(const int* ops, const int* args, int n_ops, int K, Program& prog, int& depth) {
  if (n_ops < 1 || n_ops > kMaxOps) return false;
  int sp = 0;
  depth = 0;
  prog.n_leaf = 0;
  for (int i = 0; i < n_ops; ++i) {
    int slot;
    switch (ops[i]) {
      case kLeaf:
        if (args[i] < 0 || args[i] >= K) return false;
        prog.leaf[prog.n_leaf++] = args[i];
        slot = sp++;
        break;
      case kAnd:
      case kOr:
        if (sp < 2) return false;
        slot = --sp - 1;
        break;
      case kNot:
        if (sp < 1) return false;
        slot = sp - 1;
        break;
      default:
        return false;
    }
    if (sp > kMaxDepth) return false;
    depth = sp > depth ? sp : depth;
    prog.op[i] = ops[i] | slot << 2;
  }
  prog.n = n_ops;
  return sp == 1;
}

template <int D>
cudaError_t launch(bool vec, const uint32_t* leaves, uint32_t* out, unsigned long long* count,
                   int W, const Program& prog, cudaStream_t stream) {
  constexpr int kBlockWords = kThreads * kWords;
  const unsigned blocks =
      static_cast<unsigned>((static_cast<long long>(W) + kBlockWords - 1) / kBlockWords);
  if (vec)
    combine_kernel<D, true><<<blocks, kThreads, 0, stream>>>(leaves, out, count, W, prog);
  else
    combine_kernel<D, false><<<blocks, kThreads, 0, stream>>>(leaves, out, count, W, prog);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int bitmap_max_ops() { return kMaxOps; }

int bitmap_max_depth() { return kMaxDepth; }

// leaves (K, W) and out (W,) are device words; count is one zeroed device
// 64-bit counter, or null for no count; ops and args are host arrays of
// n_ops ints.
int bitmap_combine_launch(const void* leaves, void* out, void* count, const int* ops,
                          const int* args, int K, int W, int n_ops, cudaStream_t stream) {
  Program prog{};
  int depth = 0;
  if (K < 1 || W < 1 || !pack_program(ops, args, n_ops, K, prog, depth))
    return cudaErrorInvalidValue;
  const bool vec = W % kWords == 0 && reinterpret_cast<uintptr_t>(leaves) % (4 * kWords) == 0 &&
                   reinterpret_cast<uintptr_t>(out) % (4 * kWords) == 0;
  const auto* in = static_cast<const uint32_t*>(leaves);
  auto* o = static_cast<uint32_t*>(out);
  auto* c = static_cast<unsigned long long*>(count);
  if (depth <= 2) return launch<2>(vec, in, o, c, W, prog, stream);
  if (depth <= 4) return launch<4>(vec, in, o, c, W, prog, stream);
  return launch<kMaxDepth>(vec, in, o, c, W, prog, stream);
}

}  // extern "C"
