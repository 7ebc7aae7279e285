// Packed-bitmap predicate combine + popcount of the catalog's query engine.
//
// Replaces the TPU kernel src/repro/kernels/bitmap/bitmap.py::_combine_kernel
// (pallas_call in combine_pallas).
//
// leaves is (K, W) words, bit b of word w being row 32w + b. The compiled
// predicate is a stack program of leaf/and/or/not ops whose last two ops AND
// the validity leaf, so a NOT never leaks padding or tombstoned rows into the
// result or the count. For each word w the kernel runs the program over the
// K leaf words of w, writes the combined word to out[w] and adds its
// popcount to *count.
//
// Bound on the card: HBM bytes, (K + 1) * W * 4 (each leaf word read once,
// one word written). The program is a few bitwise operations per leaf word
// and the popcount one per output word: operations bound nothing.
//
// Design: one thread per word, grid-stride, no padding of W (threads past W
// do nothing; the last word's high bits are cleared by the final validity
// AND, as on the TPU). The TPU kernel bakes the static program into its code
// as a jit constant; here the program is a kernel parameter passed by value
// (n, op[kMaxOps], arg[kMaxOps]), so it sits in the constant bank and every
// thread reads the same opcode: the interpreter loop does not diverge. The
// stack is a fixed local array of kMaxDepth words. The count is __popc per
// word, a warp reduce, a shared reduce over the block's warps and one 64-bit
// atomicAdd per block: integer and exact in any order the atomics land.
// Neighbouring threads read neighbouring words of each leaf row, so loads
// coalesce. The entry point validates the program against kMaxOps and
// kMaxDepth (the only copy of these limits) and refuses what the kernel does
// not take with cudaErrorInvalidValue.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kMaxOps = 64;
constexpr int kMaxDepth = 32;
constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

enum Opcode : int { kLeaf = 0, kAnd = 1, kOr = 2, kNot = 3 };

struct Program {
  int n;
  int op[kMaxOps];
  int arg[kMaxOps];
};

__global__ void __launch_bounds__(kThreads)
combine_kernel(const uint32_t* __restrict__ leaves, uint32_t* __restrict__ out,
               unsigned long long* __restrict__ count, int W, const Program prog) {
  unsigned long long bits = 0;
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t w = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       w < static_cast<size_t>(W); w += stride) {
    uint32_t stack[kMaxDepth];
    int sp = 0;
    for (int i = 0; i < prog.n; ++i) {
      switch (prog.op[i]) {
        case kLeaf:
          stack[sp++] = __ldg(leaves + static_cast<size_t>(prog.arg[i]) * W + w);
          break;
        case kAnd:
          --sp;
          stack[sp - 1] &= stack[sp];
          break;
        case kOr:
          --sp;
          stack[sp - 1] |= stack[sp];
          break;
        default:  // kNot (the entry point admits no other opcode)
          stack[sp - 1] = ~stack[sp - 1];
          break;
      }
    }
    out[w] = stack[0];
    bits += __popc(stack[0]);
  }
  for (int o = 16; o > 0; o >>= 1) bits += __shfl_down_sync(0xffffffffu, bits, o);
  __shared__ unsigned long long warp_bits[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_bits[warp] = bits;
  __syncthreads();
  if (warp == 0) {
    bits = lane < kThreads / 32 ? warp_bits[lane] : 0;
    for (int o = 16; o > 0; o >>= 1) bits += __shfl_down_sync(0xffffffffu, bits, o);
    if (lane == 0 && bits > 0) atomicAdd(count, bits);
  }
}

// Depth-checks the program: every op's operands exist, every leaf index is
// below K, the stack never exceeds kMaxDepth and ends holding one value.
bool program_ok(const int* ops, const int* args, int n_ops, int K) {
  if (n_ops < 1 || n_ops > kMaxOps) return false;
  int depth = 0;
  for (int i = 0; i < n_ops; ++i) {
    switch (ops[i]) {
      case kLeaf:
        if (args[i] < 0 || args[i] >= K || ++depth > kMaxDepth) return false;
        break;
      case kAnd:
      case kOr:
        if (depth < 2) return false;
        --depth;
        break;
      case kNot:
        if (depth < 1) return false;
        break;
      default:
        return false;
    }
  }
  return depth == 1;
}

}  // namespace

extern "C" {

int bitmap_max_ops() { return kMaxOps; }

int bitmap_max_depth() { return kMaxDepth; }

// leaves (K, W) and out (W,) are device words; count is one zeroed device
// 64-bit counter; ops and args are host arrays of n_ops ints.
int bitmap_combine_launch(const void* leaves, void* out, void* count, const int* ops,
                          const int* args, int K, int W, int n_ops, cudaStream_t stream) {
  if (K < 1 || W < 1 || !program_ok(ops, args, n_ops, K)) return cudaErrorInvalidValue;
  Program prog{};
  prog.n = n_ops;
  for (int i = 0; i < n_ops; ++i) {
    prog.op[i] = ops[i];
    prog.arg[i] = args[i];
  }
  const long long want = (static_cast<long long>(W) + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
  combine_kernel<<<blocks, kThreads, 0, stream>>>(
      static_cast<const uint32_t*>(leaves), static_cast<uint32_t*>(out),
      static_cast<unsigned long long*>(count), W, prog);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
