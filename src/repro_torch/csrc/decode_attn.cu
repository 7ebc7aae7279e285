// Decode attention: the query heads of one new token against the K/V cache,
// read in place in the cache's own type.
//
// Replaces no TPU kernel: the reference (src/repro/models/attention.py,
// decode_attention) leaves the step to XLA's einsums. It replaces the
// port's plain version, models/attention.py::_decode_core, whose einsums
// widen the whole bf16 cache to float32 in every layer (a cast, then a copy
// to fold (batch, kv head) into one GEMM batch) and read it back through an
// f32 GEMM of G rows: about 9x the cache's bytes a layer.
//
// The arithmetic is the reference's, step for step:
//   1. scores: T(q * scale) . k, summed over the head dim in f32 (bf16
//      products are exact in f32, so bf16 MMA with f32 accumulation is that
//      sum in another order; a float32 cache takes f32 FMAs);
//   2. positions past pos, and at or before pos - window when window > 0,
//      are masked: their exp is exactly 0 in f32, so they are skipped;
//   3. softmax in f32 over the whole row: each probability is
//      exp(s - max) / sum with the row's own max and sum;
//   4. the normalised probabilities rounded to the cache's type, then summed
//      against V in f32; the output rounded to q's type.
// Step 4 rounds normalised probabilities, so the row's max and sum must be
// known before any probability is rounded: no online (flash-decoding)
// rescale of the output, which would round un-normalised ones. Only the sum
// is gathered on the way: each warp keeps a running max and sum of
// exp(s - max) as it scores, rescaled when the max grows, and the parts are
// combined in a fixed order, so the sum equals the reference's up to f32
// rounding in another order, as any two reduction orders do.
//
// Bound on the card: HBM bytes. With G query rows a KV head the kernel does
// about 2G FLOP for every 2 bytes of bf16 cache (7 FLOP a byte for qwen2's
// G = 7, against a ridge of about 295), so the least time is the K and V
// rows up to pos, plus q and the output, once at 3.35 TB/s.
//
// Design: the unit of work is one (batch row, KV head, group of up to 8
// query rows): the group shares every K and V row (grouped, never repeated
// to H) and is the n = 8 of the tensor cores' m16n8k16 MMA. A unit's
// positions lo .. pos are cut into tiles of 128 rows, dealt in turn to the c
// blocks of a thread-block cluster, so that few units still fill the card
// (c from the unit count, the cache's length and what the card holds at
// once: decode_attn_plan). Each of a block's 8 warps takes 16 rows of every
// tile and streams them, its K rows and then its V rows, through a ring of
// its own shared-memory stages (cp.async, 16-byte copies, rows past pos
// arrive as zeros), so the warps never wait on each other while they
// stream, and the first V rows load while the softmax is gathered. A K item
// is one ldmatrix and one bf16 MMA per 16 of the head dim against the
// scaled query rows held in registers; its f32 scores stay in shared memory
// (past 48 KB of them a block, in a scratch tensor the wrapper allocates, so
// any length runs). Once every warp has scored its rows, the warps' (max,
// sum) pairs are combined in warp order and the blocks' in rank order over
// distributed shared memory, so every block holds the same two numbers. A V
// item rounds the warp's 16 x G probabilities to the cache's type and is one
// ldmatrix.trans and MMA per 16 of the head dim into f32 accumulators. The
// warps' partial sums are added in warp order, the blocks' in rank order: no
// atomics, so every call gives the same bits and a CUDA graph replays as the
// eager step. A float32 cache (the reduced test configs) runs the same
// schedule with FMAs in place of the MMA. pos is an int or a device int64 (a
// captured step's); nothing here reads the host or synchronises.
//
// Measured on an NVIDIA H100 80GB HBM3 (chip_smoke.py's decode_attn rows):
// at qwen2-0.5b's serve decode shape (37.7 MB, a bound of 11.3 us) the
// kernel takes about 37 us, as long as one PyTorch sum over the same rows;
// a bare streaming read of those bytes takes about 25 us. The launch, the
// first bytes' latency, the drain and the one wait between the K and the V
// rows are most of so short a kernel. At granite-4.0-h-small's (302 MB) it
// runs at about 74 % of the bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kWarpRows = 16;           // cache rows a warp takes of each tile: the MMA's m or k
constexpr int kTile = kWarps * kWarpRows;  // cache rows of a tile, dealt to one block
constexpr int kGT = 8;                  // query rows a block takes: the MMA's n
constexpr int kMaxCluster = 8;          // the portable cluster size
constexpr int kScoreSmem = 48 * 1024;   // a block's scores above this go to scratch
constexpr int kPsStride = kWarpRows + 8;  // a warp's probability row, elements (no bank conflicts)
constexpr int kMaxUnits = 65535;        // grid y

struct Params {
  const void* q;            // (B, KV, G, hd), q's type = the cache's
  const void* k;            // (B, S, KV, hd)
  const void* v;
  void* out;                // (B, KV, G, hd)
  float* scratch;           // units x c x min(G, kGT) x per_pos scores, or null: in shared memory
  const long long* pos_ptr; // a 0-d device int64, or null: pos
  int S, KV, G, hd, ngt, pos, window, per_pos;
  float scale;
};

template <typename T>
struct Elem;
template <>
struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
  static __device__ __forceinline__ __nv_bfloat16 from_f(float x) { return __float2bfloat16_rn(x); }
};
template <>
struct Elem<float> {
  static __device__ __forceinline__ float to_f(float x) { return x; }
  static __device__ __forceinline__ float from_f(float x) { return x; }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; zeros where !valid (src is then
// any mapped address and is not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// d += a (16 x 16, row-major) . b (16 x 8, column-major), bf16 in, f32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the block's rank in its cluster, and the cluster's size
__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return static_cast<int>(r);
}

__device__ __forceinline__ int cluster_size() {
  uint32_t n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return static_cast<int>(n);
}

// every thread of the cluster: shared-memory writes before it are seen by
// every block after it
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

// the float at p's place in the shared memory of the cluster's block r
__device__ __forceinline__ float ld_rank(const float* p, int r) {
  uint32_t a;
  float x;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(a) : "r"(smem_u32(p)), "r"(r));
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(x) : "r"(a) : "memory");
  return x;
}

// the sum of the float at p's place over the cluster's c blocks, in rank
// order: the loads first, all in flight together
__device__ __forceinline__ float sum_over_ranks(const float* p, int c) {
  float x[kMaxCluster];
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r) x[r] = r < c ? ld_rank(p, r) : 0.0f;
  float acc = 0.0f;
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r)
    if (r < c) acc += x[r];
  return acc;
}

// (max, sum) of exp(s - max) over the union of the first n <= N parts given
// as (max_i, sum_i), taken in part order; a part with no scores has max -inf
// and sum 0
template <int N>
__device__ __forceinline__ void combine(float& m, float& l, const float (&mi)[N], const float (&li)[N], int n) {
  m = -INFINITY;
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (i < n) m = fmaxf(m, mi[i]);
  l = 0.0f;
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (i < n && mi[i] != -INFINITY) l += li[i] * expf(mi[i] - m);
}

// ring stages a warp keeps: 70-135 KB of bf16 rows a block, so that the
// blocks of an SM keep the ~100 KB in flight that HBM's latency asks for; a
// float32 cache (test configs) takes one stage, unpipelined, to fit hd 256
template <typename T, int KS>
__host__ __device__ constexpr int stages() {
  return sizeof(T) != 2 ? 1 : KS <= 4 ? 6 : 2;
}

// dynamic shared memory of a block: the warps' rings and probability tiles,
// the scaled query rows and, without scratch, the scores of ``rows`` query rows
template <typename T, int KS>
size_t smem_bytes(int hd, int rows, int per_pos, bool scratch) {
  const size_t es = sizeof(T);
  size_t n = static_cast<size_t>(stages<T, KS>()) * kTile * (hd * es + 16) + kWarps * kGT * kPsStride * es +
             kGT * hd * es;
  return scratch ? n : n + static_cast<size_t>(rows) * per_pos * sizeof(float);
}

// KS: the most 16-wide steps of the head dim the instance takes (hd <= 16 KS)
template <typename T, int KS>
__global__ void __launch_bounds__(kThreads) decode_attn_kernel(const Params p) {
  constexpr int ES = sizeof(T);
  constexpr bool kMma = ES == 2;
  constexpr int kStages = stages<T, KS>();
  const int c = cluster_size(), rank = cluster_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, t4 = lane & 3;  // the MMA fragments' row and column pair
  const int hd = p.hd, per_pos = p.per_pos;
  const int unit = blockIdx.y;
  const int bk = unit / p.ngt;                 // b * KV + kv
  const int g0 = (unit - bk * p.ngt) * kGT;
  const int gn = min(kGT, p.G - g0);
  const int rows = min(kGT, p.G);              // score rows a block keeps (>= gn)
  const int b = bk / p.KV, kv = bk - b * p.KV;

  // the positions attended: lo .. hi
  const int pos = p.pos_ptr ? static_cast<int>(*p.pos_ptr) : p.pos;
  const int hi = min(pos, p.S - 1);
  const int lo = p.window > 0 ? max(0, pos - p.window + 1) : 0;
  const int nt = hi >= lo ? (hi - lo + kTile) / kTile : 0;  // tiles of the unit
  const int mt = nt > rank ? (nt - rank + c - 1) / c : 0;   // this block's: rank, rank + c, ...

  extern __shared__ __align__(16) unsigned char smem[];
  // the softmax statistics (max, sum): of each warp, of the block, of the row
  __shared__ float w_max[kWarps][kGT], w_sum[kWarps][kGT], s_max[kGT], s_sum[kGT], s_gmax[kGT], s_gsum[kGT];
  const int rs = hd * ES + 16;  // ring row stride, bytes: ldmatrix rows fall in distinct banks
  const int wstage = kWarpRows * rs;
  unsigned char* ring = smem;
  unsigned char* wring = ring + warp * kStages * wstage;  // this warp's stages
  T* const tiles_end = reinterpret_cast<T*>(smem + kStages * kTile * rs);
  T* ps = tiles_end + warp * kGT * kPsStride;  // this warp's probabilities, kGT x kPsStride
  T* qs = tiles_end + kWarps * kGT * kPsStride;  // kGT x hd
  float* sc = p.scratch ? p.scratch + static_cast<size_t>(unit * c + rank) * rows * per_pos
                        : reinterpret_cast<float*>(qs + kGT * hd);  // rows x per_pos

  const size_t row = static_cast<size_t>(p.KV) * hd;  // elements from one position to the next
  const size_t head0 = static_cast<size_t>(b) * p.S * row + static_cast<size_t>(kv) * hd;
  const T* kbase = static_cast<const T*>(p.k) + head0;
  const T* vbase = static_cast<const T*>(p.v) + head0;

  // the query rows, loaded ahead of the ring's copies (kGT hd <= KS kThreads)
  const T* qrow = static_cast<const T*>(p.q) + (static_cast<size_t>(bk) * p.G + g0) * hd;
  T qv[KS];
#pragma unroll
  for (int j = 0; j < KS; ++j) {
    const int i = tid + j * kThreads;
    qv[j] = i < gn * hd ? qrow[i] : Elem<T>::from_f(0.0f);
  }

  // Each warp streams its own 16 rows of every tile through its own stages:
  // items 0 .. mt - 1 are its rows of the block's K tiles, mt .. 2 mt - 1
  // of its V tiles. This lane copies chunks ch0, ch0 + 32, ... of rows r0,
  // r0 + rstep, ... (a lane past the last whole row of a pass copies none).
  const int chunks = hd * ES / 16;
  const int rstep = chunks <= 32 ? 32 / chunks : 1;
  const int r0 = chunks <= 32 ? lane / chunks : 0;
  const int ch0 = chunks <= 32 ? lane - r0 * chunks : lane;
  const int total = 2 * mt;
  auto load = [&](int item) {
    const bool is_v = item >= mt;
    const int p0 = lo + (rank + (is_v ? item - mt : item) * c) * kTile + warp * kWarpRows;
    const T* base = is_v ? vbase : kbase;
    unsigned char* st = wring + (item % kStages) * wstage;
    if (r0 < rstep) {
      for (int r = r0; r < kWarpRows; r += rstep) {
        const bool ok = p0 + r <= hi;
        const T* src = base + static_cast<size_t>(ok ? p0 + r : lo) * row;
        for (int ch = ch0; ch < chunks; ch += 32) cp_async16(st + r * rs + ch * 16, src + ch * (16 / ES), ok);
      }
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < total) load(s);
    cp_async_commit();
  }
  // the query rows times scale, rounded to T as the reference rounds q * scale
#pragma unroll
  for (int j = 0; j < KS; ++j) {
    const int i = tid + j * kThreads;
    if (i < kGT * hd) qs[i] = Elem<T>::from_f(Elem<T>::to_f(qv[j]) * p.scale);
  }
  for (int x = lane; x < (kGT - rows) * kPsStride; x += 32)  // probability rows never written
    ps[rows * kPsStride + x] = Elem<T>::from_f(0.0f);
  __syncthreads();

  uint32_t qf[KS][2];  // the MMA's b fragments of the scaled query rows
  float acc[KS][4];    // MMA: (head dim x query row) fragments; FMA: output lane + 32 (4 i + j) at [i][j]
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    acc[ks][0] = acc[ks][1] = acc[ks][2] = acc[ks][3] = 0.0f;
    if constexpr (kMma) {
      if (ks * 16 < hd) {
        const T* qr = qs + gid * hd + ks * 16 + 2 * t4;
        qf[ks][0] = *reinterpret_cast<const uint32_t*>(qr);
        qf[ks][1] = *reinterpret_cast<const uint32_t*>(qr + 8);
      }
    }
  }

  // The running max and sum of exp(s - max) of this warp's scores of query
  // row sg, taken as each K item is scored (the sum rescaled to a new max):
  // lanes 4 sg .. 4 sg + 3 read 4 scores each and hold the same two numbers.
  const int sg = lane >> 2, sq = lane & 3;
  float rm = -INFINITY, rl = 0.0f;
  auto running_stats = [&](int j0) {
    __syncwarp();
    const float4 x = *reinterpret_cast<const float4*>(sc + min(sg, rows - 1) * per_pos + j0 + 4 * sq);
    float m = fmaxf(fmaxf(x.x, x.y), fmaxf(x.z, x.w));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    m = fmaxf(fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2)), rm);
    float e = m == -INFINITY ? 0.0f : expf(x.x - m) + expf(x.y - m) + expf(x.z - m) + expf(x.w - m);
    e += __shfl_xor_sync(0xffffffffu, e, 1);
    e += __shfl_xor_sync(0xffffffffu, e, 2);
    rl = m == -INFINITY ? 0.0f : rl * expf(rm - m) + e;
    rm = m;
  };

  // the row max and sum over the cluster, once every K item is scored: the
  // warps' combined in warp order, then the blocks' in rank order
  auto softmax_stats = [&]() {
    if (sq == 0 && sg < rows) {
      w_max[warp][sg] = rm;
      w_sum[warp][sg] = rl;
    }
    __syncthreads();
    if (tid < rows) {
      float mi[kWarps], li[kWarps];
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        mi[w] = w_max[w][tid];
        li[w] = w_sum[w][tid];
      }
      combine(s_max[tid], s_sum[tid], mi, li, kWarps);
    }
    cluster_sync();
    if (tid < rows) {
      float mi[kMaxCluster], li[kMaxCluster];
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r) {
        mi[r] = r < c ? ld_rank(&s_max[tid], r) : -INFINITY;
        li[r] = r < c ? ld_rank(&s_sum[tid], r) : 0.0f;
      }
      combine(s_gmax[tid], s_gsum[tid], mi, li, c);
    }
    __syncthreads();
  };

  for (int i = 0; i < total; ++i) {
    if (i == mt) softmax_stats();
    if (i + kStages - 1 < total) load(i + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncwarp();
    const unsigned char* st = wring + (i % kStages) * wstage;
    const int lt = i < mt ? i : i - mt;                // the tile's index among the block's
    const int j0 = lt * kTile + warp * kWarpRows;      // the warp's first row's score column
    const int p0 = lo + (rank + lt * c) * kTile + warp * kWarpRows;
    if (i < mt) {  // scores of the warp's K rows
      if constexpr (kMma) {
        float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        const unsigned char* a_row = st + (lane & 15) * rs + (lane >> 4) * 16;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          if (ks * 16 < hd) {
            uint32_t a[4];
            ldmatrix_x4(a, a_row + ks * 32);
            mma_bf16(d, a, qf[ks][0], qf[ks][1]);
          }
        }
        const bool ok0 = p0 + gid <= hi, ok1 = p0 + gid + 8 <= hi;
        float* s0 = sc + (2 * t4) * per_pos + j0;
        if (2 * t4 < rows) {
          s0[gid] = ok0 ? d[0] : -INFINITY;
          s0[gid + 8] = ok1 ? d[2] : -INFINITY;
        }
        if (2 * t4 + 1 < rows) {
          s0[per_pos + gid] = ok0 ? d[1] : -INFINITY;
          s0[per_pos + gid + 8] = ok1 ? d[3] : -INFINITY;
        }
      } else {
        for (int x = lane; x < rows * kWarpRows; x += 32) {
          const int g = x / kWarpRows, r = x - g * kWarpRows;
          const T* kr = reinterpret_cast<const T*>(st + r * rs);
          const T* qr = qs + g * hd;
          float s = 0.0f;
          for (int dd = 0; dd < hd; ++dd) s = fmaf(Elem<T>::to_f(qr[dd]), Elem<T>::to_f(kr[dd]), s);
          sc[g * per_pos + j0 + r] = p0 + r <= hi ? s : -INFINITY;
        }
      }
      running_stats(j0);
    } else {  // the warp's V rows: their probabilities, rounded to T, then P . V
      for (int x = lane; x < rows * kWarpRows; x += 32) {
        const int g = x / kWarpRows, r = x - g * kWarpRows;
        ps[g * kPsStride + r] = Elem<T>::from_f(expf(sc[g * per_pos + j0 + r] - s_gmax[g]) / s_gsum[g]);
      }
      __syncwarp();
      if constexpr (kMma) {
        const T* pr = ps + gid * kPsStride + 2 * t4;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(pr);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(pr + 8);
        const int mi = lane >> 3;  // which 8 x 8 matrix this lane's row address feeds
        const unsigned char* v_row = st + ((lane & 7) + (mi & 2) * 4) * rs + (mi & 1) * 16;
#pragma unroll
        for (int mtile = 0; mtile < KS; ++mtile) {
          if (mtile * 16 < hd) {
            uint32_t a[4];
            ldmatrix_x4_trans(a, v_row + mtile * 32);
            mma_bf16(acc[mtile], a, b0, b1);
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4 * KS; ++j) {
          const int o = lane + 32 * j;
          if (o < rows * hd) {
            const int g = o / hd, dd = o - g * hd;
            float a = acc[j >> 2][j & 3];
            for (int r = 0; r < kWarpRows; ++r)
              a = fmaf(Elem<T>::to_f(ps[g * kPsStride + r]),
                       Elem<T>::to_f(reinterpret_cast<const T*>(st + r * rs)[dd]), a);
            acc[j >> 2][j & 3] = a;
          }
        }
      }
    }
    __syncwarp();  // the stage and the probabilities are read before they are written again
  }
  if (mt == 0) softmax_stats();
  cp_async_wait<0>();
  __syncthreads();

  // the warps' partial sums (kWarps x kGT x hd f32, over the ring), added in
  // warp order into warp 0's: the block's partial sum
  float* part = reinterpret_cast<float*>(ring);
  float* mine = part + warp * kGT * hd;
  if constexpr (kMma) {
#pragma unroll
    for (int mtile = 0; mtile < KS; ++mtile) {
      if (mtile * 16 < hd) {
        const int d0 = mtile * 16 + gid;
        mine[(2 * t4) * hd + d0] = acc[mtile][0];
        mine[(2 * t4 + 1) * hd + d0] = acc[mtile][1];
        mine[(2 * t4) * hd + d0 + 8] = acc[mtile][2];
        mine[(2 * t4 + 1) * hd + d0 + 8] = acc[mtile][3];
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4 * KS; ++j) {
      const int o = lane + 32 * j;
      if (o < rows * hd) mine[o] = acc[j >> 2][j & 3];
    }
  }
  __syncthreads();
  for (int o = tid; o < rows * hd; o += kThreads) {
    float s = part[o];
    for (int w = 1; w < kWarps; ++w) s += part[w * kGT * hd + o];
    part[o] = s;  // warp 0's slot: this thread alone reads and writes index o
  }
  cluster_sync();
  // the blocks' partial sums added in rank order, each block a share of the outputs
  T* out = static_cast<T*>(p.out) + (static_cast<size_t>(bk) * p.G + g0) * hd;
  const int share = (gn * hd + c - 1) / c;
  const int o_end = min(gn * hd, (rank + 1) * share);
  for (int o = rank * share + tid; o < o_end; o += kThreads) out[o] = Elem<T>::from_f(sum_over_ranks(part + o, c));
  cluster_sync();  // no block leaves while another reads its shared memory
}

using Kernel = void (*)(const Params);

// the instance for a type code (0 bf16, 1 float32) and head dim, or null
Kernel kernel_for(int code, int hd) {
  if (code == 1) return decode_attn_kernel<float, 16>;
  if (code != 0) return nullptr;
  if (hd <= 64) return decode_attn_kernel<__nv_bfloat16, 4>;
  if (hd <= 128) return decode_attn_kernel<__nv_bfloat16, 8>;
  return decode_attn_kernel<__nv_bfloat16, 16>;
}

size_t smem_for(int code, int hd, int rows, int per_pos, bool scratch) {
  if (code == 1) return smem_bytes<float, 16>(hd, rows, per_pos, scratch);
  if (hd <= 64) return smem_bytes<__nv_bfloat16, 4>(hd, rows, per_pos, scratch);
  if (hd <= 128) return smem_bytes<__nv_bfloat16, 8>(hd, rows, per_pos, scratch);
  return smem_bytes<__nv_bfloat16, 16>(hd, rows, per_pos, scratch);
}

bool scores_fit(int rows, int per_pos) {
  return static_cast<size_t>(rows) * per_pos * sizeof(float) <= kScoreSmem;
}

cudaLaunchConfig_t config_for(int c, int units, size_t smem, cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(c, units, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = c;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

bool shape_ok(int B, int S, int KV, int G, int hd, int code) {
  const long long units = static_cast<long long>(B) * KV * ((G + kGT - 1) / kGT);
  return B >= 1 && S >= 1 && KV >= 1 && G >= 1 && hd >= 16 && hd <= 256 && hd % 16 == 0 &&
         units <= kMaxUnits && kernel_for(code, hd) != nullptr;
}

}  // namespace

extern "C" {

// The launch plan of a shape on the current device: plan[0] the cluster
// size c, plan[1] per_pos (a block's score columns), plan[2] the scratch
// floats the wrapper allocates (0: the scores fit in shared memory); int64.
// c is the least power of two (at most 8, and at most half the
// cache's tiles) that puts two blocks on every SM, halved until the card
// holds the whole grid at once. Refuses (cudaErrorInvalidValue) a head dim that is
// no multiple of 16 in 16 .. 256, a type other than bf16 (0) or float32
// (1), and more than 65535 (batch row, KV head, group of 8 query rows) units.
int decode_attn_plan(void* plan, int B, int S, int KV, int G, int hd, int code, void* /*stream*/) {
  if (!shape_ok(B, S, KV, G, hd, code)) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int units = B * KV * ((G + kGT - 1) / kGT);
  const int rows = G < kGT ? G : kGT;
  const int tiles = (S + kTile - 1) / kTile;
  int c = 1;
  while (c < kMaxCluster && units * c < 2 * sms && 2 * c <= tiles) c *= 2;
  const Kernel kernel = kernel_for(code, hd);
  for (;; c /= 2) {
    const int per_pos = (tiles + c - 1) / c * kTile;
    const bool scratch = !scores_fit(rows, per_pos);
    const size_t smem = smem_for(code, hd, rows, per_pos, scratch);
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    int clusters = 0;
    if (c > 1) {
      cudaLaunchAttribute attr;
      const cudaLaunchConfig_t cfg = config_for(c, units, smem, nullptr, &attr);
      e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    if (c == 1 || clusters >= units) {
      long long* out = static_cast<long long*>(plan);
      out[0] = c;
      out[1] = per_pos;
      out[2] = scratch ? static_cast<long long>(units) * c * rows * per_pos : 0;
      return 0;
    }
  }
}

// q and out (B, KV, G, hd), k and v (B, S, KV, hd), all contiguous in the
// type of ``code``; scratch as the plan asks for it; pos_ptr a device int64
// or null (then pos); c and per_pos from the plan.
int decode_attn_launch(const void* q, const void* k, const void* v, void* out, void* scratch,
                       const void* pos_ptr, int B, int S, int KV, int G, int hd, int code, int pos,
                       int window, int c, int per_pos, float scale, void* stream) {
  if (!shape_ok(B, S, KV, G, hd, code) || c < 1 || c > kMaxCluster || per_pos < 1 || window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ngt = (G + kGT - 1) / kGT;
  const int units = B * KV * ngt;
  const int rows = G < kGT ? G : kGT;
  const bool use_scratch = scratch != nullptr;
  if (!use_scratch && !scores_fit(rows, per_pos)) return static_cast<int>(cudaErrorInvalidValue);
  const Kernel kernel = kernel_for(code, hd);
  const size_t smem = smem_for(code, hd, rows, per_pos, use_scratch);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  Params p{q, k, v, out, static_cast<float*>(scratch), static_cast<const long long*>(pos_ptr),
           S, KV, G, hd, ngt, pos, window, per_pos, scale};
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config_for(c, units, smem, static_cast<cudaStream_t>(stream), &attr);
  e = cudaLaunchKernelEx(&cfg, kernel, p);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
