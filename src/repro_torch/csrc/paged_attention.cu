// Paged decode attention: one new query token per request attends over the
// request's KV history, which lies in fixed-size pages of a shared pool and
// is found through the request's page table (-1 = no page):
//   out[b, kh, g] = sum_t softmax_t(q[b, kh, g] . k[t, kh] * E**-0.5) v[t, kh]
// over the tokens t < lengths[b] of the live pages.
//
// Replaces the TPU kernel
// repro/kernels/paged_attention/kernel.py::paged_decode_attention_kernel
// (body _paged_kernel). The TPU version runs a (B, MAX_PAGES) grid in order
// on one core: scalar prefetch of the page table drives the BlockSpec index
// map, so each grid step DMAs one (page, K, E) page into VMEM, and a running
// (m, l, acc) persists in VMEM scratch across the page axis.
//
// Bound: bytes and latency on this card. A call must read the live K and V
// rows (2 * len * E values per KV head) plus q and write the output; it
// does 4 * G * E operations per live token, ~G/2 per byte in bf16, far
// below the ~295 per byte at which the tensor cores would bound it. At the
// serving engine's batch of one request (B = 1, K = 2, <= 192 tokens) the
// bytes take well under a microsecond, so a call costs its launch and its
// chain of dependent steps. The earlier design (one block per
// (request, KV head) walking the whole history serially in 256-token
// passes, CUDA-core FMAs) took 0.032160 ms at (B, K, G, E) = (1, 2, 8, 128)
// over 160 tokens and 0.308320 ms at (8, 2, 8, 128) over 8397 tokens,
// against 0.016096 / 0.022080 ms for SDPA on K/V gathered beforehand
// (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md section 6).
//
// This design (flash-decoding, one launch):
// 1. Split-K. The grid is (B * K * ceil(G / 8), splits): a block takes one
//    (request, KV head, 8 query rows) and one range of split_tokens tokens,
//    a multiple of 16; the host picks the split from shapes alone
//    (kernels/paged_attention.py::split_plan) and never reads lengths. Each
//    of the block's 4 warps walks its own 16-token tiles of the range
//    (tiles w, w + 4, ...) with its own running (m, l, acc) in registers.
//    A range at or past the length does no loads and records m = -1e30,
//    l = 0, acc = 0.
// 2. Combine in the same launch. The warps merge in shared memory; with
//    one split the block writes the output. Otherwise it writes its f32
//    partial (m, l, acc[8, E]) to a scratch, fences, and draws a ticket
//    from an int32 counter per (request, KV head, row group); the block
//    that draws the last ticket merges every split's partial,
//    m = max m_i, l = sum l_i e^(m_i - m), out = sum acc_i e^(m_i - m) /
//    max(l, 1e-30), writes the output and resets the counter to 0. The
//    counters live in a buffer that the wrapper caches per device and
//    zeroes once: calls must run on one stream at a time, as every caller
//    in the port makes them.
// 3. Asynchronous staging. A warp resolves its tile's 16 pool rows through
//    the page table (a page id >= num_pages is clamped to the last page, as
//    the reference's gather clamps) and copies the K and V rows into its
//    own shared-memory stage with cp.async.cg, 16 bytes a copy. With two
//    tiles or more per warp there are two stages (one fits a single
//    tile): the first two tiles' page ids are read before the length is,
//    both tiles' copies start at once, and each stage is refilled with the
//    tile two ahead as soon as it is multiplied, so the next tile's rows
//    are in flight while the current one is multiplied (three or four
//    stages measured no faster, PERF.md section 6). A token past the
//    range or on a -1 page is never read: its copy zero-fills the row and
//    its probability is 0 (a request with no live token writes zeros).
//    TMA is not used: a K/V row of one head is a 256-byte stripe with a
//    K * E stride, so a TMA box would need whole pages at least the tile's
//    height, and 4-token pages are among the shapes the kernel takes.
// 4. Tensor cores for bf16. Scores S^T = K_tile q^T with
//    mma.sync.m16n8k16 (M = 16 tokens, N = 8 query rows, K = E in 16-wide
//    steps; K from ldmatrix, q held in registers); PV O^T += V_tile^T P
//    (M = 16 value columns, N = 8 rows, K = 16 tokens; V from
//    ldmatrix.trans, P moved from the score accumulators' layout to the B
//    operand's by movmatrix.trans). The unnormalised probabilities are
//    rounded to bf16 before the PV product, as the TPU kernel does
//    (pexp.astype(v.dtype)), while l sums them in f32. wgmma is not
//    needed: at ~G/2 operations per byte the products only have to leave
//    the critical path, which mma.sync does. The f32 instantiation keeps
//    CUDA-core FMAs in the same fragment layout (no TF32), so f32 results
//    are exact up to summation order.
// E is a template argument (16 for the reduced configs, 32, 64, 128, 256);
// G and the page size are free; q, the pools and the output are bf16 or
// f32, 16-byte aligned.
#include <algorithm>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <type_traits>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 16;  // tokens per warp tile
constexpr int kCols = 8;   // query rows per block (the mma's N)
constexpr int kMaxSplits = 64;  // two per lane in the last block's merge
constexpr int kUnroll = 8;      // partials in flight per thread there
constexpr int kMaxStages = 2;   // K/V tiles in flight per warp
constexpr float kNegInf = -1e30f;
constexpr int kDefaultShared = 48 * 1024;
constexpr int kMaxShared = 227 * 1024;
// f32 words after the tile region: each warp's m and l, each warp's
// probabilities for the f32 PV, the block's m and l, a flag
constexpr int kSmallWords = kWarps * 2 * kCols + kWarps * kTile * kCols +
                            2 * kCols + 4;

struct Args {
  const void* q;
  const void* kpool;
  const void* vpool;
  const int32_t* page_table;
  const int32_t* lengths;
  void* out;
  float* part_acc;  // (heads, splits, 8, E)
  float* part_ml;   // (heads, splits, 2, 8)
  int32_t* tickets; // (heads,)
  int kv_heads, groups, num_pages, page, max_pages;
  int split_tokens, stages, region;
  float scale;
};

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// reduce over the 8 lanes that share lane % 4 (the tokens of a column)
__device__ __forceinline__ float column_max(float v) {
  for (int o = 4; o < 32; o <<= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float column_sum(float v) {
  for (int o = 4; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy into shared memory; with live false nothing is read and the
// destination is zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(live ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// wait until at most n (0 or 1) of the thread's copy groups are pending
__device__ __forceinline__ void cp_async_wait_pending(int n) {
  if (n == 0)
    cp_async_wait<0>();
  else
    cp_async_wait<1>();
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(y)
               : "r"(x));
  return y;
}

// d += a b, m16n8k16, bf16 inputs, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Fragment layout shared by both element types. Lane l holds, for the
// tile's scores S^T (16 tokens x 8 rows), s[0] = (token r, row ca),
// s[1] = (r, cb), s[2] = (r + 8, ca), s[3] = (r + 8, cb), and for each
// 16-column slice mt of the output O^T (E x 8 rows), acc[mt][0] =
// (column 16 mt + r, row ca), [1] = (that column, cb), [2] = (column
// 16 mt + r + 8, ca), [3] = (that column, cb), with r = l / 4,
// ca = 2 (l % 4), cb = ca + 1: the accumulator layout of mma.m16n8.
template <typename T, int E>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(Args a) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr int kVec = 16 / sizeof(T);        // elements per 16-byte copy
  constexpr int kRow = E + kVec;              // padded staged row
  constexpr int kRowVecs = E / kVec;
  constexpr int kTileElems = kTile * kRow;    // one K or V tile
  constexpr int kMt = E / 16;
  constexpr int kCopies = kTile * kRowVecs / 32;  // per lane per tile
  static_assert(kTile * kRowVecs % 32 == 0, "tile copies per lane");

  extern __shared__ __align__(16) unsigned char smem[];
  T* tiles = reinterpret_cast<T*>(smem);  // [warp][stage][K | V][16][kRow]
  float* warp_ml = reinterpret_cast<float*>(smem + a.region);  // [w][2][8]
  float* warp_p = warp_ml + kWarps * 2 * kCols;  // [w][16][8], f32 PV
  float* blk = warp_p + kWarps * kTile * kCols;  // block m, l [2][8]
  int* flag = reinterpret_cast<int*>(blk + 2 * kCols);
  T* q_s = reinterpret_cast<T*>(flag + 4);  // f32: [8][kRow]

  const T* q = static_cast<const T*>(a.q);
  const T* kpool = static_cast<const T*>(a.kpool);
  const T* vpool = static_cast<const T*>(a.vpool);
  const int gchunks = (a.groups + kCols - 1) / kCols;
  const int splits = gridDim.y;
  const int head = blockIdx.x;  // (b * K + kh) * gchunks + gc
  const int split = blockIdx.y;
  const int gc = head % gchunks;
  const int bk = head / gchunks;
  const int b = bk / a.kv_heads;
  const int kh = bk % a.kv_heads;
  const int g_base = gc * kCols;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int r = lane >> 2;
  const int ca = 2 * (lane & 3);
  const int cb = ca + 1;

  const int t_begin = split * a.split_tokens;
  const int limit = a.max_pages * a.page;
  const int32_t* pt = a.page_table + static_cast<int64_t>(b) * a.max_pages;
  const T* qh = q + (static_cast<int64_t>(bk) * a.groups + g_base) * E;
  // the page id of a token of the warp's n-th tile (lane % 16), -1 past
  // the table
  auto page_id = [&](int n) -> int {
    const int tok = t_begin + (warp + n * kWarps) * kTile + (lane & 15);
    return tok < limit ? pt[tok / a.page] : -1;
  };
  // loaded before the length is known, so that the loads overlap: the
  // page ids of the tiles of the first stages and, for bf16, q as B
  // fragments in registers
  int pids[kMaxStages];
#pragma unroll
  for (int j = 0; j < kMaxStages; ++j)
    pids[j] = j < a.stages ? page_id(j) : -1;
  uint32_t qf[kMt][2];
  if constexpr (kBf16) {
    const bool live_row = g_base + r < a.groups;
#pragma unroll
    for (int kk = 0; kk < kMt; ++kk) {
      const uint32_t* qr =
          reinterpret_cast<const uint32_t*>(qh + r * E + kk * 16 + ca);
      qf[kk][0] = live_row ? qr[0] : 0u;
      qf[kk][1] = live_row ? qr[4] : 0u;
    }
  }
  const int len = a.lengths[b];
  const int t_end = min(t_begin + a.split_tokens, max(0, min(len, limit)));

  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;
  float acc[kMt][4];
#pragma unroll
  for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[mt][j] = 0.f;

  if (t_begin < t_end) {  // the same for the whole block
    if constexpr (!kBf16) {  // f32 q rows in shared memory
      for (int i = tid; i < kCols * E; i += kThreads) {
        const int g = i / E;
        q_s[g * kRow + i % E] = g_base + g < a.groups ? qh[i] : T(0);
      }
      __syncthreads();
    }

    const int ntiles = (t_end - t_begin + kTile - 1) / kTile;
    const int cnt = warp < ntiles ? (ntiles - 1 - warp) / kWarps + 1 : 0;
    T* mine = tiles + warp * a.stages * 2 * kTileElems;
    float* p_s = warp_p + warp * kTile * kCols;

    // start the copies of the warp's n-th tile, whose page ids are pid,
    // into stage st; returns the tile's live tokens as a 16-bit mask
    auto stage_tile = [&](int n, int pid, T* st) -> uint32_t {
      const int tok = t_begin + (warp + n * kWarps) * kTile + (lane & 15);
      long long off = -1;
      if (tok < t_end && pid >= 0) {
        pid = min(pid, a.num_pages - 1);
        off = ((static_cast<long long>(pid) * a.page + tok % a.page) *
                   a.kv_heads + kh) * E;
      }
      T* vst = st + kTileElems;
#pragma unroll
      for (int i = 0; i < kCopies; ++i) {
        const int c = i * 32 + lane;
        const int row = c / kRowVecs;
        const int col = (c % kRowVecs) * kVec;
        const long long o = __shfl_sync(0xffffffffu, off, row);
        const long long src = o >= 0 ? o + col : 0;
        cp_async16(st + row * kRow + col, kpool + src, o >= 0);
        cp_async16(vst + row * kRow + col, vpool + src, o >= 0);
      }
      cp_async_commit();
      return __ballot_sync(0xffffffffu, lane < 16 && off >= 0);
    };

    // the live tokens of the tiles in stages 0 and 1
    uint32_t mask0 = cnt > 0 ? stage_tile(0, pids[0], mine) : 0u;
    uint32_t mask1 = a.stages > 1 && cnt > 1
                         ? stage_tile(1, pids[1], mine + 2 * kTileElems)
                         : 0u;
    for (int n = 0; n < cnt; ++n) {
      const int stage = n % a.stages;
      const T* kst = mine + stage * 2 * kTileElems;
      const T* vst = kst + kTileElems;
      cp_async_wait_pending(min(cnt, n + a.stages) - n - 1);
      __syncwarp();
      const uint32_t live_cur = stage ? mask1 : mask0;

      // scores
      float s[4] = {0.f, 0.f, 0.f, 0.f};
      if constexpr (kBf16) {
        // two accumulator chains, even and odd 16-wide steps of E
        float s2[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < kMt; ++kk) {
          uint32_t af[4];
          ldsm_x4(af, kst + (lane & 15) * kRow + kk * 16 + (lane >> 4) * 8);
          if (kk & 1)
            mma_bf16(s2, af, qf[kk][0], qf[kk][1]);
          else
            mma_bf16(s, af, qf[kk][0], qf[kk][1]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) s[j] += s2[j];
      } else {
        const float4* k0 = reinterpret_cast<const float4*>(kst + r * kRow);
        const float4* k1 =
            reinterpret_cast<const float4*>(kst + (r + 8) * kRow);
        const float4* q0 = reinterpret_cast<const float4*>(q_s + ca * kRow);
        const float4* q1 = reinterpret_cast<const float4*>(q_s + cb * kRow);
#pragma unroll 8
        for (int v = 0; v < E / 4; ++v) {
          const float4 x0 = k0[v], x1 = k1[v], y0 = q0[v], y1 = q1[v];
          s[0] += x0.x * y0.x + x0.y * y0.y + x0.z * y0.z + x0.w * y0.w;
          s[1] += x0.x * y1.x + x0.y * y1.y + x0.z * y1.z + x0.w * y1.w;
          s[2] += x1.x * y0.x + x1.y * y0.y + x1.z * y0.z + x1.w * y0.w;
          s[3] += x1.x * y1.x + x1.y * y1.y + x1.z * y1.z + x1.w * y1.w;
        }
      }

      // online softmax over the tile's live tokens, per column
      const bool live0 = (live_cur >> r) & 1u;
      const bool live1 = (live_cur >> (r + 8)) & 1u;
      const float x0 = live0 ? s[0] * a.scale : kNegInf;
      const float x1 = live0 ? s[1] * a.scale : kNegInf;
      const float x2 = live1 ? s[2] * a.scale : kNegInf;
      const float x3 = live1 ? s[3] * a.scale : kNegInf;
      const float mn_a = fmaxf(m_a, column_max(fmaxf(x0, x2)));
      const float mn_b = fmaxf(m_b, column_max(fmaxf(x1, x3)));
      const float p0 = live0 ? expf(x0 - mn_a) : 0.f;
      const float p1 = live0 ? expf(x1 - mn_b) : 0.f;
      const float p2 = live1 ? expf(x2 - mn_a) : 0.f;
      const float p3 = live1 ? expf(x3 - mn_b) : 0.f;
      const float al_a = expf(m_a - mn_a);
      const float al_b = expf(m_b - mn_b);
      l_a = l_a * al_a + column_sum(p0 + p2);
      l_b = l_b * al_b + column_sum(p1 + p3);
      m_a = mn_a;
      m_b = mn_b;
#pragma unroll
      for (int mt = 0; mt < kMt; ++mt) {
        acc[mt][0] *= al_a;
        acc[mt][1] *= al_b;
        acc[mt][2] *= al_a;
        acc[mt][3] *= al_b;
      }

      // PV with the probabilities rounded to T
      if constexpr (kBf16) {
        const uint32_t b0 = movmatrix_trans(pack_bf16(p0, p1));
        const uint32_t b1 = movmatrix_trans(pack_bf16(p2, p3));
#pragma unroll
        for (int mt = 0; mt < kMt; ++mt) {
          uint32_t af[4];
          ldsm_x4_trans(af, vst + ((lane >> 4) * 8 + (lane & 7)) * kRow +
                                mt * 16 + ((lane >> 3) & 1) * 8);
          mma_bf16(acc[mt], af, b0, b1);
        }
      } else {
        p_s[r * kCols + ca] = p0;
        p_s[r * kCols + cb] = p1;
        p_s[(r + 8) * kCols + ca] = p2;
        p_s[(r + 8) * kCols + cb] = p3;
        __syncwarp();
#pragma unroll
        for (int mt = 0; mt < kMt; ++mt) {
          const int e = mt * 16 + r;
#pragma unroll 4
          for (int t = 0; t < kTile; ++t) {
            const float va = vst[t * kRow + e];
            const float vb = vst[t * kRow + e + 8];
            const float pa = p_s[t * kCols + ca];
            const float pb = p_s[t * kCols + cb];
            acc[mt][0] = fmaf(va, pa, acc[mt][0]);
            acc[mt][1] = fmaf(va, pb, acc[mt][1]);
            acc[mt][2] = fmaf(vb, pa, acc[mt][2]);
            acc[mt][3] = fmaf(vb, pb, acc[mt][3]);
          }
        }
      }
      __syncwarp();  // the stage is read: refill it with a later tile
      if (n + a.stages < cnt) {
        const uint32_t m = stage_tile(n + a.stages, page_id(n + a.stages),
                                      mine + stage * 2 * kTileElems);
        if (stage)
          mask1 = m;
        else
          mask0 = m;
      }
    }
  }

  // merge the warps: every walk is over, so the tile region is free
  __syncthreads();
  float* wml = warp_ml + warp * 2 * kCols;
  if (lane < 4) {
    wml[ca] = m_a;
    wml[cb] = m_b;
    wml[kCols + ca] = l_a;
    wml[kCols + cb] = l_b;
  }
  __syncthreads();
  float big_a = kNegInf, big_b = kNegInf;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    big_a = fmaxf(big_a, warp_ml[w * 2 * kCols + ca]);
    big_b = fmaxf(big_b, warp_ml[w * 2 * kCols + cb]);
  }
  const float sc_a = expf(m_a - big_a);
  const float sc_b = expf(m_b - big_b);
  float* red = reinterpret_cast<float*>(smem);  // [w][8][E]
  float* rw = red + warp * kCols * E;
#pragma unroll
  for (int mt = 0; mt < kMt; ++mt) {
    const int e = mt * 16 + r;
    rw[ca * E + e] = acc[mt][0] * sc_a;
    rw[cb * E + e] = acc[mt][1] * sc_b;
    rw[ca * E + e + 8] = acc[mt][2] * sc_a;
    rw[cb * E + e + 8] = acc[mt][3] * sc_b;
  }
  if (tid < kCols) {
    float big = kNegInf;
    for (int w = 0; w < kWarps; ++w)
      big = fmaxf(big, warp_ml[w * 2 * kCols + tid]);
    float l = 0.f;
    for (int w = 0; w < kWarps; ++w)
      l += warp_ml[w * 2 * kCols + kCols + tid] *
           expf(warp_ml[w * 2 * kCols + tid] - big);
    blk[tid] = big;
    blk[kCols + tid] = l;
  }
  __syncthreads();

  T* oh = static_cast<T*>(a.out) +
          (static_cast<int64_t>(bk) * a.groups + g_base) * E;
  if (splits == 1) {
    for (int i = tid; i < kCols * E; i += kThreads) {
      const int g = i / E;
      if (g_base + g >= a.groups) continue;
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) v += red[w * kCols * E + i];
      oh[i] = from_f32<T>(v / fmaxf(blk[kCols + g], 1e-30f));
    }
    return;
  }

  // this split's partial, then a ticket; the last block merges the splits
  const int64_t part = static_cast<int64_t>(head) * splits;
  float* pa = a.part_acc + (part + split) * kCols * E;
  for (int i = tid; i < kCols * E; i += kThreads) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += red[w * kCols * E + i];
    pa[i] = v;
  }
  if (tid < 2 * kCols) a.part_ml[(part + split) * 2 * kCols + tid] = blk[tid];
  __threadfence();
  __syncthreads();
  if (tid == 0) flag[0] = atomicAdd(a.tickets + head, 1) == splits - 1;
  __syncthreads();
  if (!flag[0]) return;
  __threadfence();

  // each split's weight e^(m_i - m) per row, one warp per row, two
  // splits per lane
  float* wgt = reinterpret_cast<float*>(smem);  // [split][8]
  for (int g = warp; g < kCols; g += kWarps) {
    float mi[2], li[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = lane + 32 * u;
      const float* ml = a.part_ml + (part + i) * 2 * kCols;
      mi[u] = i < splits ? __ldcg(ml + g) : kNegInf;
      li[u] = i < splits ? __ldcg(ml + kCols + g) : 0.f;
    }
    const float big = warp_max(fmaxf(mi[0], mi[1]));
    float l = 0.f;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = lane + 32 * u;
      const float w = expf(mi[u] - big);
      if (i < splits) wgt[i * kCols + g] = w;
      l += w * li[u];
    }
    l = warp_sum(l);
    if (lane == 0) blk[kCols + g] = l;
  }
  __syncthreads();
  // the weighted sum of the partials, kUnroll of them in flight
  const float4* parts =
      reinterpret_cast<const float4*>(a.part_acc + part * kCols * E);
  constexpr int kStride = kCols * E / 4;  // float4s of one partial
  for (int i = tid; i < kStride; i += kThreads) {
    const int g = i / (E / 4);
    if (g_base + g >= a.groups) continue;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int sp0 = 0; sp0 < splits; sp0 += kUnroll) {
      float4 x[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        x[u] = sp0 + u < splits
                   ? __ldcg(parts + static_cast<int64_t>(sp0 + u) * kStride + i)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float w = sp0 + u < splits ? wgt[(sp0 + u) * kCols + g] : 0.f;
        v.x += w * x[u].x;
        v.y += w * x[u].y;
        v.z += w * x[u].z;
        v.w += w * x[u].w;
      }
    }
    const float l = fmaxf(blk[kCols + g], 1e-30f);
    oh[4 * i] = from_f32<T>(v.x / l);
    oh[4 * i + 1] = from_f32<T>(v.y / l);
    oh[4 * i + 2] = from_f32<T>(v.z / l);
    oh[4 * i + 3] = from_f32<T>(v.w / l);
  }
  if (tid == 0) a.tickets[head] = 0;
}

template <typename T, int E>
int launch(Args a, int64_t heads, int splits, cudaStream_t s) {
  constexpr size_t kRow = E + 16 / sizeof(T);
  // the tiles, reused by the warps' merge and the last block's weights
  size_t region = std::max({sizeof(T) * kWarps * a.stages * 2 * kTile * kRow,
                            sizeof(float) * kWarps * kCols * E,
                            sizeof(float) * splits * kCols});
  region = (region + 15) / 16 * 16;
  const size_t shared = region + sizeof(float) * kSmallWords +
                        (sizeof(T) == 4 ? sizeof(T) * kCols * kRow : 0);
  if (shared > kMaxShared || a.stages < 1 || a.stages > kMaxStages)
    return static_cast<int>(cudaErrorInvalidValue);
  a.region = static_cast<int>(region);
  auto kernel = paged_decode_kernel<T, E>;
  if (shared > kDefaultShared) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shared));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  const dim3 grid(static_cast<unsigned>(heads), static_cast<unsigned>(splits));
  kernel<<<grid, kThreads, shared, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_e(int e, const Args& a, int64_t heads, int splits,
             cudaStream_t s) {
  switch (e) {
    case 16: return launch<T, 16>(a, heads, splits, s);
    case 32: return launch<T, 32>(a, heads, splits, s);
    case 64: return launch<T, 64>(a, heads, splits, s);
    case 128: return launch<T, 128>(a, heads, splits, s);
    case 256: return launch<T, 256>(a, heads, splits, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32 (q, the pools and out share it).
// part_acc (B K ceil(G / 8) splits 8 E f32), part_ml (B K ceil(G / 8)
// splits 16 f32) and tickets (B K ceil(G / 8) int32, zero) are the
// caller's scratch; with splits == 1 they are not touched.
extern "C" int pp_paged_attention(const void* q, const void* kpool,
                                  const void* vpool, const void* page_table,
                                  const void* lengths, void* out,
                                  void* part_acc, void* part_ml,
                                  void* tickets, int dtype, int64_t b,
                                  int kv_heads, int groups, int e,
                                  int num_pages, int page, int max_pages,
                                  int split_tokens, int splits, int stages,
                                  float scale, void* stream) {
  if (split_tokens < kTile || split_tokens % kTile || splits < 1 ||
      splits > kMaxSplits ||
      static_cast<int64_t>(splits) * split_tokens <
          static_cast<int64_t>(max_pages) * page)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{q, kpool, vpool, static_cast<const int32_t*>(page_table),
         static_cast<const int32_t*>(lengths), out,
         static_cast<float*>(part_acc), static_cast<float*>(part_ml),
         static_cast<int32_t*>(tickets), kv_heads, groups, num_pages, page,
         max_pages, split_tokens, stages, 0, scale};
  const int64_t heads = b * kv_heads * ((groups + kCols - 1) / kCols);
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_e<__nv_bfloat16>(e, a, heads, splits, s);
  if (dtype == 1) return launch_e<float>(e, a, heads, splits, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
