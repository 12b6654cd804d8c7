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
// (m, l, acc) persists in VMEM scratch across the page axis. It loads page
// pt[b, p] even when that is -1 (clamped) and masks the scores afterwards.
// Here blocks run in parallel and in no order, so one block takes one
// (request, KV head) and walks that request's tokens in a loop, 256 tokens
// (several pages) per pass, so that a pass has one token per thread and
// the page size does not set the number of barriers. A token is live when
// it lies below the length and its page id is >= 0; a -1 page is never
// read. The running (m, l, acc) is kept in f32 in shared memory; a request
// with no live token leaves l = 0 and acc = 0 and writes
// acc / max(l, 1e-30) = 0. Per pass:
//   0. each thread resolves one token's row in the pool through the page
//      table (or marks it dead);
//   1. scores: one thread per token reads the token's key row in 16-byte
//      vectors, four in flight, and forms its G dot products with the
//      query rows, staged in shared memory as f32 (every lane reads the
//      same query element, so the reads are broadcasts), 8 query rows at a
//      time in registers;
//   2. online softmax: one warp per query row; the unnormalised
//      probabilities are rounded to the value type before the PV product,
//      as the TPU kernel does (pexp.astype(v.dtype)), while l sums them in
//      f32;
//   3. PV: one thread per value column e and 4 query rows (held in
//      registers), summing over the pass's live tokens with 16 value loads
//      in flight (one token at a time makes the pass a chain of dependent
//      loads); neighbouring threads read neighbouring columns of a value
//      row (coalesced).
// A page id >= num_pages is clamped to the last page, as the reference's
// gather clamps. E is a template argument (16 for the reduced configs, 32,
// 64, 128, 256); G and page are free, as long as the f32 staging fits a
// block's shared memory (the wrapper checks); q, the pools and the output
// are bf16 or f32, 16-byte aligned.
//
// Bound: bytes at the serving engine's shapes. A call must read the live
// K and V rows (2 * len * E values per KV head) plus q, and write the
// output; it does 4 * G * E operations per live token, ~G/2 per byte read
// in bf16, far below the ~295 per byte where the tensor cores would bound
// it. At the engine's batch of one request (B = 1, K = 2) the grid is two
// blocks for 132 SMs, so the card is mostly idle and a call costs about a
// launch plus the serial passes; splitting the token walk over blocks
// (split-K) is left to a later change.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = kThreads;  // tokens per pass, one per thread
constexpr int kRows = 8;          // query rows per thread in the scores
constexpr int kPvRows = 4;        // query rows per thread in the PV sum
constexpr int kLoads = 4;         // key vectors in flight per thread
constexpr int kBatch = 16;        // value loads in flight per thread
constexpr float kNegInf = -1e30f;
constexpr int kDefaultShared = 48 * 1024;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

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

// One 16-byte vector of T as floats.
template <typename T>
struct Vec {
  static constexpr int kN = 16 / sizeof(T);
  float x[kN];
  __device__ __forceinline__ void load(const T* p) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int u = 0; u < kN; ++u) x[u] = to_f32(v[u]);
  }
};

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Grid: one block per (request, KV head), blockIdx.x = b * K + kh.
// Shared memory: f32 q (G, E), acc (G, E), scores/probabilities
// (G, kChunk) and m, l, alpha (G), padded to 8 bytes; int64 row offsets
// (kChunk).
template <typename T, int E>
__global__ void __launch_bounds__(kThreads)
    paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kpool,
                        const T* __restrict__ vpool,
                        const int32_t* __restrict__ page_table,
                        const int32_t* __restrict__ lengths,
                        T* __restrict__ out, int kv_heads, int groups,
                        int num_pages, int page, int max_pages, float scale) {
  constexpr int kVecs = E / Vec<T>::kN;  // 16-byte vectors per row
  extern __shared__ float smem[];
  const int b = blockIdx.x / kv_heads;
  const int kh = blockIdx.x % kv_heads;
  const int ge = groups * E;
  float* q_s = smem;
  float* acc_s = q_s + ge;
  float* s_s = acc_s + ge;
  float* m_s = s_s + groups * kChunk;
  float* l_s = m_s + groups;
  float* a_s = l_s + groups;
  int64_t* off_s = reinterpret_cast<int64_t*>(a_s + groups + (groups & 1));
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const int64_t head = static_cast<int64_t>(b) * kv_heads + kh;
  const T* qh = q + head * ge;
  for (int i = tid; i < ge; i += kThreads) {
    q_s[i] = to_f32(qh[i]);
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < groups; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  __syncthreads();

  const int len = lengths[b];
  const int total = max(0, min(len, max_pages * page));
  const int32_t* pt = page_table + static_cast<int64_t>(b) * max_pages;
  for (int t0 = 0; t0 < total; t0 += kChunk) {
    const int n = min(kChunk, total - t0);

    // 0. this pass's token rows (-1: no page)
    if (tid < n) {
      const int t = t0 + tid;
      int pid = pt[t / page];
      if (pid >= num_pages) pid = num_pages - 1;
      off_s[tid] = pid < 0 ? -1
                           : ((static_cast<int64_t>(pid) * page + t % page) *
                                  kv_heads + kh) * E;
    }
    __syncthreads();

    // 1. scores, one thread per token
    if (tid < n) {
      const int64_t off = off_s[tid];
      for (int g0 = 0; g0 < groups; g0 += kRows) {
        float dot[kRows];
#pragma unroll
        for (int j = 0; j < kRows; ++j) dot[j] = 0.f;
        if (off >= 0) {
          // kLoads vectors in flight at a time, then their products
          for (int c0 = 0; c0 < kVecs; c0 += kLoads) {
            Vec<T> kv[kLoads];
#pragma unroll
            for (int c = 0; c < kLoads; ++c)
              if (c0 + c < kVecs) kv[c].load(kpool + off + (c0 + c) * Vec<T>::kN);
#pragma unroll
            for (int c = 0; c < kLoads; ++c) {
              if (c0 + c >= kVecs) break;
#pragma unroll
              for (int j = 0; j < kRows; ++j) {
                if (g0 + j < groups) {
                  const float* qg = q_s + (g0 + j) * E + (c0 + c) * Vec<T>::kN;
#pragma unroll
                  for (int u = 0; u < Vec<T>::kN; ++u)
                    dot[j] = fmaf(qg[u], kv[c].x[u], dot[j]);
                }
              }
            }
          }
        }
#pragma unroll
        for (int j = 0; j < kRows; ++j)
          if (g0 + j < groups) s_s[(g0 + j) * kChunk + tid] = dot[j] * scale;
      }
    }
    __syncthreads();

    // 2. online softmax over the pass's live tokens, one warp per row
    for (int g = warp; g < groups; g += kWarps) {
      float* sg = s_s + g * kChunk;
      float mx = kNegInf;
      for (int i = lane; i < n; i += 32)
        if (off_s[i] >= 0) mx = fmaxf(mx, sg[i]);
      mx = warp_max(mx);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int i = lane; i < n; i += 32) {
        const float pe = off_s[i] >= 0 ? expf(sg[i] - m_new) : 0.f;
        sum += pe;
        sg[i] = to_f32(from_f32<T>(pe));
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        l_s[g] = l_s[g] * alpha + sum;
        a_s[g] = alpha;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // 3. PV, one thread per (value column, kPvRows query rows)
    const int pv_items = E * ((groups + kPvRows - 1) / kPvRows);
    for (int w = tid; w < pv_items; w += kThreads) {
      const int e = w % E;
      const int g0 = (w / E) * kPvRows;
      float pv[kPvRows];
#pragma unroll
      for (int j = 0; j < kPvRows; ++j) pv[j] = 0.f;
      // kBatch value loads in flight at a time; a dead token (probability
      // 0) reads nothing and adds 0
      for (int i0 = 0; i0 < n; i0 += kBatch) {
        float v[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int64_t off = i0 + u < n ? off_s[i0 + u] : -1;
          v[u] = off >= 0 ? to_f32(vpool[off + e]) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (i0 + u >= n) break;
#pragma unroll
          for (int j = 0; j < kPvRows; ++j)
            if (g0 + j < groups)
              pv[j] = fmaf(s_s[(g0 + j) * kChunk + i0 + u], v[u], pv[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < kPvRows; ++j) {
        const int g = g0 + j;
        if (g < groups) acc_s[g * E + e] = acc_s[g * E + e] * a_s[g] + pv[j];
      }
    }
    __syncthreads();
  }

  T* oh = out + head * ge;
  for (int i = tid; i < ge; i += kThreads)
    oh[i] = from_f32<T>(acc_s[i] / fmaxf(l_s[i / E], 1e-30f));
}

template <typename T, int E>
int launch(const void* q, const void* kpool, const void* vpool,
           const void* page_table, const void* lengths, void* out, int64_t b,
           int kv_heads, int groups, int num_pages, int page, int max_pages,
           float scale, cudaStream_t s) {
  const size_t shared =
      sizeof(float) * (2 * static_cast<size_t>(groups) * E +
                       static_cast<size_t>(groups) * kChunk + 3 * groups +
                       (groups & 1)) +
      sizeof(int64_t) * kChunk;
  auto kernel = paged_decode_kernel<T, E>;
  if (shared > kDefaultShared) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shared));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  const dim3 grid(static_cast<unsigned>(b * kv_heads));
  kernel<<<grid, kThreads, shared, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(kpool),
      static_cast<const T*>(vpool), static_cast<const int32_t*>(page_table),
      static_cast<const int32_t*>(lengths), static_cast<T*>(out), kv_heads,
      groups, num_pages, page, max_pages, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_e(int e, const void* q, const void* kpool, const void* vpool,
             const void* page_table, const void* lengths, void* out,
             int64_t b, int kv_heads, int groups, int num_pages, int page,
             int max_pages, float scale, cudaStream_t s) {
  switch (e) {
    case 16:
      return launch<T, 16>(q, kpool, vpool, page_table, lengths, out, b,
                           kv_heads, groups, num_pages, page, max_pages,
                           scale, s);
    case 32:
      return launch<T, 32>(q, kpool, vpool, page_table, lengths, out, b,
                           kv_heads, groups, num_pages, page, max_pages,
                           scale, s);
    case 64:
      return launch<T, 64>(q, kpool, vpool, page_table, lengths, out, b,
                           kv_heads, groups, num_pages, page, max_pages,
                           scale, s);
    case 128:
      return launch<T, 128>(q, kpool, vpool, page_table, lengths, out, b,
                            kv_heads, groups, num_pages, page, max_pages,
                            scale, s);
    case 256:
      return launch<T, 256>(q, kpool, vpool, page_table, lengths, out, b,
                            kv_heads, groups, num_pages, page, max_pages,
                            scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32 (q, the pools and out share it).
extern "C" int pp_paged_attention(const void* q, const void* kpool,
                                  const void* vpool, const void* page_table,
                                  const void* lengths, void* out, int dtype,
                                  int64_t b, int kv_heads, int groups, int e,
                                  int num_pages, int page, int max_pages,
                                  float scale, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_e<__nv_bfloat16>(e, q, kpool, vpool, page_table, lengths,
                                   out, b, kv_heads, groups, num_pages, page,
                                   max_pages, scale, s);
  if (dtype == 1)
    return launch_e<float>(e, q, kpool, vpool, page_table, lengths, out, b,
                           kv_heads, groups, num_pages, page, max_pages,
                           scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
