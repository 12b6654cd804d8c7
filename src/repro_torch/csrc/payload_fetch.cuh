// Merge stage 3..N for one pipe, by one whole block: gather each packet's
// parked row (zeros for a packet that fetches nothing), then clear the rows
// that are freed. Every read comes before any clear, so two packets that
// name one row both receive it, as the plain version gathers every row
// before it clears any. payload_fetch.cu runs it over every packet of a
// pipe; merge_stage.cu in each of a pipe's blocks over the block's own
// packets (another block writes the others' output rows and clears the
// rows they free).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

// One packet's part in the fetch: the table row it reads (already clamped
// into [0, M)), its output row, whether it gathers the table row and
// whether it clears it.
struct FetchRow {
  int64_t row;
  int64_t out;
  bool fetch;
  bool clear;
};

// Every thread of the block calls this: it holds a barrier. ``pkt(k)``
// gives the FetchRow of the block's packet k < count. Rows are ``width``
// bytes, a multiple of 16, and move as 16-byte vectors: each packet's row
// takes the next power of two of lanes at or above its vectors (at most
// 32, a wider row loops), so a thread finds its packet and vector by
// shifts. Each thread loads kUnroll vectors before it stores any: the
// gather is bound by the loads a block keeps in flight, not by the bytes.
template <class Pkt>
__device__ void gather_then_clear(uint8_t* table, uint8_t* __restrict__ out,
                                  int64_t count, int64_t width, Pkt pkt) {
  constexpr int kUnroll = 8;
  const int vecs = static_cast<int>(width / 16);
  const int shift = vecs <= 1 ? 0 : min(5, 32 - __clz(vecs - 1));
  const int lanes = 1 << shift;  // of a packet's row
  const int64_t per = blockDim.x >> shift;  // packets a pass
  const int first = threadIdx.x & (lanes - 1);
  const int4 zero = make_int4(0, 0, 0, 0);
  int4* t = reinterpret_cast<int4*>(table);
  int4* o = reinterpret_cast<int4*>(out);
  for (int64_t base = threadIdx.x >> shift; base < count;
       base += per * kUnroll) {
    for (int v = first; v < vecs; v += lanes) {
      int4 got[kUnroll];
      int64_t dst[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t k = base + u * per;
        dst[u] = -1;
        if (k < count) {
          const FetchRow r = pkt(k);
          got[u] = r.fetch ? t[r.row * vecs + v] : zero;
          dst[u] = r.out * vecs + v;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (dst[u] >= 0) o[dst[u]] = got[u];
    }
  }
  __syncthreads();
  for (int64_t k = threadIdx.x >> shift; k < count; k += per) {
    const FetchRow r = pkt(k);
    if (r.clear)
      for (int v = first; v < vecs; v += lanes) t[r.row * vecs + v] = zero;
  }
}
