// Merge stage 3..N for one pipe, by one whole block: gather each packet's
// parked row (zeros for a packet that fetches nothing), then clear the rows
// that are freed. Every read comes before any clear, so two packets that
// name one row both receive it, as the plain version gathers every row
// before it clears any. payload_fetch.cu and merge_stage.cu both run it.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

// One packet's part in the fetch: the table row it reads (already clamped
// into [0, M)), whether it gathers that row and whether it clears it.
struct FetchRow {
  int64_t row;
  bool fetch;
  bool clear;
};

// Every thread of the block calls this: it holds a barrier. ``pkt(i)``
// gives packet i's FetchRow. Rows are ``width`` bytes, a multiple of 16,
// and move as 16-byte vectors, neighbouring threads on neighbouring
// vectors. One block moves a whole pipe, so each thread loads kUnroll
// vectors before it stores any: the gather is bound by the loads a block
// keeps in flight, not by the bytes.
template <class Pkt>
__device__ void gather_then_clear(uint8_t* table, uint8_t* __restrict__ out,
                                  int64_t b, int64_t width, Pkt pkt) {
  constexpr int kUnroll = 8;
  const int64_t vecs = width / 16;
  const int64_t n = b * vecs;
  const int64_t step = blockDim.x;
  const int4 zero = make_int4(0, 0, 0, 0);
  int4* t = reinterpret_cast<int4*>(table);
  int4* o = reinterpret_cast<int4*>(out);
  for (int64_t base = threadIdx.x; base < n; base += step * kUnroll) {
    int4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t j = base + u * step;
      if (j < n) {
        const FetchRow r = pkt(j / vecs);
        v[u] = r.fetch ? t[r.row * vecs + j % vecs] : zero;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t j = base + u * step;
      if (j < n) o[j] = v[u];
    }
  }
  __syncthreads();
  for (int64_t j = threadIdx.x; j < n; j += step) {
    const FetchRow r = pkt(j / vecs);
    if (r.clear) t[r.row * vecs + j % vecs] = zero;
  }
}
