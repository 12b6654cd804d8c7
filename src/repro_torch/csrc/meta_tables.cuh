// Three int32 tables of m rows (a pipe's expiry, generation and length,
// or a range of them) copied by one whole block. split_control.cu stages
// its block's range of them in shared memory (each slot's walker then
// writes the slot's row into the new tables); merge_stage.cu stages its
// block's range in shared memory and copies it out after the frees;
// nf_chain.cu copies NAT's (key_ip, key_port, exp) table into shared
// memory (where the copy engine cannot) and out again with it.
//
// The copy is bound by how many loads a block keeps in flight: every
// thread loads its share of all three tables (16-byte vectors when every
// pointer is aligned) before it stores any of it, so the copy costs about
// one trip to device memory.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

template <class T, int kUnroll>
__device__ __forceinline__ void copy_three(const T* const* src, T* const* dst,
                                           int64_t n) {
  for (int64_t base = threadIdx.x; base < n;
       base += static_cast<int64_t>(blockDim.x) * kUnroll) {
    T v[3][kUnroll];
#pragma unroll
    for (int t = 0; t < 3; ++t)
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t j = base + static_cast<int64_t>(u) * blockDim.x;
        if (j < n) v[t][u] = src[t][j];
      }
#pragma unroll
    for (int t = 0; t < 3; ++t)
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t j = base + static_cast<int64_t>(u) * blockDim.x;
        if (j < n) dst[t][j] = v[t][u];
      }
  }
}

// in[t] and out[t] point at this pipe's M words of table t.
__device__ __forceinline__ void copy_meta_tables(const int32_t* const in[3],
                                                 int32_t* const out[3],
                                                 int64_t m) {
  uintptr_t bits = 0;
  for (int t = 0; t < 3; ++t)
    bits |= reinterpret_cast<uintptr_t>(in[t]) |
            reinterpret_cast<uintptr_t>(out[t]);
  if (bits % 16 == 0 && m % 4 == 0) {
    const int4* vin[3] = {reinterpret_cast<const int4*>(in[0]),
                          reinterpret_cast<const int4*>(in[1]),
                          reinterpret_cast<const int4*>(in[2])};
    int4* vout[3] = {reinterpret_cast<int4*>(out[0]),
                     reinterpret_cast<int4*>(out[1]),
                     reinterpret_cast<int4*>(out[2])};
    copy_three<int4, 2>(vin, vout, m / 4);
  } else {
    copy_three<int32_t, 4>(in, out, m);
  }
}
