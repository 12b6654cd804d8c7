// Maglev L4-LB backend selection, one thread per packet:
//   h = src_ip; h = h * 1000003 ^ v for v in (dst_ip, src_port, dst_port,
//   proto); h &= 0x7FFFFFFF; out = backend_ips[table[h % T]].
//
// Replaces the TPU kernel repro/kernels/maglev/kernel.py::maglev_kernel
// (body _maglev_kernel). The TPU version keeps the (1, T) lookup table and
// the backend list resident in VMEM while (N, 128) packet tiles stream by.
// Here the grid is (packet blocks, pipes): each block serves the packets of
// one pipe and reads that pipe's table, at table + pipe * table_stride
// (stride 0 when every pipe shares one table, T when a fault gives each
// pipe its own live-or-degraded row). A table that fits the default 48 KB
// of shared memory (T <= 12288, the paper's 251 included) is staged there
// once per block; a larger one (Maglev's production 65537 is 256 KB, above
// the 227 KB a block may hold) is read through the read-only cache. The
// hash and the slot are maglev.cuh's, which the NF chain's kernel
// nf_chain.cu runs too: on the chain's path this standalone kernel no
// longer launches.
//
// Bound: bytes. Each packet reads five int32 fields and writes one (24 B),
// plus the table and backend list once; the hash is ~10 integer operations
// per packet, far below the card's integer rate. At the chain's 2 x
// 256..320 packets a call is a few blocks and costs about a launch.
#include <cstdint>
#include <cuda_runtime.h>

#include "maglev.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int64_t kSharedEntries = 48 * 1024 / 4;

template <bool kStaged>
__global__ void maglev_kernel(const int32_t* __restrict__ sip,
                              const int32_t* __restrict__ dip,
                              const int32_t* __restrict__ sp,
                              const int32_t* __restrict__ dp,
                              const int32_t* __restrict__ proto,
                              const int32_t* __restrict__ table,
                              int64_t table_stride, int t,
                              const int32_t* __restrict__ bips,
                              int32_t* __restrict__ out, int64_t b) {
  extern __shared__ int32_t staged[];
  const int64_t pipe = blockIdx.y;
  const int32_t* tab = table + pipe * table_stride;
  if (kStaged) {
    for (int k = threadIdx.x; k < t; k += blockDim.x) staged[k] = tab[k];
    __syncthreads();
  }
  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= b) return;
  const int64_t i = pipe * b + j;
  const uint32_t slot =
      pp_maglev_slot(sip[i], dip[i], sp[i], dp[i], proto[i], t);
  const int32_t backend = kStaged ? staged[slot] : __ldg(tab + slot);
  out[i] = __ldg(bips + backend);
}

}  // namespace

extern "C" int pp_maglev_select(const void* sip, const void* dip,
                                const void* sp, const void* dp,
                                const void* proto, const void* table,
                                int64_t table_stride, int t, const void* bips,
                                void* out, int64_t pipes, int64_t b,
                                void* stream) {
  const dim3 grid(static_cast<unsigned>((b + kThreads - 1) / kThreads),
                  static_cast<unsigned>(pipes));
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* a = static_cast<const int32_t*>(sip);
  const auto* c = static_cast<const int32_t*>(dip);
  const auto* d = static_cast<const int32_t*>(sp);
  const auto* e = static_cast<const int32_t*>(dp);
  const auto* f = static_cast<const int32_t*>(proto);
  const auto* tab = static_cast<const int32_t*>(table);
  const auto* bi = static_cast<const int32_t*>(bips);
  auto* o = static_cast<int32_t*>(out);
  if (t <= kSharedEntries) {
    maglev_kernel<true><<<grid, kThreads, static_cast<size_t>(t) * 4, s>>>(
        a, c, d, e, f, tab, table_stride, t, bi, o, b);
  } else {
    maglev_kernel<false><<<grid, kThreads, 0, s>>>(
        a, c, d, e, f, tab, table_stride, t, bi, o, b);
  }
  return static_cast<int>(cudaGetLastError());
}
