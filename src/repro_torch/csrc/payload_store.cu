// Split stage 3..N: predicated row scatter table[idx[b]] = payload[b] where
// enb[b], in place, for P pipes at once.
//
// Replaces the TPU kernel
// repro/kernels/payload_store/kernel.py::payload_store_kernel (body
// _store_kernel). The TPU kernel walks the packets in order on one core, so
// a later packet overwrites an earlier one that names the same row. Here
// all rows are copied at once, and two writers to one row would tear it
// into a mix of two payloads. So the store runs in two passes: the first
// takes atomicMax of the packet index per row into an M-int scratch (one
// thread per packet), the second lets only that winner copy its row (one
// warp per packet, 16-byte vectors). The result is the sequential kernel's
// "last writer wins", whatever the order the blocks run in. The scratch,
// -1 everywhere, is allocated and filled by the caller.
//
// Indices follow the reference: a negative index counts from the end, an
// index out of [0, M) is dropped.
//
// Bound: bytes (each enabled row read once from the payload and written
// once to the table, plus 5 bytes of index and enable per packet). At
// 160-352-byte rows and 256-320 packets a call moves well under a
// megabyte, so its time is the two launches.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int64_t norm_row(int32_t r, int64_t m) {
  const int64_t x = r;
  return x < 0 ? x + m : x;
}

__global__ void payload_store_claim(const int32_t* __restrict__ idx,
                                    const uint8_t* __restrict__ enb,
                                    int32_t* __restrict__ winner, int64_t n,
                                    int64_t b, int64_t m) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n || !enb[i]) return;
  const int64_t row = norm_row(idx[i], m);
  if (row < 0 || row >= m) return;
  atomicMax(winner + (i / b) * m + row, static_cast<int32_t>(i % b));
}

__global__ void payload_store_copy(uint8_t* __restrict__ table,
                                   const uint8_t* __restrict__ payload,
                                   const int32_t* __restrict__ idx,
                                   const uint8_t* __restrict__ enb,
                                   const int32_t* __restrict__ winner,
                                   int64_t b, int64_t m, int64_t width) {
  const int64_t p = blockIdx.y;
  const int64_t k = blockIdx.x;
  // k is the same for every thread of the block, so these exits are uniform
  if (!enb[p * b + k]) return;
  const int64_t row = norm_row(idx[p * b + k], m);
  if (row < 0 || row >= m || winner[p * m + row] != k) return;
  const int64_t vecs = width / 16;
  const int4* src = reinterpret_cast<const int4*>(payload + (p * b + k) * width);
  int4* dst = reinterpret_cast<int4*>(table + (p * m + row) * width);
  for (int64_t v = threadIdx.x; v < vecs; v += blockDim.x) dst[v] = src[v];
}

}  // namespace

extern "C" int pp_payload_store(void* table, const void* payload,
                                const void* idx, const void* enb,
                                void* winner, int64_t pipes, int64_t b,
                                int64_t m, int64_t width, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t n = pipes * b;
  const int threads = 256;
  payload_store_claim<<<static_cast<unsigned>((n + threads - 1) / threads),
                        threads, 0, s>>>(
      static_cast<const int32_t*>(idx), static_cast<const uint8_t*>(enb),
      static_cast<int32_t*>(winner), n, b, m);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(b), static_cast<unsigned>(pipes));
  payload_store_copy<<<grid, 32, 0, s>>>(
      static_cast<uint8_t*>(table), static_cast<const uint8_t*>(payload),
      static_cast<const int32_t*>(idx), static_cast<const uint8_t*>(enb),
      static_cast<const int32_t*>(winner), b, m, width);
  return static_cast<int>(cudaGetLastError());
}
