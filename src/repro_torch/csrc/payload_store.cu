// Split stage 3..N: predicated row scatter table[idx[b]] = payload[b] where
// enb[b], in place, for P pipes at once.
//
// Replaces the TPU kernel
// repro/kernels/payload_store/kernel.py::payload_store_kernel (body
// _store_kernel). The TPU kernel walks the packets in order on one core, so
// a later packet overwrites an earlier one that names the same row. Here
// the packets' rows are copied in parallel, and two writers to one row
// would tear it into a mix of two payloads. So a packet copies its row
// only if no later enabled packet of its pipe names the same row: the
// sequential kernel's "last writer wins", whatever the order the blocks
// run in, in one launch and without scratch.
//
// Grid (ceil(B / 8), P), 256 threads: one warp per packet, 8 packets per
// block. A launch covers B consecutive packets of each pipe, whose arrays
// hold ``stride`` packets a pipe: the wrapper (kernels/payload_store.py)
// launches a batch past the block's shared memory as consecutive tiles of
// at most 12288 packets, in arrival order on one stream, so a later tile's
// writer overwrites an earlier tile's, as the sequential kernel does. Each block first stages its pipe's target rows for the packets
// from its first packet to B - 1 into shared memory as int32 (-1 for a
// disabled packet or a row out of range). A packet's warp then scans the
// later packets' rows 32 at a time with __any_sync and, if none matches,
// copies its row in 16-byte vectors, one per lane.
//
// Indices follow the reference: a negative index counts from the end, an
// index out of [0, M) is dropped.
//
// Bound: bytes (each enabled row read once from the payload and written
// once to the table, plus 5 bytes of index and enable per packet). At
// 160-352-byte rows and 256-320 packets a call moves well under a
// megabyte, so its time is the launch. The earlier design took
// three launches per call, a fill of an M-int winner scratch, an
// atomicMax claim pass and the copy pass: 0.010496 ms against
// index_copy_'s 0.006704 ms (8 pipes x 256 packets, M 4096, W 160; NVIDIA
// H100 80GB HBM3, 700.00 W; PERF.md section 6).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;  // packets per block, one warp each
constexpr int kThreads = 32 * kWarps;

__global__ void __launch_bounds__(kThreads)
    payload_store_kernel(uint8_t* __restrict__ table,
                         const uint8_t* __restrict__ payload,
                         const int32_t* __restrict__ idx,
                         const uint8_t* __restrict__ enb, int64_t b,
                         int64_t stride, int64_t m, int64_t width) {
  extern __shared__ int32_t rows[];  // rows of packets first .. b - 1
  const int64_t p = blockIdx.y;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kWarps;
  const int n = static_cast<int>(b - first);
  const int32_t* ip = idx + p * stride + first;
  const uint8_t* ep = enb + p * stride + first;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    int64_t r = ip[i];
    if (r < 0) r += m;
    rows[i] = ep[i] && r >= 0 && r < m ? static_cast<int32_t>(r) : -1;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= n) return;
  const int32_t row = rows[warp];
  if (row < 0) return;
  // a later enabled packet naming the same row overwrites this one
  for (int j0 = warp + 1; j0 < n; j0 += 32) {
    const int j = j0 + lane;
    if (__any_sync(0xffffffffu, j < n && rows[j] == row)) return;
  }
  const int64_t vecs = width / 16;
  const int4* src =
      reinterpret_cast<const int4*>(payload + (p * stride + first + warp) *
                                               width);
  int4* dst = reinterpret_cast<int4*>(table + (p * m + row) * width);
  for (int64_t v = lane; v < vecs; v += 32) dst[v] = src[v];
}

}  // namespace

// The caller keeps b within the shared memory of a block (4 bytes a packet,
// 48 KB) and m below 2**31; payload, idx and enb hold ``stride`` packets a
// pipe, of which this call stores the first b (the pointers name a tile).
extern "C" int pp_payload_store(void* table, const void* payload,
                                const void* idx, const void* enb,
                                int64_t pipes, int64_t b, int64_t stride,
                                int64_t m, int64_t width, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>((b + kWarps - 1) / kWarps),
                  static_cast<unsigned>(pipes));
  const size_t shared = sizeof(int32_t) * static_cast<size_t>(b);
  payload_store_kernel<<<grid, kThreads, shared, s>>>(
      static_cast<uint8_t*>(table), static_cast<const uint8_t*>(payload),
      static_cast<const int32_t*>(idx), static_cast<const uint8_t*>(enb), b,
      stride, m, width);
  return static_cast<int>(cudaGetLastError());
}
