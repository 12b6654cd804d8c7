// Merge stage 3..N: gather row idx[b] where mask[b] (zeros elsewhere), then
// clear the gathered rows, in place, for P pipes at once.
//
// Replaces the TPU kernel
// repro/kernels/payload_fetch/kernel.py::payload_fetch_kernel (body
// _fetch_kernel). One block per pipe runs payload_fetch.cuh: the block
// copies every masked row out in 16-byte vectors (a masked-off packet
// writes a zero output row and never touches the table: Merge hands those
// rows over with pp_ti = 0 duplicates, which must neither read nor clear
// row 0), waits at a barrier, then clears the rows. Two masked packets can
// name one row: after Merge frees a slot its generation reads 0, so a
// second packet with a valid CRC and pp_clk = 0 matches it again. Both
// then receive the row, as in the plain version, which gathers every row
// before it clears any. (The earlier design copied and cleared per warp
// and raced there.) merge_stage.cu runs the same gather-then-clear.
//
// Indices follow the reference: a negative index counts from the end, an
// out-of-range read is clamped and an out-of-range clear is dropped.
//
// Bound: bytes (each masked row read once and written once as output and
// once as zeros; each masked-off row written once as zeros).
#include <cstdint>
#include <cuda_runtime.h>

#include "payload_fetch.cuh"

namespace {

constexpr int kThreads = 512;

__global__ void __launch_bounds__(kThreads)
    payload_fetch_kernel(uint8_t* table, const int32_t* __restrict__ idx,
                         const uint8_t* __restrict__ mask,
                         uint8_t* __restrict__ out, int64_t b, int64_t m,
                         int64_t width) {
  const int64_t p = blockIdx.x;
  const int32_t* ip = idx + p * b;
  const uint8_t* mp = mask + p * b;
  gather_then_clear(table + p * m * width, out + p * b * width, b, width,
                    [=](int64_t i) {
                      int64_t r = ip[i];
                      if (r < 0) r += m;
                      const bool on = mp[i] != 0;
                      return FetchRow{r < 0 ? 0 : (r >= m ? m - 1 : r), i,
                                      on, on && r >= 0 && r < m};
                    });
}

}  // namespace

extern "C" int pp_payload_fetch(void* table, const void* idx,
                                const void* mask, void* out, int64_t pipes,
                                int64_t b, int64_t m, int64_t width,
                                void* stream) {
  payload_fetch_kernel<<<static_cast<unsigned>(pipes), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(table), static_cast<const int32_t*>(idx),
      static_cast<const uint8_t*>(mask), static_cast<uint8_t*>(out), b, m,
      width);
  return static_cast<int>(cudaGetLastError());
}
