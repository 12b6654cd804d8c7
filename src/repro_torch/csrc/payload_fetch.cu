// Merge stage 3..N: gather row idx[b] where mask[b] (zeros elsewhere), then
// clear the gathered rows, in place, for P pipes at once.
//
// Replaces the TPU kernel
// repro/kernels/payload_fetch/kernel.py::payload_fetch_kernel (body
// _fetch_kernel). One warp per packet: a masked-off packet writes a zero
// output row and never touches the table (Merge hands those rows over
// with pp_ti = 0 duplicates, which must neither read nor clear row 0); a
// matched packet copies its row out in 16-byte vectors and zeroes each
// vector right after reading it. Matched rows are unique by construction
// (Merge's generation check frees the slot, so a second packet with the
// same tag fails it), so no two warps touch one row.
//
// Indices follow the reference: a negative index counts from the end, an
// out-of-range read is clamped and an out-of-range clear is dropped.
//
// Bound: bytes (each matched row read once and written once as output and
// once as zeros; each masked-off row written once as zeros).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void payload_fetch_kernel(uint8_t* __restrict__ table,
                                     const int32_t* __restrict__ idx,
                                     const uint8_t* __restrict__ mask,
                                     uint8_t* __restrict__ out, int64_t b,
                                     int64_t m, int64_t width) {
  const int64_t p = blockIdx.y;
  const int64_t k = blockIdx.x;
  const int64_t vecs = width / 16;
  int4* o = reinterpret_cast<int4*>(out + (p * b + k) * width);
  const int4 zero = make_int4(0, 0, 0, 0);
  if (!mask[p * b + k]) {
    for (int64_t v = threadIdx.x; v < vecs; v += blockDim.x) o[v] = zero;
    return;
  }
  int64_t row = idx[p * b + k];
  if (row < 0) row += m;
  const bool clear = row >= 0 && row < m;
  const int64_t rd = row < 0 ? 0 : (row >= m ? m - 1 : row);
  int4* t = reinterpret_cast<int4*>(table + (p * m + rd) * width);
  for (int64_t v = threadIdx.x; v < vecs; v += blockDim.x) {
    o[v] = t[v];
    if (clear) t[v] = zero;
  }
}

}  // namespace

extern "C" int pp_payload_fetch(void* table, const void* idx,
                                const void* mask, void* out, int64_t pipes,
                                int64_t b, int64_t m, int64_t width,
                                void* stream) {
  const dim3 grid(static_cast<unsigned>(b), static_cast<unsigned>(pipes));
  payload_fetch_kernel<<<grid, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(table), static_cast<const int32_t*>(idx),
      static_cast<const uint8_t*>(mask), static_cast<uint8_t*>(out), b, m,
      width);
  return static_cast<int>(cudaGetLastError());
}
