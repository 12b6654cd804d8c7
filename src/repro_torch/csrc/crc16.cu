// CRC-16/CCITT-FALSE over the PayloadPark tag, one thread per packet.
//
// Replaces the TPU kernel repro/kernels/crc16/kernel.py::crc16_kernel
// (body _crc_kernel): the same bitwise CRC (poly 0x1021, init 0xFFFF) over
// the 4 little-endian tag bytes (ti lo, ti hi, clk lo, clk hi), in
// crc16.cuh. Split and Merge run that function inside their control
// kernels (split_control.cu, merge_stage.cu); this standalone kernel is
// the crc16_tag primitive.
//
// Bound: bytes. Each packet reads 8 bytes and writes 4; the 32 shift/xor
// steps are register work far below the card's integer rate. Threads read
// and write neighbouring int32 words, so each warp moves whole 128-byte
// lines; a 256-packet call is one block and costs a launch, nothing more.
#include <cstdint>
#include <cuda_runtime.h>

#include "crc16.cuh"

namespace {

__global__ void crc16_tag_kernel(const int32_t* __restrict__ ti,
                                 const int32_t* __restrict__ clk,
                                 int32_t* __restrict__ out, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = static_cast<int32_t>(pp_tag_crc16(ti[i], clk[i]));
}

}  // namespace

extern "C" int pp_crc16_tag(const void* ti, const void* clk, void* out,
                            int64_t n, void* stream) {
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  crc16_tag_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ti), static_cast<const int32_t*>(clk),
      static_cast<int32_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
