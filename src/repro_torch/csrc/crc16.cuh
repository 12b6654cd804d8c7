// CRC-16/CCITT-FALSE over the PayloadPark tag, as one device function.
//
// The body of the TPU kernel repro/kernels/crc16/kernel.py::crc16_kernel
// (_crc_kernel): the CRC (poly 0x1021, init 0xFFFF) over the 4
// little-endian tag bytes (ti lo, ti hi, clk lo, clk hi). Byte at a time:
// the 8 bit steps of a byte fold into x = high byte ^ byte, x ^= x >> 4,
// crc = (crc << 8) ^ (x << 12) ^ (x << 5) ^ x, which is the bitwise CRC's
// result exactly (the polynomial's terms below x^16 are x^12, x^5 and 1)
// in 12 operations a byte instead of 8 dependent bit steps. crc16.cu runs it
// one thread per packet; split_control.cu stamps Split's tags and
// merge_stage.cu checks Merge's tags with the same function.
#pragma once

#include <cstdint>

__device__ __forceinline__ uint32_t pp_tag_crc16(int32_t ti, int32_t clk) {
  const uint32_t t = static_cast<uint32_t>(ti);
  const uint32_t c = static_cast<uint32_t>(clk);
  const uint32_t bytes[4] = {t & 0xFFu, (t >> 8) & 0xFFu, c & 0xFFu,
                             (c >> 8) & 0xFFu};
  uint32_t crc = 0xFFFFu;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    uint32_t x = ((crc >> 8) ^ bytes[k]) & 0xFFu;
    x ^= x >> 4;
    crc = ((crc << 8) ^ (x << 12) ^ (x << 5) ^ x) & 0xFFFFu;
  }
  return crc;
}
