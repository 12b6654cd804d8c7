// Maglev L4-LB backend selection as device code: the 5-tuple hash
//   h = src_ip; h = h * 1000003 ^ v for v in (dst_ip, src_port, dst_port,
//   proto); h &= 0x7FFFFFFF
// and the table slot h % T.
//
// The body of the TPU kernel repro/kernels/maglev/kernel.py::maglev_kernel
// (_maglev_kernel). The hash runs in uint32_t, so the multiply wraps
// exactly as the reference's int32 arithmetic; h & 0x7FFFFFFF is
// non-negative, so % needs no sign fix. maglev.cu runs it one thread per
// packet; nf_chain.cu runs it as the LB stage of the NF chain, on the
// header NAT has rewritten.
#pragma once

#include <cstdint>

__device__ __forceinline__ uint32_t pp_maglev_slot(int32_t sip, int32_t dip,
                                                   int32_t sp, int32_t dp,
                                                   int32_t proto, int t) {
  uint32_t h = static_cast<uint32_t>(sip);
  h = h * 1000003u ^ static_cast<uint32_t>(dip);
  h = h * 1000003u ^ static_cast<uint32_t>(sp);
  h = h * 1000003u ^ static_cast<uint32_t>(dp);
  h = h * 1000003u ^ static_cast<uint32_t>(proto);
  h &= 0x7FFFFFFFu;
  return h % static_cast<uint32_t>(t);
}
