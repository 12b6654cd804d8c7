// Firewall ACL probe: blocked[i] = any(src_ip[i] == rules[k]).
//
// Replaces the TPU kernel repro/kernels/acl_match/kernel.py::acl_match_kernel
// (body _acl_kernel). The TPU version pads the rule list with -1 to its
// tile; here each block stages the rules in shared memory, 256 at a time,
// and every thread (one per packet) compares its address against them
// (acl_match.cuh, which the NF chain's kernel nf_chain.cu runs too: on the
// chain's path this standalone kernel no longer launches).
//
// Bound: bytes (4 read and 1 written per packet, plus the rules once per
// block); the compares are far below the card's integer rate.
#include <cstdint>
#include <cuda_runtime.h>

#include "acl_match.cuh"

namespace {

__global__ void acl_match_kernel(const int32_t* __restrict__ ip,
                                 const int32_t* __restrict__ rules,
                                 uint8_t* __restrict__ out, int64_t n,
                                 int r) {
  __shared__ int32_t tile[kAclRuleTile];
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int32_t v = i < n ? ip[i] : 0;
  bool hit = false;
  // every thread takes part in the staging, including those past n
  for (int base = 0; base < r; base += kAclRuleTile) {
    const int cnt = pp_acl_load_tile(rules, r, base, tile);
    __syncthreads();
    hit |= pp_acl_hit(v, tile, cnt);
    __syncthreads();
  }
  if (i < n) out[i] = hit ? 1 : 0;
}

}  // namespace

extern "C" int pp_acl_match(const void* ip, const void* rules, void* out,
                            int64_t n, int r, void* stream) {
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  acl_match_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ip), static_cast<const int32_t*>(rules),
      static_cast<uint8_t*>(out), n, r);
  return static_cast<int>(cudaGetLastError());
}
