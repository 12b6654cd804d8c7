// Firewall ACL probe as device code: is a source address among the rules?
//
// The body of the TPU kernel repro/kernels/acl_match/kernel.py::
// acl_match_kernel (_acl_kernel), without its -1 rule padding (a TPU tiling
// artifact). The block stages the rules in shared memory, kAclRuleTile at a
// time, and each thread compares its packets' addresses against the tile: a
// shared-memory read of one word by the whole warp is a broadcast, so the
// R <= 20 rules of the paper's chains cost R register compares per packet.
// acl_match.cu runs it one thread per packet; nf_chain.cu runs it as the
// firewall stage of the NF chain.
#pragma once

#include <cstdint>

constexpr int kAclRuleTile = 256;

// Copies rules [base, base + count) into tile, with every thread of the
// block taking part, and returns count. A __syncthreads() must follow
// before the tile is read, and another before the next tile is loaded.
__device__ __forceinline__ int pp_acl_load_tile(const int32_t* rules, int r,
                                                int base, int32_t* tile) {
  const int cnt = min(kAclRuleTile, r - base);
  for (int k = threadIdx.x; k < cnt; k += blockDim.x) tile[k] = rules[base + k];
  return cnt;
}

__device__ __forceinline__ bool pp_acl_hit(int32_t v, const int32_t* tile,
                                           int cnt) {
  bool hit = false;
  for (int k = 0; k < cnt; ++k) hit |= (tile[k] == v);
  return hit;
}
