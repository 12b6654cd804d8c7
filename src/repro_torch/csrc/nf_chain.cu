// The NF chain's header pass (paper §6.1, §7: Firewall -> NAT -> Maglev LB,
// and the MAC swapper), one block per pipe, in one launch.
//
// Replaces the TPU kernel repro/kernels/acl_match/kernel.py::acl_match_kernel
// and the TPU kernel repro/kernels/maglev/kernel.py::maglev_kernel on the
// chain's path: their device code (acl_match.cuh, maglev.cuh) runs here as
// the firewall and LB stages,
// beside the NAT insert walk that the reference runs as a lax.scan over
// packets (repro/nf/nat.py). Its plain version is
// repro_torch/backend/ref.py::nf_chain.
//
// The header fields that a stage writes are copied to the outputs first; a
// field that no stage of the launch writes arrives with its output pointer
// equal to its input (the wrapper returns the input tensor, as the plain
// version does) and is neither copied nor written. Then the stages run in
// chain order on the outputs, with a barrier between stages:
//   fw       each thread takes its packets; rule tiles staged in shared
//            memory; a blocked packet is dropped and dies.
//   nat      the pipe's (key_ip, key_port, exp) table is copied into shared
//            memory (or, past MAX_SHARED bytes, into the output tensors,
//            where it is walked in device memory). Then one warp walks the
//            packets in arrival order, 32 at a time: lane j loads packet
//            base + j and its hash, and for each packet the lanes 0-7 read
//            the 8 probe slots; three ballots give the first live match, the
//            first stale match and the first free slot (the lowest probe
//            position, so the window wraps at the table's end as in the
//            plain version); one lane writes the insert, refresh or
//            tear-down, or the 8 lanes age their slots (CLOCK). A
//            __syncwarp() orders each packet's writes before the next
//            packet's reads, so a second packet of a flow sees the first's
//            insert. Dead packets touch nothing. After each 32 packets the
//            lanes rewrite their own packet (src_ip, src_port) or drop it.
//            Then the table is copied out into the new tensors.
//   lb       each thread hashes its packets' rewritten 5-tuple (maglev.cuh)
//            and reads the live or, where the pipe's flag is down, the
//            degraded table through the read-only cache.
//   macswap  each thread swaps its live packets' MACs.
// The stage list arrives as descriptors in the kernel's parameters, at most
// kMaxStages; the wrapper splits a longer chain into consecutive launches.
//
// Bound: bytes. Per call each NAT table is read and written once (2 x 12 B
// a slot), the header fields that the stages read are read once and those
// they write written once (FW -> NAT: alive, src_ip and src_port, 9 B each
// way a packet) and the drops written (1 B). At 8 pipes x 256 packets and
// capacity 4096 that is ~0.83 MB, ~0.25 us at 3.35 TB/s. The walk's 256-320
// dependent steps a pipe (shuffles, shared-memory reads, ballots) set the
// time instead: one block per pipe leaves most SMs idle.
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "acl_match.cuh"
#include "maglev.cuh"
#include "meta_tables.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kMaxStages = 8;  // MAX_STAGES in kernels/nf_chain.py
constexpr int kProbe = 8;      // NAT_PROBE_DEPTH
constexpr unsigned kFull = 0xffffffffu;

enum Kind : int64_t { kFw = 0, kNat = 1, kLb = 2, kMacSwap = 3 };

// One stage as the wrapper writes it (NF_KINDS order for the kind):
//   fw       ptr: rules                      val: R
//   nat      ptr: key_ip, key_port, exp in; key_ip, key_port, exp out;
//                 stale_hits in, out         val: C, base_port, max_exp,
//                                                 nat_ip, staged
//   lb       ptr: table, backend_ips, table_down, up (bool; null: live)
//                                            val: T, up stride (0 or 1)
//   macswap  -
struct StageDesc {
  int64_t kind;
  int64_t ptr[8];
  int64_t val[6];
};
static_assert(sizeof(StageDesc) == 15 * 8, "descriptor words");

enum Field { kSrcIp, kDstIp, kSrcPort, kDstPort, kProto, kSrcMac, kDstMac };

struct ChainArgs {
  const uint8_t* alive_in;  // (P, B)
  const int32_t* in[7];     // the Field order
  const uint8_t* dropped_in;  // null: nothing dropped yet
  uint8_t* alive;
  int32_t* f[7];
  uint8_t* dropped;
  int64_t b;
  int n_stages;
  StageDesc stage[kMaxStages];
};

template <class T>
__device__ __forceinline__ T* as(int64_t p) {
  return reinterpret_cast<T*>(p);
}

// The packet of one pipe: pointers into the outputs at pipe p.
struct Pipe {
  uint8_t* alive;
  int32_t* f[7];
  uint8_t* dropped;
  int64_t b, p;
};

__device__ void fw_stage(const StageDesc& st, const Pipe& x,
                         int32_t* tile) {
  const int32_t* rules = as<const int32_t>(st.ptr[0]);
  const int r = static_cast<int>(st.val[0]);
  for (int base = 0; base < r; base += kAclRuleTile) {
    const int cnt = pp_acl_load_tile(rules, r, base, tile);
    __syncthreads();
    for (int64_t i = threadIdx.x; i < x.b; i += blockDim.x) {
      if (x.alive[i] && pp_acl_hit(x.f[kSrcIp][i], tile, cnt)) {
        x.alive[i] = 0;
        x.dropped[i] = 1;
      }
    }
    __syncthreads();
  }
}

// NAT's flow hash (backend/ref.py::nat_hash, NAT_HASH_CONSTS): int32 with
// wrapping multiplies and an arithmetic shift, then (h & 0x7FFFFFFF) mod C.
constexpr int32_t kNatSeed = -1640531527;  // 0x9E3779B9
constexpr int32_t kNatMul1 = -2048144789;  // 0x85EBCA6B
constexpr int32_t kNatMul2 = -1028477379;  // 0xC2B2AE3D

__device__ __forceinline__ int32_t nat_hash(int32_t ip, int32_t port,
                                            uint32_t cap) {
  int32_t h = ip ^ kNatSeed;
  h = static_cast<int32_t>(static_cast<uint32_t>(h) *
                           static_cast<uint32_t>(kNatMul1)) ^ port;
  h = h ^ (h >> 13);
  h = static_cast<int32_t>(static_cast<uint32_t>(h) *
                           static_cast<uint32_t>(kNatMul2));
  return static_cast<int32_t>((static_cast<uint32_t>(h) & 0x7FFFFFFFu) % cap);
}

// Warp 0 only: the walk over the pipe's packets in arrival order, on the
// table at kip / kport / kexp (shared or device memory), and the rewrite.
// Returns the number of stale hits (the same on every lane).
__device__ int32_t nat_walk(int32_t* kip, int32_t* kport, int32_t* kexp,
                            uint32_t cap, int32_t base_port, int32_t max_exp,
                            int32_t nat_ip, const Pipe& x) {
  const int lane = threadIdx.x & 31;
  int32_t stale = 0;
  for (int64_t base = 0; base < x.b; base += 32) {
    const int64_t mine = base + lane;
    const bool have = mine < x.b;
    const int32_t my_ip = have ? x.f[kSrcIp][mine] : 0;
    const int32_t my_port = have ? x.f[kSrcPort][mine] : 0;
    const int my_alive = have ? x.alive[mine] : 0;
    const int32_t my_h = nat_hash(my_ip, my_port, cap);
    int32_t my_mapped = -1;
    const int n = static_cast<int>(x.b - base < 32 ? x.b - base : 32);
    for (int k = 0; k < n; ++k) {
      if (!__shfl_sync(kFull, my_alive, k)) continue;  // uniform
      const int32_t ip = __shfl_sync(kFull, my_ip, k);
      const int32_t port = __shfl_sync(kFull, my_port, k);
      const uint32_t h = static_cast<uint32_t>(__shfl_sync(kFull, my_h, k));
      const bool probe = lane < kProbe;
      uint32_t slot = h + static_cast<uint32_t>(lane);
      if (slot >= cap) slot -= cap;  // cap >= kProbe: one wrap at most
      int32_t ki = 0, kp = 0, ex = 0;
      if (probe) {
        ki = kip[slot];
        kp = kport[slot];
        ex = kexp[slot];
      }
      const bool live = ex > 0;
      const bool match = ki == ip && kp == port;
      const unsigned hit = __ballot_sync(kFull, probe && live && match);
      const unsigned gone = __ballot_sync(kFull, probe && !live && match);
      const unsigned vacant = __ballot_sync(kFull, probe && !live);
      int32_t mapped = -1;
      if (hit | vacant) {
        // a hit refreshes its binding; a stale hit (its binding aged out:
        // gone implies vacant) tears the binding down, keys -1 and expiry
        // kept; otherwise the first vacant slot takes the flow
        const unsigned w = hit ? hit : (gone ? gone : vacant);
        const int pw = __ffs(static_cast<int>(w)) - 1;
        if (lane == pw) {
          if (!hit && gone) {
            kip[slot] = -1;
            kport[slot] = -1;
          } else {
            if (!hit) {
              kip[slot] = ip;
              kport[slot] = port;
            }
            kexp[slot] = max_exp;
          }
        }
        uint32_t s = h + static_cast<uint32_t>(pw);
        if (s >= cap) s -= cap;
        if (hit || !gone) mapped = base_port + static_cast<int32_t>(s);
        stale += !hit && gone;
      } else if (probe) {
        kexp[slot] = ex > 0 ? ex - 1 : 0;  // exhausted: CLOCK ages the window
      }
      if (lane == k) my_mapped = mapped;
      __syncwarp();
    }
    if (have && my_alive) {
      if (my_mapped >= 0) {
        x.f[kSrcIp][mine] = nat_ip;
        x.f[kSrcPort][mine] = my_mapped;
      } else {
        x.alive[mine] = 0;
        x.dropped[mine] = 1;
      }
    }
  }
  return stale;
}

__device__ void nat_stage(const StageDesc& st, const Pipe& x,
                          int32_t* smem) {
  const int64_t cap = st.val[0];
  const bool staged = st.val[4] != 0;
  const int64_t off = x.p * cap;
  const int32_t* const in[3] = {as<const int32_t>(st.ptr[0]) + off,
                                as<const int32_t>(st.ptr[1]) + off,
                                as<const int32_t>(st.ptr[2]) + off};
  int32_t* const out[3] = {as<int32_t>(st.ptr[3]) + off,
                           as<int32_t>(st.ptr[4]) + off,
                           as<int32_t>(st.ptr[5]) + off};
  int32_t* const tab[3] = {staged ? smem : out[0],
                           staged ? smem + cap : out[1],
                           staged ? smem + 2 * cap : out[2]};
  copy_meta_tables(in, tab, cap);
  __syncthreads();
  if (threadIdx.x < 32) {
    const int32_t stale = nat_walk(
        tab[0], tab[1], tab[2], static_cast<uint32_t>(cap),
        static_cast<int32_t>(st.val[1]), static_cast<int32_t>(st.val[2]),
        static_cast<int32_t>(st.val[3]), x);
    if (threadIdx.x == 0)
      as<int32_t>(st.ptr[7])[x.p] = as<const int32_t>(st.ptr[6])[x.p] + stale;
  }
  __syncthreads();
  if (staged) copy_meta_tables(tab, out, cap);
}

__device__ void lb_stage(const StageDesc& st, const Pipe& x) {
  const uint8_t* up = as<const uint8_t>(st.ptr[3]);
  const bool down = up != nullptr && !up[x.p * st.val[1]];
  const int32_t* tab = as<const int32_t>(down ? st.ptr[2] : st.ptr[0]);
  const int32_t* bips = as<const int32_t>(st.ptr[1]);
  const int t = static_cast<int>(st.val[0]);
  for (int64_t i = threadIdx.x; i < x.b; i += blockDim.x) {
    if (!x.alive[i]) continue;
    const uint32_t slot =
        pp_maglev_slot(x.f[kSrcIp][i], x.f[kDstIp][i], x.f[kSrcPort][i],
                       x.f[kDstPort][i], x.f[kProto][i], t);
    x.f[kDstIp][i] = __ldg(bips + __ldg(tab + slot));
  }
}

__device__ void macswap_stage(const Pipe& x) {
  for (int64_t i = threadIdx.x; i < x.b; i += blockDim.x) {
    if (!x.alive[i]) continue;
    const int32_t s = x.f[kSrcMac][i];
    x.f[kSrcMac][i] = x.f[kDstMac][i];
    x.f[kDstMac][i] = s;
  }
}

__global__ void __launch_bounds__(kThreads)
    nf_chain_kernel(const __grid_constant__ ChainArgs a) {
  extern __shared__ int4 nat_table[];  // 3 x C words when staged
  __shared__ int32_t rule_tile[kAclRuleTile];
  const int64_t p = blockIdx.x;
  const int64_t pb = p * a.b;
  Pipe x;
  x.alive = a.alive + pb;
  for (int k = 0; k < 7; ++k) x.f[k] = a.f[k] + pb;
  x.dropped = a.dropped + pb;
  x.b = a.b;
  x.p = p;
  const bool copy_alive = a.alive != a.alive_in;
  bool copy[7];
  for (int k = 0; k < 7; ++k) copy[k] = a.f[k] != a.in[k];
  for (int64_t i = threadIdx.x; i < a.b; i += blockDim.x) {
    if (copy_alive) x.alive[i] = a.alive_in[pb + i];
    for (int k = 0; k < 7; ++k)
      if (copy[k]) x.f[k][i] = a.in[k][pb + i];
    x.dropped[i] = a.dropped_in != nullptr ? a.dropped_in[pb + i] : 0;
  }
  for (int s = 0; s < a.n_stages; ++s) {
    __syncthreads();  // the previous stage's writes, by any thread
    const StageDesc& st = a.stage[s];
    switch (st.kind) {
      case kFw:
        fw_stage(st, x, rule_tile);
        break;
      case kNat:
        nat_stage(st, x, reinterpret_cast<int32_t*>(nat_table));
        break;
      case kLb:
        lb_stage(st, x);
        break;
      default:
        macswap_stage(x);
        break;
    }
  }
}

}  // namespace

extern "C" int pp_nf_chain(
    const void* alive_in, const void* sip_in, const void* dip_in,
    const void* sp_in, const void* dp_in, const void* proto_in,
    const void* smac_in, const void* dmac_in, void* alive, void* sip,
    void* dip, void* sp, void* dp, void* proto, void* smac, void* dmac,
    const void* dropped_in, void* dropped, const void* stages, int n_stages,
    int64_t pipes, int64_t b, int64_t shared_bytes, void* stream) {
  if (n_stages < 0 || n_stages > kMaxStages)
    return static_cast<int>(cudaErrorInvalidValue);
  ChainArgs a;
  a.alive_in = static_cast<const uint8_t*>(alive_in);
  const void* in[7] = {sip_in, dip_in, sp_in, dp_in, proto_in, smac_in,
                       dmac_in};
  void* out[7] = {sip, dip, sp, dp, proto, smac, dmac};
  for (int k = 0; k < 7; ++k) {
    a.in[k] = static_cast<const int32_t*>(in[k]);
    a.f[k] = static_cast<int32_t*>(out[k]);
  }
  a.dropped_in = static_cast<const uint8_t*>(dropped_in);
  a.alive = static_cast<uint8_t*>(alive);
  a.dropped = static_cast<uint8_t*>(dropped);
  a.b = b;
  a.n_stages = n_stages;
  std::memset(a.stage, 0, sizeof(a.stage));
  std::memcpy(a.stage, stages, sizeof(StageDesc) * n_stages);
  // past 48 KB of shared memory (the static rule tile included) a block
  // needs the kernel's opt-in, which holds for the current device only;
  // raise it whenever a call on that device needs more
  constexpr int kMaxDevices = 64;
  static int64_t opted_in[kMaxDevices] = {};
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const bool known = device < kMaxDevices;
  if (!known || shared_bytes > opted_in[device]) {
    e = cudaFuncSetAttribute(nf_chain_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(shared_bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
    if (known) opted_in[device] = shared_bytes;
  }
  nf_chain_kernel<<<static_cast<unsigned>(pipes), kThreads,
                    static_cast<size_t>(shared_bytes),
                    static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
