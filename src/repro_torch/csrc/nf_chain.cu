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
//            where it is walked in device memory), then walked in waves of
//            packets whose probe windows are disjoint, then copied out into
//            the new tensors.
//   lb       each thread hashes its packets' rewritten 5-tuple (maglev.cuh)
//            and reads the live or, where the pipe's flag is down, the
//            degraded table through the read-only cache.
//   macswap  each thread swaps its live packets' MACs.
// The stage list arrives as descriptors in the kernel's parameters, at most
// kMaxStages; the wrapper splits a longer chain into consecutive launches.
//
// NAT's walk. A packet reads and writes only its 8 probe slots
// [h, h + 8) mod C (the insert, the refresh, the tear-down and CLOCK's
// ageing), so two packets whose windows are disjoint commute, and only a
// chain of overlapping windows has to keep arrival order. The block takes
// the packets in arrival-order chunks of kChunk (exact: chunks keep the
// order). For a chunk, each live packet joins the chain of its hash
// bucket h / 8, and finds the earlier live packets whose window overlaps
// its own ((h_j - h_i) mod C < 8 or (h_i - h_j) mod C < 8: every pair when
// C < 16) in the chains of the buckets next to its own: a 256-bit mask.
// Then rounds: a packet none of whose masked packets
// is still pending is ready; the ready packets are one wave (1 + the
// largest wave of its overlapping earlier packets,
// backend/ref.py::nat_waves), walked in the round that finds them, and the
// round's one barrier orders its table writes before the next round's
// reads. Each warp lists its ready packets and its four groups of 8 lanes
// walk them, four at a time, every lane of the warp in step (a step is a
// chain of dependent instructions, so divergent groups would run one
// after another): each lane reads one probe slot, three ballots give the
// first live match, the first stale match and the first free slot (the
// lowest probe position, so the window wraps at the table's end as in the
// plain version), and one lane writes the insert, refresh or tear-down,
// or the 8 lanes age their slots (CLOCK). After the last round each
// packet is rewritten (src_ip, src_port) or dropped. Dead packets take no
// wave and touch nothing. One flow repeated is the worst case: one packet
// a wave, as the old one-warp walk in arrival order.
//
// The table copies. A table of 16-byte aligned rows (C a multiple of 4)
// comes in by the Tensor Memory Accelerator: one thread asks for the three
// C x 4-byte copies into shared memory, completing on an mbarrier (for the
// launch's first NAT stage at the kernel's start, so that the copy overlaps
// the header copies, the stages before NAT and the chunk's schedule; the
// walk waits for it). Another table, and every table going out, takes the
// plain copy of meta_tables.cuh: a bulk copy out would make the block wait,
// before it may exit, for the copy engine to have read its shared memory,
// which took longer than the plain stores.
//
// Bound: bytes. Per call each NAT table is read and written once (2 x 12 B
// a slot), the header fields that the stages read are read once and those
// they write written once (FW -> NAT: alive, src_ip and src_port, 9 B each
// way a packet) and the drops written (1 B). At 8 pipes x 256 packets and
// capacity 4096 that is ~0.83 MB, ~0.25 us at 3.35 TB/s. What sets the
// time is a pipe's chain of dependent steps: the launch, the header copies
// and the firewall, the table's trip through the copy engine, the
// schedule (two barriers and a short chain walk) and, per wave, one
// barrier and up to kChunk / 64 walk steps; one block per pipe leaves
// most SMs idle.
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
constexpr int kChunk = 256;    // NAT_WAVE_CHUNK in backend/ref.py
constexpr int kMaskWords = kChunk / 32;
constexpr int kGroups = kThreads / kProbe;   // packets walked at once
constexpr int kWarpGroups = 32 / kProbe;     // groups of a warp
constexpr int kPerGroup = kChunk / kGroups;  // a group's packets of a chunk
constexpr int kOwned = kChunk / (kThreads / 32);  // packets a warp owns
constexpr int kBuckets = kThreads;  // chains of the schedule's hash buckets
constexpr int kReach = 2;           // buckets an overlapping window may be off
// static shared memory (the schedule, the rule tile): kernels/nf_chain.py
// leaves it out of MAX_SHARED
constexpr int kStaticShared = 20480;

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

// ``first``: the chain begins with the firewall, so its first rule tile
// is in ``tile`` already (the kernel loads it at its start) and the
// packets' alive and src_ip equal the inputs (alive_in, ip_in), which the
// same thread has just read for the header copies.
__device__ void fw_stage(const StageDesc& st, const Pipe& x, int32_t* tile,
                         bool first, const uint8_t* alive_in,
                         const int32_t* ip_in) {
  const int32_t* rules = as<const int32_t>(st.ptr[0]);
  const int r = static_cast<int>(st.val[0]);
  const uint8_t* alive = first ? alive_in : x.alive;
  const int32_t* ip = first ? ip_in : x.f[kSrcIp];
  for (int base = 0; base < r; base += kAclRuleTile) {
    const int cnt = r - base < kAclRuleTile ? r - base : kAclRuleTile;
    if (base > 0 || !first) {
      pp_acl_load_tile(rules, r, base, tile);
      __syncthreads();
    }
    for (int64_t i = threadIdx.x; i < x.b; i += blockDim.x) {
      if (alive[i] && pp_acl_hit(ip[i], tile, cnt)) {
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

// -- the Tensor Memory Accelerator's bulk copies and their mbarrier --------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Whether the three tables can move as bulk copies: 16-byte aligned rows
// of a multiple of 16 bytes.
__device__ __forceinline__ bool bulk_ok(const int32_t* const t[3],
                                        int64_t cap) {
  uintptr_t bits = 0;
  for (int k = 0; k < 3; ++k) bits |= reinterpret_cast<uintptr_t>(t[k]);
  return bits % 16 == 0 && cap % 4 == 0;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(1u)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// One thread: the three tables global -> shared, completing on bar.
__device__ __forceinline__ void bulk_load(int32_t* const dst[3],
                                          const int32_t* const src[3],
                                          int64_t cap, uint64_t* bar) {
  const uint32_t bytes = static_cast<uint32_t>(cap * 4);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(3 * bytes)
               : "memory");
  for (int k = 0; k < 3; ++k)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst[k])),
        "l"(reinterpret_cast<uint64_t>(src[k])), "r"(bytes),
        "r"(smem_u32(bar))
        : "memory");
}

// Every thread: wait until the phase ``parity`` of bar has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
}

__device__ __forceinline__ void proxy_fence() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// -- NAT --------------------------------------------------------------------

// A NAT stage's tables at pipe p: the inputs and the outputs; a staged
// table is walked in shared memory, another on the outputs.
struct NatTables {
  const int32_t* in[3];
  int32_t* out[3];
  int64_t cap;
  bool staged, bulk_in;
};

__device__ NatTables nat_tables(const StageDesc& st, int64_t p) {
  NatTables t;
  t.cap = st.val[0];
  t.staged = st.val[4] != 0;
  const int64_t off = p * t.cap;
  for (int k = 0; k < 3; ++k) {
    t.in[k] = as<const int32_t>(st.ptr[k]) + off;
    t.out[k] = as<int32_t>(st.ptr[3 + k]) + off;
  }
  t.bulk_in = t.staged && bulk_ok(t.in, t.cap);
  return t;
}

// The block's schedule of one chunk (static shared memory).
struct NatSchedule {
  uint64_t bar;                        // the table copy's mbarrier
  uint32_t walked[2][kMaskWords];      // packets walked before a round, by
                                       // the round's parity
  uint32_t mask[kMaskWords][kChunk];   // [q][i] bit j: packet 32 q + j is
                                       // live, before i, and overlaps it
  int32_t h[kChunk];                   // the hash, -1 for a dead packet
  int32_t ip[kChunk];
  int32_t port[kChunk];
  int32_t mapped[kChunk];              // the walk's port, -1: dropped
  int32_t head[kBuckets];              // the bucket chains of live packets
  int16_t next[kChunk];
  int16_t ready[kThreads / 32][kOwned];  // a warp's ready packets
  int32_t stale;                       // stale hits of the stage
};
static_assert(sizeof(NatSchedule) + kAclRuleTile * 4 <= kStaticShared,
              "kernels/nf_chain.py reserves kStaticShared bytes");

struct NatConsts {
  uint32_t cap;
  int32_t base_port, max_exp, nat_ip;
};

// The 8 bits of a full-warp ballot that belong to this lane's group.
__device__ __forceinline__ unsigned group_bits(bool pred) {
  return (__ballot_sync(kFull, pred) >> (threadIdx.x & 24)) & 0xFFu;
}

// The whole warp: the 8 lanes of each group walk the group's packet i of
// the chunk (none when ``act`` is false) on the table at kip / kport /
// kexp (shared or device memory) and note its port in s.mapped.
__device__ __forceinline__ void nat_step(int32_t* kip, int32_t* kport,
                                         int32_t* kexp, const NatConsts& c,
                                         NatSchedule& s, int i, bool act) {
  const int q = threadIdx.x & 7;
  int32_t ip = 0, port = 0, ki = 0, kp = 0, ex = 0;
  uint32_t h = 0, slot = 0;
  if (act) {
    ip = s.ip[i];
    port = s.port[i];
    h = static_cast<uint32_t>(s.h[i]);
    slot = h + static_cast<uint32_t>(q);
    if (slot >= c.cap) slot -= c.cap;  // cap >= kProbe: one wrap at most
    ki = kip[slot];
    kp = kport[slot];
    ex = kexp[slot];
  }
  const bool live = ex > 0;
  const bool match = act && ki == ip && kp == port;
  const unsigned hit = group_bits(live && match);
  const unsigned gone = group_bits(!live && match);
  const unsigned vacant = group_bits(act && !live);
  if (!act) return;
  // a hit refreshes its binding; a stale hit (its binding aged out: gone
  // implies vacant) tears the binding down, keys -1 and expiry kept;
  // otherwise the first vacant slot takes the flow; with none of them
  // (every slot live) CLOCK ages the window. Each lane works out its
  // slot's new row and whether it writes it, so the step has one branch.
  const bool stale = !hit && gone;
  const unsigned w = hit ? hit : (gone ? gone : vacant);
  const int pw = __ffs(static_cast<int>(w)) - 1;  // -1: exhausted
  const bool mine = q == pw;
  const bool keep = hit || pw < 0;  // the keys stay
  if (mine || pw < 0) {
    kip[slot] = stale ? -1 : (keep ? ki : ip);
    kport[slot] = stale ? -1 : (keep ? kp : port);
    kexp[slot] = pw < 0 ? ex - 1 : (stale ? ex : c.max_exp);
  }
  if (q == 0) {
    uint32_t sw = h + static_cast<uint32_t>(pw);
    if (sw >= c.cap) sw -= c.cap;
    const bool found = pw >= 0 && !stale;
    s.mapped[i] = found ? c.base_port + static_cast<int32_t>(sw) : -1;
    if (stale) atomicAdd(&s.stale, 1);
  }
}

// Every thread: schedule and walk the n <= kChunk packets at c0 on the
// table at kip / kport / kexp. When ``bar`` is set the table is still
// arriving: the walk waits for it.
//
// Thread t < n loads packet t, hashes it into its bucket's chain and
// builds its mask of the overlapping earlier live packets. Warp w owns
// packets 4w + g + 64k (g < 4 its group, k < 4), lane 8g + k holding that
// packet's mask in registers. In each round an owner finds its packet
// ready when none of them is still pending; the warp lists its ready
// packets and its 4 groups walk them, 4 at a time, every lane of the warp
// in step. Round r reads the walked set from walked[r & 1] and adds its
// own and the last round's packets to walked[(r + 1) & 1], so one barrier
// a round orders the walk. Then thread t rewrites or drops packet t.
__device__ __forceinline__ void nat_chunk(int32_t* kip, int32_t* kport,
                                          int32_t* kexp, const NatConsts& c,
                                          const Pipe& x, NatSchedule& s,
                                          int64_t c0, int n, uint64_t* bar,
                                          uint32_t parity) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int32_t hp = -1;  // packet tid's hash, -1 when dead or past n
  if (tid < n) {
    const int64_t k = c0 + tid;
    const int32_t ip = x.f[kSrcIp][k];
    const int32_t port = x.f[kSrcPort][k];
    s.ip[tid] = ip;
    s.port[tid] = port;
    if (x.alive[k]) hp = nat_hash(ip, port, c.cap);
    s.h[tid] = hp;
  }
  s.head[tid] = -1;  // kBuckets == kThreads
  if (tid < 2 * kMaskWords) s.walked[tid / kMaskWords][tid % kMaskWords] = 0;
  __syncthreads();
  // bucket h / 8 of nb: a window that overlaps this one starts at most one
  // bucket away, two when the last bucket is partial (C % 8 != 0), mod nb
  const int32_t nb = static_cast<int32_t>((c.cap + 7) / 8);
  const int32_t beta = hp >> 3;
  if (hp >= 0)
    s.next[tid] = static_cast<int16_t>(
        atomicExch(&s.head[beta & (kBuckets - 1)], tid));
  __syncthreads();
  if (tid < kChunk) {
#pragma unroll
    for (int q = 0; q < kMaskWords; ++q) s.mask[q][tid] = 0u;
  }
  if (hp >= 0) {
    const int reach = c.cap % 8 == 0 ? 1 : kReach;
    int32_t seen[2 * kReach + 1];
#pragma unroll
    for (int o = 0; o <= 2 * kReach; ++o) {
      const int off = o - kReach;
      if (off < -reach || off > reach) continue;
      int32_t bk = beta + off;
      if (nb > 2 * kReach) {
        bk += bk < 0 ? nb : (bk >= nb ? -nb : 0);
      } else {
        bk = (bk % nb + nb) % nb;
      }
      bk &= kBuckets - 1;
      bool dup = false;
#pragma unroll
      for (int t = 0; t < o; ++t)
        dup |= t - kReach >= -reach && seen[t] == bk;
      seen[o] = bk;
      if (dup) continue;
      for (int j = s.head[bk]; j >= 0; j = s.next[j]) {
        if (j >= tid) continue;
        int32_t d = s.h[j] - hp;
        if (d < 0) d += static_cast<int32_t>(c.cap);
        const uint32_t u = static_cast<uint32_t>(d);
        if (u < kProbe || u > c.cap - kProbe)
          s.mask[j >> 5][tid] |= 1u << (j & 31);
      }
    }
  }
  __syncthreads();
  const int own = (tid >> 3) + kGroups * (tid & 7);
  const int i = (tid & 7) < kPerGroup && own < n ? own : -1;
  bool pending = i >= 0 && s.h[i] >= 0;
  uint32_t mine[kMaskWords];
#pragma unroll
  for (int q = 0; q < kMaskWords; ++q) mine[q] = pending ? s.mask[q][i] : 0u;
  if (bar != nullptr) mbar_wait(bar, parity);
  int wave = 0;
  for (int r = 1; __syncthreads_or(pending); ++r) {
    const uint32_t* walked = s.walked[r & 1];
    uint32_t wait = 0;
#pragma unroll
    for (int q = 0; q < kMaskWords; ++q) wait |= mine[q] & ~walked[q];
    const bool ready = pending && !wait;
    const unsigned list = __ballot_sync(kFull, ready);
    if (ready) {
      s.ready[warp][__popc(list & ((1u << lane) - 1u))] =
          static_cast<int16_t>(i);
      pending = false;
      wave = r;
    }
    __syncwarp();
    const int count = __popc(list);
    const int steps = (count + kWarpGroups - 1) / kWarpGroups;
    for (int k = lane >> 3; k < steps * kWarpGroups; k += kWarpGroups)
      nat_step(kip, kport, kexp, c, s, k < count ? s.ready[warp][k] : 0,
               k < count);
    if (wave != 0 && wave >= r - 1)
      atomicOr(&s.walked[(r + 1) & 1][i >> 5], 1u << (i & 31));
  }
  if (hp >= 0) {
    const int64_t k = c0 + tid;
    const int32_t mapped = s.mapped[tid];
    if (mapped >= 0) {
      x.f[kSrcIp][k] = c.nat_ip;
      x.f[kSrcPort][k] = mapped;
    } else {
      x.alive[k] = 0;
      x.dropped[k] = 1;
    }
  }
}

// The kernel's state across its NAT stages: which stage's table was
// requested at the start, and the mbarrier's phase.
struct NatCopies {
  int prefetched;
  uint32_t parity;
};

__device__ __forceinline__ void nat_stage(const StageDesc& st, int stage,
                                          const Pipe& x, int32_t* smem,
                                          NatSchedule& s, NatCopies& cp) {
  const NatTables t = nat_tables(st, x.p);
  // the staged table, addressed from the shared array itself so that its
  // copies use shared-memory instructions
  int32_t* const staged[3] = {smem, smem + t.cap, smem + 2 * t.cap};
  const int32_t stale_in =
      threadIdx.x == 0 ? as<const int32_t>(st.ptr[6])[x.p] : 0;
  const NatConsts c = {static_cast<uint32_t>(t.cap),
                       static_cast<int32_t>(st.val[1]),
                       static_cast<int32_t>(st.val[2]),
                       static_cast<int32_t>(st.val[3])};
  if (!t.staged) {
    copy_meta_tables(t.in, t.out, t.cap);
  } else if (stage != cp.prefetched) {
    // shared memory that an earlier NAT stage of the launch walked
    proxy_fence();
    __syncthreads();
    if (!t.bulk_in)
      copy_meta_tables(t.in, staged, t.cap);
    else if (threadIdx.x == 0)
      bulk_load(staged, t.in, t.cap, &s.bar);
  }
  if (threadIdx.x == 0) s.stale = 0;
  uint64_t* bar = t.bulk_in ? &s.bar : nullptr;
  for (int64_t c0 = 0; c0 < x.b; c0 += kChunk) {
    const int n = static_cast<int>(x.b - c0 < kChunk ? x.b - c0 : kChunk);
    // two call sites, so that the staged walk addresses shared memory
    if (t.staged)
      nat_chunk(staged[0], staged[1], staged[2], c, x, s, c0, n, bar,
                cp.parity);
    else
      nat_chunk(t.out[0], t.out[1], t.out[2], c, x, s, c0, n, bar,
                cp.parity);
    bar = nullptr;
  }
  if (x.b == 0 && t.bulk_in) mbar_wait(&s.bar, cp.parity);
  if (t.bulk_in) cp.parity ^= 1u;
  if (t.staged) {
    // plain stores: a bulk copy out made the block wait, before it could
    // exit, until the copy engine had read the table
    __syncthreads();  // every write of the walk
    copy_meta_tables(staged, t.out, t.cap);
  }
  if (threadIdx.x == 0) as<int32_t>(st.ptr[7])[x.p] = stale_in + s.stale;
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
  __shared__ NatSchedule sched;
  int32_t* const smem = reinterpret_cast<int32_t*>(nat_table);
  const int64_t p = blockIdx.x;
  const int64_t pb = p * a.b;
  Pipe x;
  x.alive = a.alive + pb;
  for (int k = 0; k < 7; ++k) x.f[k] = a.f[k] + pb;
  x.dropped = a.dropped + pb;
  x.b = a.b;
  x.p = p;
  // the first NAT stage's table, if the copy engine can move it, is asked
  // for first: it arrives while the block runs what comes before the walk
  NatCopies cp = {-1, 0u};
  for (int s = 0; s < a.n_stages; ++s) {
    if (a.stage[s].kind != kNat) continue;
    if (nat_tables(a.stage[s], p).bulk_in) cp.prefetched = s;
    break;
  }
  if (threadIdx.x == 0) {
    mbar_init(&sched.bar);
    if (cp.prefetched >= 0) {
      const NatTables t = nat_tables(a.stage[cp.prefetched], p);
      int32_t* const staged[3] = {smem, smem + t.cap, smem + 2 * t.cap};
      bulk_load(staged, t.in, t.cap, &sched.bar);
    }
  }
  // a chain that begins with the firewall: its first rule tile comes in
  // with the header copies below, in the same trip to device memory
  const bool fw_first = a.n_stages > 0 && a.stage[0].kind == kFw;
  if (fw_first)
    pp_acl_load_tile(as<const int32_t>(a.stage[0].ptr[0]),
                     static_cast<int>(a.stage[0].val[0]), 0, rule_tile);
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
        fw_stage(st, x, rule_tile, s == 0, a.alive_in + pb,
                 a.in[kSrcIp] + pb);
        break;
      case kNat:
        nat_stage(st, s, x, smem, sched, cp);
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
  // past 48 KB of shared memory (the static schedule and rule tile
  // included) a block needs the kernel's opt-in, which holds for the
  // current device only; raise it whenever a call on that device needs more
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
