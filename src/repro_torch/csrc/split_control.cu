// Split's control pass (paper Algorithm 1 lines 4-25) and the header tag
// CRC, in one launch of P x N blocks: block (p, r) owns a contiguous range
// of pipe p's M slots.
//
// Replaces the TPU kernel repro/kernels/crc16/kernel.py::crc16_kernel on
// Split's path: the tag CRC runs here, through crc16.cuh, beside the
// tagger and the metadata probe that the reference runs as a lax.scan over
// packets (repro/core/park.py::_split_control). Its plain version is
// repro_torch/backend/ref.py::split_control; ref.py::split_rounds is the
// plain version of the order in which this kernel probes.
//
// The tagger: each eligible packet (alive, payload at least min_park_len)
// advances TI and CLK by one, so a packet's tag follows from k, the running
// count of eligible packets up to it: ti = (TI + k) mod M and
// clk = ((CLK - 1 + k) mod (max_clk - 1)) + 1 for k > 0 (the clock skips
// 0, which marks a free slot), in 32 bits from TI and CLK - 1 reduced once
// (Tagger). An eligible packet's probe reads
// and writes only its own slot (TI + k) mod M, so the packets that touch
// slot s are those with k = k0, k0 + M, k0 + 2M, ... (k0 = ((s - TI - 1)
// mod M) + 1), in that order, and each slot's sequence is independent of
// every other's. When no more packets are eligible than M, every sequence
// has at most one packet, and the walk below is at most one step.
//
// So the kernel is spread over blocks of slot ranges
// (kernels/merge_stage.py::slot_ranges: N = 16 ranges of 256 slots at
// M 4096, at most 8192 slots a range). Each block:
// (a) in one trip to device memory, stages its range of the three
// metadata tables in shared memory (16-byte vectors where aligned) and
// reads the pipe's TI, CLK and B packets (5 bytes each);
// (b) takes every packet's k by a block-wide scan (each thread stages and
// counts a contiguous run of packets, then warp shuffles and the warps'
// totals, one barrier; every block of the pipe computes the same scan);
// (c) probes each owned slot's packets in order: the expiry counts down,
// the slot is claimed at <= 1 and a parked payload is evicted at exactly 1
// (Alg. 1 lines 10-25), and the prober writes the packets' enb, evicted,
// skip_occupied and park_len and the slot's row into the new tables: the
// block lists the eligible packets by k, pos[k - 1] = i, with their park
// lengths, and after a second barrier one thread a slot walks the slot's
// packets, k = k0, k0 + M, ..., the slot's (expiry, generation, length) in
// registers;
// (d) writes, for the packets i with i mod N = r (as
// merge_stage.py::packet_blocks shares out the packets that touch no
// slot), ti, clk, the CRC and skip_small, and the zero decisions of a
// packet that is not eligible; block 0 writes the new TI and CLK.
// Every output element is written by exactly one block, every slot row
// once. A block barrier waits for the global loads and stores issued
// before it, so no global store comes before the block's last barrier.
//
// Shared memory (dynamic): the range's staged rows (12 bytes a slot) and
// 13 bytes a packet (pos and the park length by k, a packet's park length
// and then its k, its flags). Past the block's 227 KB (a batch past
// ~17,600 packets at M 4096) the same layout lives in a device-memory
// scratch tensor, one region a block, and the block works there.
//
// Bound: bytes. Per pipe the three (M,) int32 tables are read and written
// once (12 M bytes each way) and each packet reads 5 bytes and writes 20
// (four int32 and four bool decisions); the scan and the CRC are register
// work. At 8 pipes x M 4096 x 256 packets that is 837,760 bytes, 0.00025
// ms at 3.35 TB/s. What the earlier design of one block per pipe lost, and
// what this one does about it: 8 of 132 SMs worked at 8 pipes and one at
// the stream's one pipe (now P x 16 blocks); that one block copied the
// pipe's 48 KB of tables in and out before the scan's barriers (now each
// block stages 3 KB in the one trip and stores after its last barrier);
// the packets were read twice and each probed slot once more, three
// dependent trips (now one trip in, one out); and one thread walked the
// whole batch when more packets were eligible than M (now each slot's
// thread walks its own packets).
#include <cstdint>
#include <cuda_runtime.h>

#include "crc16.cuh"
#include "meta_tables.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr uint8_t kEligible = 1;
constexpr uint8_t kSmall = 2;  // alive, payload under min_park_len

struct SplitArgs {
  const int32_t* tbl_idx;  // (P,) TI register
  const int32_t* clk;      // (P,) CLK register
  const int32_t* exp_in;   // (P, M) metadata tables
  const int32_t* gen_in;
  const int32_t* len_in;
  const uint8_t* alive;  // (P, B)
  const int32_t* plen;
  int32_t* tbl_idx_out;  // (P,)
  int32_t* clk_out;
  int32_t* exp_out;  // (P, M)
  int32_t* gen_out;
  int32_t* len_out;
  uint8_t* enb;  // (P, B) decisions, the plain version's layout
  int32_t* ti;
  int32_t* tclk;
  uint8_t* evicted;
  uint8_t* skip_occupied;
  uint8_t* skip_small;
  int32_t* park_len;
  int32_t* crc;
  uint32_t* scratch;  // (P x N, scratch_words) past the shared memory, or null
  int64_t b, m, max_clk, blocks, span, scratch_words;
  int32_t max_exp, min_park_len, pass_bytes;
};

__device__ __forceinline__ int32_t floor_mod(int32_t x, int32_t n) {
  const int32_t r = x % n;
  return r < 0 ? r + n : r;
}

__device__ __forceinline__ int64_t min64(int64_t x, int64_t y) {
  return x < y ? x : y;
}

// A pipe's tag after k eligible packets: TI advanced by k, mod M, and the
// clock CLK itself at k = 0, else advanced by k, wrapping from
// max_clk - 1 to 1 (it skips 0, which marks a free slot).
struct Tagger {
  uint32_t ti;     // TI mod M
  uint32_t m;
  uint32_t clk;    // (CLK - 1) mod (max_clk - 1)
  uint32_t wrap;   // max_clk - 1
  int32_t clk0;    // CLK

  __device__ __forceinline__ int32_t ti_at(uint32_t k) const {
    return static_cast<int32_t>((ti + k) % m);
  }
  __device__ __forceinline__ int32_t clk_at(uint32_t k) const {
    return k > 0 ? static_cast<int32_t>((clk + k) % wrap + 1) : clk0;
  }
};

// Alg. 1 lines 10-25 for the eligible packet q with running count k on a
// slot whose (expiry, generation, length) is (e, g, l): the expiry counts
// down, a slot whose expiry reaches 0 is claimed (evicting a parked payload
// if it was 1), an occupied slot is skipped.
__device__ __forceinline__ void probe(const SplitArgs& a, const Tagger& tag,
                                      int64_t q, uint32_t k, int32_t park,
                                      int32_t& e, int32_t& g, int32_t& l) {
  const bool available = e <= 1;
  a.enb[q] = available;
  a.evicted[q] = e == 1;
  a.skip_occupied[q] = !available;
  a.park_len[q] = available ? park : 0;
  if (available) {
    e = a.max_exp;
    g = tag.clk_at(k);
    l = park;
  } else {
    e -= 1;
  }
}

// The tag of packet q with running count k and flags f, and the decisions
// of a packet that is not eligible.
__device__ __forceinline__ void stamp(const SplitArgs& a, const Tagger& tag,
                                      int64_t q, uint32_t k, uint8_t f) {
  const int32_t ti = tag.ti_at(k);
  const int32_t c = tag.clk_at(k);
  a.ti[q] = ti;
  a.tclk[q] = c;
  a.crc[q] = static_cast<int32_t>(pp_tag_crc16(ti, c));
  a.skip_small[q] = (f & kSmall) != 0;
  if (!(f & kEligible)) {
    a.enb[q] = 0;
    a.evicted[q] = 0;
    a.skip_occupied[q] = 0;
    a.park_len[q] = 0;
  }
}

// The block's work on its staged rows and packet lists at smem (shared
// memory, or its region of the device-memory scratch).
__device__ __forceinline__ void split_block(const SplitArgs& a,
                                            uint32_t* const smem,
                                            int* warp_sum) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const uint32_t blocks = static_cast<uint32_t>(a.blocks);  // < 2^31
  const uint32_t block = blockIdx.x % blocks;
  const int64_t p = blockIdx.x / blocks;
  const int64_t lo = block * a.span;  // the owned slots
  const int64_t hi = min64(lo + a.span, a.m);
  const int64_t b = a.b;
  const int64_t m = a.m;
  const int64_t pb = p * b;
  const int64_t pm = p * m;
  // the range's (expiry, generation, length): slot s at s - lo
  int32_t* const staged[3] = {reinterpret_cast<int32_t*>(smem),
                              reinterpret_cast<int32_t*>(smem) + a.span,
                              reinterpret_cast<int32_t*>(smem) + 2 * a.span};
  int32_t* const pos = staged[2] + a.span;  // eligible packets, by k - 1
  int32_t* const park = pos + b;             // their park lengths, by k - 1
  int32_t* const val = park + b;  // by packet: its park length, then its k
  uint8_t* const flag = reinterpret_cast<uint8_t*>(val + b);

  // -- (a) one trip: this thread's contiguous run of packets (one packet
  // at B <= kThreads), the registers and the range of the tables ---------
  const int64_t per = (b + kThreads - 1) / kThreads;
  const int64_t r0 = min64(b, tid * per);
  const int64_t r1 = min64(b, r0 + per);
  const bool has0 = r0 < r1;
  const bool alive0 = has0 && a.alive[pb + r0] != 0;
  const int32_t plen0 = has0 ? a.plen[pb + r0] : 0;
  const int32_t ti0 = a.tbl_idx[p];
  const int32_t clk0 = a.clk[p];
  const int32_t* const in[3] = {a.exp_in + pm + lo, a.gen_in + pm + lo,
                                a.len_in + pm + lo};
  copy_meta_tables(in, staged, hi - lo);
  // each thread stages and counts its own run, so no barrier comes
  // between the two
  int cnt = 0;
  auto stage = [&](int64_t i, bool alive, int32_t plen) {
    const bool e = alive && plen >= a.min_park_len;
    flag[i] = e ? kEligible : (alive ? kSmall : 0);
    val[i] = min(plen, a.pass_bytes);
    cnt += e;
  };
  if (has0) stage(r0, alive0, plen0);
  for (int64_t i = r0 + 1; i < r1; ++i)
    stage(i, a.alive[pb + i] != 0, a.plen[pb + i]);
  // the tag after k eligible packets in 32 bits, from the registers
  // reduced once: ti = (TI mod M + k) mod M, clk = ((CLK - 1) mod
  // (max_clk - 1) + k) mod (max_clk - 1) + 1 (M, B and max_clk at most
  // 2^31, checked by the wrapper)
  const int32_t wrap = static_cast<int32_t>(a.max_clk - 1);
  const int32_t c1 = floor_mod(clk0, wrap);  // then CLK - 1, mod wrap
  const Tagger tag{
      static_cast<uint32_t>(floor_mod(ti0, static_cast<int32_t>(m))),
      static_cast<uint32_t>(m),
      static_cast<uint32_t>(c1 == 0 ? wrap - 1 : c1 - 1),
      static_cast<uint32_t>(wrap), clk0};

  // -- (b) the running count of eligible packets: one barrier ------------
  int x = cnt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sum[warp] = x;
  __syncthreads();
  // every warp scans the warps' totals itself: no second barrier
  int w = lane < kWarps ? warp_sum[lane] : 0;
#pragma unroll
  for (int o = 1; o < kWarps; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, w, o);
    if (lane >= o) w += y;
  }
  const int total = __shfl_sync(0xffffffffu, w, kWarps - 1);
  const int before = __shfl_sync(0xffffffffu, w, warp > 0 ? warp - 1 : 0);
  const int k0 = x - cnt + (warp > 0 ? before : 0);
  // the first k that names slot s: (TI + k) mod M = s, 1 <= k <= M
  auto first_k = [&](int64_t s) {
    const int64_t d = s - tag.ti - 1;
    return (d < 0 ? d + m : d) + 1;
  };

  // -- the list of the eligible packets by k, then (c): each owned slot's
  // packets in order, k = k0, k0 + M, ..., the slot's row in registers (a
  // walk of at most one step when no more packets are eligible than M);
  // every store from here on --------------------------------------------
  int k = k0;
  for (int64_t i = r0; i < r1; ++i) {
    const bool e = flag[i] & kEligible;
    const int32_t pk = val[i];
    k += e;
    val[i] = k;
    if (e) {
      pos[k - 1] = static_cast<int32_t>(i);
      park[k - 1] = pk;
    }
  }
  __syncthreads();
  for (int64_t s = lo + tid; s < hi; s += kThreads) {
    const int64_t r = s - lo;
    int32_t e = staged[0][r], g = staged[1][r], l = staged[2][r];
    for (int64_t kk = first_k(s); kk <= total; kk += m)
      probe(a, tag, pb + pos[kk - 1], static_cast<uint32_t>(kk),
            park[kk - 1], e, g, l);
    a.exp_out[pm + s] = e;
    a.gen_out[pm + s] = g;
    a.len_out[pm + s] = l;
  }
  // -- (d) the tag of each of the block's share of the packets -----------
  const int64_t stride = static_cast<int64_t>(kThreads) * blocks;
  for (int64_t i = block + static_cast<int64_t>(tid) * blocks; i < b;
       i += stride)
    stamp(a, tag, pb + i, val[i], flag[i]);
  if (block == 0 && tid == 0) {
    a.tbl_idx_out[p] = tag.ti_at(total);
    a.clk_out[p] = tag.clk_at(total);
  }
}

__global__ void __launch_bounds__(kThreads)
    split_control_kernel(const SplitArgs a) {
  extern __shared__ __align__(16) uint32_t shared[];
  __shared__ int warp_sum[kWarps];
  // two call sites, so that the shared-memory one addresses shared memory
  if (a.scratch)
    split_block(a, a.scratch + blockIdx.x * a.scratch_words, warp_sum);
  else
    split_block(a, shared, warp_sum);
}

// The bytes of one block's staged rows and packet lists
// (kernels/split_control.py passes a scratch tensor of P x N x
// scratch_words(b, span) words past its MAX_SHARED).
size_t shared_bytes(int64_t b, int64_t span) {
  return static_cast<size_t>(12 * span + 13 * b);
}

int64_t scratch_words(int64_t b, int64_t span) {
  return static_cast<int64_t>((shared_bytes(b, span) + 15) / 16) * 4;
}

}  // namespace

extern "C" int pp_split_control(
    const void* tbl_idx, const void* clk, const void* meta_exp,
    const void* meta_clk, const void* meta_len, const void* alive,
    const void* payload_len, void* tbl_idx_out, void* clk_out,
    void* meta_exp_out, void* meta_clk_out, void* meta_len_out, void* enb,
    void* ti, void* tclk, void* evicted, void* skip_occupied,
    void* skip_small, void* park_len, void* crc, int64_t pipes, int64_t b,
    int64_t m, int64_t max_clk, int max_exp, int min_park_len,
    int pass_bytes, int64_t blocks, int64_t span, void* scratch,
    void* stream) {
  SplitArgs a;
  a.tbl_idx = static_cast<const int32_t*>(tbl_idx);
  a.clk = static_cast<const int32_t*>(clk);
  a.exp_in = static_cast<const int32_t*>(meta_exp);
  a.gen_in = static_cast<const int32_t*>(meta_clk);
  a.len_in = static_cast<const int32_t*>(meta_len);
  a.alive = static_cast<const uint8_t*>(alive);
  a.plen = static_cast<const int32_t*>(payload_len);
  a.tbl_idx_out = static_cast<int32_t*>(tbl_idx_out);
  a.clk_out = static_cast<int32_t*>(clk_out);
  a.exp_out = static_cast<int32_t*>(meta_exp_out);
  a.gen_out = static_cast<int32_t*>(meta_clk_out);
  a.len_out = static_cast<int32_t*>(meta_len_out);
  a.enb = static_cast<uint8_t*>(enb);
  a.ti = static_cast<int32_t*>(ti);
  a.tclk = static_cast<int32_t*>(tclk);
  a.evicted = static_cast<uint8_t*>(evicted);
  a.skip_occupied = static_cast<uint8_t*>(skip_occupied);
  a.skip_small = static_cast<uint8_t*>(skip_small);
  a.park_len = static_cast<int32_t*>(park_len);
  a.crc = static_cast<int32_t*>(crc);
  a.scratch = static_cast<uint32_t*>(scratch);
  a.b = b;
  a.m = m;
  a.max_clk = max_clk;
  a.blocks = blocks;
  a.span = span;
  a.scratch_words = scratch_words(b, span);
  a.max_exp = max_exp;
  a.min_park_len = min_park_len;
  a.pass_bytes = pass_bytes;
  const size_t shared = scratch ? 0 : shared_bytes(b, span);
  if (shared > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        split_control_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shared));
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it, so the next call does not report it
      return static_cast<int>(err);
    }
  }
  split_control_kernel<<<static_cast<unsigned>(pipes * blocks), kThreads,
                         shared, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
