// Merge's tag check, its validate/free pass (paper Algorithm 2 lines
// 11-13) and the gather-and-clear of the parked rows, in one launch of
// P x N blocks: block (p, r) owns a contiguous range of pipe p's M slots.
//
// Replaces the TPU kernels repro/kernels/crc16/kernel.py::crc16_kernel and
// repro/kernels/payload_fetch/kernel.py::payload_fetch_kernel on Merge's
// path: the tag check runs crc16.cuh and the fetch runs payload_fetch.cuh,
// beside the metadata pass that the reference runs as a lax.scan over
// packets (repro/core/park.py::_merge_control). Its plain version is
// repro_torch/backend/ref.py::merge_stage.
//
// Every interaction in Merge is keyed on one (clamped) slot: the contested
// walk, the freed bitmap, the zeroing of a freed slot's metadata and the
// read-before-clear of its row. So the packets and rows of disjoint slot
// ranges are independent, and each block takes its own with no
// synchronisation between blocks. kernels/merge_stage.py::slot_ranges
// chooses N and the range (span) from M: N = 16 up to M = 131072, more
// past it so that a block owns at most 8192 slots, whole bitmap words
// where M allows. A checked packet (alive, pp_valid, ENB 1, CRC ok: the
// only kind that may match and free a slot) belongs to the block that owns
// its clamped slot; any other packet touches no slot and belongs to block
// i mod N, i its place in the batch (packet_blocks in the wrapper), so
// the packets that Split did not park, which all carry tag 0, do not pile
// onto block 0. That block writes all of the packet's outputs, so every
// packet is written once.
// Each block:
// (a) in one trip to device memory, stages its range of the metadata
// tables in shared memory and reads the pipe's headers; then checks
// every packet's tag and lists its own packets in arrival order. The
// slot follows the reference's index rules: a negative tag counts from
// the end, a read out of range is clamped and a free out of range is
// dropped. Each checked own packet sets its slot's bit in a bitmap of the
// range; a bit already set marks the slot as contested (two checked
// packets name it) in a second bitmap.
// (b) Validates/frees in arrival order, in shared memory. A packet
// matches when its slot's generation equals its pp_clk, and a match frees
// the slot (in range only): it zeroes the staged row, so a later packet
// with pp_clk = 0 matches it again, as in the plain version. A checked
// packet alone on its slot, which is every packet of honest traffic,
// decides on its own, all in parallel; the packets on contested slots (a
// duplicate, a forged or an out-of-range tag) take their turns across a
// warp's lanes, by shuffles.
// (c) After (b)'s barrier, every store: the decisions, the staged tables
// into the new tensors, and payload_fetch.cuh's gather of each own
// packet's row (its slot's row, clamped; zeros when it does not match)
// and, after a barrier, the clear of the freed rows. Every reader of a row
// is in the block that clears it, so no read can come after a clear (C3).
// A barrier waits for the global loads and stores issued before it, so
// the block's only accesses to device memory before (b)'s barrier are
// the one trip for its tables and headers.
//
// Shared memory (dynamic): two bitmaps of the range's slots, the staged
// (expiry, generation, length) of each of its slots, and 17 bytes a
// packet (its slot, pp_clk, the length a match reads, its place in the
// block's list of own packets, and its flags), indexed by the packet.
// Past the block's 227 KB (a batch past ~13,400 packets) the same layout
// lives in a device-memory scratch tensor, one region a block, and the
// block works there: atomics and barriers order it as in shared memory,
// and every trip to it costs a device-memory access instead.
//
// Bound: bytes. Per pipe the three (M,) int32 tables are read and written
// once (12 M bytes each way); each packet reads 22 bytes of header and
// writes 9 of decisions; each matched row is read once and cleared once,
// and the (B, W) output rows are written once. The time is the launch and
// two dependent trips to device memory (the tables with the headers, then
// the rows), with a few barriers between: at 8 pipes x M 4096, 128 blocks
// of 256 slots and ~16 packets each fill the card.
#include <cstdint>
#include <cuda_runtime.h>

#include "crc16.cuh"
#include "meta_tables.cuh"
#include "payload_fetch.cuh"

namespace {

constexpr int kThreads = 256;
constexpr uint8_t kChecked = 1;
constexpr uint8_t kInRange = 2;
constexpr uint8_t kMatched = 4;
constexpr uint8_t kDropOp = 8;
constexpr uint8_t kCrcFail = 16;
constexpr uint8_t kDisabled = 32;

struct MergeArgs {
  uint8_t* table;         // (P, M, W), in place
  const int32_t* exp_in;  // (P, M) metadata tables
  const int32_t* gen_in;
  const int32_t* len_in;
  const uint8_t* alive;  // (P, B) header fields
  const uint8_t* valid;
  const int32_t* enb;
  const int32_t* op;
  const int32_t* ti;
  const int32_t* clk;
  const int32_t* crc;
  int32_t* exp_out;  // (P, M)
  int32_t* gen_out;
  int32_t* len_out;
  uint8_t* matched;  // (P, B) decisions, the plain version's layout
  uint8_t* premature;
  uint8_t* crc_fail;
  uint8_t* disabled;
  uint8_t* is_drop;
  int32_t* park_len;
  uint8_t* parked;  // (P, B, W)
  uint32_t* scratch;  // (P x N, scratch_words) past the shared memory, or null
  int64_t b, m, width, blocks, span, scratch_words;
  int32_t op_drop;
};

// Words of one bitmap of a range, even so that the rows staged after the
// two bitmaps start 16-byte aligned.
__host__ __device__ __forceinline__ int64_t bitmap_words(int64_t span) {
  return (span + 63) / 64 * 2;
}

// One packet's header as Merge reads it.
struct Header {
  int32_t ti, enb, clk, crc, op;
  bool live;
};

__device__ __forceinline__ Header load_header(const MergeArgs& a, int64_t q) {
  return Header{a.ti[q], a.enb[q], a.clk[q], a.crc[q], a.op[q],
                a.alive[q] && a.valid[q]};
}

// The block's work on its bitmaps and staged rows at smem (shared memory,
// or its region of the device-memory scratch).
__device__ __forceinline__ void merge_block(const MergeArgs& a,
                                            uint32_t* const smem,
                                            int* warp_own,
                                            int& any_contested) {
  const int tid = threadIdx.x;
  const uint32_t blocks = static_cast<uint32_t>(a.blocks);  // < 2^31
  const uint32_t block = blockIdx.x % blocks;
  const int64_t p = blockIdx.x / blocks;
  const int64_t lo = block * a.span;  // the owned slots
  const int64_t hi = lo + a.span < a.m ? lo + a.span : a.m;
  const int64_t b = a.b;
  const int64_t m = a.m;
  const int64_t pb = p * b;
  const int64_t pm = p * m;
  const int64_t words = bitmap_words(a.span);
  uint32_t* seen = smem;  // bit k - lo of each bitmap: slot k
  uint32_t* contested = smem + words;
  // the range's (expiry, generation, length), staged: slot k at k - lo
  int32_t* const staged[3] = {
      reinterpret_cast<int32_t*>(smem + 2 * words),
      reinterpret_cast<int32_t*>(smem + 2 * words) + a.span,
      reinterpret_cast<int32_t*>(smem + 2 * words) + 2 * a.span};
  int32_t* gen_s = staged[1];
  int32_t* len_s = staged[2];
  int32_t* slot = staged[2] + a.span;  // by packet
  int32_t* clk = slot + b;             // the packet's pp_clk
  int32_t* plen = clk + b;             // the length a match reads
  int32_t* own = plen + b;             // the block's packets, in order
  uint8_t* flag = reinterpret_cast<uint8_t*>(own + b);

  // one trip to device memory: this thread's first packet's header (its
  // only one at B <= kThreads) with the range of the tables, staged
  const Header h0 = tid < b ? load_header(a, pb + tid) : Header{};
  for (int64_t j = tid; j < 2 * words; j += kThreads) smem[j] = 0;
  if (tid == 0) any_contested = 0;
  const int32_t* const in[3] = {a.exp_in + pm + lo, a.gen_in + pm + lo,
                                a.len_in + pm + lo};
  int32_t* const out[3] = {a.exp_out + pm + lo, a.gen_out + pm + lo,
                           a.len_out + pm + lo};
  copy_meta_tables(in, staged, hi - lo);
  __syncthreads();

  // -- (a) tag check, kThreads packets at a time. A checked packet, which
  // may match and free its slot, belongs to the block that owns its
  // clamped slot; any other packet touches no slot and belongs to block
  // i mod N. The block's list keeps arrival order -----------------------
  int64_t count = 0;
  for (int64_t base = 0; base < b; base += kThreads) {
    const int64_t i = base + tid;
    bool mine = false;
    if (i < b) {
      const Header h = base == 0 ? h0 : load_header(a, pb + i);
      const int64_t s = h.ti < 0 ? static_cast<int64_t>(h.ti) + m : h.ti;
      const int64_t k = s < 0 ? 0 : (s >= m ? m - 1 : s);
      const bool is_pp = h.live && h.enb == 1;
      const bool crc_ok =
          static_cast<int32_t>(pp_tag_crc16(h.ti, h.clk)) == h.crc;
      const bool checked = is_pp && crc_ok;
      mine = checked ? k >= lo && k < hi
                     : static_cast<uint32_t>(i) % blocks == block;
      flag[i] = 0;
      if (mine) {
        slot[i] = static_cast<int32_t>(k);
        clk[i] = h.clk;
        flag[i] = (checked ? kChecked : 0) |
                  (s >= 0 && s < m ? kInRange : 0) |
                  (h.op == a.op_drop ? kDropOp : 0) |
                  (is_pp && !crc_ok ? kCrcFail : 0) |
                  (h.live && h.enb == 0 ? kDisabled : 0);
        if (checked) {
          const int64_t r = k - lo;
          const uint32_t bit = 1u << (r & 31);
          if (atomicOr(&seen[r >> 5], bit) & bit) {
            atomicOr(&contested[r >> 5], bit);
            any_contested = 1;
          }
        }
      }
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, mine);
    if ((tid & 31) == 0) warp_own[tid >> 5] = __popc(ballot);
    __syncthreads();
    int64_t rank = count;
    for (int w = 0; w < kThreads / 32; ++w) {
      if (w < tid >> 5) rank += warp_own[w];
      count += warp_own[w];
    }
    if (mine)
      own[rank + __popc(ballot & ((1u << (tid & 31)) - 1u))] =
          static_cast<int32_t>(i);
    __syncthreads();
  }

  // -- (b) validate / free in arrival order (Alg. 2 lines 11-13), in
  // shared memory: a free zeroes the slot's staged row ------------------
  auto alone = [&](int64_t i) {
    const int64_t r = slot[i] - lo;
    return !((contested[r >> 5] >> (r & 31)) & 1u);
  };
  // a checked packet alone on its slot decides on the slot's staged row
  for (int64_t e = tid; e < count; e += kThreads) {
    const int64_t i = own[e];
    const uint8_t f = flag[i];
    if (!(f & kChecked) || !alone(i)) continue;
    const int64_t r = slot[i] - lo;
    if (gen_s[r] != clk[i]) continue;
    flag[i] = f | kMatched;
    plen[i] = len_s[r];
    if (f & kInRange) staged[0][r] = gen_s[r] = len_s[r] = 0;
  }
  // the packets on contested slots, in arrival order, 32 of the list at a
  // time: each lane holds its packet's slot row in registers, and for each
  // contested packet in turn the warp learns by shuffles whether it
  // matches; a match in range frees the slot, so the later lanes on it
  // read (0, 0) from then on, as in the plain version
  if (tid < 32 && any_contested) {
    for (int64_t base = 0; base < count; base += 32) {
      const int64_t e = base + tid;
      const int64_t i = e < count ? own[e] : 0;
      const bool on = e < count && (flag[i] & kChecked) && !alone(i);
      const int64_t r = on ? slot[i] - lo : -1;
      int32_t g = on ? gen_s[r] : 0;
      int32_t l = on ? len_s[r] : 0;
      const int32_t c = on ? clk[i] : 0;
      const bool in_range = on && (flag[i] & kInRange);
      bool matched = false, freed = false;
      int32_t got = 0;
      for (unsigned todo = __ballot_sync(0xffffffffu, on); todo;
           todo &= todo - 1) {
        const int src = __ffs(todo) - 1;
        const bool hit = __shfl_sync(0xffffffffu, g == c, src);
        const bool frees = __shfl_sync(0xffffffffu, in_range, src);
        const int64_t at = __shfl_sync(0xffffffffu, r, src);
        if (tid == src && hit) {
          matched = true;
          got = l;
        }
        if (hit && frees && on && r == at) {
          g = l = 0;
          freed = true;
        }
      }
      if (matched) {
        flag[i] |= kMatched;
        plen[i] = got;
      }
      if (freed) staged[0][r] = gen_s[r] = len_s[r] = 0;
      __syncwarp();
    }
  }
  __syncthreads();

  // -- (c) the outputs, every store after (b)'s barrier -------------------
  for (int64_t e = tid; e < count; e += kThreads) {
    const int64_t i = own[e];
    const int64_t q = pb + i;
    const uint8_t f = flag[i];
    const bool ok = f & kMatched;
    a.matched[q] = ok;
    a.premature[q] = (f & kChecked) && !ok;
    a.crc_fail[q] = (f & kCrcFail) != 0;
    a.disabled[q] = (f & kDisabled) != 0;
    a.is_drop[q] = ok && (f & kDropOp);
    a.park_len[q] = ok ? plen[i] : 0;
  }
  copy_meta_tables(staged, out, hi - lo);
  gather_then_clear(a.table + pm * a.width, a.parked + pb * a.width, count,
                    a.width, [=](int64_t e) {
                      const int64_t i = own[e];
                      const uint8_t f = flag[i];
                      const bool on = f & kMatched;
                      return FetchRow{slot[i], i, on, on && (f & kInRange)};
                    });
}

__global__ void __launch_bounds__(kThreads)
    merge_stage_kernel(const MergeArgs a) {
  extern __shared__ uint32_t shared[];
  __shared__ int warp_own[kThreads / 32];
  __shared__ int any_contested;
  // two call sites, so that the shared-memory one addresses shared memory
  if (a.scratch)
    merge_block(a, a.scratch + blockIdx.x * a.scratch_words, warp_own,
                any_contested);
  else
    merge_block(a, shared, warp_own, any_contested);
}

// The bytes of one block's bitmaps, staged rows of its range and staged
// packets (kernels/merge_stage.py passes a scratch tensor of P x N x
// scratch_words(b, span) words past 227 KB).
size_t shared_bytes(int64_t b, int64_t span) {
  return static_cast<size_t>(8 * bitmap_words(span) + 12 * span + 17 * b);
}

int64_t scratch_words(int64_t b, int64_t span) {
  return static_cast<int64_t>((shared_bytes(b, span) + 15) / 16) * 4;
}

}  // namespace

extern "C" int pp_merge_stage(
    void* table, const void* meta_exp, const void* meta_clk,
    const void* meta_len, const void* alive, const void* pp_valid,
    const void* pp_enb, const void* pp_op, const void* pp_ti,
    const void* pp_clk, const void* pp_crc, void* meta_exp_out,
    void* meta_clk_out, void* meta_len_out, void* matched, void* premature,
    void* crc_fail, void* disabled, void* is_drop, void* park_len,
    void* parked, int64_t pipes, int64_t b, int64_t m, int64_t width,
    int op_drop, int64_t blocks, int64_t span, void* scratch, void* stream) {
  MergeArgs a;
  a.table = static_cast<uint8_t*>(table);
  a.exp_in = static_cast<const int32_t*>(meta_exp);
  a.gen_in = static_cast<const int32_t*>(meta_clk);
  a.len_in = static_cast<const int32_t*>(meta_len);
  a.alive = static_cast<const uint8_t*>(alive);
  a.valid = static_cast<const uint8_t*>(pp_valid);
  a.enb = static_cast<const int32_t*>(pp_enb);
  a.op = static_cast<const int32_t*>(pp_op);
  a.ti = static_cast<const int32_t*>(pp_ti);
  a.clk = static_cast<const int32_t*>(pp_clk);
  a.crc = static_cast<const int32_t*>(pp_crc);
  a.exp_out = static_cast<int32_t*>(meta_exp_out);
  a.gen_out = static_cast<int32_t*>(meta_clk_out);
  a.len_out = static_cast<int32_t*>(meta_len_out);
  a.matched = static_cast<uint8_t*>(matched);
  a.premature = static_cast<uint8_t*>(premature);
  a.crc_fail = static_cast<uint8_t*>(crc_fail);
  a.disabled = static_cast<uint8_t*>(disabled);
  a.is_drop = static_cast<uint8_t*>(is_drop);
  a.park_len = static_cast<int32_t*>(park_len);
  a.parked = static_cast<uint8_t*>(parked);
  a.b = b;
  a.m = m;
  a.width = width;
  a.op_drop = op_drop;
  a.blocks = blocks;
  a.span = span;
  a.scratch = static_cast<uint32_t*>(scratch);
  a.scratch_words = scratch_words(b, span);
  const size_t shared = scratch ? 0 : shared_bytes(b, span);
  if (shared > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        merge_stage_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shared));
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it, so the next call does not report it
      return static_cast<int>(err);
    }
  }
  merge_stage_kernel<<<static_cast<unsigned>(pipes * blocks), kThreads,
                       shared, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
