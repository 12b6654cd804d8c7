// Merge's tag check, its validate/free pass (paper Algorithm 2 lines
// 11-13) and the gather-and-clear of the parked rows, one block per pipe,
// in one launch.
//
// Replaces the TPU kernels repro/kernels/crc16/kernel.py::crc16_kernel and
// repro/kernels/payload_fetch/kernel.py::payload_fetch_kernel on Merge's
// path: the tag check runs crc16.cuh and the fetch runs payload_fetch.cuh,
// beside the metadata pass that the reference runs as a lax.scan over
// packets (repro/core/park.py::_merge_control). Its plain version is
// repro_torch/backend/ref.py::merge_stage.
//
// (a) Tag check, one thread per packet: checked = alive & pp_valid &
// ENB == 1 & CRC ok. The slot follows the reference's index rules: a
// negative tag counts from the end, a read out of range is clamped and a
// free out of range is dropped. Each checked packet stages its slot's
// (generation, length) and its pp_clk in shared memory and sets its
// (clamped) slot's bit in a shared bitmap; a bit already set marks the
// slot as contested (two checked packets name it) in a second bitmap.
// (b) Validate/free, in arrival order. A packet matches when its slot's
// generation equals its pp_clk, and a match frees the slot (in range
// only). Packets that are not checked neither match nor free. So a checked
// packet alone on its slot, which is every packet of honest traffic,
// decides on its own staged row, all in parallel. The packets on
// contested slots (a duplicate, a forged or an out-of-range tag) are
// walked in arrival order by one lane, 32 packets a ballot, with a shared
// bitmap of the slots freed so far: a freed slot reads (0, 0, 0), so a
// later packet with pp_clk = 0 matches it again, as in the plain version.
// Then every packet writes its decisions and zeroes its freed slot. The
// metadata tables come out as new tensors: the block copies its pipe's
// tables (meta_tables.cuh) before any free.
// (c) Fetch: payload_fetch.cuh gathers every matched row (clamped), with
// zero rows for the rest, and only after a barrier clears the freed rows.
//
// Shared memory (dynamic): three bitmaps of M bits and 17 bytes a packet
// (its slot, the staged generation, length and pp_clk, and its flags).
// Past the block's 227 KB (a table past ~620,000 slots, or a batch past
// ~13,600 packets) the same layout lives in a device-memory scratch
// tensor, one region a pipe, and the block works there: the kernel zeroes
// the bitmaps itself, atomics and barriers order it as in shared memory,
// and every trip to it costs a device-memory access instead.
//
// Bound: bytes. Per pipe the three (M,) int32 tables are read and written
// once (12 M bytes each way); each packet reads 22 bytes of header and
// writes 9 of decisions; each matched row is read once and cleared once,
// and the (B, W) output rows are written once. One block per pipe leaves
// most SMs idle: the time is the launch plus a few dependent trips to
// device memory (the copy, the header, the staged rows, the gather), each
// with every load of the block in flight together.
#include <cstdint>
#include <cuda_runtime.h>

#include "crc16.cuh"
#include "meta_tables.cuh"
#include "payload_fetch.cuh"

namespace {

constexpr int kThreads = 512;
constexpr uint8_t kChecked = 1;
constexpr uint8_t kInRange = 2;
constexpr uint8_t kMatched = 4;

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
  uint32_t* scratch;  // (P, scratch_words) past the shared memory, or null
  int64_t b, m, width, scratch_words;
  int32_t op_drop;
};

__host__ __device__ __forceinline__ int64_t bitmap_words(int64_t m) {
  return (m + 31) / 32;
}

__global__ void __launch_bounds__(kThreads)
    merge_stage_kernel(const MergeArgs a) {
  extern __shared__ uint32_t shared[];
  const int tid = threadIdx.x;
  const int64_t p = blockIdx.x;
  uint32_t* const smem = a.scratch ? a.scratch + p * a.scratch_words : shared;
  const int64_t b = a.b;
  const int64_t m = a.m;
  const int64_t pb = p * b;
  const int64_t pm = p * m;
  const int64_t words = bitmap_words(m);
  uint32_t* seen = smem;
  uint32_t* contested = smem + words;
  uint32_t* freed = smem + 2 * words;
  int32_t* slot = reinterpret_cast<int32_t*>(smem + 3 * words);
  int32_t* gen = slot + b;  // the slot's generation as this packet reads it
  int32_t* len = gen + b;   // the slot's length as this packet reads it
  int32_t* clk = len + b;   // the packet's pp_clk
  uint8_t* flag = reinterpret_cast<uint8_t*>(clk + b);

  for (int64_t j = tid; j < 3 * words; j += kThreads) smem[j] = 0;
  {
    const int32_t* const in[3] = {a.exp_in + pm, a.gen_in + pm,
                                  a.len_in + pm};
    int32_t* const out[3] = {a.exp_out + pm, a.gen_out + pm, a.len_out + pm};
    copy_meta_tables(in, out, m);
  }
  __syncthreads();

  // -- (a) tag check; stage the checked packets' rows ---------------------
  for (int64_t i = tid; i < b; i += kThreads) {
    const int64_t q = pb + i;
    const bool live = a.alive[q] && a.valid[q];
    const int32_t enb = a.enb[q];
    const int32_t t = a.ti[q];
    const int32_t c = a.clk[q];
    const bool is_pp = live && enb == 1;
    const bool crc_ok = static_cast<int32_t>(pp_tag_crc16(t, c)) == a.crc[q];
    const bool checked = is_pp && crc_ok;
    const int64_t s = t < 0 ? static_cast<int64_t>(t) + m : t;
    const int64_t k = s < 0 ? 0 : (s >= m ? m - 1 : s);
    a.crc_fail[q] = is_pp && !crc_ok;
    a.disabled[q] = live && enb == 0;
    slot[i] = static_cast<int32_t>(k);
    flag[i] = (checked ? kChecked : 0) | (s >= 0 && s < m ? kInRange : 0);
    if (checked) {
      gen[i] = a.gen_in[pm + k];
      len[i] = a.len_in[pm + k];
      clk[i] = c;
      const uint32_t bit = 1u << (k & 31);
      if (atomicOr(&seen[k >> 5], bit) & bit)
        atomicOr(&contested[k >> 5], bit);
    }
  }
  __syncthreads();

  // -- (b) validate / free in arrival order (Alg. 2 lines 11-13) ----------
  // a checked packet alone on its slot decides on its own staged row
  auto alone = [&](int64_t i) {
    return !((contested[slot[i] >> 5] >> (slot[i] & 31)) & 1u);
  };
  for (int64_t i = tid; i < b; i += kThreads)
    if ((flag[i] & kChecked) && alone(i) && gen[i] == clk[i])
      flag[i] |= kMatched;
  // the packets on contested slots, in arrival order
  if (tid < 32) {
    for (int64_t base = 0; base < b; base += 32) {
      const int64_t i = base + tid;
      unsigned todo = __ballot_sync(
          0xffffffffu, i < b && (flag[i] & kChecked) && !alone(i));
      if (tid == 0) {
        for (; todo; todo &= todo - 1) {
          const int64_t j = base + __ffs(todo) - 1;
          const int32_t k = slot[j];
          const uint32_t bit = 1u << (k & 31);
          if (freed[k >> 5] & bit) gen[j] = len[j] = 0;
          if (gen[j] != clk[j]) continue;
          flag[j] |= kMatched;
          if (flag[j] & kInRange) freed[k >> 5] |= bit;
        }
      }
      __syncwarp();
    }
  }
  __syncthreads();
  for (int64_t i = tid; i < b; i += kThreads) {
    const int64_t q = pb + i;
    const uint8_t f = flag[i];
    const bool ok = f & kMatched;
    a.matched[q] = ok;
    a.premature[q] = (f & kChecked) && !ok;
    a.is_drop[q] = ok && a.op[q] == a.op_drop;
    a.park_len[q] = ok ? len[i] : 0;
    if (ok && (f & kInRange)) {
      a.exp_out[pm + slot[i]] = 0;
      a.gen_out[pm + slot[i]] = 0;
      a.len_out[pm + slot[i]] = 0;
    }
  }

  // -- (c) gather every matched row, then clear the freed ones ------------
  gather_then_clear(a.table + pm * a.width, a.parked + pb * a.width, b,
                    a.width, [=](int64_t i) {
                      const uint8_t f = flag[i];
                      const bool on = f & kMatched;
                      return FetchRow{slot[i], on, on && (f & kInRange)};
                    });
}

// The bytes of one block's bitmaps and staged rows (kernels/merge_stage.py
// passes a scratch tensor of P x scratch_words(b, m) words past 227 KB).
size_t shared_bytes(int64_t b, int64_t m) {
  return static_cast<size_t>(12 * bitmap_words(m) + 17 * b);
}

int64_t scratch_words(int64_t b, int64_t m) {
  return static_cast<int64_t>((shared_bytes(b, m) + 15) / 16) * 4;
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
    int op_drop, void* scratch, void* stream) {
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
  a.scratch = static_cast<uint32_t*>(scratch);
  a.scratch_words = scratch_words(b, m);
  const size_t shared = scratch ? 0 : shared_bytes(b, m);
  if (shared > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        merge_stage_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shared));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  merge_stage_kernel<<<static_cast<unsigned>(pipes), kThreads, shared,
                       static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
