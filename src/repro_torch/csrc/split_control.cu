// Split's control pass (paper Algorithm 1 lines 4-25) and the header tag
// CRC, one block per pipe, in one launch.
//
// Replaces the TPU kernel repro/kernels/crc16/kernel.py::crc16_kernel on
// Split's path: the tag CRC runs here, through crc16.cuh, beside the
// tagger and the metadata probe that the reference runs as a lax.scan over
// packets (repro/core/park.py::_split_control). Its plain version is
// repro_torch/backend/ref.py::split_control.
//
// Stage 1, the tagger: each eligible packet (alive, payload at least
// min_park_len) advances TI and CLK by one, so a packet's tag follows from
// k, the running count of eligible packets up to it. Each thread takes a
// contiguous run of packets, and a block-wide scan of the runs' counts
// (warp shuffles, then the warps' totals) gives every packet its k.
// ti = (TI + k) mod M and clk = ((CLK - 1 + k) mod (max_clk - 1)) + 1 for
// k > 0 (the clock skips 0, which marks a free slot), in 64 bits.
//
// Stage 2, the probe: when a pipe's eligible packets number at most M,
// their slots are distinct, and a packet that is not eligible leaves its
// slot as it was. So each eligible packet reads its own slot's (expiry,
// generation, length), decides available / evicted / claim and writes the
// row back, all in parallel. When there are more eligible packets than M
// (a table smaller than the batch), one thread walks the packets in order
// over the metadata in device memory. The metadata tables come out as new
// tensors, as the plain version's do: the block copies its pipe's tables
// first (meta_tables.cuh), and the scan's barriers order the copy before
// every probe.
//
// Bound: bytes. Per pipe the three (M,) int32 tables are read and written
// once (12 M bytes each way) and each packet reads 5 bytes and writes 20
// (four int32 and four bool decisions); the scan and the CRC are register
// work. At M 4096 the tables outweigh the packets. One block per pipe
// leaves most SMs idle: the time is the launch plus a few dependent trips
// to device memory (the loads of the copy, of the packets and of the
// probed slots), each with every load of the block in flight together.
#include <cstdint>
#include <cuda_runtime.h>

#include "crc16.cuh"
#include "meta_tables.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

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
  int64_t b, m, max_clk;
  int32_t max_exp, min_park_len, pass_bytes;
};

__device__ __forceinline__ int64_t floor_mod(int64_t x, int64_t n) {
  const int64_t r = x % n;
  return r < 0 ? r + n : r;
}

__device__ __forceinline__ int64_t min64(int64_t x, int64_t y) {
  return x < y ? x : y;
}

// Alg. 1 lines 10-25 for one eligible packet: the slot's expiry counts
// down, a slot whose expiry reaches 0 is claimed (evicting a parked
// payload if the expiry was 1), an occupied slot is skipped.
__device__ __forceinline__ void probe(const SplitArgs& a, int64_t pkt,
                                      int64_t slot, int32_t exp_pre,
                                      int32_t gen_cur, int32_t len_cur,
                                      int64_t clk_n, int32_t plen) {
  const bool available = exp_pre <= 1;
  const int32_t park = min(plen, a.pass_bytes);
  a.exp_out[slot] = available ? a.max_exp : exp_pre - 1;
  a.gen_out[slot] = available ? static_cast<int32_t>(clk_n) : gen_cur;
  a.len_out[slot] = available ? park : len_cur;
  a.enb[pkt] = available;
  a.evicted[pkt] = exp_pre == 1;
  a.skip_occupied[pkt] = !available;
  a.park_len[pkt] = available ? park : 0;
}

__global__ void __launch_bounds__(kThreads)
    split_control_kernel(const SplitArgs a) {
  __shared__ int warp_sum[kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t p = blockIdx.x;
  const int64_t b = a.b;
  const int64_t m = a.m;
  const int64_t pb = p * b;
  const int64_t pm = p * m;

  {
    const int32_t* const in[3] = {a.exp_in + pm, a.gen_in + pm,
                                  a.len_in + pm};
    int32_t* const out[3] = {a.exp_out + pm, a.gen_out + pm, a.len_out + pm};
    copy_meta_tables(in, out, m);
  }

  // -- stage 1: the running count of eligible packets ----------------------
  const int64_t per = (b + kThreads - 1) / kThreads;
  const int64_t lo = min64(b, tid * per);
  const int64_t hi = min64(b, lo + per);
  int cnt = 0;
  for (int64_t i = lo; i < hi; ++i)
    cnt += a.alive[pb + i] && a.plen[pb + i] >= a.min_park_len;
  int x = cnt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? warp_sum[lane] : 0;
#pragma unroll
    for (int o = 1; o < kWarps; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kWarps) warp_sum[lane] = w;
  }
  __syncthreads();
  const int64_t total = warp_sum[kWarps - 1];
  int64_t k = x - cnt + (warp > 0 ? warp_sum[warp - 1] : 0);

  // -- per packet: tag, CRC and, with distinct slots, the probe ------------
  const int64_t ti0 = a.tbl_idx[p];
  const int64_t clk0 = a.clk[p];
  const bool distinct = total <= m;
  for (int64_t i = lo; i < hi; ++i) {
    const int32_t plen = a.plen[pb + i];
    const bool alive = a.alive[pb + i] != 0;
    const bool e = alive && plen >= a.min_park_len;
    k += e;
    const int64_t ti_n = floor_mod(ti0 + k, m);
    const int64_t clk_n =
        k > 0 ? floor_mod(clk0 - 1 + k, a.max_clk - 1) + 1 : clk0;
    a.ti[pb + i] = static_cast<int32_t>(ti_n);
    a.tclk[pb + i] = static_cast<int32_t>(clk_n);
    a.crc[pb + i] = static_cast<int32_t>(pp_tag_crc16(
        static_cast<int32_t>(ti_n), static_cast<int32_t>(clk_n)));
    a.skip_small[pb + i] = alive && plen < a.min_park_len;
    if (!e) {
      a.enb[pb + i] = 0;
      a.evicted[pb + i] = 0;
      a.skip_occupied[pb + i] = 0;
      a.park_len[pb + i] = 0;
    } else if (distinct) {
      const int64_t s = pm + ti_n;
      probe(a, pb + i, s, a.exp_in[s], a.gen_in[s], a.len_in[s], clk_n, plen);
    }
  }

  if (tid != 0) return;
  if (!distinct) {
    // more eligible packets than slots: Alg. 1 packet by packet
    int64_t kk = 0;
    for (int64_t i = 0; i < b; ++i) {
      const int32_t plen = a.plen[pb + i];
      if (!(a.alive[pb + i] && plen >= a.min_park_len)) continue;
      ++kk;
      const int64_t s = pm + floor_mod(ti0 + kk, m);
      probe(a, pb + i, s, a.exp_out[s], a.gen_out[s], a.len_out[s],
            floor_mod(clk0 - 1 + kk, a.max_clk - 1) + 1, plen);
    }
  }
  a.tbl_idx_out[p] = static_cast<int32_t>(floor_mod(ti0 + total, m));
  a.clk_out[p] = static_cast<int32_t>(
      total > 0 ? floor_mod(clk0 - 1 + total, a.max_clk - 1) + 1 : clk0);
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
    int pass_bytes, void* stream) {
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
  a.b = b;
  a.m = m;
  a.max_clk = max_clk;
  a.max_exp = max_exp;
  a.min_park_len = min_park_len;
  a.pass_bytes = pass_bytes;
  split_control_kernel<<<static_cast<unsigned>(pipes), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
