// Merge's packet transformation (paper Algorithm 2, the packet's side of
// stages 3..N): every returning packet's new payload, its length and its
// header fields, in one launch, written out of place.
//
// Replaces the TPU kernel: none. The reference computes this step as jnp
// array code after its payload_fetch kernel, not as a Pallas kernel: the
// packet transformation of repro/core/park.py::merge_fn (a take_along_axis
// of the carried remainder, the parked row padded to pmax, three where
// selects on the payload and five on the header fields). Its plain version
// is repro_torch/backend/ref.py::merge_payload, that expression in
// PyTorch; over (P, B, pmax) it makes an int64 index of 8 bytes an output
// byte and some ten payload-wide passes.
//
// For packet r of the P x B rows, with fetch = matched & !is_drop_op,
// shift = fetch ? park_len : 0, forwarded = disabled | fetch and new_len =
// payload_len + shift (int32, wrapping as torch's add does), byte col of
// the new payload is
//   forwarded:     0 where col >= new_len, else
//                  parked[r][col] where col < shift (0 past the row width
//                  W; pmax < W reads the first pmax bytes), else
//                  payload[r][clamp(col - shift, 0, pmax - 1)];
//   not forwarded: payload[r][col], the row as it came.
// A dropped packet (premature, crc_fail or is_drop_op) is no longer alive;
// a forwarded or dropped one loses its PayloadPark header (pp_valid and
// the five pp_* fields zeroed).
//
// Bound: bytes. Each output byte is written once (P x B x pmax), each
// payload byte read at most once (a forwarded row needs the carried bytes
// under new_len, any other row all pmax), each restored parked byte once,
// and 35 bytes of header fields and decisions are read and 26 written a
// packet. On chip_smoke.py's inputs at the benchmark cells' shapes that is
// 160.9 MB a call (256 x 256 x 1450, 160 B rows) and 322.6 MB (512 x 256 x
// 1450, 352 B rows): 0.048 and 0.096 ms at 3.35 TB/s.
//
// So the design moves each byte once and keeps every intermediate in
// registers: no index tensor, no padded parked row, no mask in device
// memory. The flat output is cut into 16-byte chunks, each stored with
// one 16-byte store (the output is a fresh tensor, 16-byte aligned; rows
// of pmax = 1450 bytes are only 2-byte aligned, so a chunk may start in
// one row and end in the next). A warp takes a row: its row's plan
// (forwarded, shift, new_len) is read once, turned into runs of columns
// (the parked prefix, the carried payload or the row as it came, zeros
// past new_len), and each lane builds the chunks that lie inside the row,
// neighbouring lanes neighbouring chunks, so a warp's loads cover 512
// contiguous bytes and reach device memory once through L1. A chunk takes
// its bytes from at most two runs; each run is read with the one or two
// aligned 16-byte loads that hold it, brought into place with funnel
// shifts and cut out with byte masks (run_piece). Then a thread a packet
// builds the one chunk that crosses into the next row or ends the output
// (chunk_bytes: a piece from each row) and writes the eight per-packet
// fields. Byte by byte remain only pmax < 16 and a carried column that
// would be clamped (a negative shift, or new_len past pmax + shift), which
// Merge's decisions do not produce. Measured on an H100 (700 W) at the
// first cell's shape: a flat cut with the run-boundary chunks byte by
// byte, 3.4 times the bound; with every chunk from vector loads, 2.6
// times; a warp a row with the crossing chunks in their own pass (their
// code then holds no registers while the rows are copied), 1.7 times.
//
// Grid: one block of 4 warps for every 4 rows, at most 2**20 blocks,
// striding past that. The payload's and the parked rows' strides are
// parameters, so the wrapper copies no input.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;  // rows a block takes at a time, a warp each
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 16;  // output bytes a chunk, one 16-byte store
constexpr int64_t kMaxBlocks = 1 << 20;
constexpr int kFields = 5;  // pp_enb, pp_op, pp_ti, pp_clk, pp_crc

struct Args {
  const uint8_t* payload;
  const int32_t* payload_len;
  const uint8_t* alive;
  const uint8_t* pp_valid;
  const int32_t* pp[kFields];
  const uint8_t* parked;
  const uint8_t* matched;
  const uint8_t* premature;
  const uint8_t* crc_fail;
  const uint8_t* disabled;
  const uint8_t* is_drop_op;
  const int32_t* park_len;
  uint8_t* out;
  int32_t* out_len;
  uint8_t* out_alive;
  uint8_t* out_valid;
  int32_t* out_pp[kFields];
  int64_t rows;
  int64_t pmax;
  int64_t stride;         // bytes from one payload row to the next
  int64_t width;          // W, the parked row's bytes
  int64_t parked_stride;  // bytes from one parked row to the next
};

struct Plan {
  bool forwarded;
  int32_t shift;
  int32_t len;  // new_len
};

// The five loads are issued together (no short-circuit between them).
__device__ __forceinline__ Plan plan_of(const Args& a, int64_t r) {
  const uint8_t matched = __ldg(a.matched + r);
  const uint8_t drop = __ldg(a.is_drop_op + r);
  const uint8_t disabled = __ldg(a.disabled + r);
  const int32_t park_len = __ldg(a.park_len + r);
  const int32_t len = __ldg(a.payload_len + r);
  const bool fetch = matched != 0 && drop == 0;
  const int32_t shift = fetch ? park_len : 0;
  return {disabled != 0 || fetch, shift,
          static_cast<int32_t>(static_cast<uint32_t>(len) +
                               static_cast<uint32_t>(shift))};
}

// Byte col of row r's new payload, as the header comment defines it.
__device__ __forceinline__ uint8_t byte_of(const Args& a, const Plan& p,
                                           int64_t r, int64_t col) {
  const uint8_t* row = a.payload + r * a.stride;
  if (!p.forwarded) return __ldg(row + col);
  if (col >= p.len) return 0;
  if (col < p.shift)
    return col < a.width ? __ldg(a.parked + r * a.parked_stride + col) : 0;
  int64_t src = col - p.shift;
  src = src < 0 ? 0 : (src > a.pmax - 1 ? a.pmax - 1 : src);
  return __ldg(row + src);
}

// The 16 bytes at address at, of which only [j0, j1) are wanted
// (0 <= j0 < j1 <= 16): of the two aligned 16-byte words that hold
// at[0..16), each one that holds a wanted byte is read, the other is taken
// as 0, and funnel shifts bring byte j to place j.  A word read holds a
// byte of the wanted range, and an aligned 16-byte word never crosses a
// page, so no read can fault.
__device__ __forceinline__ uint4 load_part(uintptr_t at, int j0, int j1) {
  const int off = static_cast<int>(at & 15);
  const uint4* q = reinterpret_cast<const uint4*>(at - off);
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  const uint4 lo = j0 < kChunk - off ? __ldg(q) : zero;
  if (off == 0) return lo;
  const uint4 hi = j1 > kChunk - off ? __ldg(q + 1) : zero;
  uint32_t w0, w1, w2, w3, w4;
  switch (off >> 2) {
    case 0: w0 = lo.x; w1 = lo.y; w2 = lo.z; w3 = lo.w; w4 = hi.x; break;
    case 1: w0 = lo.y; w1 = lo.z; w2 = lo.w; w3 = hi.x; w4 = hi.y; break;
    case 2: w0 = lo.z; w1 = lo.w; w2 = hi.x; w3 = hi.y; w4 = hi.z; break;
    default: w0 = lo.w; w1 = hi.x; w2 = hi.y; w3 = hi.z; w4 = hi.w; break;
  }
  const unsigned bits = 8u * static_cast<unsigned>(off & 3);
  return make_uint4(__funnelshift_r(w0, w1, bits),
                    __funnelshift_r(w1, w2, bits),
                    __funnelshift_r(w2, w3, bits),
                    __funnelshift_r(w3, w4, bits));
}

// The bytes j < t of word k of a 16-byte vector, as a mask: the low
// 8 (t - 4 k) bits, none below 0 and all 32 past 4 bytes (the funnel
// shift stops at 32).
__device__ __forceinline__ uint32_t below(int t, int k) {
  const int bits = 8 * t - 32 * k;
  return __funnelshift_lc(0xffffffffu, 0u, bits > 0 ? bits : 0);
}

__device__ __forceinline__ uint4 select(uint4 v, int j0, int j1) {
  return make_uint4(v.x & below(j1, 0) & ~below(j0, 0),
                    v.y & below(j1, 1) & ~below(j0, 1),
                    v.z & below(j1, 2) & ~below(j0, 2),
                    v.w & below(j1, 3) & ~below(j0, 3));
}

// Row r's runs of source bytes in 32-bit columns: the parked prefix in
// columns [0, pend), the carried payload (or the row as it came) in
// [cbeg, cend) from source column col - off, zeros elsewhere.  shift and
// new_len are taken within +-2**30 here (pmax and W are below 2**30, so
// no run changes and no difference overflows); a carried run whose source
// would be clamped, which only a shift below -2**30 or a carried column
// past pmax can ask for, sends its chunks byte by byte.
struct Runs {
  int32_t pend, cbeg, cend, off;
};

__device__ __forceinline__ int32_t clamp32(int32_t x, int32_t lo,
                                           int32_t hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ Runs runs_of(const Args& a, const Plan& p) {
  const int32_t pmax = static_cast<int32_t>(a.pmax);
  if (!p.forwarded) return {0, 0, pmax, 0};
  const int32_t lim = 1 << 30;
  const int32_t shift = clamp32(p.shift, -lim, lim);
  const int32_t len = clamp32(p.len, -lim, lim);
  int32_t pend = shift < len ? shift : len;
  pend = pend < static_cast<int32_t>(a.width) ? pend
                                               : static_cast<int32_t>(a.width);
  return {pend, shift, len, shift};
}

// Bytes [j0, j1) of a chunk whose byte j is column col0 + j of the row
// at row / prow (col0 is negative for the second row of a chunk that
// crosses one), the rest 0, from the row's runs: one aligned load pair
// for a chunk of one run (most chunks), two and byte masks where runs
// meet.  False (and nothing read) when a carried source would be clamped.
__device__ __forceinline__ bool run_piece(const Args& a, const Runs& u,
                                          uintptr_t row, uintptr_t prow,
                                          int32_t col0, int j0, int j1,
                                          uint4* v) {
  const int32_t pj1 = clamp32(u.pend - col0, j0, j1);
  const int32_t qj0 = clamp32(u.cbeg - col0, j0, j1);
  const int32_t qj1 = clamp32(u.cend - col0, qj0, j1);
  const int32_t src0 = col0 - u.off;
  if (qj0 < qj1 && (src0 + qj0 < 0 ||
                    src0 + qj1 > static_cast<int32_t>(a.pmax)))
    return false;
  if (pj1 == 0 && qj0 == 0 && qj1 == kChunk) {
    *v = load_part(row + static_cast<intptr_t>(src0), 0, kChunk);
    return true;
  }
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  const uint4 pv = pj1 > j0
                       ? load_part(prow + static_cast<intptr_t>(col0), j0, pj1)
                       : zero;
  const uint4 qv = qj1 > qj0
                       ? load_part(row + static_cast<intptr_t>(src0), qj0, qj1)
                       : zero;
  const uint4 x = select(pv, j0, pj1), y = select(qv, qj0, qj1);
  *v = make_uint4(x.x | y.x, x.y | y.y, x.z | y.z, x.w | y.w);
  return true;
}

// Chunk c byte by byte: when pmax < 16 (a chunk may then span 17 rows)
// or a piece declines; no chunk of the benchmark's cells comes here.
__device__ __forceinline__ uint4 bytes_one_by_one(const Args& a, int64_t r,
                                                  int64_t col, int n) {
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  Plan p = plan_of(a, r);
  for (int j = 0; j < n; ++j) {
    w[j >> 2] |= static_cast<uint32_t>(byte_of(a, p, r, col))
                 << (8 * (j & 3));
    if (++col == a.pmax && j + 1 < n) {
      col = 0;
      p = plan_of(a, ++r);
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The n bytes of chunk c of the output (n < 16 only at the ragged end),
// whose first byte is in row r, of plan p0; p1 is row r + 1's plan: its
// row's piece and, when it crosses into the next row, that row's.
__device__ __forceinline__ uint4 chunk_bytes(const Args& a, int64_t r,
                                             const Plan& p0, const Plan& p1,
                                             int64_t c, int64_t total,
                                             int* n_out) {
  const int64_t f0 = c * kChunk;
  const int64_t col = f0 - r * a.pmax;
  const int n = total - f0 < kChunk ? static_cast<int>(total - f0) : kChunk;
  *n_out = n;
  uint4 v;
  bool ok = a.pmax >= kChunk;
  if (ok) {
    const int in_row = a.pmax - col < n ? static_cast<int>(a.pmax - col) : n;
    const uintptr_t row =
        reinterpret_cast<uintptr_t>(a.payload) + r * a.stride;
    const uintptr_t prow =
        reinterpret_cast<uintptr_t>(a.parked) + r * a.parked_stride;
    const int32_t c32 = static_cast<int32_t>(col);
    ok = run_piece(a, runs_of(a, p0), row, prow, c32, 0, in_row, &v);
    if (ok && in_row < n) {
      uint4 u;
      ok = run_piece(a, runs_of(a, p1), row + a.stride,
                     prow + a.parked_stride,
                     c32 - static_cast<int32_t>(a.pmax), in_row, n, &u);
      v = make_uint4(v.x | u.x, v.y | u.y, v.z | u.z, v.w | u.w);
    }
  }
  return ok ? v : bytes_one_by_one(a, r, col, n);
}

// Chunk c's n bytes: one 16-byte store, or byte by byte at the ragged end.
__device__ __forceinline__ void store_chunk(const Args& a, int64_t c,
                                            uint4 v, int n) {
  if (n == kChunk) {
    reinterpret_cast<uint4*>(a.out)[c] = v;
    return;
  }
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  for (int j = 0; j < n; ++j)
    a.out[c * kChunk + j] = static_cast<uint8_t>(w[j >> 2] >> (8 * (j & 3)));
}

// Row r's eight per-packet fields.
__device__ __forceinline__ void packet_fields(const Args& a, int64_t r,
                                              const Plan& p) {
  const bool dropped = (__ldg(a.premature + r) | __ldg(a.crc_fail + r) |
                        __ldg(a.is_drop_op + r)) != 0;
  const bool gone = p.forwarded || dropped;
  a.out_len[r] = p.forwarded ? p.len : __ldg(a.payload_len + r);
  a.out_alive[r] = __ldg(a.alive + r) && !dropped;
  a.out_valid[r] = __ldg(a.pp_valid + r) && !gone;
#pragma unroll
  for (int k = 0; k < kFields; ++k)
    a.out_pp[k][r] = gone ? 0 : __ldg(a.pp[k] + r);
}

// The first chunk past row r's whole chunks: the one that crosses into
// the next row or ends the output, if any (with pmax < 16 every chunk that
// starts in the row).
__device__ __forceinline__ int64_t whole_end(const Args& a, int64_t start) {
  return a.pmax >= kChunk ? (start + a.pmax) / kChunk
                          : (start + kChunk - 1) / kChunk;
}

// Two passes in one launch.  First a warp a row over the chunks that lie
// inside it, 32 at a time, from the row's runs (run_piece).  Then a
// thread a packet: the packet's one chunk that crosses into the next row
// or ends the output (chunk_bytes; every chunk that starts in the row when
// pmax < 16), and its eight fields.  Kept apart, the rare chunks' code
// holds no registers in the first pass.
__global__ void __launch_bounds__(kThreads)
    merge_payload_kernel(const Args a) {
  const int lane = threadIdx.x & 31;
  const int64_t total = a.rows * a.pmax;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * kWarps +
                   (threadIdx.x >> 5);
       r < a.rows; r += static_cast<int64_t>(gridDim.x) * kWarps) {
    const int64_t start = r * a.pmax;
    const int64_t whole = whole_end(a, start);
    const Runs u = runs_of(a, plan_of(a, r));
    const uintptr_t row =
        reinterpret_cast<uintptr_t>(a.payload) + r * a.stride;
    const uintptr_t prow =
        reinterpret_cast<uintptr_t>(a.parked) + r * a.parked_stride;
    for (int64_t c = (start + kChunk - 1) / kChunk + lane; c < whole;
         c += 32) {
      const int32_t col = static_cast<int32_t>(c * kChunk - start);
      uint4 v;
      if (!run_piece(a, u, row, prow, col, 0, kChunk, &v))
        v = bytes_one_by_one(a, r, col, kChunk);
      reinterpret_cast<uint4*>(a.out)[c] = v;
    }
  }
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       r < a.rows; r += static_cast<int64_t>(gridDim.x) * kThreads) {
    const Plan p0 = plan_of(a, r);
    const Plan p1 = plan_of(a, r + 1 < a.rows ? r + 1 : r);
    const int64_t start = r * a.pmax;
    const int64_t end = (start + a.pmax + kChunk - 1) / kChunk;
    for (int64_t c = whole_end(a, start); c < end; ++c) {
      int n;
      const uint4 v = chunk_bytes(a, r, p0, p1, c, total, &n);
      store_chunk(a, c, v, n);
    }
    packet_fields(a, r, p0);
  }
}

}  // namespace

// payload (rows, pmax) with rows ``stride`` bytes apart and parked (rows,
// width) with rows ``parked_stride`` bytes apart, uint8; every per-packet
// array (rows,) contiguous, bool as one byte, the rest int32; ``out`` a
// contiguous (rows, pmax) uint8 tensor, 16-byte aligned; pmax and width
// below 2**30. The caller launches only for rows > 0.
extern "C" int pp_merge_payload(
    const void* payload, const void* payload_len, const void* alive,
    const void* pp_valid, const void* pp_enb, const void* pp_op,
    const void* pp_ti, const void* pp_clk, const void* pp_crc,
    const void* parked, const void* matched, const void* premature,
    const void* crc_fail, const void* disabled, const void* is_drop_op,
    const void* park_len, void* out, void* out_len, void* out_alive,
    void* out_valid, void* out_enb, void* out_op, void* out_ti,
    void* out_clk, void* out_crc, int64_t rows, int64_t pmax,
    int64_t stride, int64_t width, int64_t parked_stride, void* stream) {
  Args a;
  a.payload = static_cast<const uint8_t*>(payload);
  a.payload_len = static_cast<const int32_t*>(payload_len);
  a.alive = static_cast<const uint8_t*>(alive);
  a.pp_valid = static_cast<const uint8_t*>(pp_valid);
  const void* pp[kFields] = {pp_enb, pp_op, pp_ti, pp_clk, pp_crc};
  void* out_pp[kFields] = {out_enb, out_op, out_ti, out_clk, out_crc};
  for (int k = 0; k < kFields; ++k) {
    a.pp[k] = static_cast<const int32_t*>(pp[k]);
    a.out_pp[k] = static_cast<int32_t*>(out_pp[k]);
  }
  a.parked = static_cast<const uint8_t*>(parked);
  a.matched = static_cast<const uint8_t*>(matched);
  a.premature = static_cast<const uint8_t*>(premature);
  a.crc_fail = static_cast<const uint8_t*>(crc_fail);
  a.disabled = static_cast<const uint8_t*>(disabled);
  a.is_drop_op = static_cast<const uint8_t*>(is_drop_op);
  a.park_len = static_cast<const int32_t*>(park_len);
  a.out = static_cast<uint8_t*>(out);
  a.out_len = static_cast<int32_t*>(out_len);
  a.out_alive = static_cast<uint8_t*>(out_alive);
  a.out_valid = static_cast<uint8_t*>(out_valid);
  a.rows = rows;
  a.pmax = pmax;
  a.stride = stride;
  a.width = width;
  a.parked_stride = parked_stride;
  int64_t blocks = (rows + kWarps - 1) / kWarps;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  merge_payload_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
