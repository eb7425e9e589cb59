// Device functions shared by the four egress kernels (memcrypt, permcheck,
// checked_memcrypt, fabric_egress).  Keeping the keystream and the lookup in
// one header makes the kernels bit-identical to each other by construction:
// kernels 1, 3 and 4 run the same 12-round ARX keystream; kernels 2, 3 and 4
// the same per-lane sorted search (`shard_prologue` + `lane_search`) and
// vector loads and stores; kernels 3 and 4 the same fused egress block
// (`egress_block`).
//
// u32 words cross the C interface as int32 (torch has no uint32 arithmetic
// on the CPU); every kernel reinterprets them as uint32_t and hands the same
// bit patterns back.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace egress {

constexpr int THREADS = 256;        // threads per block, kernel 1
constexpr int ENTRY_TILE = 1024;    // table entries per tile
constexpr int MAX_TILES = 64;       // MAX_ENTRIES / ENTRY_TILE
constexpr int HWPID_SHIFT = 24;
constexpr int32_t PAGE_MASK = (1 << HWPID_SHIFT) - 1;
constexpr int32_t EMPTY_START = 0x7FFFFFFF;  // start of a dead entry / tile
constexpr int VEC = 4;              // addresses per thread, search kernels
constexpr int SEARCH_THREADS = 128; // threads per block, search kernels

// repro_torch.core.checker fault codes
constexpr int32_t FAULT_NONE = 0;
constexpr int32_t FAULT_NO_ABITS = 1;
constexpr int32_t FAULT_NOT_LOCAL = 2;
constexpr int32_t FAULT_NO_ENTRY = 3;
constexpr int32_t FAULT_PERM = 4;

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// x0 of the 12-round threefry-2x32-style block (core/crypto.arx_mac32) over
// the counter (line = pos / 16, word = pos % 16): the keystream word XORed
// into the u32 word at flat position `pos` (already reduced mod 2^32).
__device__ __forceinline__ uint32_t keystream_x0(uint32_t k0, uint32_t k1,
                                                 uint32_t pos) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = (pos >> 4) + k0;
  uint32_t x1 = (pos & 15u) + k1;
#define EGRESS_ROUND(r) \
  x0 += x1;             \
  x1 = rotl32(x1, r) ^ x0;
  EGRESS_ROUND(13) EGRESS_ROUND(15) EGRESS_ROUND(26) EGRESS_ROUND(6)
  x0 += k1; x1 += k2 + 1u;          // key injection j = 1
  EGRESS_ROUND(17) EGRESS_ROUND(29) EGRESS_ROUND(16) EGRESS_ROUND(24)
  x0 += k2; x1 += k0 + 2u;          // j = 2
  EGRESS_ROUND(13) EGRESS_ROUND(15) EGRESS_ROUND(26) EGRESS_ROUND(6)
  x0 += k0; x1 += k1 + 3u;          // j = 3 (x1 is dead past here)
#undef EGRESS_ROUND
  return x0;
}

struct Verdict {
  bool any_ok;    // some entry covering the page grants `need`
  bool covered;   // some entry covers the page
  int32_t idx;    // the covering entry, else -1
};

// ---------------------------------------------------------------------------
// The per-lane sorted search (kernels 2, 3 and 4).
//
// PRECONDITION on every shard it searches — what HostTable commits and every
// view of it (make_shard_view, HostRuntime.shard_view, stack_views) keeps:
//   * the live entries are a prefix, strictly sorted by start and
//     non-overlapping (ends[k] <= starts[k + 1]);
//   * every entry past them is an EMPTY_START (INT32_MAX) sentinel, so a
//     page (< 2^24) never reaches it;
//   * the shard holds n_tiles * ENTRY_TILE entries (n_tiles <= MAX_TILES),
//     and tile_min[t] = starts[t * ENTRY_TILE] (EMPTY_START for a dead
//     tile), as core/table.tile_summary builds it.
// Then at most one entry covers a page: the last entry whose start <= page.
// Two levels find it: the last live tile t with tile_min[t] <= page, from
// shared memory; then the last entry of tile t with start <= page, through
// the read-only cache, whose top levels every lane shares (from shared
// memory for a shard with one live tile).  Both are fixed-trip binary
// searches over power-of-two steps, so every lane of a block runs the same
// number of probes and no lane diverges.
//
// A shard that breaks the precondition makes the search miss an entry that
// covers the page, never report one that does not: `lane_search` returns k
// only where starts[k] <= page, and `entry_verdict` grants only where also
// page < ends[k].  So it fails closed.
// ---------------------------------------------------------------------------

// Block-uniform facts about one shard, set up by `shard_prologue`.
struct Shard {
  const int32_t* tmin;    // shared: tile_min, EMPTY_START past the live tiles
  const int32_t* starts;  // device: the shard's starts
  const int32_t* tile;    // shared: tile 0's live starts, when `staged`
  int tile_live;          // live entries staged in `tile`
  int tile_step;          // first level-1 step: step_below(live tiles)
  int entry_step;         // first level-2 step over `tile`, when `staged`
  bool staged;            // one live tile, staged in shared memory
};

// Largest power of two strictly below n; 0 for n <= 1.
__device__ __forceinline__ int step_below(int n) {
  return n <= 1 ? 0 : 1 << (31 - __clz(n - 1));
}

// Every thread of the block must call this (it synchronises), with the
// shard's device arrays; blockDim.x must be at least MAX_TILES and divide
// ENTRY_TILE.  `s_tmin` holds MAX_TILES ints of shared memory, `s_tile`
// ENTRY_TILE.  A shard whose live entries fit in its first tile (a host's
// resident shard at the 255-host deployment) is staged in shared memory,
// blockDim.x entries at a time up to the first sentinel, and its level-2
// search spans only its live entries: 0-1 probes for the 1-2 entries of a
// host's shard there, where the search of a whole tile takes 10.
__device__ __forceinline__ Shard shard_prologue(
    const int32_t* __restrict__ starts, const int32_t* __restrict__ tile_min,
    int n_tiles, int32_t* s_tmin, int32_t* s_tile) {
  const int tid = threadIdx.x;
  const int32_t tm = tid < n_tiles ? tile_min[tid] : EMPTY_START;
  if (tid < MAX_TILES) s_tmin[tid] = tm;
  const int live_tiles = __syncthreads_count(tm != EMPTY_START);
  Shard sh{s_tmin, starts, s_tile, 0, step_below(live_tiles), 0,
           live_tiles == 1};
  if (sh.staged) {
    for (int base = 0; base < ENTRY_TILE; base += blockDim.x) {
      const int32_t v = starts[base + tid];
      s_tile[base + tid] = v;
      const int live = __syncthreads_count(v != EMPTY_START);
      sh.tile_live += live;
      if (live < static_cast<int>(blockDim.x)) break;   // the sentinel tail
    }
    sh.entry_step = step_below(sh.tile_live);
  }
  return sh;
}

// One lane's V pages -> for each, the only entry that can cover it: the
// last entry whose start <= page, or -1.  No barriers.  The V searches run
// step for step together, so their loads are independent and overlap.
// Level-1 probes stay below MAX_TILES and level-2 probes inside the tile
// (the steps sum to 2 * first step - 1 < the searched length); the
// EMPTY_START tiles and entries past the live ones are never <= a page.
// Only the staged tile needs a bound check: it holds nothing past the chunk
// that reached the first sentinel.
template <int V>
__device__ __forceinline__ void lane_search(const int32_t (&page)[V],
                                            const Shard& sh, int (&k)[V]) {
  int t[V], e[V];
#pragma unroll
  for (int j = 0; j < V; ++j) t[j] = e[j] = 0;
  for (int s = sh.tile_step; s > 0; s >>= 1) {
#pragma unroll
    for (int j = 0; j < V; ++j)
      if (sh.tmin[t[j] + s] <= page[j]) t[j] += s;
  }
  if (sh.staged) {
    for (int s = sh.entry_step; s > 0; s >>= 1) {
#pragma unroll
      for (int j = 0; j < V; ++j)
        if (e[j] + s < sh.tile_live && sh.tile[e[j] + s] <= page[j])
          e[j] += s;
    }
#pragma unroll
    for (int j = 0; j < V; ++j) k[j] = sh.tile[e[j]] <= page[j] ? e[j] : -1;
    return;
  }
  const int32_t* base[V];
#pragma unroll
  for (int j = 0; j < V; ++j) base[j] = sh.starts + t[j] * ENTRY_TILE;
#pragma unroll
  for (int s = ENTRY_TILE / 2; s > 0; s >>= 1) {
#pragma unroll
    for (int j = 0; j < V; ++j)
      if (__ldg(base[j] + e[j] + s) <= page[j]) e[j] += s;
  }
#pragma unroll
  for (int j = 0; j < V; ++j)
    k[j] = __ldg(base[j] + e[j]) <= page[j] ? t[j] * ENTRY_TILE + e[j] : -1;
}

// The verdict for `page` from its search result: the caller's one read of
// the found entry's end and permission bits.
__device__ __forceinline__ Verdict entry_verdict(
    int32_t page, int k, const int32_t* __restrict__ ends,
    const int32_t* __restrict__ permbits, int32_t need) {
  Verdict v{false, false, -1};
  if (k >= 0 && page < __ldg(ends + k)) {
    v.covered = true;
    v.idx = k;
    v.any_ok = (__ldg(permbits + k) & need) == need;
  }
  return v;
}

// The search kernels take VEC consecutive int32 operands per thread: one
// 16-byte load or store on the WIDE path (the length a multiple of VEC and
// every operand 16-byte aligned, as `aligned16` tests on the host), else
// element by element up to the length `n`.  `load_vec` fills the lanes past
// `n` with `fill`; the stores write only lanes below it.
static_assert(VEC == 4, "one 16-byte load or store carries VEC words");

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <bool WIDE>
__device__ __forceinline__ void load_vec(const int32_t* __restrict__ p,
                                         int64_t i0, int64_t n, int32_t fill,
                                         int32_t (&v)[VEC]) {
  if (WIDE && i0 < n) {
    const int4 q = *reinterpret_cast<const int4*>(p + i0);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    return;
  }
#pragma unroll
  for (int j = 0; j < VEC; ++j) v[j] = !WIDE && i0 + j < n ? p[i0 + j] : fill;
}

template <bool WIDE>
__device__ __forceinline__ void store_vec(int32_t* __restrict__ p, int64_t i0,
                                          int64_t n,
                                          const int32_t (&v)[VEC]) {
  if (WIDE) {
    *reinterpret_cast<int4*>(p + i0) = make_int4(v[0], v[1], v[2], v[3]);
    return;
  }
#pragma unroll
  for (int j = 0; j < VEC; ++j)
    if (i0 + j < n) p[i0 + j] = v[j];
}

template <bool WIDE>
__device__ __forceinline__ void store_vec(bool* __restrict__ p, int64_t i0,
                                          int64_t n, const bool (&v)[VEC]) {
  if (WIDE) {
    *reinterpret_cast<uchar4*>(p + i0) = make_uchar4(v[0], v[1], v[2], v[3]);
    return;
  }
#pragma unroll
  for (int j = 0; j < VEC; ++j)
    if (i0 + j < n) p[i0 + j] = v[j];
}

// The fused egress epilogue, per word: the verdict's fault code in the
// reference's priority (NO_ABITS for tag <= 0 — the -1 padding lane
// included — then NOT_LOCAL, NO_ENTRY, PERM) and the decrypted word, or 0
// on a denied lane.
__device__ __forceinline__ void egress_word(int32_t word, int32_t ext,
                                            int32_t hwpid, const Verdict& v,
                                            uint32_t k0, uint32_t k1,
                                            uint32_t pos, int32_t* out,
                                            int32_t* fault) {
  const int32_t tag = ext >> HWPID_SHIFT;  // arithmetic: -1 stays -1
  const bool tag_ok = tag == hwpid;
  const bool allowed = tag_ok && v.any_ok;
  int32_t f = FAULT_NONE;
  if (!allowed)
    f = tag <= 0 ? FAULT_NO_ABITS
        : !tag_ok ? FAULT_NOT_LOCAL
        : !v.covered ? FAULT_NO_ENTRY
        : FAULT_PERM;
  uint32_t w = 0;
  if (allowed) w = static_cast<uint32_t>(word) ^ keystream_x0(k0, k1, pos);
  *out = static_cast<int32_t>(w);
  *fault = f;
}

// The fused egress of kernels 3 and 4 for one block of one row: VEC words
// per thread, each checked by the search against the row's shard and
// decrypted at keystream position pos0 + lane (mod 2^32), or zeroed with
// its fault code.  `data`, `ext`, `out` and `fault` point at the row's
// first word, `starts`, `ends`, `permbits` and `tile_min` at its shard.
// Every thread of the block must call it (the prologue synchronises).
template <bool WIDE>
__device__ __forceinline__ void egress_block(
    const int32_t* __restrict__ data, const int32_t* __restrict__ ext,
    int64_t b, int32_t hwpid, const int32_t* __restrict__ starts,
    const int32_t* __restrict__ ends, const int32_t* __restrict__ permbits,
    const int32_t* __restrict__ tile_min, int n_tiles, int32_t need,
    uint32_t k0, uint32_t k1, uint32_t pos0, int32_t* __restrict__ out,
    int32_t* __restrict__ fault) {
  __shared__ int32_t s_tmin[MAX_TILES];
  __shared__ int32_t s_tile[ENTRY_TILE];
  // the words first: their loads overlap the shard prologue's
  const int64_t lane0 =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) * VEC;
  int32_t w[VEC], e[VEC], page[VEC];
  load_vec<WIDE>(data, lane0, b, 0, w);
  load_vec<WIDE>(ext, lane0, b, -1, e);
  const Shard sh = shard_prologue(starts, tile_min, n_tiles, s_tmin, s_tile);
  if (lane0 >= b) return;
#pragma unroll
  for (int j = 0; j < VEC; ++j) page[j] = e[j] & PAGE_MASK;
  int k[VEC];
  lane_search<VEC>(page, sh, k);
  int32_t o[VEC], f[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const Verdict v = entry_verdict(page[j], k[j], ends, permbits, need);
    egress_word(w[j], e[j], hwpid, v, k0, k1,
                pos0 + static_cast<uint32_t>(lane0 + j), &o[j], &f[j]);
  }
  store_vec<WIDE>(out, lane0, b, o);
  store_vec<WIDE>(fault, lane0, b, f);
}

}  // namespace egress
