// Device functions shared by the four egress kernels (memcrypt, permcheck,
// checked_memcrypt, fabric_egress).  Keeping the keystream and the lookup in
// one header makes the kernels bit-identical to each other by construction:
// kernels 1, 3 and 4 run the same 12-round ARX keystream, kernels 2, 3 and 4
// the same diff-form range test.
//
// u32 words cross the C interface as int32 (torch has no uint32 arithmetic
// on the CPU); every kernel reinterprets them as uint32_t and hands the same
// bit patterns back.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace egress {

constexpr int THREADS = 256;        // threads per block = lanes per block
constexpr int ENTRY_TILE = 1024;    // table entries per shared-memory slab
constexpr int MAX_TILES = 64;       // MAX_ENTRIES / ENTRY_TILE: one u64 mask
constexpr int HWPID_SHIFT = 24;
constexpr int32_t PAGE_MASK = (1 << HWPID_SHIFT) - 1;

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
  int32_t idx;    // first covering entry (WANT_IDX only), else -1
};

// One page per thread, looked up against one table shard.  The shard streams
// through shared memory ENTRY_TILE entries at a time (12 KB of starts, sizes,
// sizes_ok); each slab is read from device memory once per block and then
// broadcast to every lane, so the block pays N*12 bytes per 256 lanes.
//
// The range test is the diff form `(page - start) as u32 < size`: a page
// below the start wraps to a huge unsigned value, a denied entry carries a
// zero `sizes_ok` window, and the INT32_MAX sentinel entries have size 0 and
// never match.
//
// `hier` (uniform across the block) first ORs the candidate tiles of every
// lane's page from the [tile_min, tile_max) summary into one u64 mask and
// then walks only the set tiles, in ascending order, so `idx` stays the FIRST
// covering entry; flat walks every tile.  Any entry that covers a page lies
// in a tile whose window holds the page, so both walks give the same answer.
//
// Every thread of the block must call this (it synchronises); `active` marks
// the lanes that hold a page.
template <bool WANT_IDX>
__device__ __forceinline__ Verdict block_lookup(
    int32_t page, bool active, const int32_t* __restrict__ starts,
    const int32_t* __restrict__ sizes, const int32_t* __restrict__ sizes_ok,
    int n_tiles, const int32_t* __restrict__ tile_min,
    const int32_t* __restrict__ tile_max, bool hier) {
  __shared__ int32_t s_start[ENTRY_TILE];
  __shared__ uint32_t s_size[ENTRY_TILE];
  __shared__ uint32_t s_ok[ENTRY_TILE];
  __shared__ unsigned long long s_need;

  unsigned long long need;
  if (hier) {
    if (threadIdx.x == 0) s_need = 0ull;
    __syncthreads();
    if (active) {
      unsigned long long mine = 0ull;
      for (int t = 0; t < n_tiles; ++t)
        if (page >= tile_min[t] && page < tile_max[t]) mine |= 1ull << t;
      if (mine) atomicOr(&s_need, mine);
    }
    __syncthreads();
    need = s_need;
  } else {
    need = n_tiles >= MAX_TILES ? ~0ull : ((1ull << n_tiles) - 1ull);
  }

  Verdict v{false, false, -1};
  const uint32_t upage = static_cast<uint32_t>(page);
  while (need) {
    const int t = __ffsll(static_cast<long long>(need)) - 1;
    need &= need - 1ull;
    __syncthreads();  // every lane is done with the previous slab
    for (int k = threadIdx.x; k < ENTRY_TILE; k += blockDim.x) {
      const int64_t g = static_cast<int64_t>(t) * ENTRY_TILE + k;
      s_start[k] = starts[g];
      s_size[k] = static_cast<uint32_t>(sizes[g]);
      s_ok[k] = static_cast<uint32_t>(sizes_ok[g]);
    }
    __syncthreads();
    if (active) {
#pragma unroll 8
      for (int k = 0; k < ENTRY_TILE; ++k) {
        const uint32_t diff = upage - static_cast<uint32_t>(s_start[k]);
        v.any_ok |= diff < s_ok[k];
        if (WANT_IDX) {
          if (v.idx < 0 && diff < s_size[k]) v.idx = t * ENTRY_TILE + k;
        } else {
          v.covered |= diff < s_size[k];
        }
      }
    }
  }
  if (WANT_IDX) v.covered = v.idx >= 0;
  return v;
}

// The fused egress epilogue of kernels 3 and 4: the verdict's fault code in
// the reference's priority (NO_ABITS for tag <= 0 — the -1 padding lane
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
  *out = allowed ? static_cast<int32_t>(static_cast<uint32_t>(word) ^
                                        keystream_x0(k0, k1, pos))
                 : 0;
  *fault = f;
}

}  // namespace egress
