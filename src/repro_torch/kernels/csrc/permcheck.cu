// Kernel 2: the permission check — per tagged address, `allowed` (tag match
// and the covering entry grants `need`) and `idx` (the covering entry, else
// -1).  The reference's flat, hier and adaptive modes change only its cost;
// all three run this one search.
//
// Replaces src/repro/kernels/permcheck.py:permcheck_view_pallas
// (_permcheck_flat_kernel, _permcheck_hier_kernel,
// _permcheck_adaptive_kernel).  Bound on the H100: bytes — 9 per address
// and 4 per table word the search reads, against ~3 integer operations per
// probe and ceil(log2 live tiles) + ceil(log2 live entries of the tile) + 1
// probes per address.  The TPU kernel compares every address with every
// entry of the tiles it walks, keeping the shard (up to 768 KiB) resident in
// VMEM; here each lane binary-searches the sorted shard
// (`egress::lane_search`): the tile summary from shared memory, then the
// tile's starts through the read-only cache, whose top levels every lane
// shares.  Each thread takes VEC consecutive addresses with 16-byte loads
// and stores, so its VEC searches overlap their loads.
#include "egress.cuh"

namespace {

template <bool WIDE>
__global__ void __launch_bounds__(egress::SEARCH_THREADS)
permcheck_kernel(const int32_t* __restrict__ ext, int64_t b,
                 const int32_t* __restrict__ starts,
                 const int32_t* __restrict__ ends,
                 const int32_t* __restrict__ permbits,
                 const int32_t* __restrict__ tile_min, int n_tiles,
                 int32_t need, int32_t hwpid, bool* __restrict__ allowed,
                 int32_t* __restrict__ idx) {
  constexpr int V = egress::VEC;
  __shared__ int32_t s_tmin[egress::MAX_TILES];
  __shared__ int32_t s_tile[egress::ENTRY_TILE];
  // the addresses first: their loads overlap the shard prologue's
  const int64_t i0 =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) * V;
  int32_t e[V], page[V];
  egress::load_vec<WIDE>(ext, i0, b, -1, e);
  const egress::Shard sh =
      egress::shard_prologue(starts, tile_min, n_tiles, s_tmin, s_tile);
  if (i0 >= b) return;
#pragma unroll
  for (int j = 0; j < V; ++j) page[j] = e[j] & egress::PAGE_MASK;
  int k[V];
  egress::lane_search<V>(page, sh, k);
  bool ok[V];
  int32_t id[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const egress::Verdict v =
        egress::entry_verdict(page[j], k[j], ends, permbits, need);
    ok[j] = (e[j] >> egress::HWPID_SHIFT) == hwpid && v.any_ok;
    id[j] = v.idx;
  }
  egress::store_vec<WIDE>(idx, i0, b, id);
  egress::store_vec<WIDE>(allowed, i0, b, ok);
}

}  // namespace

extern "C" int permcheck_launch(const void* ext, int64_t b,
                                const void* starts, const void* ends,
                                const void* permbits, int64_t n_entries,
                                const void* tile_min, int32_t n_tiles,
                                int32_t need, int32_t hwpid, void* allowed,
                                void* idx, void* stream) {
  if (b <= 0) return 0;
  if (n_tiles < 1 || n_tiles > egress::MAX_TILES ||
      n_entries != static_cast<int64_t>(n_tiles) * egress::ENTRY_TILE)
    return cudaErrorInvalidValue;
  const int64_t per_block =
      static_cast<int64_t>(egress::SEARCH_THREADS) * egress::VEC;
  const unsigned blocks = static_cast<unsigned>((b + per_block - 1) /
                                                per_block);
  const bool wide = b % egress::VEC == 0 && egress::aligned16(ext) &&
                    egress::aligned16(idx) &&
                    reinterpret_cast<uintptr_t>(allowed) % egress::VEC == 0;
  auto kernel = wide ? permcheck_kernel<true> : permcheck_kernel<false>;
  kernel<<<blocks, egress::SEARCH_THREADS, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ext), b,
      static_cast<const int32_t*>(starts), static_cast<const int32_t*>(ends),
      static_cast<const int32_t*>(permbits),
      static_cast<const int32_t*>(tile_min), n_tiles, need, hwpid,
      static_cast<bool*>(allowed), static_cast<int32_t*>(idx));
  return static_cast<int>(cudaGetLastError());
}
