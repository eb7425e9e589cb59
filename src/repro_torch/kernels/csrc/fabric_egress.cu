// Kernel 4: the fabric-wide batched egress — kernel 3 for every
// (host, tenant) row of a fabric step in one launch.
//
// Replaces src/repro/kernels/fabric_egress.py:fabric_egress_pallas
// (_fabric_egress_impl, _fabric_egress_kernel).  Bound on the H100: bytes —
// 16 per word (data and address in, word and fault out), 4 per row (its
// HWPID) and 4 per table word the search reads, against ~52 integer
// operations per granted word for the keystream and ~3 per search probe.
// Design: a 2-D grid (word block, row); each block finds its row's shard by
// blockIdx.y and runs the fused egress block (`egress::egress_block`, which
// kernel 3 runs on one row): each lane binary-searches the shard
// (`egress::lane_search`), so a word costs O(log N) probes.  At the
// 255-host deployment a row's live entries fit in one 1024-entry tile: the
// block stages that tile in shared memory and searches only its live
// entries.  Each thread takes VEC consecutive words with 16-byte loads of
// data and address and 16-byte stores of word and fault, and runs the
// keystream on granted words only.  The tenant HWPID is a per-row device
// operand, so admitting a tenant never rebuilds or re-launches anything.
// Rows are not padded: the keystream position is still counted as
// row * bucket_pad(B, 1024) + lane, as the reference pads each row.
#include "egress.cuh"

namespace {

template <bool WIDE>
__global__ void __launch_bounds__(egress::SEARCH_THREADS)
fabric_egress_kernel(const int32_t* __restrict__ data,
                     const int32_t* __restrict__ ext, int64_t b, int64_t bp,
                     const int32_t* __restrict__ hwpids,
                     const int32_t* __restrict__ starts,
                     const int32_t* __restrict__ ends,
                     const int32_t* __restrict__ permbits, int64_t n_entries,
                     const int32_t* __restrict__ tile_min, int n_tiles,
                     int32_t need, uint32_t k0, uint32_t k1,
                     int32_t* __restrict__ out, int32_t* __restrict__ fault) {
  const int64_t row = blockIdx.y;
  const int64_t ro = row * b, eo = row * n_entries;
  egress::egress_block<WIDE>(data + ro, ext + ro, b, hwpids[row], starts + eo,
                             ends + eo, permbits + eo,
                             tile_min + row * n_tiles, n_tiles, need, k0, k1,
                             static_cast<uint32_t>(row * bp), out + ro,
                             fault + ro);
}

}  // namespace

extern "C" int fabric_egress_launch(
    const void* data, const void* ext, int64_t rows, int64_t b, int64_t bp,
    const void* hwpids, const void* starts, const void* ends,
    const void* permbits, int64_t n_entries, const void* tile_min,
    int32_t n_tiles, int32_t need, uint32_t k0, uint32_t k1, void* out,
    void* fault, void* stream) {
  if (rows <= 0 || b <= 0) return 0;
  if (n_tiles < 1 || n_tiles > egress::MAX_TILES || rows > 65535 ||
      n_entries != static_cast<int64_t>(n_tiles) * egress::ENTRY_TILE)
    return cudaErrorInvalidValue;
  const int64_t per_block =
      static_cast<int64_t>(egress::SEARCH_THREADS) * egress::VEC;
  const dim3 grid(static_cast<unsigned>((b + per_block - 1) / per_block),
                  static_cast<unsigned>(rows));
  const bool wide = b % egress::VEC == 0 && egress::aligned16(data) &&
                    egress::aligned16(ext) && egress::aligned16(out) &&
                    egress::aligned16(fault);
  auto kernel = wide ? fabric_egress_kernel<true>
                     : fabric_egress_kernel<false>;
  kernel<<<grid, egress::SEARCH_THREADS, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(data), static_cast<const int32_t*>(ext), b,
      bp, static_cast<const int32_t*>(hwpids),
      static_cast<const int32_t*>(starts), static_cast<const int32_t*>(ends),
      static_cast<const int32_t*>(permbits), n_entries,
      static_cast<const int32_t*>(tile_min), n_tiles, need, k0, k1,
      static_cast<int32_t*>(out), static_cast<int32_t*>(fault));
  return static_cast<int>(cudaGetLastError());
}
