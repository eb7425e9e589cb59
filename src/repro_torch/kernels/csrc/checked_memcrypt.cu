// Kernel 3: the fused egress — cover-only permission lookup, keystream
// decrypt, zero-fill and one FAULT_* code per word, in one pass.
//
// Replaces src/repro/kernels/memcrypt.py:checked_memcrypt_view_pallas
// (_checked_memcrypt_kernel, with _cover_search / _cover_tile from
// permcheck.py).  Bound on the H100: bytes — 16 per word and 4 per table
// word a search of the sorted shard reads, against ~52 integer operations
// per granted word for the keystream and ~3 per probe of that search.
// Design: kernel 4's block body (`egress::egress_block`) on one row: each
// lane binary-searches the sorted shard (`egress::lane_search`, so a word
// costs O(log N) probes where the TPU kernel compares it with every entry
// of the tiles it walks), tests the one entry found against the page and
// `need`, and runs the keystream on granted words only.  Each thread takes
// VEC consecutive words with 16-byte loads of data and address and 16-byte
// stores of word and fault; each word is read once and written once.
#include "egress.cuh"

namespace {

template <bool WIDE>
__global__ void __launch_bounds__(egress::SEARCH_THREADS)
checked_memcrypt_kernel(const int32_t* __restrict__ data,
                        const int32_t* __restrict__ ext, int64_t b,
                        const int32_t* __restrict__ starts,
                        const int32_t* __restrict__ ends,
                        const int32_t* __restrict__ permbits,
                        const int32_t* __restrict__ tile_min, int n_tiles,
                        int32_t need, int32_t hwpid, uint32_t k0, uint32_t k1,
                        uint32_t base_word, int32_t* __restrict__ out,
                        int32_t* __restrict__ fault) {
  egress::egress_block<WIDE>(data, ext, b, hwpid, starts, ends, permbits,
                             tile_min, n_tiles, need, k0, k1, base_word, out,
                             fault);
}

}  // namespace

extern "C" int checked_memcrypt_launch(
    const void* data, const void* ext, int64_t b, const void* starts,
    const void* ends, const void* permbits, int64_t n_entries,
    const void* tile_min, int32_t n_tiles, int32_t need, int32_t hwpid,
    uint32_t k0, uint32_t k1, uint32_t base_word, void* out, void* fault,
    void* stream) {
  if (b <= 0) return 0;
  if (n_tiles < 1 || n_tiles > egress::MAX_TILES ||
      n_entries != static_cast<int64_t>(n_tiles) * egress::ENTRY_TILE)
    return cudaErrorInvalidValue;
  const int64_t per_block =
      static_cast<int64_t>(egress::SEARCH_THREADS) * egress::VEC;
  const unsigned blocks = static_cast<unsigned>((b + per_block - 1) /
                                                per_block);
  const bool wide = b % egress::VEC == 0 && egress::aligned16(data) &&
                    egress::aligned16(ext) && egress::aligned16(out) &&
                    egress::aligned16(fault);
  auto kernel = wide ? checked_memcrypt_kernel<true>
                     : checked_memcrypt_kernel<false>;
  kernel<<<blocks, egress::SEARCH_THREADS, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(data), static_cast<const int32_t*>(ext), b,
      static_cast<const int32_t*>(starts), static_cast<const int32_t*>(ends),
      static_cast<const int32_t*>(permbits),
      static_cast<const int32_t*>(tile_min), n_tiles, need, hwpid, k0, k1,
      base_word, static_cast<int32_t*>(out), static_cast<int32_t*>(fault));
  return static_cast<int>(cudaGetLastError());
}
