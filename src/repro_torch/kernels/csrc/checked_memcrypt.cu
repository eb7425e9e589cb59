// Kernel 3: the fused egress — cover-only permission lookup, keystream
// decrypt, zero-fill and one FAULT_* code per word, in one pass.
//
// Replaces src/repro/kernels/memcrypt.py:checked_memcrypt_view_pallas
// (_checked_memcrypt_kernel, with _cover_search / _cover_tile from
// permcheck.py).  Bound on the H100: bytes — 16 per word and 4 per table
// word a search of the sorted shard reads, against ~52 integer operations
// per granted word for the keystream and ~3 per probe of that search.
// Design: the block-wide slab scan (`egress::block_lookup`, ~3 operations
// per word and evaluated entry, so far above that bound) for "granted" and
// "covered", then the keystream computed only on granted lanes; each word
// is read once and written once.
#include "egress.cuh"

namespace {

__global__ void __launch_bounds__(egress::THREADS)
checked_memcrypt_kernel(const int32_t* __restrict__ data,
                        const int32_t* __restrict__ ext, int64_t b,
                        const int32_t* __restrict__ starts,
                        const int32_t* __restrict__ sizes,
                        const int32_t* __restrict__ sizes_ok, int n_tiles,
                        const int32_t* __restrict__ tile_min,
                        const int32_t* __restrict__ tile_max,
                        const int32_t* __restrict__ sel, int32_t hwpid,
                        uint32_t k0, uint32_t k1, uint32_t base_word,
                        int32_t* __restrict__ out,
                        int32_t* __restrict__ fault) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  const bool active = i < b;
  const int32_t e = active ? ext[i] : -1;
  const egress::Verdict v = egress::block_lookup(
      e & egress::PAGE_MASK, active, starts, sizes, sizes_ok, n_tiles,
      tile_min, tile_max, *sel != 0);
  if (active)
    egress::egress_word(data[i], e, hwpid, v, k0, k1,
                        base_word + static_cast<uint32_t>(i), out + i,
                        fault + i);
}

}  // namespace

extern "C" int checked_memcrypt_launch(
    const void* data, const void* ext, int64_t b, const void* starts,
    const void* sizes, const void* sizes_ok, int32_t n_tiles,
    const void* tile_min, const void* tile_max, const void* sel,
    int32_t hwpid, uint32_t k0, uint32_t k1, uint32_t base_word, void* out,
    void* fault, void* stream) {
  if (b <= 0) return 0;
  if (n_tiles < 1 || n_tiles > egress::MAX_TILES) return cudaErrorInvalidValue;
  const int64_t blocks = (b + egress::THREADS - 1) / egress::THREADS;
  checked_memcrypt_kernel<<<static_cast<unsigned>(blocks), egress::THREADS,
                            0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(data), static_cast<const int32_t*>(ext), b,
      static_cast<const int32_t*>(starts), static_cast<const int32_t*>(sizes),
      static_cast<const int32_t*>(sizes_ok), n_tiles,
      static_cast<const int32_t*>(tile_min),
      static_cast<const int32_t*>(tile_max),
      static_cast<const int32_t*>(sel), hwpid, k0, k1, base_word,
      static_cast<int32_t*>(out), static_cast<int32_t*>(fault));
  return static_cast<int>(cudaGetLastError());
}
