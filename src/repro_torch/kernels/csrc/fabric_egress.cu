// Kernel 4: the fabric-wide batched egress — kernel 3 for every
// (host, tenant) row of a fabric step in one launch.
//
// Replaces src/repro/kernels/fabric_egress.py:fabric_egress_pallas
// (_fabric_egress_impl, _fabric_egress_kernel).  Bound on the H100: at the
// 255-host deployment each row's shard is one 1024-entry slab, so the flat
// walk spends ~3000 integer operations per word (three per slab entry)
// against 16 bytes per word: operations bound, although the function needs
// only the slab's few live entries.  Design: a 2-D grid (address block,
// row); each row's tenant HWPID and flat/hier choice are read from device
// arrays, so admitting a tenant or a row changing mode never rebuilds or
// re-launches anything, and flat and hier rows share one launch.  Rows are
// not padded: the keystream position is still counted as
// row * bucket_pad(B, 1024) + lane, as the reference pads each row.
#include "egress.cuh"

namespace {

__global__ void __launch_bounds__(egress::THREADS)
fabric_egress_kernel(const int32_t* __restrict__ data,
                     const int32_t* __restrict__ ext, int64_t b, int64_t bp,
                     const int32_t* __restrict__ hwpids,
                     const int32_t* __restrict__ use_hier,
                     const int32_t* __restrict__ starts,
                     const int32_t* __restrict__ sizes,
                     const int32_t* __restrict__ sizes_ok, int64_t n_entries,
                     const int32_t* __restrict__ tile_min,
                     const int32_t* __restrict__ tile_max, int n_tiles,
                     uint32_t k0, uint32_t k1, int32_t* __restrict__ out,
                     int32_t* __restrict__ fault) {
  const int64_t row = blockIdx.y;
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
  const bool active = lane < b;
  const int64_t i = row * b + lane;
  const int32_t e = active ? ext[i] : -1;
  const int64_t eo = row * n_entries;
  const int64_t to = row * static_cast<int64_t>(n_tiles);
  const egress::Verdict v = egress::block_lookup<false>(
      e & egress::PAGE_MASK, active, starts + eo, sizes + eo, sizes_ok + eo,
      n_tiles, tile_min + to, tile_max + to, use_hier[row] != 0);
  if (active)
    egress::egress_word(data[i], e, hwpids[row], v, k0, k1,
                        static_cast<uint32_t>(row * bp + lane), out + i,
                        fault + i);
}

}  // namespace

extern "C" int fabric_egress_launch(
    const void* data, const void* ext, int64_t rows, int64_t b, int64_t bp,
    const void* hwpids, const void* use_hier, const void* starts,
    const void* sizes, const void* sizes_ok, int64_t n_entries,
    const void* tile_min, const void* tile_max, int32_t n_tiles, uint32_t k0,
    uint32_t k1, void* out, void* fault, void* stream) {
  if (rows <= 0 || b <= 0) return 0;
  if (n_tiles < 1 || n_tiles > egress::MAX_TILES || rows > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>((b + egress::THREADS - 1) /
                                        egress::THREADS),
                  static_cast<unsigned>(rows));
  fabric_egress_kernel<<<grid, egress::THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(data), static_cast<const int32_t*>(ext), b,
      bp, static_cast<const int32_t*>(hwpids),
      static_cast<const int32_t*>(use_hier),
      static_cast<const int32_t*>(starts), static_cast<const int32_t*>(sizes),
      static_cast<const int32_t*>(sizes_ok), n_entries,
      static_cast<const int32_t*>(tile_min),
      static_cast<const int32_t*>(tile_max), n_tiles, k0, k1,
      static_cast<int32_t*>(out), static_cast<int32_t*>(fault));
  return static_cast<int>(cudaGetLastError());
}
