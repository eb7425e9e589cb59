// Kernel 2: the permission check — per tagged address, `allowed` (tag match
// and some covering entry grants `need`) and `idx` (first covering entry,
// else -1), in flat, hier or adaptive mode.
//
// Replaces src/repro/kernels/permcheck.py:permcheck_view_pallas
// (_permcheck_flat_kernel, _permcheck_hier_kernel,
// _permcheck_adaptive_kernel).  Bound on the H100: integer operations —
// about four per (address, evaluated entry), against 9 bytes per address and
// 12 per entry.  The TPU kernel keeps the whole shard (up to 768 KiB)
// resident in VMEM; that does not fit in 227 KB of shared memory, so here
// each block of 256 addresses streams the shard through shared memory in
// 1024-entry slabs read once per block and broadcast to all lanes, and hier
// mode skips every slab no lane of the block needs.  Adaptive mode reads the
// selector from device memory, so choosing a mode never syncs the host.
#include "egress.cuh"

namespace {

__global__ void __launch_bounds__(egress::THREADS)
permcheck_kernel(const int32_t* __restrict__ ext, int64_t b,
                 const int32_t* __restrict__ starts,
                 const int32_t* __restrict__ sizes,
                 const int32_t* __restrict__ sizes_ok, int n_tiles,
                 const int32_t* __restrict__ tile_min,
                 const int32_t* __restrict__ tile_max,
                 const int32_t* __restrict__ sel, int mode, int32_t hwpid,
                 bool* __restrict__ allowed, int32_t* __restrict__ idx) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  const bool active = i < b;
  const int32_t e = active ? ext[i] : -1;
  // mode 0 flat, 1 hier, 2 adaptive (selector operand, uniform per launch)
  const bool hier = mode == 1 || (mode == 2 && *sel != 0);
  const egress::Verdict v = egress::block_lookup<true>(
      e & egress::PAGE_MASK, active, starts, sizes, sizes_ok, n_tiles,
      tile_min, tile_max, hier);
  if (active) {
    allowed[i] = ((e >> egress::HWPID_SHIFT) == hwpid) && v.any_ok;
    idx[i] = v.idx;
  }
}

}  // namespace

extern "C" int permcheck_launch(const void* ext, int64_t b,
                                const void* starts, const void* sizes,
                                const void* sizes_ok, int32_t n_tiles,
                                const void* tile_min, const void* tile_max,
                                const void* sel, int32_t mode, int32_t hwpid,
                                void* allowed, void* idx, void* stream) {
  if (b <= 0) return 0;
  if (n_tiles < 1 || n_tiles > egress::MAX_TILES) return cudaErrorInvalidValue;
  const int64_t blocks = (b + egress::THREADS - 1) / egress::THREADS;
  permcheck_kernel<<<static_cast<unsigned>(blocks), egress::THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ext), b,
      static_cast<const int32_t*>(starts), static_cast<const int32_t*>(sizes),
      static_cast<const int32_t*>(sizes_ok), n_tiles,
      static_cast<const int32_t*>(tile_min),
      static_cast<const int32_t*>(tile_max),
      static_cast<const int32_t*>(sel), mode, hwpid,
      static_cast<bool*>(allowed), static_cast<int32_t*>(idx));
  return static_cast<int>(cudaGetLastError());
}
