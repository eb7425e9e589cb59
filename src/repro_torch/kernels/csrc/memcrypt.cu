// Kernel 1: counter-mode ARX keystream XOR over a u32 buffer.
//
// Replaces src/repro/kernels/memcrypt.py:memcrypt_pallas (_memcrypt_kernel).
// Bound on the H100: integer operations, narrowly — ~52 int32 operations per
// word (12 rounds of add, rotate, xor plus key injections) at 64 per clock
// per SM take about 1.3x as long as HBM needs for the 8 bytes moved per
// word.  Design: one thread per word on a grid-stride loop, coalesced 4-byte
// loads and stores, the keystream in registers; no shared memory and nothing
// kept between words.
#include "egress.cuh"

namespace {

__global__ void __launch_bounds__(egress::THREADS)
memcrypt_kernel(const int32_t* __restrict__ data, int32_t* __restrict__ out,
                int64_t n, uint32_t k0, uint32_t k1, uint32_t base_word) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    const uint32_t pos = base_word + static_cast<uint32_t>(i);  // mod 2^32
    out[i] = static_cast<int32_t>(static_cast<uint32_t>(data[i]) ^
                                  egress::keystream_x0(k0, k1, pos));
  }
}

}  // namespace

extern "C" int memcrypt_launch(const void* data, void* out, int64_t n,
                               uint32_t k0, uint32_t k1, uint32_t base_word,
                               void* stream) {
  if (n <= 0) return 0;
  int64_t blocks = (n + egress::THREADS - 1) / egress::THREADS;
  if (blocks > (1 << 20)) blocks = 1 << 20;
  memcrypt_kernel<<<static_cast<unsigned>(blocks), egress::THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(data), static_cast<int32_t*>(out), n, k0,
      k1, base_word);
  return static_cast<int>(cudaGetLastError());
}
