// The dropless MoE's expert FFN over slots sorted by expert, f32.
//
// Replaces no TPU kernel: the reference computes its experts with XLA's
// batched products over a capacity buffer ([E, C, D]), which drops slots
// past the capacity.  This kernel runs granite's dropless dispatch, at
// decode and at prefill: slot s of expert e (offsets[e] <= s <
// offsets[e + 1]) reads token tok[s]'s row of x and gets
//
//   y[s] = (silu(x @ Wg[e]) * (x @ Wu[e])) @ Wd[e]
//
// Bound on the H100 at decode: bytes.  There an expert sees a few slots (16
// tokens x top-10 over 72 experts: ~2.2), so the weights of the experts hit
// (3 x D x F x 4 B each) are nearly all the traffic, at ~2 x slots FLOPs a
// weight.  At prefill (a chunk of 8,192 tokens: ~1,100 slots an expert) it
// is the f32 operations.  Design: each weight is read from device memory
// once for all of its expert's slots, and an expert with no slots costs
// its blocks one read of two offsets.  Three kernels on one stream:
//
//   gate_up: grid (Z, column tiles x K splits, E).  A block holds SB slots
//     at a time, stages their x rows in shared memory KT rows at a time,
//     and streams its [rows, VEC x threads] tile of Wg and Wu with VEC-wide
//     loads, keeping SB x VEC sums of each in registers.  The D rows are
//     cut into K splits so that a decode's ~65 live experts still fill the
//     card; each split writes its partial sums to a workspace [K, slots,
//     2F] (no atomics: the sums are the same from run to run).
//   act: h = silu(sum_k gate) * sum_k up, [slots, F].
//   down: grid (Z, column tiles of D, E), SB slots of h at a time against
//     a [F, VEC x threads] tile of Wd; y is written in sorted slot order.
//
// Z blocks share an expert's slot chunks (chunk c goes to block c mod Z),
// so a prefill-sized call still spreads over the card.  Z is the grid's
// fastest dimension: the blocks that read one weight tile run side by side
// and find it in L2, where Z outermost would stream every expert's weights
// from device memory once per chunk.  Two shapes of block: at decode SB 8
// slots x VEC 4 columns a thread (a few slots, so wide rows of weights);
// at prefill SB 16 x VEC 2, which halves the L2 bytes a multiply-add.  The
// wrapper picks the shape, Z and the K splits from the slot count.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 128;
constexpr int KT = 256;            // x or h rows staged in shared memory

__device__ __forceinline__ float silu(float g) {
  return g / (1.f + expf(-g));
}

// VEC consecutive floats at p (aligned to VEC floats)
template <int VEC>
__device__ __forceinline__ void load(const float* p, float (&w)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    w[0] = t.x; w[1] = t.y; w[2] = t.z; w[3] = t.w;
  } else {
    static_assert(VEC == 2, "VEC is 2 or 4");
    const float2 t = *reinterpret_cast<const float2*>(p);
    w[0] = t.x; w[1] = t.y;
  }
}

template <int VEC>
__device__ __forceinline__ void store(float* p, const float (&w)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(w[0], w[1], w[2], w[3]);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(w[0], w[1]);
  }
}

template <int VEC>
__device__ __forceinline__ void fma_row(float (&acc)[VEC], float a,
                                        const float (&w)[VEC]) {
#pragma unroll
  for (int v = 0; v < VEC; ++v) acc[v] += a * w[v];
}

// Stage rows [k, k + kn) of the SB slots' inputs (rows of `src` picked by
// `row_of`, zero for slots past nb) into xs[SB][KT].
template <int SB, typename RowOf>
__device__ __forceinline__ void stage(float* xs, const float* __restrict__ src,
                                      int64_t width, int nb, int k, int kn,
                                      RowOf row_of) {
  for (int i = threadIdx.x; i < SB * KT; i += THREADS) {
    const int j = i / KT, kk = i % KT;
    xs[i] = (j < nb && kk < kn) ? src[row_of(j) * width + k + kk] : 0.f;
  }
}

template <int SB, int VEC>
__global__ void __launch_bounds__(THREADS)
moe_grouped_ffn_gate_up(const float* __restrict__ x,
                        const int32_t* __restrict__ tok,
                        const int32_t* __restrict__ offsets,
                        const float* __restrict__ wg,
                        const float* __restrict__ wu, float* __restrict__ ws,
                        int64_t n_slots, int d, int f, int col_tiles,
                        int k_rows) {
  __shared__ __align__(16) float xs[SB * KT];
  const int e = blockIdx.z;
  const int seg0 = offsets[e];
  const int n = offsets[e + 1] - seg0;
  if (n <= 0) return;
  const int tile = blockIdx.y % col_tiles, split = blockIdx.y / col_tiles;
  const int k0 = split * k_rows, k1 = min(d, k0 + k_rows);
  const int col = tile * VEC * THREADS + threadIdx.x * VEC;
  const bool live = col < f;
  const float* gw = wg + static_cast<int64_t>(e) * d * f + col;
  const float* uw = wu + static_cast<int64_t>(e) * d * f + col;
  float* part = ws + static_cast<int64_t>(split) * n_slots * 2 * f;
  for (int c0 = blockIdx.x * SB; c0 < n; c0 += gridDim.x * SB) {
    const int nb = min(SB, n - c0);
    float ag[SB][VEC] = {}, au[SB][VEC] = {};
    for (int k = k0; k < k1; k += KT) {
      const int kn = min(KT, k1 - k);
      __syncthreads();
      stage<SB>(xs, x, d, nb, k, kn, [&](int j) {
        return static_cast<int64_t>(tok[seg0 + c0 + j]);
      });
      __syncthreads();
      if (!live) continue;
#pragma unroll 4
      for (int kk = 0; kk < kn; ++kk) {
        const int64_t r = static_cast<int64_t>(k + kk) * f;
        float g[VEC], u[VEC];
        load<VEC>(gw + r, g);
        load<VEC>(uw + r, u);
#pragma unroll
        for (int j = 0; j < SB; ++j) {
          const float a = xs[j * KT + kk];
          fma_row<VEC>(ag[j], a, g);
          fma_row<VEC>(au[j], a, u);
        }
      }
    }
    if (!live) continue;
    for (int j = 0; j < nb; ++j) {
      float* row = part + static_cast<int64_t>(seg0 + c0 + j) * 2 * f;
      store<VEC>(row + col, ag[j]);
      store<VEC>(row + f + col, au[j]);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
moe_grouped_ffn_act(const float* __restrict__ ws, float* __restrict__ h,
                    int64_t n_slots, int f, int splits) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (i >= n_slots * f) return;
  const int64_t s = i / f, c = i % f;
  float g = 0.f, u = 0.f;
  for (int k = 0; k < splits; ++k) {
    const float* row = ws + (static_cast<int64_t>(k) * n_slots + s) * 2 * f;
    g += row[c];
    u += row[f + c];
  }
  h[i] = silu(g) * u;
}

template <int SB, int VEC>
__global__ void __launch_bounds__(THREADS)
moe_grouped_ffn_down(const float* __restrict__ h,
                     const int32_t* __restrict__ offsets,
                     const float* __restrict__ wd, float* __restrict__ y,
                     int d, int f) {
  __shared__ __align__(16) float hs[SB * KT];
  const int e = blockIdx.z;
  const int seg0 = offsets[e];
  const int n = offsets[e + 1] - seg0;
  if (n <= 0) return;
  const int col = blockIdx.y * VEC * THREADS + threadIdx.x * VEC;
  const bool live = col < d;
  const float* dw = wd + static_cast<int64_t>(e) * f * d + col;
  for (int c0 = blockIdx.x * SB; c0 < n; c0 += gridDim.x * SB) {
    const int nb = min(SB, n - c0);
    float acc[SB][VEC] = {};
    for (int k = 0; k < f; k += KT) {
      const int kn = min(KT, f - k);
      __syncthreads();
      stage<SB>(hs, h, f, nb, k, kn, [&](int j) {
        return static_cast<int64_t>(seg0 + c0 + j);
      });
      __syncthreads();
      if (!live) continue;
#pragma unroll 4
      for (int kk = 0; kk < kn; ++kk) {
        float w[VEC];
        load<VEC>(dw + static_cast<int64_t>(k + kk) * d, w);
#pragma unroll
        for (int j = 0; j < SB; ++j) fma_row<VEC>(acc[j], hs[j * KT + kk], w);
      }
    }
    if (!live) continue;
    for (int j = 0; j < nb; ++j)
      store<VEC>(y + static_cast<int64_t>(seg0 + c0 + j) * d + col, acc[j]);
  }
}

template <int SB, int VEC>
cudaError_t run(const float* x, const int32_t* tok, const int32_t* offsets,
                const float* wg, const float* wu, const float* wd, float* ws,
                float* h, float* y, int64_t n_slots, int e, int d, int f,
                int splits, int z, cudaStream_t s) {
  constexpr int cols = VEC * THREADS;  // columns of a block's weight tile
  const int col_tiles = (f + cols - 1) / cols;
  const int k_rows = (d + splits - 1) / splits;
  moe_grouped_ffn_gate_up<SB, VEC>
      <<<dim3(z, col_tiles * splits, e), THREADS, 0, s>>>(
          x, tok, offsets, wg, wu, ws, n_slots, d, f, col_tiles, k_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t act_blocks = (n_slots * f + THREADS - 1) / THREADS;
  moe_grouped_ffn_act<<<static_cast<unsigned>(act_blocks), THREADS, 0, s>>>(
      ws, h, n_slots, f, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  moe_grouped_ffn_down<SB, VEC>
      <<<dim3(z, (d + cols - 1) / cols, e), THREADS, 0, s>>>(h, offsets, wd,
                                                             y, d, f);
  return cudaGetLastError();
}

}  // namespace

// x [T, D], tok [n_slots] (int32 token of each sorted slot), offsets [E+1]
// (int32, on the device), wg/wu [E, D, F], wd [E, F, D], ws [splits,
// n_slots, 2F], h [n_slots, F], y [n_slots, D]; all f32 and contiguous.
// sb: slots a block holds, 8 (decode: 4 columns a thread) or 16 (prefill:
// 2 columns a thread).
extern "C" int moe_grouped_ffn_launch(const void* x, const void* tok,
                                      const void* offsets, const void* wg,
                                      const void* wu, const void* wd,
                                      void* ws, void* h, void* y,
                                      int64_t n_slots, int32_t e, int32_t d,
                                      int32_t f, int32_t splits, int32_t z,
                                      int32_t sb, void* stream) {
  if (n_slots <= 0 || e <= 0) return 0;
  if (d % 4 || f % 4 || splits < 1 || splits > 65535 || z < 1 ||
      e > 65535 || (sb != 8 && sb != 16))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* xf = static_cast<const float*>(x);
  const auto* tk = static_cast<const int32_t*>(tok);
  const auto* of = static_cast<const int32_t*>(offsets);
  const auto* g = static_cast<const float*>(wg);
  const auto* u = static_cast<const float*>(wu);
  const auto* dn = static_cast<const float*>(wd);
  auto* w = static_cast<float*>(ws);
  auto* hf = static_cast<float*>(h);
  auto* yf = static_cast<float*>(y);
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      sb == 8 ? run<8, 4>(xf, tk, of, g, u, dn, w, hf, yf, n_slots, e, d, f,
                          splits, z, s)
              : run<16, 2>(xf, tk, of, g, u, dn, w, hf, yf, n_slots, e, d, f,
                           splits, z, s);
  return static_cast<int>(err);
}
