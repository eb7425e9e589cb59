// Kernel 5: forward flash attention — online softmax over K/V tiles, f32
// accumulators, causal and sliding-window masks with the queries aligned
// to the END of the keys, GQA folded into the index arithmetic.
//
// Replaces src/repro/kernels/flash_attention.py:flash_attention_pallas
// (_flash_kernel).  Bound on the H100: at the serving shapes the prefill
// (q [4,32,1024,128] against 1024 keys, causal) is operations bound — about
// 34 GFLOP of f32 FMA work on the CUDA cores, since the kernel keeps IEEE
// f32 and never uses TF32 — while a decode step (one query row per head
// against ~1056 keys) is bytes bound on reading the KV cache.  Design, a
// simple correct first version: one thread block per (q-tile, head, batch)
// with 256 threads; the q tile is staged once in shared memory, each K/V
// tile of BK keys is staged in turn, S = Q K^T is computed as a 16 x 16
// thread grid of register micro-tiles, one warp per row group runs the
// online-softmax update in shared memory, and each thread keeps its slice
// of the output accumulator in registers across the K loop.  K tiles that
// are masked for every row of the q tile (above the causal diagonal,
// before the window) are skipped; masking inside a tile uses the
// reference's finite NEG_INF, so a row whose first tile is fully masked
// is wiped exactly by the next tile's alpha = 0, as on the TPU.  Operands
// are addressed through their strides: a decode step attends over a slice
// of the KV cache, and q and the output keep the projection's
// [B, S, H, dh] layout, without a copy.
#include <cfloat>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int BK = 64;                      // keys per K/V tile
// flash_attention.py:37, rounded to f32 from the double product as there
constexpr float NEG_INF =
    static_cast<float>(-0.7 * static_cast<double>(FLT_MAX));

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

struct Strides {
  int64_t b, h, s;  // element strides; the head dim is contiguous
};

template <int DH, int BQ>
constexpr size_t smem_bytes() {
  // q [BQ][DH+1], k [BK][DH+1], v [BK][DH], p [BQ][BK+1], m, l, alpha [BQ]
  return sizeof(float) * (static_cast<size_t>(BQ) * (DH + 1) + BK * (DH + 1) +
                          BK * DH + BQ * (BK + 1) + 3 * BQ);
}

template <typename T, int DH, int BQ>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, Strides qs,
                 Strides ks, Strides vs, Strides os, int sq, int sk,
                 int group, float scale, int causal, int window) {
  constexpr int RM = BQ / 16;   // q rows per thread
  constexpr int CN = BK / 16;   // key columns per thread in S
  constexpr int DN = DH / 16;   // output columns per thread
  constexpr int KP = DH + 1;    // padded q and K rows: conflict-free reads
  constexpr int PP = BK + 1;
  constexpr int WARPS = THREADS / 32;
  constexpr int ROWS_PER_WARP = BQ / WARPS;

  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + BQ * KP;
  float* v_s = k_s + BK * KP;
  float* p_s = v_s + BK * DH;
  float* m_s = p_s + BQ * PP;
  float* l_s = m_s + BQ;
  float* a_s = l_s + BQ;

  const int q0 = blockIdx.x * BQ;
  const int64_t h = blockIdx.y, b = blockIdx.z;
  const int64_t hk = h / group;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int warp = tid / 32, lane = tid % 32;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;

  for (int i = tid; i < BQ * DH; i += THREADS) {
    const int r = i / DH, d = i % DH;
    q_s[r * KP + d] = q0 + r < sq ? to_f32(qb[(q0 + r) * qs.s + d]) : 0.f;
  }
  for (int r = tid; r < BQ; r += THREADS) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.f;
  }

  // query r sits at absolute key position q0 + r + (sk - sq)
  const int off = sk - sq;
  const int pos_lo = q0 + off;
  const int pos_hi = min(q0 + BQ, sq) - 1 + off;
  int k_end = sk;
  if (causal) k_end = min(k_end, pos_hi + 1);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, pos_lo - window + 1);

  float acc[RM][DN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < DN; ++j) acc[i][j] = 0.f;

  for (int kt = (k_begin / BK) * BK; kt < k_end; kt += BK) {
    __syncthreads();   // the previous tile's readers are done
    for (int i = tid; i < BK * DH; i += THREADS) {
      const int r = i / DH, d = i % DH;
      const bool in = kt + r < sk;
      k_s[r * KP + d] = in ? to_f32(kb[(kt + r) * ks.s + d]) : 0.f;
      v_s[i] = in ? to_f32(vb[(kt + r) * vs.s + d]) : 0.f;
    }
    __syncthreads();

    // S = (Q K^T) * scale, masked with the finite NEG_INF
    float s[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) s[i][j] = 0.f;
    for (int d = 0; d < DH; ++d) {
      float qv[RM], kv[CN];
#pragma unroll
      for (int i = 0; i < RM; ++i) qv[i] = q_s[(ty + 16 * i) * KP + d];
#pragma unroll
      for (int j = 0; j < CN; ++j) kv[j] = k_s[(tx + 16 * j) * KP + d];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = ty + 16 * i;
      const int qpos = q0 + r + off;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int c = tx + 16 * j;
        const int kpos = kt + c;
        bool keep = kpos < sk;
        if (causal) keep = keep && kpos <= qpos;
        if (window > 0) keep = keep && kpos > qpos - window;
        p_s[r * PP + c] = keep ? s[i][j] * scale : NEG_INF;
      }
    }
    __syncthreads();

    // online softmax, one warp per group of rows
    for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
      const int r = warp * ROWS_PER_WARP + rr;
      float mx = NEG_INF;
      for (int c = lane; c < BK; c += 32) mx = fmaxf(mx, p_s[r * PP + c]);
#pragma unroll
      for (int sh = 16; sh > 0; sh >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, sh));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = lane; c < BK; c += 32) {
        const float p = expf(p_s[r * PP + c] - m_new);
        p_s[r * PP + c] = p;
        sum += p;
      }
#pragma unroll
      for (int sh = 16; sh > 0; sh >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, sh);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const float alpha = a_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < DN; ++j) acc[i][j] *= alpha;
    }
    for (int c = 0; c < BK; ++c) {
      float pv[RM], vv[DN];
#pragma unroll
      for (int i = 0; i < RM; ++i) pv[i] = p_s[(ty + 16 * i) * PP + c];
#pragma unroll
      for (int j = 0; j < DN; ++j) vv[j] = v_s[c * DH + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < DN; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }
  __syncthreads();

  T* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r >= sq) continue;
    const float inv_l = 1.f / fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < DN; ++j)
      store(&ob[(q0 + r) * os.s + tx + 16 * j], acc[i][j] * inv_l);
  }
}

template <typename T, int DH, int BQ>
int launch(const void* q, const void* k, const void* v, void* o, int64_t b,
           int64_t h, const Strides& qs, const Strides& ks, const Strides& vs,
           const Strides& os, int sq, int sk, int group, float scale,
           int causal, int window, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DH, BQ>();
  auto* kern = flash_fwd_kernel<T, DH, BQ>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((sq + BQ - 1) / BQ),
                  static_cast<unsigned>(h), static_cast<unsigned>(b));
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), qs, ks, vs, os, sq, sk,
      group, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int BQ>
int dispatch_dh(int dh, const void* q, const void* k, const void* v,
                void* o, int64_t b, int64_t h, const Strides& qs,
                const Strides& ks, const Strides& vs, const Strides& os,
                int sq, int sk, int group, float scale, int causal,
                int window, cudaStream_t st) {
  switch (dh) {
    case 32: return launch<T, 32, BQ>(q, k, v, o, b, h, qs, ks, vs, os, sq,
                                      sk, group, scale, causal, window, st);
    case 64: return launch<T, 64, BQ>(q, k, v, o, b, h, qs, ks, vs, os, sq,
                                      sk, group, scale, causal, window, st);
    case 128: return launch<T, 128, BQ>(q, k, v, o, b, h, qs, ks, vs, os, sq,
                                        sk, group, scale, causal, window, st);
    case 256: return launch<T, 256, BQ>(q, k, v, o, b, h, qs, ks, vs, os, sq,
                                        sk, group, scale, causal, window, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch_bq(int bq, int dh, const void* q, const void* k, const void* v,
                void* o, int64_t b, int64_t h, const Strides& qs,
                const Strides& ks, const Strides& vs, const Strides& os,
                int sq, int sk, int group, float scale, int causal,
                int window, cudaStream_t st) {
  if (bq == 16)
    return dispatch_dh<T, 16>(dh, q, k, v, o, b, h, qs, ks, vs, os, sq, sk,
                              group, scale, causal, window, st);
  if (bq == 64)
    return dispatch_dh<T, 64>(dh, q, k, v, o, b, h, qs, ks, vs, os, sq, sk,
                              group, scale, causal, window, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o share it).  Strides are
// in elements, (batch, head, sequence) for each operand; the head dim must
// be contiguous.  block_q is the q tile (16 or 64 rows).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int32_t dtype,
    int64_t b, int64_t h, int64_t hkv, int64_t sq, int64_t sk, int64_t dh,
    int64_t q_sb, int64_t q_sh, int64_t q_ss, int64_t k_sb, int64_t k_sh,
    int64_t k_ss, int64_t v_sb, int64_t v_sh, int64_t v_ss, int64_t o_sb,
    int64_t o_sh, int64_t o_ss, float scale, int32_t causal, int32_t window,
    int32_t block_q, void* stream) {
  if (b <= 0 || h <= 0 || sq <= 0) return 0;
  if (hkv <= 0 || h % hkv != 0 || sk <= 0 || b > 65535 || h > 65535 ||
      sq > (1 << 30) || sk > (1 << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss},
      vs{v_sb, v_sh, v_ss}, os{o_sb, o_sh, o_ss};
  const int group = static_cast<int>(h / hkv);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_bq<float>(block_q, static_cast<int>(dh), q, k, v, o, b,
                              h, qs, ks, vs, os, static_cast<int>(sq),
                              static_cast<int>(sk), group, scale, causal,
                              window, st);
  if (dtype == 1)
    return dispatch_bq<__nv_bfloat16>(
        block_q, static_cast<int>(dh), q, k, v, o, b, h, qs, ks, vs, os,
        static_cast<int>(sq), static_cast<int>(sk), group, scale, causal,
        window, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
