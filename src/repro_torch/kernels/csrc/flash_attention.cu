// Kernel 5: forward flash attention — online softmax with f32 statistics,
// causal and sliding-window masks with the queries aligned to the END of
// the keys, GQA head h reading kv head h / (H / Hkv).
//
// Replaces src/repro/kernels/flash_attention.py:flash_attention_pallas
// (_flash_kernel).  The TPU kernel walks one (q tile, head) over a
// sequential K grid with acc/m/l in VMEM; on Hopper the work is cut three
// ways, one kernel (or pair) per regime, chosen by the host from (Sq,
// dtype):
//
//  * decode, Sq <= 16 (every serving decode step): bytes bound on reading
//    the KV cache (q [4,32,1,128] against 1056 keys reads 34.6 MB of f32
//    K/V).  Split-K flash-decoding: one block per (key split, kv head and
//    row group, batch) holds ALL G*Sq query rows of its kv head, so each K/V
//    row leaves device memory once per kv head, not once per query head.
//    Only the visible key range [k_begin, k_end) is split (the host's
//    split plan, flash_attention.py:split_plan), into enough splits that
//    B*Hkv*splits fills the card about twice over.  A block's time is a
//    chain of load latencies, not arithmetic, so K/V tiles stream through
//    a 4-stage cp.async ring of 16-byte copies (three tiles in flight,
//    three blocks per SM); a warp scores a few key rows at a time against
//    every query row (lanes own dh slices, the shuffle reductions of all
//    rows and keys overlap).  Each split writes its (m, l, acc[dh]) in
//    f32 to a workspace; flash_decode_combine_kernel merges the splits.
//  * prefill f32, Sq > 16: operations bound (4*dh FLOPs per visible pair
//    on the CUDA cores; IEEE fmaf, never TF32).  Register-tiled: 128
//    threads, a 64-row q tile (32 at dh 256), each thread an 8-row x
//    (BK/16)-key tile of S and an 8-row x dh/16 tile of the output, fed by
//    float4 shared-memory reads (swizzled rows, no padding) — at dh 128, 64
//    FMAs per 10 loads in QK^T and per 4 loads in PV.  The 16 threads that
//    share a row sit in one half-warp, so the online-softmax statistics
//    stay in registers (reduced with __shfl_xor_sync) and P crosses shared
//    memory under __syncwarp only.  K/V tiles are double-buffered with
//    cp.async; the heaviest causal q tiles launch first.
//  * prefill bf16, Sq > 16: tensor cores, FlashAttention-2 style:
//    mma.sync m16n8k16 (bf16 in, f32 accumulate), 4 warps each owning 16
//    q rows, ldmatrix from swizzled shared memory, P kept in registers as
//    the A operand of the PV product, cp.async double-buffered K/V, the
//    output rounded once to bf16.  (wgmma/TMA is a later step.)
//
// Every path keeps the reference's finite NEG_INF: a fully masked key
// contributes exp(NEG_INF - m), which is 1 while a row has seen no visible
// key and is then wiped exactly by alpha = exp(NEG_INF - m_real) = 0, as
// on the TPU.  Operands are addressed through (batch, head, sequence)
// strides with a contiguous head dim; the host checks the 16-byte
// alignment the vector copies need.
#include <cfloat>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// flash_attention.py:37, rounded to f32 from the double product as there
constexpr float NEG_INF =
    static_cast<float>(-0.7 * static_cast<double>(FLT_MAX));
constexpr int DECODE_MAX_SQ = 16;   // Sq <= 16 takes the decode path
constexpr float LOG2E = 1.4426950408889634f;

struct Strides {
  int64_t b, h, s;  // element strides; the head dim is contiguous
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// ---- cp.async (16-byte global -> shared copies, zero-filled when off) ----

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  // src-size 0 writes 16 zero bytes without reading src
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy ROWS rows of a [*, DH] operand (row stride `ld` elements) into a
// [ROWS][DH] shared tile, 16-byte chunk c of row r at chunk position
// swz(r, c); rows at or past `n` are zero-filled.
template <typename T, int DH, int ROWS, int THREADS, typename Swz>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int64_t ld,
                                          int n, Swz swz) {
  constexpr int CH = DH * static_cast<int>(sizeof(T)) / 16;  // chunks/row
  constexpr int EPC = 16 / static_cast<int>(sizeof(T));       // elems/chunk
  for (int i = threadIdx.x; i < ROWS * CH; i += THREADS) {
    const int r = i / CH, c = i % CH;
    const bool in = r < n;
    const T* g = src + (in ? static_cast<int64_t>(r) * ld : 0) + c * EPC;
    cp_async16(dst + r * DH + swz(r, c) * EPC, g, in);
  }
}

struct NoSwizzle {
  __device__ __forceinline__ int operator()(int, int c) const { return c; }
};

// ==========================================================================
// Decode: split-K, the G query heads of a kv head folded into one block
// ==========================================================================

constexpr int DEC_THREADS = 128;
constexpr int DEC_WARPS = DEC_THREADS / 32;
constexpr int DEC_STAGES = 4;

// Query rows one block holds: all G*Sq rows of a kv head when they are 4
// or fewer (the serving step: G = 4, Sq = 1), else up to RB_MAX, which
// keeps each lane's q slices in at most 64 registers.
constexpr int decode_rb_max(int dh) { return 2048 / dh < 64 ? 2048 / dh : 64; }
constexpr int DECODE_RB_SMALL = 4;

template <typename T, int DH, int RB>
struct DecodeCfg {
  // keys per K/V tile: 8 KB of K per stage (at most 64 keys), so the four
  // stages (64 KB) let three blocks share an SM and three tiles of a split
  // are in flight while one is scored
  static constexpr int BK0 = 8192 / (DH * static_cast<int>(sizeof(T)));
  static constexpr int BK = BK0 < 64 ? BK0 : 64;
  static constexpr int EL = DH / 32;          // q/k elements per lane
  // keys a warp scores at once: U * RB dot products and their shuffle
  // chains in flight together
  static constexpr int U0 = 64 / RB < 4 ? 64 / RB : 4;
  static constexpr int U = BK / DEC_WARPS < U0 ? BK / DEC_WARPS : U0;
  static_assert(BK % (DEC_WARPS * U) == 0, "a tile splits evenly");
  static constexpr int DV = 4;                // output dims per thread
  static constexpr int TPR = DH / DV;         // threads per output row
  static constexpr int RSTEP = DEC_THREADS / TPR;
  static constexpr int RN = (RB + RSTEP - 1) / RSTEP;  // rows per thread
  static constexpr size_t SMEM =
      sizeof(T) * DEC_STAGES * 2 * BK * DH +
      sizeof(float) * (RB * BK + 3 * RB);
};

template <typename T, int N>
__device__ __forceinline__ void load_vec(float (&out)[N], const T* p) {
  if constexpr (sizeof(T) == 4 && N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + i);
      out[i] = v.x; out[i + 1] = v.y; out[i + 2] = v.z; out[i + 3] = v.w;
    }
  } else if constexpr (sizeof(T) == 2 && N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const uint2 u = *reinterpret_cast<const uint2*>(p + i);
      const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
      const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
      const float2 fa = __bfloat1622float2(a), fb = __bfloat1622float2(b);
      out[i] = fa.x; out[i + 1] = fa.y; out[i + 2] = fb.x; out[i + 3] = fb.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_f32(p[i]);
  }
}

// grid (splits, hkv * row_groups, b).  Block rows are the kv head's query
// rows r = g * sq + i (head hk * G + g, query i), RB at a time.
template <typename T, int DH, int RB>
__global__ void __launch_bounds__(DEC_THREADS, 2)
flash_decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, float* __restrict__ ws,
                          Strides qs, Strides ks, Strides vs, int h, int sq,
                          int sk, int group, int row_groups, int splits,
                          int chunk, int k_begin, int k_end, float scale,
                          int causal, int window) {
  using C = DecodeCfg<T, DH, RB>;
  constexpr int BK = C::BK, EL = C::EL, RN = C::RN, U = C::U;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* kv_s = reinterpret_cast<T*>(smem_raw);               // [STAGES][2][BK][DH]
  float* p_s = reinterpret_cast<float*>(kv_s + DEC_STAGES * 2 * BK * DH);
  float* m_s = p_s + RB * BK;
  float* l_s = m_s + RB;
  float* a_s = l_s + RB;

  const int split = blockIdx.x;
  const int hk = blockIdx.y / row_groups;
  const int rg = blockIdx.y % row_groups;
  const int64_t b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rows_total = group * sq;
  const int row0 = rg * RB;
  const int rows = min(RB, rows_total - row0);
  const int kb = k_begin + split * chunk;
  const int ke = min(k_end, kb + chunk);
  const int off = sk - sq;

  const T* kb_ptr = k + b * ks.b + hk * ks.h;
  const T* vb_ptr = v + b * vs.b + hk * vs.h;

  // each lane's dh slice of every block row, in registers
  float qr[RB][EL];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    if (r < rows) {
      const int rr = row0 + r;
      const int64_t head = static_cast<int64_t>(hk) * group + rr / sq;
      load_vec<T, EL>(qr[r], q + b * qs.b + head * qs.h +
                                 static_cast<int64_t>(rr % sq) * qs.s +
                                 lane * EL);
    } else {
#pragma unroll
      for (int e = 0; e < EL; ++e) qr[r][e] = 0.f;
    }
  }
  for (int r = tid; r < RB; r += DEC_THREADS) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.f;
  }

  const int nt = (ke - kb + BK - 1) / BK;
  auto load = [&](int t) {
    T* st = kv_s + (t % DEC_STAGES) * 2 * BK * DH;
    const int64_t row = kb + t * BK;
    load_tile<T, DH, BK, DEC_THREADS>(st, kb_ptr + row * ks.s, ks.s,
                                      ke - kb - t * BK, NoSwizzle{});
    load_tile<T, DH, BK, DEC_THREADS>(st + BK * DH, vb_ptr + row * vs.s,
                                      vs.s, ke - kb - t * BK, NoSwizzle{});
  };
#pragma unroll
  for (int s = 0; s < DEC_STAGES - 1; ++s) {
    if (s < nt) load(s);
    cp_async_commit();
  }

  // output ownership: dims d0..d0+3 of rows orow(j) = tid / TPR + j * RSTEP
  const int d0 = (tid % C::TPR) * C::DV;
  const int orow0 = tid / C::TPR;
  float acc[RN][C::DV];
#pragma unroll
  for (int j = 0; j < RN; ++j)
#pragma unroll
    for (int e = 0; e < C::DV; ++e) acc[j][e] = 0.f;

  for (int t = 0; t < nt; ++t) {
    cp_async_wait<DEC_STAGES - 2>();
    __syncthreads();   // tile t landed; tile t-1's readers are done
    if (t + DEC_STAGES - 1 < nt) load(t + DEC_STAGES - 1);
    cp_async_commit();
    const T* k_t = kv_s + (t % DEC_STAGES) * 2 * BK * DH;
    const T* v_t = k_t + BK * DH;
    const int kt = kb + t * BK;
    const int nk = min(BK, ke - kt);

    // scores: a warp takes U key rows at a time, lanes over dh; the U * RB
    // shuffle reductions are independent and overlap.  Rows past `rows`
    // hold zeros and are never read back.
    for (int j0 = warp * U; j0 < nk; j0 += DEC_WARPS * U) {
      float kr[U][EL], sc[U][RB];
#pragma unroll
      for (int u = 0; u < U; ++u)
        load_vec<T, EL>(kr[u], k_t + (j0 + u) * DH + lane * EL);
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          float x = 0.f;
#pragma unroll
          for (int e = 0; e < EL; ++e) x = fmaf(qr[r][e], kr[u][e], x);
          sc[u][r] = x;
        }
#pragma unroll
      for (int sh = 16; sh > 0; sh >>= 1)
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int r = 0; r < RB; ++r)
            sc[u][r] += __shfl_xor_sync(0xffffffffu, sc[u][r], sh);
      if (lane == 0) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int kpos = kt + j0 + u;
#pragma unroll
          for (int r = 0; r < RB; ++r) {
            const int qpos = (row0 + r) % sq + off;
            bool keep = true;
            if (causal) keep = kpos <= qpos;
            if (window > 0) keep = keep && kpos > qpos - window;
            if (j0 + u < nk)
              p_s[r * BK + j0 + u] = keep ? sc[u][r] * scale : NEG_INF;
          }
        }
      }
    }
    __syncthreads();

    // online softmax over the tile, one warp per row
    for (int r = warp; r < rows; r += DEC_WARPS) {
      float mx = NEG_INF;
      for (int j = lane; j < nk; j += 32) mx = fmaxf(mx, p_s[r * BK + j]);
#pragma unroll
      for (int sh = 16; sh > 0; sh >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, sh));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < nk; j += 32) {
        const float p = expf(p_s[r * BK + j] - m_new);
        p_s[r * BK + j] = p;
        sum += p;
      }
#pragma unroll
      for (int sh = 16; sh > 0; sh >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, sh);
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
    for (int jr = 0; jr < RN; ++jr) {
      const int r = orow0 + jr * C::RSTEP;
      if (r < rows) {
        const float alpha = a_s[r];
#pragma unroll
        for (int e = 0; e < C::DV; ++e) acc[jr][e] *= alpha;
      }
    }
#pragma unroll 4
    for (int j = 0; j < nk; ++j) {
      float vv[C::DV];
      load_vec<T, C::DV>(vv, v_t + j * DH + d0);
#pragma unroll
      for (int jr = 0; jr < RN; ++jr) {
        const int r = orow0 + jr * C::RSTEP;
        if (r < rows) {
          const float p = p_s[r * BK + j];
#pragma unroll
          for (int e = 0; e < C::DV; ++e)
            acc[jr][e] = fmaf(p, vv[e], acc[jr][e]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // partials: ws_acc [B, H, Sq, splits, DH], then m and l [B, H, Sq, splits]
  const int64_t n_part = static_cast<int64_t>(gridDim.z) * h * sq * splits;
  float* ws_m = ws + n_part * DH;
  float* ws_l = ws_m + n_part;
  auto part = [&](int r) {
    const int rr = row0 + r;
    const int64_t head = static_cast<int64_t>(hk) * group + rr / sq;
    return ((b * h + head) * sq + rr % sq) * splits + split;
  };
#pragma unroll
  for (int jr = 0; jr < RN; ++jr) {
    const int r = orow0 + jr * C::RSTEP;
    if (r < rows)
      *reinterpret_cast<float4*>(ws + part(r) * DH + d0) =
          make_float4(acc[jr][0], acc[jr][1], acc[jr][2], acc[jr][3]);
  }
  for (int r = tid; r < rows; r += DEC_THREADS) {
    ws_m[part(r)] = m_s[r];
    ws_l[part(r)] = l_s[r];
  }
}

// grid (sq, h, b): out = sum_s e^{m_s - m*} acc_s / sum_s e^{m_s - m*} l_s.
// A split whose rows saw no visible key has m_s = NEG_INF and gets weight
// exactly 0 beside any split with a real maximum.
template <typename T, int DH>
__global__ void __launch_bounds__(DEC_THREADS)
flash_decode_combine_kernel(const float* __restrict__ ws, T* __restrict__ o,
                            Strides os, int h, int sq, int splits) {
  const int i = blockIdx.x;
  const int64_t hh = blockIdx.y, b = blockIdx.z;
  const int64_t n_part = static_cast<int64_t>(gridDim.z) * h * sq * splits;
  const float* ws_m = ws + n_part * DH;
  const float* ws_l = ws_m + n_part;
  const int64_t p0 = ((b * h + hh) * sq + i) * splits;
  float m_star = NEG_INF;
  for (int s = 0; s < splits; ++s) m_star = fmaxf(m_star, ws_m[p0 + s]);
  float den = 0.f;
  for (int s = 0; s < splits; ++s)
    den += expf(ws_m[p0 + s] - m_star) * ws_l[p0 + s];
  const float inv = 1.f / fmaxf(den, 1e-30f);
  T* ob = o + b * os.b + hh * os.h + static_cast<int64_t>(i) * os.s;
  for (int d = threadIdx.x; d < DH; d += DEC_THREADS) {
    float num = 0.f;
    for (int s = 0; s < splits; ++s)
      num += expf(ws_m[p0 + s] - m_star) * ws[(p0 + s) * DH + d];
    store(&ob[d], num * inv);
  }
}

template <typename T, int DH, int RB>
int launch_decode(const void* q, const void* k, const void* v, void* o,
                  float* ws, int64_t b, int64_t h, int64_t hkv,
                  const Strides& qs, const Strides& ks, const Strides& vs,
                  const Strides& os, int sq, int sk, int group, int splits,
                  int chunk, int k_begin, int k_end, float scale, int causal,
                  int window, cudaStream_t stream) {
  using C = DecodeCfg<T, DH, RB>;
  const int row_groups = (group * sq + RB - 1) / RB;
  if (hkv * row_groups > 65535) return static_cast<int>(cudaErrorInvalidValue);
  auto* kern = flash_decode_split_kernel<T, DH, RB>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<dim3(static_cast<unsigned>(splits),
              static_cast<unsigned>(hkv * row_groups),
              static_cast<unsigned>(b)),
         DEC_THREADS, C::SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), ws, qs, ks, vs, static_cast<int>(h), sq, sk,
      group, row_groups, splits, chunk, k_begin, k_end, scale, causal,
      window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_decode_combine_kernel<T, DH>
      <<<dim3(static_cast<unsigned>(sq), static_cast<unsigned>(h),
              static_cast<unsigned>(b)),
         DEC_THREADS, 0, stream>>>(ws, static_cast<T*>(o), os,
                                   static_cast<int>(h), sq, splits);
  return static_cast<int>(cudaGetLastError());
}

// ==========================================================================
// Prefill f32: register-tiled CUDA-core kernel
// ==========================================================================

constexpr int PF_THREADS = 128;   // 8 row groups (ty) x 16 column groups (tx)

template <int DH>
struct PrefillF32Cfg {
  static constexpr int RM = DH == 256 ? 4 : 8;   // q rows per thread
  static constexpr int BQ = 8 * RM;               // 64 (32 at dh 256)
  static constexpr int BK = DH >= 128 ? 32 : 64;  // keys per K/V tile
  static constexpr int KN = BK / 16;              // keys per thread in S
  static constexpr int VD = DH >= 64 ? 4 : 2;     // output vector width
  static constexpr int DJ = DH / (16 * VD);       // output vectors / thread
  static constexpr int CH = DH / 4;               // float4 chunks per row
  // Q tile, K and V double-buffered, P^T [BK][BQ].  104 KB at dh 128 and
  // 96 KB at dh 64: two blocks (8 warps) per SM.  At dh 256, 164 KB and one
  // block: the 32-key tile keeps QK^T at 4 S values per (RM + 2) loads, and
  // a 16-key tile that would fit two blocks drops that under 4.
  static constexpr size_t SMEM =
      sizeof(float) * (BQ * DH + 4 * BK * DH + BK * BQ);
  static constexpr int MIN_BLOCKS = DH == 256 ? 1 : 2;
};

// K/V rows: chunk c of key j at c ^ (j & 7), so the 8 threads of a
// quarter-warp (keys tx + 16 c for tx = 0..7) read 8 distinct bank groups.
struct SwzKey {
  __device__ __forceinline__ int operator()(int r, int c) const {
    return c ^ (r & 7);
  }
};
// Q rows: thread rows 4 ty + i; the two ty of a warp land on other banks.
struct SwzQ {
  __device__ __forceinline__ int operator()(int r, int c) const {
    return c ^ ((r >> 2) & 7);
  }
};

template <int DH>
__global__ void __launch_bounds__(PF_THREADS, PrefillF32Cfg<DH>::MIN_BLOCKS)
flash_prefill_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         Strides qs, Strides ks, Strides vs, Strides os,
                         int sq, int sk, int group, float scale, int causal,
                         int window) {
  using C = PrefillF32Cfg<DH>;
  constexpr int RM = C::RM, BQ = C::BQ, BK = C::BK, KN = C::KN;
  constexpr int VD = C::VD, DJ = C::DJ, CH = C::CH;
  extern __shared__ __align__(16) unsigned char pf_raw[];
  float* q_s = reinterpret_cast<float*>(pf_raw);   // [BQ][DH], SwzQ
  float* k_s = q_s + BQ * DH;         // [2][BK][DH], SwzKey
  float* v_s = k_s + 2 * BK * DH;     // [2][BK][DH], plain
  float* p_s = v_s + 2 * BK * DH;     // [BK][BQ]: P^T

  // heaviest causal q tiles first
  const int qt = gridDim.z - 1 - blockIdx.z;
  const int q0 = qt * BQ;
  const int64_t hh = blockIdx.x, b = blockIdx.y;
  const int64_t hk = hh / group;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const float* qb = q + b * qs.b + hh * qs.h;
  const float* kbp = k + b * ks.b + hk * ks.h;
  const float* vbp = v + b * vs.b + hk * vs.h;

  const int off = sk - sq;
  const int pos_lo = q0 + off;
  const int pos_hi = min(q0 + BQ, sq) - 1 + off;
  int k_end = sk;
  if (causal) k_end = min(k_end, pos_hi + 1);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, pos_lo - window + 1);
  const int kt0 = (k_begin / BK) * BK;
  const int nt = k_end > kt0 ? (k_end - kt0 + BK - 1) / BK : 0;

  load_tile<float, DH, BQ, PF_THREADS>(
      q_s, qb + static_cast<int64_t>(q0) * qs.s, qs.s, sq - q0, SwzQ{});
  auto load_kv = [&](int t) {
    const int kt = kt0 + t * BK;
    float* kd = k_s + (t & 1) * BK * DH;
    float* vd = v_s + (t & 1) * BK * DH;
    load_tile<float, DH, BK, PF_THREADS>(
        kd, kbp + static_cast<int64_t>(kt) * ks.s, ks.s, sk - kt, SwzKey{});
    load_tile<float, DH, BK, PF_THREADS>(
        vd, vbp + static_cast<int64_t>(kt) * vs.s, vs.s, sk - kt,
        NoSwizzle{});
  };
  if (nt > 0) load_kv(0);
  cp_async_commit();

  // rows of this thread: 4 ty + 32 g + i; keys of S: tx + 16 c;
  // output dims: VD tx + 16 VD j + e
  int rows[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) rows[i] = 4 * ty + 32 * (i / 4) + (i % 4);

  float m[RM], l[RM], acc[RM][DJ * VD];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ * VD; ++j) acc[i][j] = 0.f;
  }

  for (int t = 0; t < nt; ++t) {
    cp_async_wait<0>();
    __syncthreads();   // tile t landed; tile t-1's readers are done
    if (t + 1 < nt) load_kv(t + 1);
    cp_async_commit();
    const float* kt_s = k_s + (t & 1) * BK * DH;
    const float* vt_s = v_s + (t & 1) * BK * DH;
    const int kt = kt0 + t * BK;

    // S = Q K^T over float4 chunks of dh
    float s[RM][KN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int c = 0; c < KN; ++c) s[i][c] = 0.f;
#pragma unroll 2
    for (int ch = 0; ch < CH; ++ch) {
      float4 kv[KN];
#pragma unroll
      for (int c = 0; c < KN; ++c) {
        const int j = tx + 16 * c;
        kv[c] = *reinterpret_cast<const float4*>(
            kt_s + j * DH + SwzKey{}(j, ch) * 4);
      }
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(
            q_s + rows[i] * DH + SwzQ{}(rows[i], ch) * 4);
#pragma unroll
        for (int c = 0; c < KN; ++c) {
          s[i][c] = fmaf(qv.x, kv[c].x, s[i][c]);
          s[i][c] = fmaf(qv.y, kv[c].y, s[i][c]);
          s[i][c] = fmaf(qv.z, kv[c].z, s[i][c]);
          s[i][c] = fmaf(qv.w, kv[c].w, s[i][c]);
        }
      }
    }

    // mask (not needed where the tile is visible to every row of the q
    // tile), online softmax in registers (the 16 threads of a row are one
    // half-warp: xor 8, 4, 2, 1)
    const bool full = kt + BK <= sk && (!causal || kt + BK - 1 <= pos_lo) &&
                      (window <= 0 || kt > pos_hi - window);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int qpos = q0 + rows[i] + off;
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < KN; ++c) {
        const int kpos = kt + tx + 16 * c;
        bool keep = true;
        if (!full) {
          keep = kpos < sk;
          if (causal) keep = keep && kpos <= qpos;
          if (window > 0) keep = keep && kpos > qpos - window;
        }
        s[i][c] = keep ? s[i][c] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][c]);
      }
#pragma unroll
      for (int sh = 8; sh > 0; sh >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, sh));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < KN; ++c) {
        s[i][c] = expf(s[i][c] - m_new);
        sum += s[i][c];
      }
#pragma unroll
      for (int sh = 8; sh > 0; sh >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, sh);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ * VD; ++j) acc[i][j] *= alpha;
    }
    // P^T [key][row]: written and read by the same half-warp
#pragma unroll
    for (int c = 0; c < KN; ++c)
#pragma unroll
      for (int g = 0; g < RM / 4; ++g)
        *reinterpret_cast<float4*>(p_s + (tx + 16 * c) * BQ + 4 * ty + 32 * g) =
            make_float4(s[4 * g][c], s[4 * g + 1][c], s[4 * g + 2][c],
                        s[4 * g + 3][c]);
    __syncwarp();

    // acc += P V
#pragma unroll 2
    for (int j = 0; j < BK; ++j) {
      float pr[RM];
#pragma unroll
      for (int g = 0; g < RM / 4; ++g) {
        const float4 p4 = *reinterpret_cast<const float4*>(
            p_s + j * BQ + 4 * ty + 32 * g);
        pr[4 * g] = p4.x; pr[4 * g + 1] = p4.y;
        pr[4 * g + 2] = p4.z; pr[4 * g + 3] = p4.w;
      }
      float vv[DJ * VD];
#pragma unroll
      for (int dj = 0; dj < DJ; ++dj) {
        const float* src = vt_s + j * DH + VD * tx + 16 * VD * dj;
        if constexpr (VD == 4) {
          const float4 x = *reinterpret_cast<const float4*>(src);
          vv[4 * dj] = x.x; vv[4 * dj + 1] = x.y;
          vv[4 * dj + 2] = x.z; vv[4 * dj + 3] = x.w;
        } else {
          const float2 x = *reinterpret_cast<const float2*>(src);
          vv[2 * dj] = x.x; vv[2 * dj + 1] = x.y;
        }
      }
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int e = 0; e < DJ * VD; ++e)
          acc[i][e] = fmaf(pr[i], vv[e], acc[i][e]);
    }
    __syncwarp();   // P^T is rewritten by the next tile
  }
  cp_async_wait<0>();

  float* ob = o + b * os.b + hh * os.h;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = q0 + rows[i];
    if (r >= sq) continue;
    const float inv_l = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int dj = 0; dj < DJ; ++dj) {
      float* dst = ob + static_cast<int64_t>(r) * os.s + VD * tx + 16 * VD * dj;
      if constexpr (VD == 4)
        *reinterpret_cast<float4*>(dst) =
            make_float4(acc[i][4 * dj] * inv_l, acc[i][4 * dj + 1] * inv_l,
                        acc[i][4 * dj + 2] * inv_l, acc[i][4 * dj + 3] * inv_l);
      else
        *reinterpret_cast<float2*>(dst) =
            make_float2(acc[i][2 * dj] * inv_l, acc[i][2 * dj + 1] * inv_l);
    }
  }
}

template <int DH>
int launch_prefill_f32(const void* q, const void* k, const void* v, void* o,
                       int64_t b, int64_t h, const Strides& qs,
                       const Strides& ks, const Strides& vs,
                       const Strides& os, int sq, int sk, int group,
                       float scale, int causal, int window,
                       cudaStream_t stream) {
  using C = PrefillF32Cfg<DH>;
  auto* kern = flash_prefill_f32_kernel<DH>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qt = (sq + C::BQ - 1) / C::BQ;
  if (n_qt > 65535) return static_cast<int>(cudaErrorInvalidValue);
  kern<<<dim3(static_cast<unsigned>(h), static_cast<unsigned>(b),
              static_cast<unsigned>(n_qt)),
         PF_THREADS, C::SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), qs, ks, vs, os,
      sq, sk, group, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

// ==========================================================================
// Prefill bf16: tensor cores (mma.sync m16n8k16, f32 accumulators)
// ==========================================================================

constexpr int TC_THREADS = 128;   // 4 warps x 16 q rows
constexpr int TC_BQ = 64;

template <int DH>
struct PrefillBf16Cfg {
  static constexpr int BK = DH == 256 ? 32 : 64;
  static constexpr int CH = DH / 8;              // 16-byte chunks per row
  // Q, K and V double-buffered: 80 KB at dh 128 (two blocks per SM), 96 KB
  // at dh 256
  static constexpr size_t SMEM = 2 * (TC_BQ * DH + 4 * BK * DH);
};

// 16-byte chunk c of row r at c ^ (r mod 8) (mod 4 at dh 32, 4 chunks a
// row): the 8 rows an ldmatrix reads at one chunk hit distinct banks.
template <int DH>
struct SwzTc {
  __device__ __forceinline__ int operator()(int r, int c) const {
    return c ^ (r & (DH / 8 < 8 ? DH / 8 - 1 : 7));
  }
};

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// 2^x on the special-function unit (the bf16 path's softmax): 2^0 = 1 and
// 2^(NEG_INF - m) = 0 exactly, as the finite masking needs
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

template <int DH>
__global__ void __launch_bounds__(TC_THREADS, 2)
flash_prefill_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          __nv_bfloat16* __restrict__ o, Strides qs,
                          Strides ks, Strides vs, Strides os, int sq, int sk,
                          int group, float scale, int causal, int window) {
  using C = PrefillBf16Cfg<DH>;
  constexpr int BK = C::BK, NB = BK / 8, KS = DH / 16, DB = DH / 8;
  using Swz = SwzTc<DH>;
  extern __shared__ __align__(16) unsigned char tc_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(tc_raw);  // [BQ][DH]
  __nv_bfloat16* k_s = q_s + TC_BQ * DH;    // [2][BK][DH]
  __nv_bfloat16* v_s = k_s + 2 * BK * DH;   // [2][BK][DH]

  const int qt = gridDim.z - 1 - blockIdx.z;
  const int q0 = qt * TC_BQ;
  const int64_t hh = blockIdx.x, b = blockIdx.y;
  const int64_t hk = hh / group;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;    // mma fragment row / column pair

  const int off = sk - sq;
  const int pos_lo = q0 + off;
  const int pos_hi = min(q0 + TC_BQ, sq) - 1 + off;
  int k_end = sk;
  if (causal) k_end = min(k_end, pos_hi + 1);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, pos_lo - window + 1);
  const int kt0 = (k_begin / BK) * BK;
  const int nt = k_end > kt0 ? (k_end - kt0 + BK - 1) / BK : 0;

  const __nv_bfloat16* kbp = k + b * ks.b + hk * ks.h;
  const __nv_bfloat16* vbp = v + b * vs.b + hk * vs.h;
  load_tile<__nv_bfloat16, DH, TC_BQ, TC_THREADS>(
      q_s, q + b * qs.b + hh * qs.h + static_cast<int64_t>(q0) * qs.s, qs.s,
      sq - q0, Swz{});
  auto load_kv = [&](int t) {
    const int kt = kt0 + t * BK;
    load_tile<__nv_bfloat16, DH, BK, TC_THREADS>(
        k_s + (t & 1) * BK * DH, kbp + static_cast<int64_t>(kt) * ks.s, ks.s,
        sk - kt, Swz{});
    load_tile<__nv_bfloat16, DH, BK, TC_THREADS>(
        v_s + (t & 1) * BK * DH, vbp + static_cast<int64_t>(kt) * vs.s, vs.s,
        sk - kt, Swz{});
  };
  if (nt > 0) load_kv(0);
  cp_async_commit();

  // this thread's two rows (fragment rows g and g + 8 of the warp's 16)
  const int r_lo = q0 + warp * 16 + g;
  const int qpos[2] = {r_lo + off, r_lo + 8 + off};
  const float sl2 = scale * LOG2E;   // softmax in base 2: exp2(x log2 e)
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[DB][4];
#pragma unroll
  for (int n = 0; n < DB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  // ldmatrix lane roles: matrix mi = lane / 8, row lane % 8 of it
  const int mi = lane / 8, mr = lane % 8;

  for (int t = 0; t < nt; ++t) {
    cp_async_wait<0>();
    __syncthreads();
    if (t + 1 < nt) load_kv(t + 1);
    cp_async_commit();
    const __nv_bfloat16* kt_s = k_s + (t & 1) * BK * DH;
    const __nv_bfloat16* vt_s = v_s + (t & 1) * BK * DH;
    const int kt = kt0 + t * BK;

    // S = Q K^T: 16 x BK per warp
    float s[NB][4];
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t a[4];
      {
        const int r = warp * 16 + (mi % 2) * 8 + mr;
        ldmatrix_x4(a, q_s + r * DH + Swz{}(r, 2 * kk + mi / 2) * 8);
      }
#pragma unroll
      for (int n = 0; n < NB; n += 2) {
        uint32_t bf[4];
        const int r = n * 8 + (mi / 2) * 8 + mr;
        ldmatrix_x4(bf, kt_s + r * DH + Swz{}(r, 2 * kk + mi % 2) * 8);
        mma_bf16(s[n], a, bf[0], bf[1]);
        mma_bf16(s[n + 1], a, bf[2], bf[3]);
      }
    }

    // mask (skipped on tiles every row sees) and online softmax; a row's 4
    // threads are one quad (xor 1, 2)
    const bool full = kt + BK <= sk && (!causal || kt + BK - 1 <= pos_lo) &&
                      (window <= 0 || kt > pos_hi - window);
    float alpha[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = NEG_INF;
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kpos = kt + n * 8 + 2 * tq + e;
          bool keep = true;
          if (!full) {
            keep = kpos < sk;
            if (causal) keep = keep && kpos <= qpos[hr];
            if (window > 0) keep = keep && kpos > qpos[hr] - window;
          }
          float& x = s[n][2 * hr + e];
          x = keep ? x * sl2 : NEG_INF;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hr], mx);
      alpha[hr] = fast_exp2(m[hr] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[n][2 * hr + e];
          x = fast_exp2(x - m_new);
          sum += x;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[hr] = l[hr] * alpha[hr] + sum;
      m[hr] = m_new;
    }
#pragma unroll
    for (int n = 0; n < DB; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // acc += P V: the S accumulators of key blocks 2j, 2j+1 are the A
    // fragment of k-step j, rounded to bf16
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
      a[1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
      a[2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
      a[3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
#pragma unroll
      for (int n = 0; n < DB; n += 2) {
        uint32_t bf[4];
        const int r = 16 * j + (mi % 2) * 8 + mr;
        ldmatrix_x4_trans(bf, vt_s + r * DH + Swz{}(r, n + mi / 2) * 8);
        mma_bf16(acc[n], a, bf[0], bf[1]);
        mma_bf16(acc[n + 1], a, bf[2], bf[3]);
      }
    }
  }
  cp_async_wait<0>();

  __nv_bfloat16* ob = o + b * os.b + hh * os.h;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = r_lo + 8 * hr;
    if (r >= sq) continue;
    const float inv_l = 1.f / fmaxf(l[hr], 1e-30f);
#pragma unroll
    for (int n = 0; n < DB; ++n)
      *reinterpret_cast<__nv_bfloat162*>(
          ob + static_cast<int64_t>(r) * os.s + n * 8 + 2 * tq) =
          __floats2bfloat162_rn(acc[n][2 * hr] * inv_l,
                                acc[n][2 * hr + 1] * inv_l);
  }
}

template <int DH>
int launch_prefill_bf16(const void* q, const void* k, const void* v, void* o,
                        int64_t b, int64_t h, const Strides& qs,
                        const Strides& ks, const Strides& vs,
                        const Strides& os, int sq, int sk, int group,
                        float scale, int causal, int window,
                        cudaStream_t stream) {
  using C = PrefillBf16Cfg<DH>;
  auto* kern = flash_prefill_bf16_kernel<DH>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qt = (sq + TC_BQ - 1) / TC_BQ;
  if (n_qt > 65535) return static_cast<int>(cudaErrorInvalidValue);
  kern<<<dim3(static_cast<unsigned>(h), static_cast<unsigned>(b),
              static_cast<unsigned>(n_qt)),
         TC_THREADS, C::SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      qs, ks, vs, os, sq, sk, group, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

struct Args {
  const void *q, *k, *v;
  void* o;
  float* ws;
  int64_t b, h, hkv;
  Strides qs, ks, vs, os;
  int sq, sk, group, splits, chunk, k_begin, k_end;
  float scale;
  int causal, window;
  cudaStream_t st;
};

template <typename T, int DH>
int dispatch_decode(const Args& a) {
  constexpr int RB_MAX = decode_rb_max(DH);
  if (a.group * a.sq <= DECODE_RB_SMALL)
    return launch_decode<T, DH, DECODE_RB_SMALL>(
        a.q, a.k, a.v, a.o, a.ws, a.b, a.h, a.hkv, a.qs, a.ks, a.vs, a.os,
        a.sq, a.sk, a.group, a.splits, a.chunk, a.k_begin, a.k_end, a.scale,
        a.causal, a.window, a.st);
  return launch_decode<T, DH, RB_MAX>(
      a.q, a.k, a.v, a.o, a.ws, a.b, a.h, a.hkv, a.qs, a.ks, a.vs, a.os,
      a.sq, a.sk, a.group, a.splits, a.chunk, a.k_begin, a.k_end, a.scale,
      a.causal, a.window, a.st);
}

template <int DH>
int dispatch(int dtype, const Args& a) {
  if (a.sq <= DECODE_MAX_SQ) {
    if (a.ws == nullptr || a.splits <= 0 || a.chunk <= 0)
      return static_cast<int>(cudaErrorInvalidValue);
    return dtype == 0 ? dispatch_decode<float, DH>(a)
                      : dispatch_decode<__nv_bfloat16, DH>(a);
  }
  if (dtype == 0)
    return launch_prefill_f32<DH>(a.q, a.k, a.v, a.o, a.b, a.h, a.qs, a.ks,
                                  a.vs, a.os, a.sq, a.sk, a.group, a.scale,
                                  a.causal, a.window, a.st);
  return launch_prefill_bf16<DH>(a.q, a.k, a.v, a.o, a.b, a.h, a.qs, a.ks,
                                 a.vs, a.os, a.sq, a.sk, a.group, a.scale,
                                 a.causal, a.window, a.st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o share it).  Strides are
// in elements, (batch, head, sequence) for each operand; the head dim must
// be contiguous and every row 16-byte aligned.  Sq <= 16 runs the split-K
// decode pair and needs the split plan (splits keys-chunks of `chunk`
// covering [k_begin, k_end)) and an f32 workspace of
// B*H*Sq*splits*(dh + 2) floats; longer Sq runs the prefill kernel of the
// dtype and ignores them.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int32_t dtype,
    int64_t b, int64_t h, int64_t hkv, int64_t sq, int64_t sk, int64_t dh,
    int64_t q_sb, int64_t q_sh, int64_t q_ss, int64_t k_sb, int64_t k_sh,
    int64_t k_ss, int64_t v_sb, int64_t v_sh, int64_t v_ss, int64_t o_sb,
    int64_t o_sh, int64_t o_ss, float scale, int32_t causal, int32_t window,
    void* ws, int32_t splits, int32_t chunk, int32_t k_begin, int32_t k_end,
    void* stream) {
  if (b <= 0 || h <= 0 || sq <= 0) return 0;
  if (hkv <= 0 || h % hkv != 0 || sk <= 0 || b > 65535 || h > 65535 ||
      sq > (1 << 30) || sk > (1 << 30) || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, o, static_cast<float*>(ws), b, h, hkv,
               Strides{q_sb, q_sh, q_ss}, Strides{k_sb, k_sh, k_ss},
               Strides{v_sb, v_sh, v_ss}, Strides{o_sb, o_sh, o_ss},
               static_cast<int>(sq), static_cast<int>(sk),
               static_cast<int>(h / hkv), splits, chunk, k_begin, k_end,
               scale, causal, window, static_cast<cudaStream_t>(stream)};
  switch (dh) {
    case 32: return dispatch<32>(dtype, a);
    case 64: return dispatch<64>(dtype, a);
    case 128: return dispatch<128>(dtype, a);
    case 256: return dispatch<256>(dtype, a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
