// One decode step (S = 1) of the Mamba2 (SSD) mixer after its input
// projections, f32, in three kernels on one stream.
//
// Replaces no TPU kernel: the reference runs the step as XLA's elementwise
// operations and an einsum over the state (src/repro/layers/mamba.py).
// Added because the step, left to PyTorch, passes over each layer's
// [B, H, Dh, N] f32 state seven to nine times (the dt*x (x) B tensor, the
// decay, the sum, the einsum's read, the copy back into the cache) and
// launches some sixty small kernels around it.  Per sequence b and head h
// (group g = h / (H / G)):
//
//   x, B, C  <- silu(causal conv(window ++ input) + bias), windows rolled
//   dt       =  softplus(dt_in + dt_bias);   da = exp(dt * -exp(a_log))
//   h        =  da * h + (dt * x) (x) B                   [Dh, N]
//   y        =  h . C + D * x                              [Dh]
//   out      =  rms_norm(y * silu(z)) * (1 + norm_scale)   over d_inner
//
// Bound on the H100: bytes, the state read once and written once (at
// granite's B = 16, H = 128, Dh = 64, N = 128: 134 MB a layer, 40 us at
// 3.35 TB/s); everything else is ~4 MB.  Design:
//
//   conv: one thread a (sequence, channel) of the x, B and C streams, and
//     one a (sequence, head) for dt and the decay.  It reads its channel's
//     window of W-1 inputs before it writes the rolled one, so the window
//     may be updated in place.  Products and sums are rounded one by one
//     (__fmul_rn, __fadd_rn) in PyTorch's order, so the windows and the
//     conv outputs are those of the plain version bit for bit.
//   state: one block a (sequence, head), its [Dh, N] tile contiguous.
//     A row of N floats is read as float4s by TPR = min(32, N / 4) lanes,
//     VPL float4s a lane; each lane updates its part of the row, writes it
//     back where it read it (in place or to a fresh tensor) and sums its
//     h * C; the TPR lanes then add their sums by shuffles.  Each lane
//     loads RB rows of state before it computes (32 bytes in flight a
//     thread at VPL 1); more rows cost registers, hence blocks an SM (8
//     rows took 112-120 registers and ran slower at granite's widths).
//     B and C of the head's group stay in registers.  The block also
//     gates its Dh outputs, v = y * silu(z), and writes the sum of their
//     squares, one partial a (sequence, head).
//   norm: blocks of 1,024 elements of one sequence's v; each adds the
//     sequence's H partials in one fixed order (so every block of a
//     sequence has the same mean square) and scales.
//
// The wrapper (kernels/mamba2_decode.py) allocates the scratch and picks
// VPL from N; N must be a multiple of 4 with N / 4 a power of two up to
// 32, or a multiple of 128 up to 512.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_CONV_W = 8;
constexpr int NORM_ELEMS = 4 * THREADS;   // v elements a norm block scales

__device__ __forceinline__ float silu(float v) {
  return v / (1.f + expf(-v));
}

__device__ __forceinline__ float softplus(float v) {
  return v > 20.f ? v : log1pf(expf(v));
}

// One stream of the causal conv: input [B, ch], weights [W, ch], bias
// [ch], window src/dst [B, W-1, ch] (dst may be src), output [B, ch].
struct ConvStream {
  const float* in;
  const float* w;
  const float* bias;
  const float* src;
  float* dst;
  float* out;
  int ch;
};

__device__ __forceinline__ void conv_channel(const ConvStream& s, int b,
                                             int c, int wlen) {
  const int64_t base = static_cast<int64_t>(b) * (wlen - 1) * s.ch + c;
  float win[MAX_CONV_W];
#pragma unroll
  for (int i = 0; i < MAX_CONV_W; ++i) {
    if (i < wlen - 1) win[i] = s.src[base + static_cast<int64_t>(i) * s.ch];
    else if (i == wlen - 1) win[i] = s.in[static_cast<int64_t>(b) * s.ch + c];
  }
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < MAX_CONV_W; ++i) {
    if (i < wlen)
      acc = __fadd_rn(acc, __fmul_rn(win[i], s.w[static_cast<int64_t>(i) *
                                                 s.ch + c]));
  }
  acc = __fadd_rn(acc, s.bias[c]);
#pragma unroll
  for (int i = 0; i < MAX_CONV_W - 1; ++i) {
    if (i < wlen - 1)
      s.dst[base + static_cast<int64_t>(i) * s.ch] = win[i + 1];
  }
  s.out[static_cast<int64_t>(b) * s.ch + c] = silu(acc);
}

__global__ void __launch_bounds__(THREADS)
mamba2_decode_conv(ConvStream sx, ConvStream sb, ConvStream sc,
                   const float* __restrict__ dt_in,
                   const float* __restrict__ dt_bias,
                   const float* __restrict__ a_log, float* __restrict__ dt,
                   float* __restrict__ da, int batch, int nh, int wlen) {
  const int cols = sx.ch + sb.ch + sc.ch + nh;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (i >= static_cast<int64_t>(batch) * cols) return;
  const int b = static_cast<int>(i / cols);
  int c = static_cast<int>(i % cols);
  if (c < sx.ch) return conv_channel(sx, b, c, wlen);
  c -= sx.ch;
  if (c < sb.ch) return conv_channel(sb, b, c, wlen);
  c -= sb.ch;
  if (c < sc.ch) return conv_channel(sc, b, c, wlen);
  c -= sc.ch;
  const int64_t j = static_cast<int64_t>(b) * nh + c;
  const float t = softplus(__fadd_rn(dt_in[j], dt_bias[c]));
  dt[j] = t;
  da[j] = expf(__fmul_rn(t, -expf(a_log[c])));
}

// The sum of v over the block's threads, in one fixed order; every
// thread gets it.
__device__ __forceinline__ float block_sum(float v, float* red) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) total += red[w];
  return total;
}

template <int VPL>
__global__ void __launch_bounds__(THREADS)
mamba2_decode_state(const float* __restrict__ xc, const float* __restrict__ bc,
                    const float* __restrict__ cc, const float* __restrict__ dt,
                    const float* __restrict__ da,
                    const float* __restrict__ d_skip,
                    const float* __restrict__ z, const float* src, float* dst,
                    float* __restrict__ v_out, float* __restrict__ ss,
                    int nh, int dh, int n, int gn, int rep, int tpr) {
  constexpr int RB = VPL < 2 ? 2 : 1;      // rows a lane loads at once
  __shared__ float red[THREADS / 32];
  const int bh = blockIdx.x;               // b * nh + h
  const int b = bh / nh, h = bh % nh;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int per_warp = 32 / tpr;           // rows a warp takes at once
  const int slots = (THREADS / 32) * per_warp;
  const int slot = warp * per_warp + lane / tpr, part = lane % tpr;
  const int64_t gofs = static_cast<int64_t>(b) * gn + (h / rep) * n;
  float4 bv[VPL], cv[VPL];
#pragma unroll
  for (int v = 0; v < VPL; ++v) {
    const int k = (part + tpr * v) * 4;
    bv[v] = *reinterpret_cast<const float4*>(bc + gofs + k);
    cv[v] = *reinterpret_cast<const float4*>(cc + gofs + k);
  }
  const float dtv = dt[bh], dav = da[bh], dsk = d_skip[h];
  const int64_t tile = static_cast<int64_t>(bh) * dh * n;
  const int64_t xofs = static_cast<int64_t>(bh) * dh;    // [b, h*Dh + r]
  const float* xh = xc + xofs;
  const float* zh = z + xofs;
  float* vh = v_out + xofs;
  float sq = 0.f;
  for (int r0 = 0; r0 < dh; r0 += RB * slots) {
    int row[RB];
    float4 hv[RB][VPL];
#pragma unroll
    for (int j = 0; j < RB; ++j) {
      row[j] = r0 + j * slots + slot;
      if (row[j] < dh) {
        const float* p = src + tile + static_cast<int64_t>(row[j]) * n;
#pragma unroll
        for (int v = 0; v < VPL; ++v)
          hv[j][v] =
              *reinterpret_cast<const float4*>(p + (part + tpr * v) * 4);
      }
    }
    float acc[RB];
#pragma unroll
    for (int j = 0; j < RB; ++j) {
      acc[j] = 0.f;
      if (row[j] >= dh) continue;
      const float dtx = __fmul_rn(dtv, xh[row[j]]);
      float* p = dst + tile + static_cast<int64_t>(row[j]) * n;
#pragma unroll
      for (int v = 0; v < VPL; ++v) {
        float4 s = hv[j][v];
        s.x = __fadd_rn(__fmul_rn(dav, s.x), __fmul_rn(dtx, bv[v].x));
        s.y = __fadd_rn(__fmul_rn(dav, s.y), __fmul_rn(dtx, bv[v].y));
        s.z = __fadd_rn(__fmul_rn(dav, s.z), __fmul_rn(dtx, bv[v].z));
        s.w = __fadd_rn(__fmul_rn(dav, s.w), __fmul_rn(dtx, bv[v].w));
        *reinterpret_cast<float4*>(p + (part + tpr * v) * 4) = s;
        acc[j] += s.x * cv[v].x + s.y * cv[v].y + s.z * cv[v].z +
                  s.w * cv[v].w;
      }
    }
#pragma unroll
    for (int j = 0; j < RB; ++j) {
      for (int off = tpr / 2; off > 0; off >>= 1)
        acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], off);
      if (part == 0 && row[j] < dh) {
        const float v = (acc[j] + xh[row[j]] * dsk) * silu(zh[row[j]]);
        vh[row[j]] = v;
        sq += v * v;
      }
    }
  }
  sq = block_sum(sq, red);
  if (threadIdx.x == 0) ss[bh] = sq;
}

// grid (d_inner / NORM_ELEMS, B)
__global__ void __launch_bounds__(THREADS)
mamba2_decode_norm(const float* __restrict__ v, const float* __restrict__ ss,
                   const float* __restrict__ scale, float* __restrict__ out,
                   int di, int nh, float eps) {
  __shared__ float red[THREADS / 32];
  const int b = blockIdx.y;
  float part = 0.f;
  for (int h = threadIdx.x; h < nh; h += THREADS)
    part += ss[static_cast<int64_t>(b) * nh + h];
  const float total = block_sum(part, red);
  const float inv = rsqrtf(total / static_cast<float>(di) + eps);
  const int64_t row = static_cast<int64_t>(b) * di;
  const int end = min(di, static_cast<int>(blockIdx.x + 1) * NORM_ELEMS);
  for (int i = blockIdx.x * NORM_ELEMS + threadIdx.x; i < end; i += THREADS)
    out[row + i] = (v[row + i] * inv) * (1.f + scale[i]);
}

}  // namespace

// z, x [B, di]; bm, cm [B, gn]; dt_in [B, nh] (the input projections);
// wx [W, di], bx [di], wb/wc [W, gn], bb/bcb [gn] (conv weights, biases);
// a_log, dt_bias, d_skip [nh]; norm_scale [di]; the cache's windows
// conv_x [B, W-1, di], conv_b/conv_c [B, W-1, gn] and state ssm [B, nh,
// dh, n], read from the first four and written to the next four (the same
// pointers for an update in place); ws the scratch, B x (2 di + 2 gn +
// 3 nh) + 3 floats (B and C start on a 16-byte boundary whatever B x di,
// for their float4 loads); y_out [B, di].  All f32 and contiguous.
extern "C" int mamba2_decode_launch(
    const void* z, const void* x, const void* bm, const void* cm,
    const void* dt_in, const void* wx, const void* bx, const void* wb,
    const void* bb, const void* wc, const void* bcb, const void* a_log,
    const void* dt_bias, const void* d_skip, const void* norm_scale,
    const void* conv_x, const void* conv_b, const void* conv_c,
    const void* ssm, void* conv_x_out, void* conv_b_out, void* conv_c_out,
    void* ssm_out, void* ws, void* y_out, int32_t batch, int32_t di,
    int32_t gn, int32_t nh, int32_t dh, int32_t n, int32_t wlen, float eps,
    void* stream) {
  if (batch <= 0) return 0;
  const int tpr = n / 4 < 32 ? n / 4 : 32;
  const int vpl = n / (4 * tpr);
  if (n % 4 || tpr < 1 || (tpr & (tpr - 1)) || tpr * 4 * vpl != n ||
      (vpl != 1 && vpl != 2 && vpl != 4) || gn % n || nh % (gn / n) ||
      nh * dh != di || wlen < 2 || wlen > MAX_CONV_W)
    return static_cast<int>(cudaErrorInvalidValue);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto* w = static_cast<float*>(ws);
  float* xc = w;
  float* bc = xc + ((static_cast<int64_t>(batch) * di + 3) & ~int64_t{3});
  float* cc = bc + static_cast<int64_t>(batch) * gn;
  float* dt = cc + static_cast<int64_t>(batch) * gn;
  float* da = dt + static_cast<int64_t>(batch) * nh;
  float* ss = da + static_cast<int64_t>(batch) * nh;
  float* v = ss + static_cast<int64_t>(batch) * nh;
  auto s = static_cast<cudaStream_t>(stream);

  const ConvStream sx{f(x), f(wx), f(bx), f(conv_x),
                      static_cast<float*>(conv_x_out), xc, di};
  const ConvStream sb{f(bm), f(wb), f(bb), f(conv_b),
                      static_cast<float*>(conv_b_out), bc, gn};
  const ConvStream sc{f(cm), f(wc), f(bcb), f(conv_c),
                      static_cast<float*>(conv_c_out), cc, gn};
  const int64_t total = static_cast<int64_t>(batch) * (di + 2 * gn + nh);
  mamba2_decode_conv<<<static_cast<unsigned>((total + THREADS - 1) / THREADS),
                       THREADS, 0, s>>>(sx, sb, sc, f(dt_in), f(dt_bias),
                                        f(a_log), dt, da, batch, nh, wlen);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int rep = nh / (gn / n);
  const unsigned blocks = static_cast<unsigned>(batch) * nh;
  auto* hs = f(ssm);
  auto* hd = static_cast<float*>(ssm_out);
  if (vpl == 1)
    mamba2_decode_state<1><<<blocks, THREADS, 0, s>>>(
        xc, bc, cc, dt, da, f(d_skip), f(z), hs, hd, v, ss, nh, dh, n, gn,
        rep, tpr);
  else if (vpl == 2)
    mamba2_decode_state<2><<<blocks, THREADS, 0, s>>>(
        xc, bc, cc, dt, da, f(d_skip), f(z), hs, hd, v, ss, nh, dh, n, gn,
        rep, tpr);
  else
    mamba2_decode_state<4><<<blocks, THREADS, 0, s>>>(
        xc, bc, cc, dt, da, f(d_skip), f(z), hs, hd, v, ss, nh, dh, n, gn,
        rep, tpr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  mamba2_decode_norm<<<dim3((di + NORM_ELEMS - 1) / NORM_ELEMS, batch),
                       THREADS, 0, s>>>(v, ss, f(norm_scale),
                                        static_cast<float*>(y_out), di, nh,
                                        eps);
  return static_cast<int>(cudaGetLastError());
}
