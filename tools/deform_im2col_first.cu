// D1's first CUDA body (birefnet_tpu_torch/csrc/deform_im2col.cu as first
// ported): one warp per (position, tap), every lane computing the sample
// point and the four corner weights, then two channels a lane per step
// (bf16x2 or float2); the warp, row and batch indices divided in 64 bits.
// The same f32 operations in the same order as the plain version, so its
// columns are bitwise the redesigned kernel's. Kept as the baseline of
// tools/deform_im2col_time.py; not part of the port's library. Same C
// entry name as the kernel's (bt_deform_im2col; its first signature, with
// a mask_f32 flag), built into a library of its own by build.build_extra.

#include "common.cuh"

namespace {

constexpr int kWarps = 8, kThreads = 32 * kWarps;

struct Geom {
  int H, W, C, OW, P, kw, K, stride, pad, dil;
};

__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<bf16>(float v) { return bt::round_bf16(v); }
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }

template <typename T>
struct Pair;
template <>
struct Pair<bf16> {
  using type = __nv_bfloat162;
  static __device__ __forceinline__ float2 load(const type& v) { return __bfloat1622float2(v); }
  static __device__ __forceinline__ type make(float a, float b) {
    return __floats2bfloat162_rn(a, b);
  }
};
template <>
struct Pair<float> {
  using type = float2;
  static __device__ __forceinline__ float2 load(const type& v) { return v; }
  static __device__ __forceinline__ type make(float a, float b) { return make_float2(a, b); }
};

__device__ __forceinline__ float corner_sum(const float v[4], const float w[4]) {
  float s = __fmul_rn(v[0], w[0]);
  s = __fadd_rn(s, __fmul_rn(v[1], w[1]));
  s = __fadd_rn(s, __fmul_rn(v[2], w[2]));
  return __fadd_rn(s, __fmul_rn(v[3], w[3]));
}

// x [B, H, W, C] T; offset [B*P, 2K] f32; mask [B*P, K] M; cols [B*P, K*C] T.
template <typename T, typename M, bool kPairs>
__global__ void __launch_bounds__(kThreads)
    deform_im2col_kernel(const T* __restrict__ x, const float* __restrict__ offset,
                         const M* __restrict__ mask, T* __restrict__ cols, long long warps,
                         Geom g) {
  const long long warp = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  if (warp >= warps) return;
  const int lane = threadIdx.x & 31;
  const long long row = warp / g.K;  // b*P + p
  const int k = (int)(warp - row * g.K);
  const long long b = row / g.P;
  const int p = (int)(row - b * g.P);
  const int oy = p / g.OW, ox = p - oy * g.OW;
  const int ki = k / g.kw, kj = k - ki * g.kw;

  const float dy = offset[row * 2 * g.K + 2 * k];
  const float dx = offset[row * 2 * g.K + 2 * k + 1];
  const float m = to_f32(mask[row * g.K + k]);
  // (base + tap) is an integer, exact in f32; then + the offset, rounded once.
  const float ys = __fadd_rn((float)(oy * g.stride - g.pad + ki * g.dil), dy);
  const float xs = __fadd_rn((float)(ox * g.stride - g.pad + kj * g.dil), dx);
  const bool valid = ys > -1.f && ys < (float)g.H && xs > -1.f && xs < (float)g.W;
  const float y0f = floorf(ys), x0f = floorf(xs);
  const float ly = __fsub_rn(ys, y0f), lx = __fsub_rn(xs, x0f);
  const float hy = __fsub_rn(1.f, ly), hx = __fsub_rn(1.f, lx);
  // Clamped before the int conversion; only an invalid sample (all weights
  // zero) is moved by it.
  const int y0 = (int)fminf(fmaxf(y0f, -2.f), (float)g.H);
  const int x0 = (int)fminf(fmaxf(x0f, -2.f), (float)g.W);

  float w[4];
  long long pix[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int cy = y0 + (q >> 1), cx = x0 + (q & 1);
    const bool in = valid && cy >= 0 && cy < g.H && cx >= 0 && cx < g.W;
    const float wyx = __fmul_rn(q >> 1 ? ly : hy, q & 1 ? lx : hx);
    w[q] = round_to<T>(__fmul_rn(__fmul_rn(wyx, in ? 1.f : 0.f), m));
    const int ry = min(max(cy, 0), g.H - 1), rx = min(max(cx, 0), g.W - 1);
    pix[q] = ((b * g.H + ry) * g.W + rx) * g.C;
  }
  T* out = cols + warp * g.C;
  if (kPairs) {
    using P2 = typename Pair<T>::type;
    for (int c = 2 * lane; c < g.C; c += 64) {
      float lo[4], hi[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 v = Pair<T>::load(*reinterpret_cast<const P2*>(x + pix[q] + c));
        lo[q] = v.x;
        hi[q] = v.y;
      }
      *reinterpret_cast<P2*>(out + c) = Pair<T>::make(corner_sum(lo, w), corner_sum(hi, w));
    }
  } else {
    for (int c = lane; c < g.C; c += 32) {
      float v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) v[q] = to_f32(x[pix[q] + c]);
      out[c] = (T)round_to<T>(corner_sum(v, w));
    }
  }
}

template <typename T, typename M>
cudaError_t launch(const void* x, const void* offset, const void* mask, void* cols, int B,
                   const Geom& g, cudaStream_t s) {
  const long long warps = (long long)B * g.P * g.K;
  if (warps == 0) return cudaSuccess;
  const long long blocks = (warps + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  const uintptr_t align = 2 * sizeof(T) - 1;
  const bool pairs = g.C % 2 == 0 && (reinterpret_cast<uintptr_t>(x) & align) == 0 &&
                     (reinterpret_cast<uintptr_t>(cols) & align) == 0;
  auto* xt = static_cast<const T*>(x);
  auto* of = static_cast<const float*>(offset);
  auto* mt = static_cast<const M*>(mask);
  auto* ct = static_cast<T*>(cols);
  if (pairs)
    deform_im2col_kernel<T, M, true><<<(unsigned)blocks, kThreads, 0, s>>>(xt, of, mt, ct, warps, g);
  else
    deform_im2col_kernel<T, M, false><<<(unsigned)blocks, kThreads, 0, s>>>(xt, of, mt, ct, warps, g);
  return cudaGetLastError();
}

}  // namespace

// x [B, H, W, C] (bf16, or f32 with x_f32); offset [B, OH, OW, 2*kh*kw] f32,
// (dy, dx) per row-major tap; mask [B, OH, OW, kh*kw] (bf16 like x, or f32
// with mask_f32; an f32 x takes an f32 mask); cols [B*OH*OW, kh*kw*C] of
// x's type. All contiguous.
extern "C" int bt_deform_im2col(const void* x, const void* offset, const void* mask,
                                void* cols, int B, int H, int W, int C, int OH, int OW,
                                int kh, int kw, int stride, int pad, int dil, int x_f32,
                                int mask_f32, void* stream) {
  if (B < 0 || H <= 0 || W <= 0 || C <= 0 || OH < 0 || OW < 0 || kh <= 0 || kw <= 0 ||
      stride <= 0 || dil <= 0 || (x_f32 && !mask_f32))
    return (int)cudaErrorInvalidValue;
  const Geom g{H, W, C, OW, OH * OW, kw, kh * kw, stride, pad, dil};
  auto s = static_cast<cudaStream_t>(stream);
  if (x_f32) return (int)launch<float, float>(x, offset, mask, cols, B, g, s);
  return (int)(mask_f32 ? launch<bf16, float>(x, offset, mask, cols, B, g, s)
                        : launch<bf16, bf16>(x, offset, mask, cols, B, g, s));
}
