// D1 deform_im2col: the column buffer of a modulated deformable conv v2.
//
//   cols[b*P + p, k*C + c] = round(sum over the 4 bilinear corners q of
//                                  x[b, qy, qx, c] * wq)
//
// for every output position p of [OH, OW], row-major tap k of [kh, kw] and
// channel c of x [B, H, W, C], where the sample point is
//   ys = (oy*stride - pad + ki*dil) + offset[b, p, 2k]      (dy)
//   xs = (ox*stride - pad + kj*dil) + offset[b, p, 2k + 1]  (dx)
// and the corner weight wq = round(wy * wx * valid * mask[b, p, k]),
// zero unless -1 < ys < H and -1 < xs < W and the corner lies in the image.
// These are the semantics of birefnet_tpu/ops/deform_conv.py:68-111 (the
// torchvision deform_conv2d sampler), which the JAX package computes as an
// XLA gather and einsum, not as a Pallas kernel. The contraction of the
// columns with the weight stays a matmul outside this kernel.
//
// The plain version (ops/kernels/deform_im2col.py::deform_im2col_plain)
// computes the same f32 operations in the same order: the weights as
// ((wy * wx) * valid) * mask, rounded to the activation type, the corner
// sum as ((q00 + q01) + q10) + q11 of f32 products. The kernel spells each
// of them with __fmul_rn / __fadd_rn, so no FMA contraction changes a
// rounding and the columns are bitwise the plain version's.
//
// Bound: the columns, written once (1.35 GB in bf16 per 1024^2 batch-2
// forward, 0.40 ms at 3.35 TB/s); x stays in L2 across its four corner
// reads (16.8 MB at the 256^2, C = 64 site in bf16). Design: a group of
// C / V threads per (position, tap), each moving V channels as one 16-byte
// vector (V = 8 in bf16, 4 in f32; V = 1 where C or the alignment does not
// allow it), so that the group reads each corner row and writes the tap's
// row in full 16-byte accesses. Each thread computes the sample point and
// the four corner weights itself, from the offsets and mask its group
// shares; the index arithmetic up to the row is 32-bit (the host checks
// B*P*K < 2^31), the element offsets 64-bit (B*P*K*C passes 2^31 at 2048^2
// inputs). The first body, one warp per (position, tap) with 64-bit
// divisions and two channels a lane, was issue-bound at 10x this bound
// (tools/deform_im2col_first.cu).

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

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

// V consecutive elements of T as f32, loaded or stored as one vector.
template <typename T, int V>
struct Vec {
  static __device__ __forceinline__ void load(const T* p, float* v) {
#pragma unroll
    for (int e = 0; e < V; ++e) v[e] = to_f32(p[e]);
  }
  static __device__ __forceinline__ void store(T* p, const float* v) {
#pragma unroll
    for (int e = 0; e < V; ++e) p[e] = (T)v[e];
  }
};
template <>
struct Vec<bf16, 8> {
  static __device__ __forceinline__ void load(const bf16* p, float* v) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h[e]);
      v[2 * e] = f.x;
      v[2 * e + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(bf16* p, const float* v) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int e = 0; e < 4; ++e) h[e] = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  }
};
template <>
struct Vec<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

// Block (G, taps per block): threadIdx.x walks the tap's C / V vectors
// (G = min(C / V, 256) of them at a time), threadIdx.y picks the tap.
// x [B, H, W, C] T; offset [B*P, 2K] f32; mask [B*P, K] T; cols [B*P, K*C] T.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    deform_im2col_kernel(const T* __restrict__ x, const float* __restrict__ offset,
                         const T* __restrict__ mask, T* __restrict__ cols, int taps, Geom g) {
  const int tap = blockIdx.x * blockDim.y + threadIdx.y;  // (b*P + p)*K + k
  if (tap >= taps) return;
  const int row = tap / g.K, k = tap - row * g.K;
  const int b = row / g.P, p = row - b * g.P;
  const int oy = p / g.OW, ox = p - oy * g.OW;
  const int ki = k / g.kw, kj = k - ki * g.kw;

  const float dy = offset[2 * (long long)tap], dx = offset[2 * (long long)tap + 1];
  const float m = to_f32(mask[tap]);
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
  const T* src[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int cy = y0 + (q >> 1), cx = x0 + (q & 1);
    const bool in = valid && cy >= 0 && cy < g.H && cx >= 0 && cx < g.W;
    const float wyx = __fmul_rn(q >> 1 ? ly : hy, q & 1 ? lx : hx);
    w[q] = round_to<T>(__fmul_rn(__fmul_rn(wyx, in ? 1.f : 0.f), m));
    const int ry = min(max(cy, 0), g.H - 1), rx = min(max(cx, 0), g.W - 1);
    src[q] = x + ((long long)(b * g.H + ry) * g.W + rx) * g.C;
  }
  T* out = cols + (long long)tap * g.C;
  for (int c = threadIdx.x * V; c < g.C; c += blockDim.x * V) {
    float v[4][V], s[V];
#pragma unroll
    for (int q = 0; q < 4; ++q) Vec<T, V>::load(src[q] + c, v[q]);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      float a = __fmul_rn(v[0][e], w[0]);
      a = __fadd_rn(a, __fmul_rn(v[1][e], w[1]));
      a = __fadd_rn(a, __fmul_rn(v[2][e], w[2]));
      s[e] = __fadd_rn(a, __fmul_rn(v[3][e], w[3]));
    }
    Vec<T, V>::store(out + c, s);
  }
}

template <typename T, int V>
cudaError_t launch_v(const void* x, const void* offset, const void* mask, void* cols, int taps,
                     const Geom& g, cudaStream_t s) {
  const int gx = g.C / V < kThreads ? g.C / V : kThreads;
  const dim3 block(gx, kThreads / gx);
  const unsigned grid = (unsigned)((taps + block.y - 1) / block.y);
  deform_im2col_kernel<T, V><<<grid, block, 0, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(offset), static_cast<const T*>(mask),
      static_cast<T*>(cols), taps, g);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* offset, const void* mask, void* cols, int B,
                   const Geom& g, cudaStream_t s) {
  const long long taps = (long long)B * g.P * g.K;
  if (taps == 0) return cudaSuccess;
  if (taps > 0x7fffffff || (long long)B * g.H * g.W > 0x7fffffff) return cudaErrorInvalidValue;
  constexpr int kV = 16 / sizeof(T);
  const bool vec = g.C % kV == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(cols) & 15) == 0;
  return vec ? launch_v<T, kV>(x, offset, mask, cols, (int)taps, g, s)
             : launch_v<T, 1>(x, offset, mask, cols, (int)taps, g, s);
}

}  // namespace

// x [B, H, W, C] (bf16, or f32 with x_f32); offset [B, OH, OW, 2*kh*kw] f32,
// (dy, dx) per row-major tap; mask [B, OH, OW, kh*kw] and cols
// [B*OH*OW, kh*kw*C] of x's type. All contiguous.
extern "C" int bt_deform_im2col(const void* x, const void* offset, const void* mask,
                                void* cols, int B, int H, int W, int C, int OH, int OW,
                                int kh, int kw, int stride, int pad, int dil, int x_f32,
                                void* stream) {
  if (B < 0 || H <= 0 || W <= 0 || C <= 0 || OH < 0 || OW < 0 || kh <= 0 || kw <= 0 ||
      stride <= 0 || dil <= 0)
    return (int)cudaErrorInvalidValue;
  const Geom g{H, W, C, OW, OH * OW, kw, kh * kw, stride, pad, dil};
  auto s = static_cast<cudaStream_t>(stream);
  return (int)(x_f32 ? launch<float>(x, offset, mask, cols, B, g, s)
                     : launch<bf16>(x, offset, mask, cols, B, g, s));
}
