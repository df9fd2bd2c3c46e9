// D1b deform_col2im: the backward of D1 (csrc/deform_im2col.cu), in f32.
//
// D1 computes, for every output position p of [OH, OW], row-major tap k of
// [kh, kw] and channel c of x [B, H, W, C],
//
//   cols[b*P + p, k*C + c] = sum over the 4 bilinear corners q of
//                            x[b, qy, qx, c] * w_q * m,      m = mask[b, p, k]
//
// at the sample point ys = (oy*stride - pad + ki*dil) + dy, xs = (ox*stride
// - pad + kj*dil) + dx, (dy, dx) = offset[b, p, 2k], offset[b, p, 2k + 1],
// with w_q = wy_q * wx_q * in_q: wy = 1 - ly or ly, wx = 1 - lx or lx for
// ly = ys - floor(ys), lx = xs - floor(xs), and in_q zero unless -1 < ys < H
// and -1 < xs < W and the corner lies in the image. Given the gradient G of
// the columns [B*P, K*C], this kernel writes the gradients of D1's three
// inputs (floor has zero derivative, as in autograd and in JAX's VJP of
// birefnet_tpu/ops/deform_conv.py:68-139):
//
//   grad_mask[b, p, k]       = sum_c G * sum_q w_q x_q        (the unmasked sample)
//   grad_offset[b, p, 2k]    = m * sum_c G * sum_q dw_q/dys x_q
//   grad_offset[b, p, 2k+1]  = m * sum_c G * sum_q dw_q/dxs x_q
//   grad_x[b, qy, qx, c]    += w_q * m * G                     (f32 atomic adds)
//
// with dw/dys = -wx, -wx, +wx, +wx and dw/dxs = -wy, +wy, -wy, +wy for the
// corners (y0, x0), (y0, x0 + 1), (y0 + 1, x0), (y0 + 1, x0 + 1).
//
// Design, from D1's thread layout: a group of Gw threads (a power of two,
// at most a warp) per (position, tap); each thread computes the sample
// point and the corner weights itself, then walks the channels V at a
// time (V = 4, one 16-byte vector of G and of each corner row, where C and
// the alignment allow it, else 1), accumulating the three sums and adding
// w_q * m * G into the four corner rows of grad_x with atomicAdd (one
// 16-byte vector atomic per corner and vector where V = 4). The group
// reduces its three sums with warp shuffles and its first thread writes
// the tap's three offset and mask gradients. grad_x is zeroed first on the
// same stream. The atomics make grad_x's order of addition, and so its last
// bits, vary from run to run; the other two outputs are deterministic.
//
// Bound: the bytes of G read once (2.71 GB per 1024^2 batch-2 training
// step over the 20 ASPP sites), x and grad_x once, the offsets, masks and
// their gradients once: about 0.9 ms at 3.35 TB/s. A simple kernel's limit
// is more likely the atomics: 4 per column element.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

struct Geom {
  int H, W, C, OW, P, kw, K, stride, pad, dil;
};

template <int V>
struct Vec {
  static __device__ __forceinline__ void load(const float* p, float* v) {
#pragma unroll
    for (int e = 0; e < V; ++e) v[e] = p[e];
  }
};
template <>
struct Vec<4> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
  }
};

// grad_x[0:V] += add[0:V]: one 16-byte vector atomic (sm_90) for V = 4,
// else V scalar ones. BT_COL2IM_SCALAR_ATOMICS selects scalar atomics for
// V = 4 too (the kernel's first body, which tools/deform_col2im_time.py
// builds beside it).
template <int V>
__device__ __forceinline__ void atomic_add(float* dst, const float* add) {
#if !defined(BT_COL2IM_SCALAR_ATOMICS)
  if constexpr (V == 4) {
    atomicAdd(reinterpret_cast<float4*>(dst), make_float4(add[0], add[1], add[2], add[3]));
    return;
  }
#endif
#pragma unroll
  for (int e = 0; e < V; ++e) atomicAdd(dst + e, add[e]);
}

// Block (Gw, kThreads / Gw): threadIdx.x walks the tap's channels, V at a
// time; threadIdx.y picks the tap. G [B*P, K*C]; x, grad_x [B, H, W, C];
// offset, grad_offset [B*P, 2K]; mask, grad_mask [B*P, K]; all f32.
template <int V>
__global__ void __launch_bounds__(kThreads)
    deform_col2im_kernel(const float* __restrict__ G, const float* __restrict__ x,
                         const float* __restrict__ offset, const float* __restrict__ mask,
                         float* __restrict__ grad_x, float* __restrict__ grad_offset,
                         float* __restrict__ grad_mask, int taps, Geom g) {
  const int tap = blockIdx.x * blockDim.y + threadIdx.y;  // (b*P + p)*K + k
  const bool live = tap < taps;
  // Every thread of the warp reaches the shuffles below, live or not.
  const int t = live ? tap : 0;
  const int row = t / g.K, k = t - row * g.K;
  const int b = row / g.P, p = row - b * g.P;
  const int oy = p / g.OW, ox = p - oy * g.OW;
  const int ki = k / g.kw, kj = k - ki * g.kw;

  const float dy = offset[2 * (long long)t], dx = offset[2 * (long long)t + 1];
  const float m = mask[t];
  const float ys = __fadd_rn((float)(oy * g.stride - g.pad + ki * g.dil), dy);
  const float xs = __fadd_rn((float)(ox * g.stride - g.pad + kj * g.dil), dx);
  const bool valid = live && ys > -1.f && ys < (float)g.H && xs > -1.f && xs < (float)g.W;
  const float y0f = floorf(ys), x0f = floorf(xs);
  const float ly = __fsub_rn(ys, y0f), lx = __fsub_rn(xs, x0f);
  const float hy = __fsub_rn(1.f, ly), hx = __fsub_rn(1.f, lx);
  const int y0 = (int)fminf(fmaxf(y0f, -2.f), (float)g.H);
  const int x0 = (int)fminf(fmaxf(x0f, -2.f), (float)g.W);

  // Per corner: the unmasked weight, its derivatives in ys and xs, the
  // masked weight grad_x takes, and the row offset (or -1 outside).
  float w[4], wy_d[4], wx_d[4], wm[4];
  long long base[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int cy = y0 + (q >> 1), cx = x0 + (q & 1);
    const bool in = valid && cy >= 0 && cy < g.H && cx >= 0 && cx < g.W;
    const float s = in ? 1.f : 0.f;
    const float wy = q >> 1 ? ly : hy, wx = q & 1 ? lx : hx;
    w[q] = __fmul_rn(__fmul_rn(wy, wx), s);
    wm[q] = __fmul_rn(w[q], m);
    wy_d[q] = __fmul_rn(q >> 1 ? wx : -wx, s);
    wx_d[q] = __fmul_rn(q & 1 ? wy : -wy, s);
    base[q] = in ? ((long long)(b * g.H + cy) * g.W + cx) * g.C : -1;
  }

  float acc_m = 0.f, acc_y = 0.f, acc_x = 0.f;
  if (valid) {
    const float* gr = G + (long long)t * g.C;
    for (int c = threadIdx.x * V; c < g.C; c += blockDim.x * V) {
      float gv[V];
      Vec<V>::load(gr + c, gv);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (base[q] < 0) continue;
        float v[V];
        Vec<V>::load(x + base[q] + c, v);
        float* dst = grad_x + base[q] + c;
        float add[V];
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float gx = __fmul_rn(gv[e], v[e]);
          acc_m = __fmaf_rn(gx, w[q], acc_m);
          acc_y = __fmaf_rn(gx, wy_d[q], acc_y);
          acc_x = __fmaf_rn(gx, wx_d[q], acc_x);
          add[e] = __fmul_rn(wm[q], gv[e]);
        }
        atomic_add<V>(dst, add);
      }
    }
  }
  // Sum over the group's threads (Gw lanes of one warp).
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    if (s < (int)blockDim.x) {
      acc_m += __shfl_xor_sync(0xffffffffu, acc_m, s, blockDim.x);
      acc_y += __shfl_xor_sync(0xffffffffu, acc_y, s, blockDim.x);
      acc_x += __shfl_xor_sync(0xffffffffu, acc_x, s, blockDim.x);
    }
  }
  if (live && threadIdx.x == 0) {
    grad_mask[tap] = acc_m;
    grad_offset[2 * (long long)tap] = __fmul_rn(m, acc_y);
    grad_offset[2 * (long long)tap + 1] = __fmul_rn(m, acc_x);
  }
}

template <int V>
cudaError_t launch_v(const float* G, const float* x, const float* offset, const float* mask,
                     float* gx, float* goff, float* gmask, int taps, const Geom& g,
                     cudaStream_t s) {
  int gw = 1;
  while (gw < 32 && gw * V < g.C) gw <<= 1;
  const dim3 block(gw, kThreads / gw);
  const unsigned grid = (unsigned)((taps + block.y - 1) / block.y);
  deform_col2im_kernel<V><<<grid, block, 0, s>>>(G, x, offset, mask, gx, goff, gmask, taps, g);
  return cudaGetLastError();
}

}  // namespace

// G [B*OH*OW, kh*kw*C], x [B, H, W, C], offset [B, OH, OW, 2*kh*kw] ((dy,
// dx) per row-major tap), mask [B, OH, OW, kh*kw]; grad_x of x's shape,
// grad_offset of offset's, grad_mask of mask's. All f32 and contiguous.
extern "C" int bt_deform_col2im(const void* G, const void* x, const void* offset,
                                const void* mask, void* grad_x, void* grad_offset,
                                void* grad_mask, int B, int H, int W, int C, int OH, int OW,
                                int kh, int kw, int stride, int pad, int dil, void* stream) {
  if (B < 0 || H <= 0 || W <= 0 || C <= 0 || OH < 0 || OW < 0 || kh <= 0 || kw <= 0 ||
      stride <= 0 || dil <= 0)
    return (int)cudaErrorInvalidValue;
  const Geom g{H, W, C, OW, OH * OW, kw, kh * kw, stride, pad, dil};
  auto s = static_cast<cudaStream_t>(stream);
  const long long taps = (long long)B * g.P * g.K;
  if (taps > 0x7fffffff || (long long)B * H * W > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaMemsetAsync(grad_x, 0, sizeof(float) * (size_t)B * H * W * C, s);
  if (e != cudaSuccess || taps == 0) return (int)e;
  const bool vec = C % 4 == 0 && (reinterpret_cast<uintptr_t>(G) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(grad_x) & 15) == 0;
  auto G_ = static_cast<const float*>(G);
  auto x_ = static_cast<const float*>(x);
  auto o_ = static_cast<const float*>(offset);
  auto m_ = static_cast<const float*>(mask);
  auto gx = static_cast<float*>(grad_x);
  auto go = static_cast<float*>(grad_offset);
  auto gm = static_cast<float*>(grad_mask);
  return (int)(vec ? launch_v<4>(G_, x_, o_, m_, gx, go, gm, (int)taps, g, s)
                   : launch_v<1>(G_, x_, o_, m_, gx, go, gm, (int)taps, g, s));
}
