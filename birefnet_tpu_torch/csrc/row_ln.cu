// Row LayerNorm over the last axis of [n, C], bf16 or f32 in and out:
//   y = (x - mean) * rstd * g + b, f32 statistics and affine, cast back.
//
// Replaces birefnet_tpu/ops/pallas/row_ln.py::_row_ln (its `_kernel`: f32
// mean, f32 variance of x - mean, rsqrt(var + eps), f32 affine), run at the
// patch-embed norm, the patch-merge norms and the stage-output norms: 16
// calls per Swin-L forward, [131072, 192] down to [512, 3072].
//
// What bounds it on the card: bytes. A bf16 element is read once and
// written once (4 bytes) against about 8 flops, so a call's least time is
// its bytes over 3.35 TB/s: 30 us at [131072, 192], under 2 us at
// [512, 3072], where the launch is most of the time. The kernel holds each
// row in registers at its exact width (rows.cuh: 16-byte vectors, no
// power-of-two padding, a group of 4 to 256 threads per row), takes both
// statistics there, and writes the row once; nothing f32 reaches device
// memory. One launch per call through a plain C entry.

#include "rows.cuh"

namespace {

using namespace bt;

template <typename T>
__global__ void __launch_bounds__(512)
row_ln_kernel(const T* __restrict__ x, const float* __restrict__ g,
              const float* __restrict__ b, T* __restrict__ y, int n, int C, int nvec,
              int G, float eps) {
  constexpr int E = rows::Vec<T>::E;
  __shared__ float red[32];
  const rows::Group grp(G);
  const bool live = grp.row < n;
  rows::Row<T> r;
  r.load(x + grp.row * C, grp, nvec, live);
  float mean, rstd;
  r.stats(grp, nvec, C, eps, red, mean, rstd);
  if (!live) return;
#pragma unroll
  for (int j = 0; j < rows::kRowSlots; ++j) {
    const int i = grp.vec(j);
    if (i >= nvec) continue;
    float gv[E], bv[E], out[E];
#pragma unroll
    for (int u = 0; u < E; u += 4) {
      rows::Vec<float>::load(g + i * E + u, gv + u);
      rows::Vec<float>::load(b + i * E + u, bv + u);
    }
#pragma unroll
    for (int e = 0; e < E; ++e) out[e] = (r.v[j][e] - mean) * rstd * gv[e] + bv[e];
    rows::Vec<T>::store(y + grp.row * C + i * E, out);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* g, const void* b, void* y, int n, int C,
                   float eps, cudaStream_t s) {
  const rows::Shape sh = rows::row_shape(C, sizeof(T));
  const int per_block = sh.threads / sh.G;
  row_ln_kernel<T><<<(n + per_block - 1) / per_block, sh.threads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(g), static_cast<const float*>(b),
      static_cast<T*>(y), n, C, sh.nvec, sh.G, eps);
  return cudaGetLastError();
}

}  // namespace

// x, y [n, C] contiguous, bf16 (f32 == 0) or f32 (f32 == 1); g, b [C] f32.
// x, y, g, b 16-byte aligned; C * itemsize % 16 == 0 and at most
// rows::kRowMaxVecs 16-byte vectors (C <= 16384 bf16).
extern "C" int bt_row_ln(const void* x, const void* g, const void* b, void* y, int n, int C,
                         int f32, float eps, void* stream) {
  const int itemsize = f32 ? 4 : 2;
  if (n <= 0 || C <= 0 || C * itemsize % 16 != 0 || C * itemsize / 16 > rows::kRowMaxVecs)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  return (int)(f32 ? launch<float>(x, g, b, y, n, C, eps, s)
                   : launch<bf16>(x, g, b, y, n, C, eps, s));
}
