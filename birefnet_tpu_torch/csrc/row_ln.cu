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
//
// The same kernel, with the canvas's pad tokens zeroed for K1, is the bf16
// row pass of K1 and K2 (bf16.cuh: ln_rows_bf16): LN1 or LN2 rounded to
// bf16 into a [T, C] scratch that their GEMMs read; and, on f32 rows, the
// row pass of the f32 K1 and K2 (f32.cuh: ln_rows_f32), LN1 or LN2 in f32.

#include "bf16.cuh"
#include "f32.cuh"
#include "rows.cuh"

namespace {

using namespace bt;

// What a launch serves, in the kernel's name so that a profile tells the
// callers apart: K4's LayerNorm, the bf16 row pass of K2 (LN2 rows), or
// that of K1 (LN1 rows with the canvas's pad tokens zeroed).
enum RowPass { kK4 = 0, kRows = 1, kCanvasRows = 2 };

template <typename T, int PASS>
__global__ void __launch_bounds__(512)
row_ln_kernel(const T* __restrict__ x, const float* __restrict__ g,
              const float* __restrict__ b, T* __restrict__ y, int n, int C, int nvec,
              int G, float eps, Geometry geo) {
  constexpr int E = rows::Vec<T>::E;
  __shared__ float red[32];
  const rows::Group grp(G);
  const bool live = grp.row < n;
  rows::Row<T> r;
  r.load(x + grp.row * C, grp, nvec, live);
  float mean, rstd;
  r.stats(grp, nvec, C, eps, red, mean, rstd);
  if (!live) return;
  bool valid = true;
  if (PASS == kCanvasRows) {
    const int p = (int)(grp.row % (geo.Hp * geo.Wp));
    valid = token_valid(geo, p / geo.Wp, p % geo.Wp);
  }
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
    for (int e = 0; e < E; ++e)
      out[e] = valid ? (r.v[j][e] - mean) * rstd * gv[e] + bv[e] : 0.f;
    rows::Vec<T>::store(y + grp.row * C + i * E, out);
  }
}

template <typename T, int PASS>
cudaError_t launch(const void* x, const void* g, const void* b, void* y, int n, int C,
                   float eps, const Geometry& geo, cudaStream_t s) {
  const rows::Shape sh = rows::row_shape(C, sizeof(T));
  const int per_block = sh.threads / sh.G;
  row_ln_kernel<T, PASS><<<(n + per_block - 1) / per_block, sh.threads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(g), static_cast<const float*>(b),
      static_cast<T*>(y), n, C, sh.nvec, sh.G, eps, geo);
  return cudaGetLastError();
}

bool bad_shape(int n, int C, int itemsize) {
  return n <= 0 || C <= 0 || C * itemsize % 16 != 0 || C * itemsize / 16 > rows::kRowMaxVecs;
}

}  // namespace

cudaError_t bt::ln_rows_bf16(const bf16* x, const float* g, const float* b, bf16* y, int T,
                             int C, const Geometry* canvas, cudaStream_t s) {
  if (bad_shape(T, C, 2) || (canvas != nullptr && (canvas->Hp <= 0 || canvas->Wp <= 0)))
    return cudaErrorInvalidValue;
  return canvas != nullptr ? launch<bf16, kCanvasRows>(x, g, b, y, T, C, 1e-5f, *canvas, s)
                           : launch<bf16, kRows>(x, g, b, y, T, C, 1e-5f, Geometry{}, s);
}

cudaError_t bt::ln_rows_f32(const float* x, const float* g, const float* b, float* y, int T,
                            int C, const Geometry* canvas, cudaStream_t s) {
  if (bad_shape(T, C, 4) || (canvas != nullptr && (canvas->Hp <= 0 || canvas->Wp <= 0)))
    return cudaErrorInvalidValue;
  return canvas != nullptr ? launch<float, kCanvasRows>(x, g, b, y, T, C, 1e-5f, *canvas, s)
                           : launch<float, kRows>(x, g, b, y, T, C, 1e-5f, Geometry{}, s);
}

// x, y [n, C] contiguous, bf16 (f32 == 0) or f32 (f32 == 1); g, b [C] f32.
// x, y, g, b 16-byte aligned; C * itemsize % 16 == 0 and at most
// rows::kRowMaxVecs 16-byte vectors (C <= 16384 bf16).
extern "C" int bt_row_ln(const void* x, const void* g, const void* b, void* y, int n, int C,
                         int f32, float eps, void* stream) {
  if (bad_shape(n, C, f32 ? 4 : 2)) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  return (int)(f32 ? launch<float, kK4>(x, g, b, y, n, C, eps, Geometry{}, s)
                   : launch<bf16, kK4>(x, g, b, y, n, C, eps, Geometry{}, s));
}

// Entry for the tests and chip_smoke.py only (the model reaches the row
// pass through bt_fused_block_attn_bf16 and bt_fused_mlp_bf16): y [T, C]
// bf16 = bf16(LN(x)) of x [T, C] bf16 (eps 1e-5), with the pad tokens of a
// [T / (Hp Wp), Hp, Wp, C] canvas (its shift, origin and real extent)
// zeroed when Hp > 0.
extern "C" int bt_bf16_ln_rows(const void* x, const void* g, const void* b, void* y, int T,
                               int C, int Hp, int Wp, int shift, int origin, int h_real,
                               int w_real, void* stream) {
  const Geometry geo{Hp, Wp, C, 0, 1, shift, origin, h_real, w_real};
  return (int)bt::ln_rows_bf16(static_cast<const bf16*>(x), static_cast<const float*>(g),
                               static_cast<const float*>(b), static_cast<bf16*>(y), T, C,
                               Hp > 0 ? &geo : nullptr, static_cast<cudaStream_t>(stream));
}

// Entry for the tests and chip_smoke.py only (the model reaches the row
// pass through bt_fused_block_attn_f32 and bt_fused_mlp_f32): y [T, C] f32
// = LN(x) of x [T, C] f32 (eps 1e-5), pads zeroed as in bt_bf16_ln_rows.
extern "C" int bt_f32_ln_rows(const void* x, const void* g, const void* b, void* y, int T,
                              int C, int Hp, int Wp, int shift, int origin, int h_real,
                              int w_real, void* stream) {
  const Geometry geo{Hp, Wp, C, 0, 1, shift, origin, h_real, w_real};
  return (int)bt::ln_rows_f32(static_cast<const float*>(x), static_cast<const float*>(g),
                              static_cast<const float*>(b), static_cast<float*>(y), T, C,
                              Hp > 0 ? &geo : nullptr, static_cast<cudaStream_t>(stream));
}
