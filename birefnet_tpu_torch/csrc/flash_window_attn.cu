// Window attention core of the Swin ws=7 middle tier, and flash attention:
//   out[w, h] = softmax(bf16(q * s) k^T + bf16(bias[h]) [+ mask[w % nW]]) v
// with s = bf16(d^-0.5), for every window w and head h.
//
// Replaces the three Pallas kernels of
// birefnet_tpu/ops/pallas/flash_window_attn.py, which compute this one
// function on two layouts: _flash_qkv (K6, the packed [B_, N, 3C] qkv
// projection, all heads of a block of windows per grid step), _flash_masked
// (K7) and _flash_plain (K8) on [B_, heads, N, d]. Here the shared core of
// window_core.cuh takes element strides (window, head, token) for q, k, v
// and the output, so K6 reads its heads' columns straight out of the packed
// projection and writes the packed [B_, N, C] output the proj product
// consumes: no transpose is ever materialized, as on the TPU. The core's
// note says what bounds it and how its design answers that.
//
// bt_flash_window_attn_f32 is the f32 branch of the same three kernels
// (their dots at precision=HIGHEST): the f32 core of window_core_f32.cuh on
// the same strided layouts, with the scale, bias and mask unrounded and the
// causal addend -1e9 in f32.
//
// Both entries take every N and head dim the JAX entry points take. The
// shapes of the first cores (core::run, core_f32::run: N <= 256, d a
// multiple of 8 up to 64, the core's own d^-0.5) run them as they are; any
// other shape runs the key-tiled cores (core_tiled, core_f32_tiled, in the
// same headers): N > 256, d above 64, a head dim the wrapper zero-padded
// to a multiple of 8 (it passes the true d's scale, which only the tiled
// cores take), and the column slices of a head dim above 128 (dv < d: one
// launch per 128 output columns, each contracting q k^T over all of d).

#include "window_core.cuh"
#include "window_core_f32.cuh"

// q, k, v, out: bf16, head dim contiguous, at element strides
// (window, head, token) = strides[0..2] (q), [3..5] (k), [6..8] (v),
// [9..11] (out), every stride and pointer 16-byte aligned (multiples of 8
// elements). bias [heads, N, N] f32, or null.
// mask by mask_kind (window_core.cuh MaskKind): none, dense [nW, N, N] f32,
// region ids [nW, N] int32, or causal; window w takes entry w % nW,
// B % nW == 0. N >= 1, d (q and k's head dim) a multiple of 8, dv (the
// output columns of v's and out's views) a multiple of 8 up to
// min(d, 128), B windows, 1 <= heads <= 65535. scale: q's multiplier, 0
// for bf16(d^-0.5).
extern "C" int bt_flash_window_attn(const void* q, const void* k, const void* v,
                                    void* out, const void* bias, const void* mask,
                                    int sqw, int sqh, int sqt, int skw, int skh,
                                    int skt, int svw, int svh, int svt, int sow,
                                    int soh, int sot, int B, int heads, int n,
                                    int d, int nw, int mask_kind, int dv, float scale,
                                    void* stream) {
  if (B <= 0 || heads <= 0 || heads > 65535 || n <= 0 || d <= 0 || d % 8 != 0 ||
      dv <= 0 || dv > d || nw <= 0 || mask_kind < bt::kNoMask ||
      mask_kind > bt::kCausal ||
      ((mask_kind == bt::kNoMask || mask_kind == bt::kCausal) != (mask == nullptr)) ||
      (mask != nullptr && B % nw != 0))
    return (int)cudaErrorInvalidValue;
  bt::StridedRows rows{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                       static_cast<const bf16*>(v), static_cast<bf16*>(out),
                       {sqw, sqh, sqt}, {skw, skh, skt}, {svw, svh, svt},
                       {sow, soh, sot}};
  const bt::Addends ad{static_cast<const float*>(bias), mask, mask_kind, nw};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 256 || d > 64 || dv != d || scale != 0.f)
    return (int)bt::core_tiled::run(
        rows, ad, B, heads, n, d, dv,
        scale != 0.f ? scale : bt::core::round_bf16_host(1.f / sqrtf((float)d)), s);
  // Heads side by side in a row (head stride d, as in K6's packed rows)
  // let a block copy a group of heads as one run.
  const bool heads_contiguous = sqh == d && skh == d && svh == d && soh == d;
  return (int)bt::core::run(rows, ad, B, heads, n, d, heads_contiguous, s);
}

// As bt_flash_window_attn with f32 q, k, v and out: every stride a multiple
// of 4 elements and every pointer 16-byte aligned; the causal addend is
// -1e9 in f32; scale 0 for f32(d^-0.5).
extern "C" int bt_flash_window_attn_f32(const void* q, const void* k, const void* v, void* out,
                                        const void* bias, const void* mask, int sqw, int sqh,
                                        int sqt, int skw, int skh, int skt, int svw, int svh,
                                        int svt, int sow, int soh, int sot, int B, int heads,
                                        int n, int d, int nw, int mask_kind, int dv, float scale,
                                        void* stream) {
  if ((mask != nullptr && B % nw != 0) || d <= 0 || d % 8 != 0 || dv <= 0 || dv > d)
    return (int)cudaErrorInvalidValue;
  const bt::F32StridedRows rows{static_cast<const float*>(q), static_cast<const float*>(k),
                                static_cast<const float*>(v), static_cast<float*>(out),
                                {sqw, sqh, sqt}, {skw, skh, skt}, {svw, svh, svt},
                                {sow, soh, sot}};
  const bt::Addends ad{static_cast<const float*>(bias), mask, mask_kind, nw};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 256 || d > 64 || dv != d || scale != 0.f)
    return (int)bt::core_f32_tiled::run(
        rows, ad, B, heads, n, d, dv, scale != 0.f ? scale : (float)std::pow((double)d, -0.5), s);
  return (int)bt::core_f32::run<bt::F32StridedRows, false>(rows, ad, B, heads, n, d, s);
}
