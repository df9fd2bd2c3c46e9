// Fused Swin window-attention block on a padded NHWC canvas:
//   out = x + proj(attention(qkv(zero_pads(LN1(x)))))
//
// Replaces birefnet_tpu/ops/pallas/fused_block_attn.py::_fused (the bf16,
// non-int8 branch of _kernel). The TPU kernel holds a whole strip of
// windows (up to 264 x 1536 tokens) in VMEM and runs every step in one
// body. A Hopper block has 227 KB of shared memory, and one 144x144 f32
// score tile alone takes 83 KB, so the work runs as four hand-written
// kernels on one stream (bt_fused_block_attn_bf16):
//
// 1. the bf16 row pass (bf16.cuh, in row_ln.cu): LN1 with f32 statistics
//    -> pad tokens zeroed (the cyclic-shift remap or the roll-free
//    `origin` offset, as the TPU kernel does) -> bf16 rows [T, C], each
//    row read once into registers; they go to the attention scratch,
//    which the core overwrites after the qkv product has read them;
// 2. the bf16 wgmma/TMA GEMM (bf16.cuh, bf16_gemm.cu) with the store
//    epilogue: qkv = bf16(h Wqkv^T + b) -> a [T, 3C] bf16 scratch;
// 3. the window-attention core of window_core.cuh (CanvasRows): reads each
//    window's q/k/v rows straight from the scratch at the window's token
//    positions (no window_partition copy), keeps scores and probabilities
//    in registers, and writes the head outputs to a [T, C] scratch in
//    canvas order. The same core serves flash_window_attn.cu; its note
//    says what bounds it and how its design answers that;
// 4. the same GEMM with the residual epilogue: out = bf16(x + bf16(attn
//    Wproj^T + b)), token-local.
//
// What bounds it on the card: the qkv and proj products are 8 C^2 flops
// per token (about 1.2 TFLOP per Swin-L forward over the bf16 tier's 48
// blocks), which the GEMM runs on the bf16 tensor cores; at the narrow
// stages it is bound by its rows' bytes (bf16_gemm.cu). The attention core
// is small (4 * 144 * C flops per token) and bound by its 8 C bytes per
// token. The LN rows and the qkv round trip through device memory (2 C and
// 6 C bytes per token each way) are the price of the split.
//
// The softmax stays in f32 with one normalization per row, unlike the
// TPU's packed head groups that round exp(s - m) to bf16 before P v.
// Rounding points (as in the JAX kernel): LN1 -> bf16; qkv + bias -> bf16;
// q * bf16(d^-0.5) -> bf16; rel-pos bias and mask -> bf16; softmax
// probabilities -> bf16; P v -> bf16; proj + bias -> bf16; + x -> bf16.
//
// W8A8 entry, bt_fused_block_attn_i8: the int8 branch of the same TPU
// kernel (fused_block_attn.py:100-112, 208-215; ComputeConfig.int8_attn).
// The proj input's per-token scale needs each token's absmax over all C
// channels, which come from C/32 different (window, head) blocks of the
// attention core, so both projections get a row pre-pass (int8.cuh; the
// kernels are in int8_gemm.cu):
// 1. quant_rows<LN, PAD>: LN1 (f32 statistics) -> pad tokens zeroed ->
//    rows rounded to bf16 -> per-token int8 codes [T, C] + scales [T],
//    each row read once into registers;
// 2. i8 gemm<kStore>: qkv = acc * (sx * sw) + b -> bf16 [T, 3C], on
//    wgmma s8 tensor cores fed by TMA;
// 3. the attention core, as in the bf16 entry, -> attention rows bf16 [T, C];
// 4. quant_rows: per-token int8 of the attention rows (same scratch);
// 5. i8 gemm<kResidual>: out = x + bf16(acc * (sa * sw) + b).
// The int8 round trips add 2 C bytes per token each way; the qkv and proj
// products (8 C^2 integer ops per token) are bound by the int8 peak.
//
// W8A8 on f32 activations, bt_fused_block_attn_i8_f32: the same TPU
// branch at tokens.dtype == float32, the same five launches with the f32
// pieces. LN1 rows are not rounded (the TPU kernel's h.astype(f32) is a
// no-op) before their codes (quant_rows<float, true, true>); the int8
// GEMM's kStore writes the dequantized qkv + bias unrounded into an f32
// [T, 3C] scratch; the core is the f32 one (F32CanvasRows, per head, the
// q scale, bias and mask unrounded); the f32 attention rows get their
// codes (quant_rows<float, false, false>); the proj GEMM's kResidual adds
// x in f32, out = y + x. The int8 products are as in the bf16 entry; the
// f32 qkv round trip is 24 C bytes per token where bf16's is 12 C.
//
// f32 entry, bt_fused_block_attn_f32: the f32 branch of the same TPU kernel
// (its dots at precision=HIGHEST, the q scale, bias and mask unrounded), as
// the same four launches on f32 tensors (f32.cuh): the f32 row pass (LN1 +
// pad-zero -> the attention scratch), the f32 GEMM for qkv -> an f32
// [T, 3C] scratch, the f32 core of window_core_f32.cuh (F32CanvasRows),
// and the same GEMM for the projection with the bias and the residual. The
// JAX kernel runs f32 per head (its packed head groups are bf16 only), and
// so does the core. The GEMM and the core take their products on the
// tensor cores as three TF32 products (f32_gemm.cu), so the GEMMs' 8 C^2
// flops per token, three TF32 ones each, bound it at the TF32 peak of
// 494.7 TFLOP/s.

#include "bf16.cuh"
#include "f32.cuh"
#include "int8.cuh"
#include "window_core.cuh"
#include "window_core_f32.cuh"

namespace {

constexpr int kD = 32;  // head dim

using bt::Geometry;

// The attention core on the qkv scratch (window_core.cuh, CanvasRows): head
// dim 32, N = ws^2 of 16, 64 or 144 tokens, a bias, and no mask, region ids
// or a dense f32 mask. Only those lean forms are built for this layout; the
// core refuses any other.
cudaError_t attention_core(const bf16* qkv, const void* bias, const void* mask,
                           int mask_kind, bf16* attn, int B, const Geometry& g,
                           cudaStream_t s) {
  namespace core = bt::core;
  const int nwin = (g.Hp / g.ws) * (g.Wp / g.ws), n = g.ws * g.ws;
  const bt::CanvasRows rows{qkv, attn, g.Hp, g.Wp, g.C, g.ws, (65536 + g.ws - 1) / g.ws};
  const bt::Addends ad{static_cast<const float*>(bias), mask, mask_kind, nwin};
  if (n <= 64)
    return core::launch_class<bt::CanvasRows, 8, kD, true, false>(rows, ad, B * nwin,
                                                                  g.heads, n, kD, false, s);
  return core::launch_class<bt::CanvasRows, 18, kD, true, false>(rows, ad, B * nwin,
                                                                 g.heads, n, kD, false, s);
}

// The f32 core on the f32 qkv scratch (window_core_f32.cuh, F32CanvasRows),
// with the mask forms of the bf16 core's canvas layout.
cudaError_t attention_core_f32(const float* qkv, const void* bias, const void* mask,
                               int mask_kind, float* attn, int B, const Geometry& g,
                               cudaStream_t s) {
  const int nwin = (g.Hp / g.ws) * (g.Wp / g.ws);
  const bt::F32CanvasRows rows{qkv, attn, g.Hp, g.Wp, g.C, g.ws};
  const bt::Addends ad{static_cast<const float*>(bias), mask, mask_kind, nwin};
  return bt::core_f32::run<bt::F32CanvasRows, true>(rows, ad, B * nwin, g.heads, g.ws * g.ws,
                                                    kD, s);
}

// The checks both routes of K1 share: head dim 32, N = ws*ws a multiple of
// 16 and at most 144, C a multiple of 64, Hp and Wp multiples of ws, a
// bias, and no mask, a dense f32 mask or region ids.
bool bad_block(int B, int Hp, int Wp, int C, int heads, int ws, const void* bias,
               const void* mask, int mask_kind) {
  const int n = ws * ws;
  return C != heads * kD || C % 64 != 0 || n % 16 != 0 || n > 144 || Hp % ws != 0 ||
         Wp % ws != 0 || B <= 0 || bias == nullptr ||
         (mask_kind != bt::kNoMask && mask_kind != bt::kMaskF32 &&
          mask_kind != bt::kRegionIds) ||
         ((mask_kind == bt::kNoMask) != (mask == nullptr));
}

}  // namespace

// x, out [B, Hp, Wp, C] bf16; ln_g, ln_b [C] f32; wqkv [3C, C] bf16;
// bqkv [3C] f32; wproj [C, C] bf16; bproj [C] f32; bias [heads, N, N] f32;
// mask by mask_kind (window_core.cuh): null, dense [nW, N, N] f32, or
// region ids [nW, N] int32, window win of an image taking entry win;
// qkv_scratch [B*Hp*Wp, 3C] bf16;
// attn_scratch [B, Hp, Wp, C] bf16 (first the LN1 rows, then the core's
// output). Head dim 32, N = ws*ws a multiple of 16 and at most 144, C a
// multiple of 64.
extern "C" int bt_fused_block_attn_bf16(
    const void* x, const void* ln_g, const void* ln_b, const void* wqkv,
    const void* bqkv, const void* wproj, const void* bproj, const void* bias,
    const void* mask, void* qkv_scratch, void* attn_scratch, void* out, int B,
    int Hp, int Wp, int C, int heads, int ws, int shift, int origin, int h_real,
    int w_real, int mask_kind, void* stream) {
  if (bad_block(B, Hp, Wp, C, heads, ws, bias, mask, mask_kind))
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const Geometry g{Hp, Wp, C, heads, ws, shift, origin, h_real, w_real};
  const int T = B * Hp * Wp;
  auto* xb = static_cast<const bf16*>(x);
  auto* qkv = static_cast<bf16*>(qkv_scratch);
  auto* attn = static_cast<bf16*>(attn_scratch);

  cudaError_t err = bt::ln_rows_bf16(xb, static_cast<const float*>(ln_g),
                                     static_cast<const float*>(ln_b), attn, T, C, &g, s);
  if (err != cudaSuccess) return (int)err;
  err = bt::gemm_bf16<bt::kStore>(attn, static_cast<const bf16*>(wqkv),
                                  static_cast<const float*>(bqkv), nullptr, qkv, T, 3 * C, C,
                                  s);
  if (err != cudaSuccess) return (int)err;

  err = attention_core(qkv, bias, mask, mask_kind, attn, B, g, s);
  if (err != cudaSuccess) return (int)err;

  return (int)bt::gemm_bf16<bt::kResidual>(attn, static_cast<const bf16*>(wproj),
                                           static_cast<const float*>(bproj), xb,
                                           static_cast<bf16*>(out), T, C, C, s);
}

// As bt_fused_block_attn_bf16, with W8A8 projections: wqkv [3C, C] and
// wproj [C, C] int8, sqkv [3C] and sproj [C] f32 per-output-channel
// scales; codes [T, C] int8 and scales [T] f32 scratch (T = B*Hp*Wp).
extern "C" int bt_fused_block_attn_i8(
    const void* x, const void* ln_g, const void* ln_b, const void* wqkv,
    const void* sqkv, const void* bqkv, const void* wproj, const void* sproj,
    const void* bproj, const void* bias, const void* mask, void* codes,
    void* scales, void* qkv_scratch, void* attn_scratch, void* out, int B, int Hp,
    int Wp, int C, int heads, int ws, int shift, int origin, int h_real,
    int w_real, int mask_kind, void* stream) {
  namespace i8 = bt::i8;
  if (bad_block(B, Hp, Wp, C, heads, ws, bias, mask, mask_kind))
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const Geometry g{Hp, Wp, C, heads, ws, shift, origin, h_real, w_real};
  const int T = B * Hp * Wp;
  auto* xb = static_cast<const bf16*>(x);
  auto* q = static_cast<int8_t*>(codes);
  auto* sc = static_cast<float*>(scales);
  auto* qkv = static_cast<bf16*>(qkv_scratch);
  auto* attn = static_cast<bf16*>(attn_scratch);

  cudaError_t err = i8::quant_rows<bf16, true, true>(
      xb, static_cast<const float*>(ln_g), static_cast<const float*>(ln_b), q, sc, T, C,
      g, s);
  if (err != cudaSuccess) return (int)err;
  err = i8::gemm<bt::kStore, bf16>(q, sc, static_cast<const int8_t*>(wqkv),
                                   static_cast<const float*>(sqkv),
                                   static_cast<const float*>(bqkv), nullptr, qkv, T, 3 * C, C,
                                   s);
  if (err != cudaSuccess) return (int)err;

  err = attention_core(qkv, bias, mask, mask_kind, attn, B, g, s);
  if (err != cudaSuccess) return (int)err;

  err = i8::quant_rows<bf16, false, false>(attn, nullptr, nullptr, q, sc, T, C, g, s);
  if (err != cudaSuccess) return (int)err;
  return (int)i8::gemm<bt::kResidual, bf16>(
      q, sc, static_cast<const int8_t*>(wproj), static_cast<const float*>(sproj),
      static_cast<const float*>(bproj), xb, static_cast<bf16*>(out), T, C, C, s);
}

// As bt_fused_block_attn_i8 on f32 activations: x, out [B, Hp, Wp, C],
// qkv_scratch [B*Hp*Wp, 3C] and attn_scratch [B, Hp, Wp, C] f32; the
// weights, scales and codes as there; every pointer 16-byte aligned.
extern "C" int bt_fused_block_attn_i8_f32(
    const void* x, const void* ln_g, const void* ln_b, const void* wqkv,
    const void* sqkv, const void* bqkv, const void* wproj, const void* sproj,
    const void* bproj, const void* bias, const void* mask, void* codes,
    void* scales, void* qkv_scratch, void* attn_scratch, void* out, int B, int Hp,
    int Wp, int C, int heads, int ws, int shift, int origin, int h_real,
    int w_real, int mask_kind, void* stream) {
  namespace i8 = bt::i8;
  if (bad_block(B, Hp, Wp, C, heads, ws, bias, mask, mask_kind))
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const Geometry g{Hp, Wp, C, heads, ws, shift, origin, h_real, w_real};
  const int T = B * Hp * Wp;
  auto* xf = static_cast<const float*>(x);
  auto* q = static_cast<int8_t*>(codes);
  auto* sc = static_cast<float*>(scales);
  auto* qkv = static_cast<float*>(qkv_scratch);
  auto* attn = static_cast<float*>(attn_scratch);

  cudaError_t err = i8::quant_rows<float, true, true>(
      xf, static_cast<const float*>(ln_g), static_cast<const float*>(ln_b), q, sc, T, C, g,
      s);
  if (err != cudaSuccess) return (int)err;
  err = i8::gemm<bt::kStore, float>(q, sc, static_cast<const int8_t*>(wqkv),
                                    static_cast<const float*>(sqkv),
                                    static_cast<const float*>(bqkv), nullptr, qkv, T, 3 * C,
                                    C, s);
  if (err != cudaSuccess) return (int)err;

  err = attention_core_f32(qkv, bias, mask, mask_kind, attn, B, g, s);
  if (err != cudaSuccess) return (int)err;

  err = i8::quant_rows<float, false, false>(attn, nullptr, nullptr, q, sc, T, C, g, s);
  if (err != cudaSuccess) return (int)err;
  return (int)i8::gemm<bt::kResidual, float>(
      q, sc, static_cast<const int8_t*>(wproj), static_cast<const float*>(sproj),
      static_cast<const float*>(bproj), xf, static_cast<float*>(out), T, C, C, s);
}

// As bt_fused_block_attn_bf16 with every tensor f32: x, out [B, Hp, Wp, C];
// wqkv [2, 3C, C], wproj [2, C, C] (each weight's TF32 hi then lo parts,
// ops/kernels/tf32.py::split_weight); qkv_scratch [B*Hp*Wp, 3C] and attn_scratch
// [B, Hp, Wp, C] f32; every pointer 16-byte aligned.
extern "C" int bt_fused_block_attn_f32(
    const void* x, const void* ln_g, const void* ln_b, const void* wqkv,
    const void* bqkv, const void* wproj, const void* bproj, const void* bias,
    const void* mask, void* qkv_scratch, void* attn_scratch, void* out, int B,
    int Hp, int Wp, int C, int heads, int ws, int shift, int origin, int h_real,
    int w_real, int mask_kind, void* stream) {
  if (bad_block(B, Hp, Wp, C, heads, ws, bias, mask, mask_kind))
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const Geometry g{Hp, Wp, C, heads, ws, shift, origin, h_real, w_real};
  const int T = B * Hp * Wp;
  auto* xf = static_cast<const float*>(x);
  auto* qkv = static_cast<float*>(qkv_scratch);
  auto* attn = static_cast<float*>(attn_scratch);

  cudaError_t err = bt::ln_rows_f32(xf, static_cast<const float*>(ln_g),
                                    static_cast<const float*>(ln_b), attn, T, C, &g, s);
  if (err != cudaSuccess) return (int)err;
  err = bt::gemm_f32<bt::kStore>(attn, static_cast<const float*>(wqkv),
                                 static_cast<const float*>(bqkv), nullptr, qkv, T, 3 * C, C, s);
  if (err != cudaSuccess) return (int)err;

  err = attention_core_f32(qkv, bias, mask, mask_kind, attn, B, g, s);
  if (err != cudaSuccess) return (int)err;

  return (int)bt::gemm_f32<bt::kResidual>(attn, static_cast<const float*>(wproj),
                                          static_cast<const float*>(bproj), xf,
                                          static_cast<float*>(out), T, C, C, s);
}
