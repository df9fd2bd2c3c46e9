// Fused Swin MLP half-block: out = x + fc2(GELU_erf(LN2(x) W1^T + b1)) W2^T + b2.
//
// Replaces birefnet_tpu/ops/pallas/fused_mlp.py::_fused (the bf16 _kernel).
// The TPU kernel keeps both weights resident in VMEM and the [rows, 4C]
// hidden of a token tile on chip. Here the half-block is three launches on
// one stream (bf16.cuh):
// 1. the bf16 row pass (row_ln.cu): LN2 with f32 statistics -> bf16 rows
//    [T, C], each row read once into registers; they go to the output
//    buffer, which fc2 overwrites after fc1 has read them;
// 2. the bf16 wgmma/TMA GEMM (bf16_gemm.cu) with the GELU epilogue:
//    h = bf16(gelu_erf3(LN2 W1^T + b1)) -> a [T, 4C] bf16 scratch;
// 3. the same GEMM with the residual epilogue: out = bf16(x + bf16(h W2^T
//    + b2)).
//
// What bounds it on the card: 16 C^2 operations per token on the bf16
// tensor cores (2.3 TFLOP per Swin-L forward over the bf16 tier's 48
// blocks). With the LN rows (2 C bytes per token each way) and the hidden
// (8 C each way) in device memory, the three launches move about 26 C bytes
// per token against the function's own 4 C: at C = 192 about 118
// operations a byte, below the card's 295, so the narrow stages (0-1, C =
// 192 and 384, the main path's bf16 sites) are bound by those bytes; at
// stages 2-3 the hidden is at most 50 MB, near the size of L2. Keeping the hidden on chip for C <= 384
// (fc1 -> GELU -> fc2 per 128-row block, fc2's sums in registers) is the
// next step where the profile shows those bytes.
//
// Numerics: LN statistics in f32, eps inside rsqrt, the normed rows rounded
// to bf16; fc1 + b1 and the 3-term erf GELU in f32 (the JAX bf16 kernel's
// `_erf(fast=True)`, with an exact reciprocal), the hidden rounded to bf16;
// fc2 + b2 rounded to bf16, then the residual add rounded to bf16: the
// rounding points of the JAX kernel.
//
// f32 entry, bt_fused_mlp_f32: the f32 branch of the same TPU kernel (its
// dots at precision=HIGHEST, the 5-coefficient erf), as the same three
// launches on f32 rows (f32.cuh): the f32 row pass (LN2 -> the output
// buffer), the f32 GEMM with the bias and the exact GELU into an f32
// [T, 4C] scratch, and the same GEMM with the bias and the residual. The
// GEMM takes each product on the tensor cores as three TF32 products
// (3xTF32, within about 1e-6 of the f32 product, summed in f32; PyTorch's
// TF32 flags do not govern it), so it is bound by the TF32 peak of 494.7
// TFLOP/s over three times the 16 C^2 operations a token (f32_gemm.cu),
// not by the hidden's bytes. The JAX kernel's VMEM gate, which sends the f32 C = 1536 stage to
// the unfused XLA MLP on the TPU, is not ported: this runs at every site.

#include "bf16.cuh"
#include "f32.cuh"

// x, out [T, C] bf16; ln_g, ln_b [C] f32; w1 [4C, C] bf16; b1 [4C] f32;
// w2 [C, 4C] bf16; b2 [C] f32; hidden [T, 4C] bf16 scratch. C % 8 == 0;
// every pointer 16-byte aligned.
extern "C" int bt_fused_mlp_bf16(const void* x, const void* ln_g, const void* ln_b,
                                 const void* w1, const void* b1, const void* w2,
                                 const void* b2, void* hidden, void* out, int T, int C,
                                 void* stream) {
  if (C % 8 != 0 || C <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto* xb = static_cast<const bf16*>(x);
  auto* h = static_cast<bf16*>(hidden);
  auto* o = static_cast<bf16*>(out);
  cudaError_t err = bt::ln_rows_bf16(xb, static_cast<const float*>(ln_g),
                                     static_cast<const float*>(ln_b), o, T, C, nullptr, s);
  if (err != cudaSuccess) return (int)err;
  err = bt::gemm_bf16<bt::kGelu>(o, static_cast<const bf16*>(w1), static_cast<const float*>(b1),
                                 nullptr, h, T, 4 * C, C, s);
  if (err != cudaSuccess) return (int)err;
  return (int)bt::gemm_bf16<bt::kResidual>(h, static_cast<const bf16*>(w2),
                                           static_cast<const float*>(b2), xb, o, T, C, 4 * C,
                                           s);
}

// As bt_fused_mlp_bf16 with every tensor f32: x, out [T, C]; w1 [2, 4C, C],
// w2 [2, C, 4C] (each weight's TF32 hi then lo parts,
// ops/kernels/tf32.py::split_weight); hidden [T, 4C] f32 scratch. C % 8 == 0 and C <= 8192 (the
// row pass's widest f32 row); every pointer 16-byte aligned.
extern "C" int bt_fused_mlp_f32(const void* x, const void* ln_g, const void* ln_b,
                                const void* w1, const void* b1, const void* w2, const void* b2,
                                void* hidden, void* out, int T, int C, void* stream) {
  if (C % 8 != 0 || C <= 0 || C > 8192 || T <= 0) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto* xf = static_cast<const float*>(x);
  auto* h = static_cast<float*>(hidden);
  auto* o = static_cast<float*>(out);
  cudaError_t err = bt::ln_rows_f32(xf, static_cast<const float*>(ln_g),
                                    static_cast<const float*>(ln_b), o, T, C, nullptr, s);
  if (err != cudaSuccess) return (int)err;
  err = bt::gemm_f32<bt::kGelu>(o, static_cast<const float*>(w1), static_cast<const float*>(b1),
                                nullptr, h, T, 4 * C, C, s);
  if (err != cudaSuccess) return (int)err;
  return (int)bt::gemm_f32<bt::kResidual>(h, static_cast<const float*>(w2),
                                          static_cast<const float*>(b2), xf, o, T, C, 4 * C, s);
}
