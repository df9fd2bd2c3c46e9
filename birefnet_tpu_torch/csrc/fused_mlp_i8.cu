// W8A8 Swin MLP half-block:
//   out = x + dq(q(GELU3(dq(q(LN2(x)) W1q^T) + b1)) W2q^T) + b2
// with q() per-token int8, dq() the dequant acc * (s_token * s_channel)
// and GELU3 the 3-term erf GELU in f32.
//
// Replaces birefnet_tpu/ops/pallas/fused_mlp.py::_fused_i8 (body
// `_kernel_i8`, quantization `_quantize_rows`; ComputeConfig.int8_mlp).
// The fc2 input is quantized per token over all 4C hidden units, so a
// row's scale exists only once its whole hidden row does. This kernel
// writes the hidden to device memory, as four launches on one stream
// (int8.cuh; the kernels are in int8_gemm.cu):
// 1. quant_rows<LN>: LN2 with f32 statistics, NOT rounded to bf16 (unlike
//    the block-attention route), -> int8 codes [T, C] + scales [T];
// 2. i8 gemm<kGelu>: h = GELU3(acc * (sx * s1) + b1) -> f32 [T, 4C];
// 3. quant_rows: per-token int8 of h over all 4C units -> codes [T, 4C]
//    (the same scratch) + scales; a hidden row (3072 or 6144 floats) is
//    read once, into the registers of 256 or 512 threads;
// 4. i8 gemm<kResidual>: out = x + bf16(acc * (sx2 * s2) + b2).
// Cost of the choice: the f32 hidden scratch is 16 C bytes per token
// written once and read once (at T = 8192, C = 768: 100 MB, about 0.06 ms
// of the card's 3.35 TB/s per call) plus 4 C bytes of int8 codes each way,
// against the 16 C^2 integer ops per token of the two GEMMs (77 GOP, 39 us
// at the 1,979 TOP/s int8 peak), which bound the function itself (its
// inputs and output are 30 MB, 9 us). The scratch traffic thus costs more
// than the card's least time for the whole call; keeping the hidden on
// chip (whole 4C rows per block, C <= 1536) is the next design.

#include "int8.cuh"

// x, out [T, C] bf16; ln_g, ln_b [C] f32; w1q [4C, C] int8, s1 [4C] f32,
// b1 [4C] f32; w2q [C, 4C] int8, s2 [C] f32, b2 [C] f32; codes [T, 4C]
// int8, scales [T] f32 and hidden [T, 4C] f32 scratch. C % 64 == 0.
extern "C" int bt_fused_mlp_i8(const void* x, const void* ln_g, const void* ln_b,
                               const void* w1q, const void* s1, const void* b1,
                               const void* w2q, const void* s2, const void* b2,
                               void* codes, void* scales, void* hidden, void* out,
                               int T, int C, void* stream) {
  namespace i8 = bt::i8;
  if (C % 64 != 0 || T <= 0) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto* xb = static_cast<const bf16*>(x);
  auto* q = static_cast<int8_t*>(codes);
  auto* sc = static_cast<float*>(scales);
  auto* h = static_cast<float*>(hidden);
  cudaError_t err = i8::quant_rows<bf16, true, false>(
      xb, static_cast<const float*>(ln_g), static_cast<const float*>(ln_b), q, sc, T, C,
      bt::Geometry{}, s);
  if (err != cudaSuccess) return (int)err;
  err = i8::gemm<bt::kGelu>(q, sc, static_cast<const int8_t*>(w1q),
                               static_cast<const float*>(s1),
                               static_cast<const float*>(b1), nullptr, h, T, 4 * C, C, s);
  if (err != cudaSuccess) return (int)err;
  err = i8::quant_rows<float, false, false>(h, nullptr, nullptr, q, sc, T, 4 * C,
                                            bt::Geometry{}, s);
  if (err != cudaSuccess) return (int)err;
  return (int)i8::gemm<bt::kResidual>(q, sc, static_cast<const int8_t*>(w2q),
                                          static_cast<const float*>(s2),
                                          static_cast<const float*>(b2), xb, out, T, C,
                                          4 * C, s);
}
