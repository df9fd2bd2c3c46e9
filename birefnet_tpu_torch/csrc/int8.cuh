// W8A8 building blocks shared by the int8 Swin kernels (fused_mlp_i8.cu,
// the int8 route of fused_block_attn.cu): declarations. The kernels are
// compiled once, in int8_gemm.cu, for sm_90a; its note says how they are
// built and what bounds them.
//
// Quantization, as birefnet_tpu/ops/pallas/fused_mlp.py::_quantize_rows:
// per token row, scale = max(amax, 1e-30) * (1/127) and
// q = clip(rint(h * (1/scale)), -127, 127), rounding half to even; weights
// are int8 per output channel, [N, K] row-major (torch [out, in]).
//
// 1. quant_rows<Tin, LN, PAD>: int8 rows of h = x (neither flag), LN(x)
//    (LN, f32 statistics, eps 1e-5), or Tin(LN(x) with the canvas's pad
//    tokens zeroed) (LN and PAD, the block-attention kernel's order: its
//    `h.astype(tokens.dtype)`, a bf16 rounding for bf16 rows and none for
//    f32). Writes int8 [T, K] and f32 [T] scales; each row is read once.
// 2. gemm<EPI, Out>: out[M, N] = epilogue(acc * (sa[m] * sw[n]) + b[n])
//    with acc = A[M, K] W[N, K]^T exact in s32, on wgmma s8 tensor cores
//    fed by TMA; EPI kStore or kResidual of common.cuh, Out bf16 (rounded
//    as common.cuh states) or f32 (out = y, or y + res, unrounded). The
//    dequant uses round-to-nearest multiplies and adds without
//    contraction, so the f32 values before each rounding point are those
//    of the plain PyTorch version (ops/quant.py), bit for bit.

#pragma once

#include "common.cuh"

namespace bt {
namespace i8 {

// Instantiated for Tin bf16 and float, each as <Tin, true, true> (K1-int8's
// LN1), <Tin, false, false> (K1-int8's attention rows) and <Tin, true,
// false> (K3's LN2). K * sizeof(Tin) % 16 == 0; x, q 16-byte aligned.
template <typename Tin, bool LN, bool PAD>
cudaError_t quant_rows(const Tin* x, const float* ln_g, const float* ln_b, int8_t* q,
                       float* scale, int T, int K, Geometry geo, cudaStream_t s);

// Instantiated for kStore and kResidual, each with Out bf16 and float.
// M, N, K > 0 with N % 8 == 0 and K % 16 == 0; A, W, res, out 16-byte
// aligned. res (for kResidual) is [M, N] of Out like out.
template <int EPI, typename Out>
cudaError_t gemm(const int8_t* A, const float* sa, const int8_t* W, const float* sw,
                 const float* bias, const Out* res, Out* out, int M, int N, int K,
                 cudaStream_t s);

}  // namespace i8
}  // namespace bt
