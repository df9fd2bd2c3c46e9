// f32 building blocks of the float32 kernel tier: K1 (bt_fused_block_attn_f32
// in fused_block_attn.cu), K2 (bt_fused_mlp_f32 in fused_mlp.cu) and K6-K8
// (bt_flash_window_attn_f32 in flash_window_attn.cu): declarations. The GEMM
// is compiled in f32_gemm.cu, the row pass in row_ln.cu, the attention core
// (window_core_f32.cuh) in the two sources that launch it; all for sm_90a.
//
// They port the f32 branches of the JAX kernels, whose every dot runs at
// precision=HIGHEST (birefnet_tpu/ops/pallas/fused_block_attn.py:66-69,
// fused_mlp.py:70-72, flash_window_attn.py:50-56): f32 products summed in
// f32. The GEMM and the core take each product on the tensor cores as
// three TF32 products (3xTF32: lo_a hi_b + hi_a lo_b + hi_a hi_b of the
// operands' TF32 parts), within about 1e-6 of the f32 product, and sum in
// f32; PyTorch's TF32 flags do not govern them.
//
// 1. ln_rows_f32: y = LN(x) over f32 rows of C, f32 statistics (eps 1e-5)
//    and affine, with the canvas's pad tokens zeroed when `canvas` is given
//    (the rows are [T / (Hp Wp), Hp, Wp] canvas tokens in order): K4's
//    register-resident row kernel (rows.cuh) on f32 rows.
// 2. gemm_f32<EPI>: out[M, N] = epilogue(A[M, K] W[N, K]^T + b[N]) in f32,
//    W given as its TF32 parts [2, N, K] (hi, then lo),
//    EPI an Epilogue of common.cuh read for f32 outputs: kStore y, kResidual
//    res + y, kGelu the exact GELU 0.5 y (1 + erf(y / sqrt 2)) (erff; the
//    JAX kernel's 7.1.26 erf is within 1.5e-7 of it).

#pragma once

#include "common.cuh"

namespace bt {

// C * 4 % 16 == 0 and C <= 8192; x, y 16-byte aligned; g, b [C] f32.
cudaError_t ln_rows_f32(const float* x, const float* g, const float* b, float* y, int T, int C,
                        const Geometry* canvas, cudaStream_t s);

// M, N, K > 0 with N % 4 == 0 and K % 8 == 0; W [2, N, K] (TF32 hi, lo);
// A, W, res, out 16-byte aligned; res (kResidual only) [M, N] like out.
template <int EPI>
cudaError_t gemm_f32(const float* A, const float* W, const float* bias, const float* res,
                     float* out, int M, int N, int K, cudaStream_t s);

}  // namespace bt
