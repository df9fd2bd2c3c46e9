// bf16 building blocks shared by K1 (bt_fused_block_attn_bf16 in
// fused_block_attn.cu) and K2 (bt_fused_mlp_bf16 in fused_mlp.cu):
// declarations. The GEMM is compiled in bf16_gemm.cu, the row pass in
// row_ln.cu, both for sm_90a.
//
// 1. ln_rows_bf16: y = bf16(LN(x)) over rows of C, f32 statistics (eps
//    1e-5) and affine, with the canvas's pad tokens zeroed when `canvas` is
//    given (the rows are [T / (Hp Wp), Hp, Wp] canvas tokens in order):
//    the JAX kernels' `h.astype(x.dtype)` point (fused_mlp.py:66,
//    fused_block_attn.py:93). Each row is read once into registers
//    (rows.cuh) and written once.
// 2. gemm_bf16<EPI>: out[M, N] = epilogue(A[M, K] W[N, K]^T + b[N]), the
//    sum in f32 on wgmma bf16 tensor cores fed by TMA (wgmma_ring.cuh), EPI
//    an Epilogue of common.cuh, every output bf16: bf16(y), bf16(res +
//    bf16(y)) or bf16(gelu_erf3(y)). The bias, the GELU and the residual
//    add run in f32 and round where the JAX kernels round
//    (fused_mlp.py:66-85, fused_block_attn.py:119, 222, 234).

#pragma once

#include "common.cuh"

namespace bt {

// C * 2 % 16 == 0 and C <= 16384; x, y 16-byte aligned; g, b [C] f32.
cudaError_t ln_rows_bf16(const bf16* x, const float* g, const float* b, bf16* y, int T, int C,
                         const Geometry* canvas, cudaStream_t s);

// M, N, K > 0 with N % 8 == 0 and K % 8 == 0; A, W, res, out 16-byte
// aligned; res (kResidual only) [M, N] like out.
template <int EPI>
cudaError_t gemm_bf16(const bf16* A, const bf16* W, const float* bias, const bf16* res,
                      bf16* out, int M, int N, int K, cudaStream_t s);

}  // namespace bt
