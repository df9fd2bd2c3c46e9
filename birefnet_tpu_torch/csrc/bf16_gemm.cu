// The bf16 GEMM of bf16.cuh for sm_90a: K1's qkv and proj products
// (bt_fused_block_attn_bf16, the bf16 branch of
// birefnet_tpu/ops/pallas/fused_block_attn.py::_fused) and K2's fc1 and fc2
// (bt_fused_mlp_bf16, fused_mlp.py::_fused), each one launch of the
// persistent, warp-specialized wgmma/TMA kernel of wgmma_ring.cuh, which
// the int8 GEMM of int8_gemm.cu shares; its note gives the design.
//
// What bounds it on the card: 2 M N K operations against the 989 TFLOP/s
// dense bf16 peak, which only wgmma reaches. K2's fc1 and fc2 are 16 C^2
// operations per token (2.32 TFLOP per Swin-L forward on the bf16 tier,
// 2.35 ms at peak), K1's qkv and proj 8 C^2 (1.17 ms). Per token a GEMM
// does 2 K N operations and moves 2 (K + N) bytes of rows (3 N with a
// residual): 0.67 C to 0.8 C operations a byte, 128-154 at C = 192, below
// the card's 295, so the narrow stages' calls are bound by bytes, the wide
// ones by the tensor cores.

#include "bf16.cuh"
#include "wgmma_ring.cuh"

namespace bt {

template <int EPI>
cudaError_t gemm_bf16(const bf16* A, const bf16* W, const float* bias, const bf16* res,
                      bf16* out, int M, int N, int K, cudaStream_t s) {
  return ring::launch<bf16, EPI>(A, W, nullptr, nullptr, bias, res, out, M, N, K, s);
}

template cudaError_t gemm_bf16<kStore>(const bf16*, const bf16*, const float*, const bf16*,
                                       bf16*, int, int, int, cudaStream_t);
template cudaError_t gemm_bf16<kResidual>(const bf16*, const bf16*, const float*, const bf16*,
                                          bf16*, int, int, int, cudaStream_t);
template cudaError_t gemm_bf16<kGelu>(const bf16*, const bf16*, const float*, const bf16*,
                                      bf16*, int, int, int, cudaStream_t);

}  // namespace bt

// Entry for the tests and chip_smoke.py only (the model reaches the GEMM
// through bt_fused_block_attn_bf16 and bt_fused_mlp_bf16).
// out [M, N] bf16 = epilogue(A W^T + bias): A [M, K] and W [N, K] bf16,
// bias [N] f32, res [M, N] bf16 (epi 1 only, else null); epi 0 store,
// 1 residual, 2 GELU.
extern "C" int bt_bf16_gemm(const void* A, const void* W, const void* bias, const void* res,
                            void* out, int M, int N, int K, int epi, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto a = static_cast<const bf16*>(A);
  auto w = static_cast<const bf16*>(W);
  auto b = static_cast<const float*>(bias);
  auto o = static_cast<bf16*>(out);
  switch (epi) {
    case bt::kStore:
      return (int)bt::gemm_bf16<bt::kStore>(a, w, b, nullptr, o, M, N, K, s);
    case bt::kResidual:
      if (res == nullptr) return (int)cudaErrorInvalidValue;
      return (int)bt::gemm_bf16<bt::kResidual>(a, w, b, static_cast<const bf16*>(res), o, M, N,
                                               K, s);
    case bt::kGelu:
      return (int)bt::gemm_bf16<bt::kGelu>(a, w, b, nullptr, o, M, N, K, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
