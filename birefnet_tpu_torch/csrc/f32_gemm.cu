// The f32 GEMM of f32.cuh for sm_90a: K1's qkv and proj products
// (bt_fused_block_attn_f32, the f32 branch of
// birefnet_tpu/ops/pallas/fused_block_attn.py::_fused) and K2's fc1 and fc2
// (bt_fused_mlp_f32, the f32 branch of fused_mlp.py::_fused), whose dots run
// at precision=HIGHEST: f32 products, f32 sums.
//
// What bounds it on the card: 2 M N K operations against the 67 TFLOP/s of
// the f32 FMA units, which is where full f32 products run (the tensor cores
// take TF32 at best, about three decimal digits). K2's fc1 and fc2 are
// 16 C^2 operations per token (2.3 TFLOP per Swin-L forward on the f32
// tier, about 35 ms at that peak), K1's qkv and proj 8 C^2 (about 1.3
// TFLOP, 19 ms). Per token a call moves 4 (K + N) bytes of rows against
// 2 K N operations: C / 4 operations a byte or more (24 at C = 96), above
// the card's f32 ridge of 20, so every call is bound by the FMA units.
//
// Design, a tiled FFMA kernel: a block of 256 threads computes a 128 x 128
// output tile, each thread an 8 x 8 register tile (two 4 x 4 quadrants 64
// rows and 64 columns apart, so a warp's shared-memory reads are
// broadcasts or 16 distinct 16-byte words). The A and W tiles are staged
// k-major ([8][128], rows padded to 132 floats), transposed on the way in
// by 4-byte cp.async copies, in a ring of three stages: the copies of k
// tiles kt + 1 and kt + 2 are in flight while tile kt computes. Each k step
// reads two float4 of A and two of W and issues 64 FFMAs. Rows and columns
// past M and N are zero-filled by the copies and not stored. The bias and
// the epilogue (the residual add, or the exact GELU by erff) run in f32 in
// registers, and each output is written once as a float4.

#include "f32.cuh"

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 8, kStages = 3, kThreads = 256;
constexpr int kLd = kBM + 4;  // floats per k row of a staged tile

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}

// The exact GELU as F.gelu computes it: x * 0.5 * (1 + erf(x / sqrt 2)).
__device__ __forceinline__ float gelu_exact(float x) {
  return x * 0.5f * (1.f + erff(x * 0.70710678118654752f));
}

template <int EPI>
__global__ void __launch_bounds__(kThreads, 2)
f32_gemm_kernel(const float* __restrict__ A, const float* __restrict__ W,
                const float* __restrict__ bias, const float* __restrict__ res,
                float* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(16) float As[kStages][kBK][kLd];
  __shared__ __align__(16) float Bs[kStages][kBK][kLd];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;

  // Thread tid copies row tid / 2 of the A and W tiles, k quad (tid % 2) * 4:
  // a warp's 4-byte writes land in 32 distinct banks.
  const int lr = tid >> 1, lk = (tid & 1) * 4;
  const bool a_ok = m0 + lr < M, b_ok = n0 + lr < N;
  const float* a_src = A + (size_t)(a_ok ? m0 + lr : 0) * K + lk;
  const float* b_src = W + (size_t)(b_ok ? n0 + lr : 0) * K + lk;
  auto load = [&](int stage, int kt) {
    const int k0 = kt * kBK;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      cp_async4(&As[stage][lk + u][lr], a_src + k0 + u, a_ok);
      cp_async4(&Bs[stage][lk + u][lr], b_src + k0 + u, b_ok);
    }
  };

  const int ty = tid >> 4, tx = tid & 15;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int ktiles = K / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles) load(s, s);
    asm volatile("cp.async.commit_group;\n");
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    // Tile kt's copies are done (one group per step, empty past the end);
    // the barrier also tells every thread that stage (kt - 1) % kStages,
    // which the next copy refills, is no longer read.
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
    __syncthreads();
    const int next = kt + kStages - 1;
    if (next < ktiles) load(next % kStages, next);
    asm volatile("cp.async.commit_group;\n");
    const int st = kt % kStages;
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[st][kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[st][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[st][kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[st][kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
  asm volatile("cp.async.wait_group 0;\n");

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (m >= M) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int n = n0 + half * 64 + tx * 4;
      if (n >= N) continue;
      const float4 bv = __ldg(reinterpret_cast<const float4*>(bias + n));
      float y[4] = {acc[i][4 * half] + bv.x, acc[i][4 * half + 1] + bv.y,
                    acc[i][4 * half + 2] + bv.z, acc[i][4 * half + 3] + bv.w};
      if (EPI == bt::kResidual) {
        const float4 r = *reinterpret_cast<const float4*>(res + (size_t)m * N + n);
        y[0] = r.x + y[0];
        y[1] = r.y + y[1];
        y[2] = r.z + y[2];
        y[3] = r.w + y[3];
      } else if (EPI == bt::kGelu) {
#pragma unroll
        for (int u = 0; u < 4; ++u) y[u] = gelu_exact(y[u]);
      }
      *reinterpret_cast<float4*>(out + (size_t)m * N + n) = make_float4(y[0], y[1], y[2], y[3]);
    }
  }
}

}  // namespace

namespace bt {

template <int EPI>
cudaError_t gemm_f32(const float* A, const float* W, const float* bias, const float* res,
                     float* out, int M, int N, int K, cudaStream_t s) {
  if (M <= 0 || N <= 0 || K <= 0 || N % 4 != 0 || K % kBK != 0 ||
      (EPI == kResidual && res == nullptr))
    return cudaErrorInvalidValue;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  f32_gemm_kernel<EPI><<<grid, kThreads, 0, s>>>(A, W, bias, res, out, M, N, K);
  return cudaGetLastError();
}

template cudaError_t gemm_f32<kStore>(const float*, const float*, const float*, const float*,
                                      float*, int, int, int, cudaStream_t);
template cudaError_t gemm_f32<kResidual>(const float*, const float*, const float*,
                                         const float*, float*, int, int, int, cudaStream_t);
template cudaError_t gemm_f32<kGelu>(const float*, const float*, const float*, const float*,
                                     float*, int, int, int, cudaStream_t);

}  // namespace bt

// Entry for the tests and chip_smoke.py only (the model reaches the GEMM
// through bt_fused_block_attn_f32 and bt_fused_mlp_f32).
// out [M, N] f32 = epilogue(A W^T + bias): A [M, K] and W [N, K] f32, bias
// [N] f32, res [M, N] f32 (epi 1 only, else null); epi 0 store, 1 residual,
// 2 exact GELU.
extern "C" int bt_f32_gemm(const void* A, const void* W, const void* bias, const void* res,
                           void* out, int M, int N, int K, int epi, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto a = static_cast<const float*>(A);
  auto w = static_cast<const float*>(W);
  auto b = static_cast<const float*>(bias);
  auto r = static_cast<const float*>(res);
  auto o = static_cast<float*>(out);
  switch (epi) {
    case bt::kStore:
      return (int)bt::gemm_f32<bt::kStore>(a, w, b, nullptr, o, M, N, K, s);
    case bt::kResidual:
      return (int)bt::gemm_f32<bt::kResidual>(a, w, b, r, o, M, N, K, s);
    case bt::kGelu:
      return (int)bt::gemm_f32<bt::kGelu>(a, w, b, nullptr, o, M, N, K, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
