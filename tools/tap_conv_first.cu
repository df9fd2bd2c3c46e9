// K5's first CUDA body (birefnet_tpu_torch/csrc/tap_conv.cu as first
// ported): one 16 x 64 output tile per block, staged into shared memory as
// f32 by scalar loads, 4 outputs of one column a thread, the taps in the
// TPU kernel's order (channel, then row, then column offset), one fmaf
// each from the bias. Kept as the reference of the redesigned kernel, which
// applies the taps in the same order and so gives bitwise the same output
// (tests/test_torch_cuda.py), and as the baseline of
// tools/tap_conv_phases.py. Not part of the port's library.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
typedef __nv_bfloat16 bf16;
namespace {
constexpr int kK = 5, kR = 2, kCin = 3;
constexpr int kTileH = 16, kTileW = 64, kThreads = 256;
constexpr int kRowsPerThread = kTileH * kTileW / kThreads;
__global__ void __launch_bounds__(kThreads)
tap_conv5_kernel(const bf16* __restrict__ x, const float* __restrict__ k,
                 const float* __restrict__ bias, bf16* __restrict__ out, int H, int W) {
  __shared__ float tile[kCin][kTileH + 2 * kR][kTileW + 2 * kR];
  __shared__ float kw[kK * kK * kCin];
  const int b = blockIdx.z, r0 = blockIdx.y * kTileH, c0 = blockIdx.x * kTileW;
  const bf16* xb = x + (size_t)b * H * W * kCin;
  for (int i = threadIdx.x; i < kK * kK * kCin; i += kThreads) kw[i] = k[i];
  constexpr int th = kTileH + 2 * kR, tw = kTileW + 2 * kR;
  for (int i = threadIdx.x; i < th * tw * kCin; i += kThreads) {
    const int ch = i % kCin, cc = (i / kCin) % tw, rr = i / (kCin * tw);
    const int r = r0 + rr - kR, c = c0 + cc - kR;
    float v = 0.f;
    if (r >= 0 && r < H && c >= 0 && c < W)
      v = __bfloat162float(xb[((size_t)r * W + c) * kCin + ch]);
    tile[ch][rr][cc] = v;
  }
  __syncthreads();
  const int tx = threadIdx.x % kTileW, ty = threadIdx.x / kTileW;
  const float b0 = bias[0];
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    const int lr = ty * kRowsPerThread + j;
    float acc = b0;
#pragma unroll
    for (int ch = 0; ch < kCin; ++ch)
#pragma unroll
      for (int u = 0; u < kK; ++u)
#pragma unroll
        for (int v = 0; v < kK; ++v)
          acc = fmaf(kw[(u * kK + v) * kCin + ch], tile[ch][lr + u][tx + v], acc);
    const int r = r0 + lr, c = c0 + tx;
    if (r < H && c < W) out[((size_t)b * H + r) * W + c] = __float2bfloat16(acc);
  }
}
}  // namespace
extern "C" int tap_conv5_first(const void* x, const void* k, const void* bias,
                               void* out, int B, int H, int W, void* stream) {
  dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, B);
  tap_conv5_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(k),
      static_cast<const float*>(bias), static_cast<bf16*>(out), H, W);
  return (int)cudaGetLastError();
}
