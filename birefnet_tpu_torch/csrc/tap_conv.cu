// 5x5 'same' (zero-padded) conv with 3 input channels and one output:
//   out[b, r, c] = bias + sum_{ch, u, v} k[u, v, ch] * x[b, r + u - 2, c + v - 2, ch]
//
// Replaces birefnet_tpu/ops/pallas/tap_conv.py::_tap_conv, the composed
// ipt1 head of the decoder at full resolution ([2, 1024, 1024, 3] bf16 on
// the main path). The work is 75 FMAs per output pixel against 6 bytes in
// and 2 bytes out, so the kernel is bound by device-memory bandwidth and
// by how well it reuses each loaded pixel: a block stages a 16 x 64 output
// tile's input with its 2-pixel halo in shared memory as f32 (each pixel
// read from device memory once per tile) and every thread accumulates 4
// outputs of one column in f32, in the TPU kernel's tap order (channel,
// then row, then column offset). The caller overwrites the border ring
// with the exact two-conv recompute, as in the JAX package.

#include "common.cuh"

namespace {

constexpr int kK = 5, kR = 2, kCin = 3;
constexpr int kTileH = 16, kTileW = 64, kThreads = 256;
constexpr int kRowsPerThread = kTileH * kTileW / kThreads;  // 4

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

// x [B, H, W, 3] bf16; k [5, 5, 3] f32; bias [1] f32; out [B, H, W] bf16.
extern "C" int bt_tap_conv5_bf16(const void* x, const void* k, const void* bias,
                                 void* out, int B, int H, int W, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, B);
  tap_conv5_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(k),
      static_cast<const float*>(bias), static_cast<bf16*>(out), H, W);
  return (int)cudaGetLastError();
}
