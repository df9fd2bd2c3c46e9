// 5x5 'same' (zero-padded) conv with 3 input channels and one output:
//   out[b, r, c] = bias + sum_{ch, u, v} k[u, v, ch] * x[b, r + u - 2, c + v - 2, ch]
//
// Replaces birefnet_tpu/ops/pallas/tap_conv.py::_tap_conv, the composed
// ipt1 head of the decoder at full resolution ([2, 1024, 1024, 3] bf16 on
// the main path). The work is 75 f32 FMAs per output pixel against 6 bytes
// in and 2 bytes out: 157 M FMAs (4.7 us at the H100's 67 TFLOP/s of f32)
// against 16.8 MB (5.0 us at 3.35 TB/s), so the kernel has to keep the FMA
// pipe busy while the input streams in, and issue little besides FMAs.
//
// Design:
// - Register blocking. A thread owns R = 4 output rows at 4 adjacent
//   columns (16 accumulators). Per channel it walks the strip's R + 4 input
//   rows once; each row is two 16-byte shared-memory loads of 8 f32 values,
//   and each value feeds up to 5 x 4 accumulators. Per output the taps are
//   applied in the TPU kernel's order (channel, then row, then column
//   offset; birefnet_tpu/ops/pallas/tap_conv.py:45-50), one fmaf each from
//   the bias, so the result is the same f32 sum as a plain per-pixel loop.
// - The taps and the bias are read from the device tensors once per block
//   (the decoder builds them on the device every forward); the taps of the
//   current channel are held in registers.
// - A persistent grid of two blocks per SM walks tiles of 32 x 128 outputs.
//   The next tile's input rows (the 2-pixel halo included) stream into a
//   raw bf16 buffer with 16-byte cp.async while the current tile computes;
//   one pass then spreads them into a channel-planar f32 tile, four pixels
//   per step with no division per element. Rows whose byte length is not a
//   multiple of 16 (W % 8 != 0) are staged by scalar loads instead.
// The caller overwrites the border ring with the exact two-conv recompute,
// as in the JAX package.

#include "common.cuh"

namespace {

constexpr int kK = 5, kR = 2, kCin = 3;
constexpr int kRows = 4;                       // output rows per thread
constexpr int kCols = 4;                       // output columns per thread
constexpr int kWarps = 8, kThreads = 32 * kWarps;
constexpr int kTileH = kRows * kWarps;         // 32
constexpr int kTileW = kCols * 32;             // 128
constexpr int kInH = kTileH + 2 * kR;          // 36 input rows per tile
constexpr int kInW = kTileW + 2 * kR;          // 132 input columns per tile
constexpr int kRawRow = kTileW * 6 + 32;       // bytes of a staged row: 16 before, 16 after
constexpr int kChunks = kRawRow / 16;          // 50
constexpr int kTapPad = 28;                    // 25 taps of a channel, padded for 16-byte loads
constexpr size_t kPlanarBytes = (size_t)kCin * kInH * kInW * 4;
constexpr size_t kRawBytes = (size_t)kInH * kRawRow;
constexpr size_t kSmem = kPlanarBytes + kRawBytes + kCin * kTapPad * 4;
static_assert(kInW % 4 == 0 && kRawRow % 16 == 0, "tile layout");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// bf16 pair (lo, hi) packed in a 32-bit word -> two f32, as __bfloat162float.
__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

struct Tile {
  int b, r0, c0;
};

__device__ __forceinline__ Tile tile_of(int t, int tiles_w, int tiles_h) {
  Tile tl;
  const int tw = t % tiles_w, rest = t / tiles_w;
  tl.c0 = tw * kTileW;
  tl.r0 = (rest % tiles_h) * kTileH;
  tl.b = rest / tiles_h;
  return tl;
}

// Issue the cp.async copies of a tile's input rows into the raw buffer:
// row i holds the bytes [6 c0 - 16, 6 (c0 + kTileW) + 16) of image row
// r0 - 2 + i, so pixel p (tile-relative, -2 <= p < kTileW + 2) starts at
// byte 16 + 6 p. W % 8 == 0 makes every image row start 16-byte aligned
// and every chunk lie wholly inside or outside the row; outside chunks and
// rows are zero-filled.
__device__ __forceinline__ void stage_raw(const bf16* __restrict__ x, uint8_t* raw, const Tile& tl,
                                          int H, int W) {
  const long row_bytes = (long)W * 6;
  for (int i = threadIdx.x; i < kInH * kChunks; i += kThreads) {
    const int row = i / kChunks, q = i - row * kChunks;
    const int r = tl.r0 - kR + row;
    const long off = (long)tl.c0 * 6 - 16 + 16 * q;
    const bool valid = r >= 0 && r < H && off >= 0 && off < row_bytes;
    const uint8_t* src = reinterpret_cast<const uint8_t*>(x);
    if (valid) src += ((long)tl.b * H + r) * row_bytes + off;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(raw + 16 * i)),
                 "l"(src), "r"(valid ? 16 : 0));
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Raw rows -> the channel-planar f32 tile plane[ch][row][p + 2]: each step
// takes four pixels (24 bytes at 4 + 24 g) and stores one 16-byte vector
// per channel.
__device__ __forceinline__ void spread_raw(const uint8_t* raw, float* plane) {
  constexpr int groups = kInW / 4;  // 33 per row
  for (int i = threadIdx.x; i < kInH * groups; i += kThreads) {
    const int row = i / groups, g = i - row * groups;
    const uint32_t* w = reinterpret_cast<const uint32_t*>(raw + row * kRawRow + 4 + 24 * g);
    uint32_t v[6];
#pragma unroll
    for (int j = 0; j < 6; ++j) v[j] = w[j];
    // Pixel words: p0 = (c0, c1) (c2, p1c0) (p1c1, p1c2) (p2c0, p2c1) (p2c2, p3c0) (p3c1, p3c2).
    const float4 c0 = make_float4(bf16_lo(v[0]), bf16_hi(v[1]), bf16_lo(v[3]), bf16_hi(v[4]));
    const float4 c1 = make_float4(bf16_hi(v[0]), bf16_lo(v[2]), bf16_hi(v[3]), bf16_lo(v[5]));
    const float4 c2 = make_float4(bf16_lo(v[1]), bf16_hi(v[2]), bf16_lo(v[4]), bf16_hi(v[5]));
    float* dst = plane + row * kInW + 4 * g;
    *reinterpret_cast<float4*>(dst) = c0;
    *reinterpret_cast<float4*>(dst + kInH * kInW) = c1;
    *reinterpret_cast<float4*>(dst + 2 * kInH * kInW) = c2;
  }
}

// The planar tile by scalar loads from device memory (any W).
__device__ __forceinline__ void stage_scalar(const bf16* __restrict__ x, float* plane,
                                             const Tile& tl, int H, int W) {
  const bf16* xb = x + (size_t)tl.b * H * W * kCin;
  for (int i = threadIdx.x; i < kInH * kInW; i += kThreads) {
    const int row = i / kInW, p = i - row * kInW;
    const int r = tl.r0 - kR + row, c = tl.c0 - kR + p;
    const bool valid = r >= 0 && r < H && c >= 0 && c < W;
    const bf16* px = xb + ((size_t)r * W + c) * kCin;
#pragma unroll
    for (int ch = 0; ch < kCin; ++ch)
      plane[(ch * kInH + row) * kInW + p] = valid ? __bfloat162float(px[ch]) : 0.f;
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
tap_conv5_kernel(const bf16* __restrict__ x, const float* __restrict__ k,
                 const float* __restrict__ bias, bf16* __restrict__ out, int H, int W,
                 int tiles_w, int tiles_h, int tiles) {
  extern __shared__ __align__(16) uint8_t smem[];
  float* plane = reinterpret_cast<float*>(smem);
  uint8_t* raw = smem + kPlanarBytes;
  float* taps = reinterpret_cast<float*>(smem + kPlanarBytes + kRawBytes);
  for (int i = threadIdx.x; i < kCin * kTapPad; i += kThreads) {
    const int ch = i / kTapPad, uv = i - ch * kTapPad;
    taps[i] = uv < kK * kK ? k[uv * kCin + ch] : 0.f;
  }
  const float b0 = bias != nullptr ? bias[0] : 0.f;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int t = blockIdx.x;
  if (kVec && t < tiles) stage_raw(x, raw, tile_of(t, tiles_w, tiles_h), H, W);
  for (; t < tiles; t += gridDim.x) {
    const Tile tl = tile_of(t, tiles_w, tiles_h);
    if (kVec) {
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncthreads();
      spread_raw(raw, plane);
      __syncthreads();
      // The raw buffer is free: stream the next tile in while this one computes.
      if (t + gridDim.x < tiles) stage_raw(x, raw, tile_of(t + gridDim.x, tiles_w, tiles_h), H, W);
    } else {
      __syncthreads();
      stage_scalar(x, plane, tl, H, W);
      __syncthreads();
    }
    float acc[kRows][kCols];
#pragma unroll
    for (int j = 0; j < kRows; ++j)
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[j][c] = b0;
#pragma unroll
    for (int ch = 0; ch < kCin; ++ch) {
      float tap[kTapPad];
#pragma unroll
      for (int i = 0; i < kTapPad; i += 4)
        *reinterpret_cast<float4*>(tap + i) =
            *reinterpret_cast<const float4*>(taps + ch * kTapPad + i);
      const float* src = plane + (ch * kInH + warp * kRows) * kInW + kCols * lane;
#pragma unroll
      for (int i = 0; i < kRows + 2 * kR; ++i) {
        float v[kCols + 2 * kR];
        *reinterpret_cast<float4*>(v) = *reinterpret_cast<const float4*>(src + i * kInW);
        *reinterpret_cast<float4*>(v + 4) = *reinterpret_cast<const float4*>(src + i * kInW + 4);
        // Input row i feeds output row j through tap row u = i - j; for each
        // output, i (so u) ascends within the channel and v inside it.
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          const int u = i - j;
          if (u < 0 || u >= kK) continue;
#pragma unroll
          for (int c = 0; c < kCols; ++c)
#pragma unroll
            for (int vv = 0; vv < kK; ++vv)
              acc[j][c] = fmaf(tap[u * kK + vv], v[c + vv], acc[j][c]);
        }
      }
    }
    const int c = tl.c0 + kCols * lane;
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int r = tl.r0 + warp * kRows + j;
      if (r >= H) break;
      bf16* dst = out + ((size_t)tl.b * H + r) * W + c;
      if (kVec && c + kCols <= W) {
        __nv_bfloat162 lo = __floats2bfloat162_rn(acc[j][0], acc[j][1]);
        __nv_bfloat162 hi = __floats2bfloat162_rn(acc[j][2], acc[j][3]);
        uint2 pack;
        pack.x = *reinterpret_cast<uint32_t*>(&lo);
        pack.y = *reinterpret_cast<uint32_t*>(&hi);
        *reinterpret_cast<uint2*>(dst) = pack;
      } else {
#pragma unroll
        for (int cc = 0; cc < kCols; ++cc)
          if (c + cc < W) dst[cc] = __float2bfloat16(acc[j][cc]);
      }
    }
    if (kVec) __syncthreads();  // the next spread overwrites the planar tile
  }
}

template <bool kVec>
cudaError_t launch(const bf16* x, const float* k, const float* bias, bf16* out, int B, int H,
                   int W, cudaStream_t s) {
  static bool attr[bt::kMaxDevices];
  const cudaError_t err = bt::once_per_device(attr, [] {
    return cudaFuncSetAttribute(tap_conv5_kernel<kVec>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  });
  if (err != cudaSuccess) return err;
  const int tiles_w = (W + kTileW - 1) / kTileW, tiles_h = (H + kTileH - 1) / kTileH;
  const long tiles = (long)B * tiles_w * tiles_h;
  if (tiles > 0x7fffffff) return cudaErrorInvalidValue;
  const int grid = tiles < 2 * bt::sm_count() ? (int)tiles : 2 * bt::sm_count();
  tap_conv5_kernel<kVec><<<grid, kThreads, kSmem, s>>>(x, k, bias, out, H, W, tiles_w, tiles_h,
                                                       (int)tiles);
  return cudaGetLastError();
}

}  // namespace

// x [B, H, W, 3] bf16; k [5, 5, 3] f32 (HWI); bias [1] f32 or null (0);
// out [B, H, W] bf16. The 16-byte staging needs W % 8 == 0 and x, out
// 16-byte aligned; other inputs take the scalar staging.
extern "C" int bt_tap_conv5_bf16(const void* x, const void* k, const void* bias,
                                 void* out, int B, int H, int W, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || k == nullptr) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const bool vec = W % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  auto* xb = static_cast<const bf16*>(x);
  auto* kf = static_cast<const float*>(k);
  auto* bf = static_cast<const float*>(bias);
  auto* ob = static_cast<bf16*>(out);
  return (int)(vec ? launch<true>(xb, kf, bf, ob, B, H, W, s)
                   : launch<false>(xb, kf, bf, ob, B, H, W, s));
}
