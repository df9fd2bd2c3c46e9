// Register-resident rows: the shared reader of the row kernels (row_ln.cu,
// the int8 row pass of int8_gemm.cu), built for sm_90a.
//
// A row of C elements is read once from device memory, as 16-byte vectors
// (8 bf16 or 4 f32), into the registers of a group of G threads: thread
// `lane` of the group holds vectors lane, lane + G, lane + 2G, lane + 3G
// (at most kRowSlots of them). The host picks G and the slots per thread
// from C with row_shape() below: 3 slots when the row's vector count is 3
// times a power of two (every Swin width, 96 * 2^k), so the group covers
// the row exactly with no idle lane; otherwise 4 slots and the next power
// of two, the slots past the row's end predicated off. So a lane holds at
// most 24 bf16 or 12 f32 values at a Swin width, whatever C is, and the
// group is part of a warp (bf16 C = 96: G = 4, 8 rows a warp), one warp
// (bf16 768, f32 384), or several warps (bf16 1536: 2, bf16 3072: 4, the
// f32 hidden rows of 3072 and 6144: 8 and 16); the group's sums then go
// through shared memory, two block barriers per sum. One warp per row at
// bf16 1536 would need 48 values a lane and 96 at 3072: more registers,
// fewer resident rows, for no fewer bytes. Blocks are max(G, 256)
// threads, so the smallest Swin-L call, [512, 3072] bf16, is 256 blocks of
// 2 rows, enough for 132 SMs.
//
// Statistics are two-pass from the registers (mean, then the mean square
// of x - mean), and each element is written once: a LayerNorm or int8 pass
// moves its row's bytes in and its output's bytes out, nothing more.

#pragma once

#include "common.cuh"

namespace bt {
namespace rows {

constexpr int kRowSlots = 4;
constexpr int kRowBlock = 256;
constexpr int kRowMaxVecs = 512 * kRowSlots;

template <typename T>
struct Vec;

template <>
struct Vec<bf16> {
  static constexpr int E = 8;
  __device__ __forceinline__ static void load(const bf16* p, float v[E]) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static void store(bf16* p, const float v[E]) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
};

template <>
struct Vec<float> {
  static constexpr int E = 4;
  __device__ __forceinline__ static void load(const float* p, float v[E]) {
    const float4 raw = *reinterpret_cast<const float4*>(p);
    v[0] = raw.x;
    v[1] = raw.y;
    v[2] = raw.z;
    v[3] = raw.w;
  }
  __device__ __forceinline__ static void store(float* p, const float v[E]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

// How a row of C elements of `itemsize` bytes spreads over a group:
// nvec 16-byte vectors, G threads (a power of two), block threads.
struct Shape {
  int nvec, G, threads;
};

inline bool pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }

// C * itemsize % 16 == 0 and C * itemsize <= 16 * kRowMaxVecs are the
// caller's to check; then G <= 512 (the row kernels' launch bound).
inline Shape row_shape(int C, int itemsize) {
  const int nvec = C * itemsize / 16;
  int G;
  if (nvec % 3 == 0 && pow2(nvec / 3)) {
    G = nvec / 3;
  } else {
    G = 1;
    while (G * kRowSlots < nvec) G *= 2;
  }
  return Shape{nvec, G, G > kRowBlock ? G : kRowBlock};
}

// The group of this thread, its lane in the group, and the row it holds.
struct Group {
  int lane, G;
  long row;
  __device__ __forceinline__ Group(int G_) : G(G_) {
    lane = threadIdx.x & (G - 1);
    row = (long)blockIdx.x * (blockDim.x / G) + threadIdx.x / G;
  }
  // Vector slot j's index in the row (valid while < nvec).
  __device__ __forceinline__ int vec(int j) const { return j * G + lane; }
};

// Sum (or max) over the G threads of each group. Every thread of the block
// calls it (G is uniform over the block); with G > 32 it syncs the block
// twice and uses red[blockDim.x / 32].
template <bool MAX>
__device__ __forceinline__ float group_reduce(float v, int G, float* red) {
  const int lanes = G < 32 ? G : 32;
  for (int o = lanes >> 1; o > 0; o >>= 1) {
    const float u = __shfl_xor_sync(0xffffffffu, v, o);
    v = MAX ? fmaxf(v, u) : v + u;
  }
  if (G > 32) {
    const int warp = threadIdx.x >> 5, per_row = G >> 5;
    __syncthreads();
    if ((threadIdx.x & 31) == 0) red[warp] = v;
    __syncthreads();
    const int first = warp - warp % per_row;
    v = red[first];
    for (int w = 1; w < per_row; ++w) v = MAX ? fmaxf(v, red[first + w]) : v + red[first + w];
  }
  return v;
}

// The group's row in registers: v[j] is vector vec(j), zeros where
// vec(j) >= nvec or the row is past the end (live false).
template <typename T>
struct Row {
  static constexpr int E = Vec<T>::E;
  float v[kRowSlots][E];

  __device__ __forceinline__ void load(const T* row, const Group& g, int nvec, bool live) {
#pragma unroll
    for (int j = 0; j < kRowSlots; ++j) {
      if (live && g.vec(j) < nvec) {
        Vec<T>::load(row + (size_t)g.vec(j) * E, v[j]);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) v[j][e] = 0.f;
      }
    }
  }

  // f32 mean and rstd = rsqrt(mean((x - mean)^2) + eps) over C elements.
  __device__ __forceinline__ void stats(const Group& g, int nvec, int C, float eps, float* red,
                                        float& mean, float& rstd) const {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < kRowSlots; ++j)
#pragma unroll
      for (int e = 0; e < E; ++e) s += v[j][e];
    mean = group_reduce<false>(s, g.G, red) / C;
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < kRowSlots; ++j) {
      if (g.vec(j) < nvec) {
#pragma unroll
        for (int e = 0; e < E; ++e) q += (v[j][e] - mean) * (v[j][e] - mean);
      }
    }
    rstd = rsqrtf(group_reduce<false>(q, g.G, red) / C + eps);
  }
};

}  // namespace rows
}  // namespace bt
