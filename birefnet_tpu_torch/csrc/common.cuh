// Shared helpers for the hand-written Hopper kernels (built for sm_90a).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace bt {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// Bytes of dynamic shared memory, rounded up so the next region starts on
// a 128-byte boundary (wmma loads need 32-byte aligned pointers).
__host__ __device__ constexpr size_t align128(size_t n) { return (n + 127) & ~size_t(127); }

// A Swin block's padded NHWC canvas: Hp x Wp tokens of C channels in
// windows of ws, rolled by -shift (cyclic shifted blocks) or holding the
// real h_real x w_real tokens at [origin, origin + real) (roll-free offset
// partition).
struct Geometry {
  int Hp, Wp, C, heads, ws, shift, origin, h_real, w_real;
};

// True at real tokens of the canvas, the coordinates the TPU kernel
// computes from its grid (canvas row r, column c).
__device__ __forceinline__ bool token_valid(const Geometry& g, int r, int c) {
  int gr = r, gc = c;
  if (g.shift) {
    gr = (gr + g.shift) % g.Hp;
    gc = (gc + g.shift) % g.Wp;
  }
  return !(gr < g.origin || gr >= g.origin + g.h_real || gc < g.origin ||
           gc >= g.origin + g.w_real);
}

}  // namespace bt
