// Shared helpers for the hand-written Hopper kernels (built for sm_90a).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace bt {

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// x as the TF32 hi and lo parts of a three-product TF32 MMA (f32_gemm.cu,
// window_core_f32.cuh): hi = x rounded to TF32, to nearest with ties away
// from zero (what cvt.rna.tf32.f32 gives for finite x, in two integer
// instructions where ptxas emulates the cvt in four), and lo = x - hi,
// exact in f32, whose low 13 bits the tensor cores ignore (they read lo
// truncated to TF32).
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi)));
}

// Host state that belongs to one device is kept per device index: a
// kernel's attributes (cudaFuncSetAttribute) belong to the context of the
// device current when they are set, so a process that drives two cards
// sets them on each. Indices at or past kMaxDevices are refused.
constexpr int kMaxDevices = 64;

// The current device's index (host), or -1 if it cannot be read or is at
// or past kMaxDevices.
inline int device_index() {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) return -1;
  return dev;
}

// set() once on each device: the first call on a device runs it and marks
// the device in `done` if it succeeds. Returns set()'s error, or
// cudaErrorInvalidDevice for a device past kMaxDevices.
template <class F>
cudaError_t once_per_device(bool (&done)[kMaxDevices], F set) {
  const int dev = device_index();
  if (dev < 0) return cudaErrorInvalidDevice;
  if (done[dev]) return cudaSuccess;
  const cudaError_t err = set();
  if (err == cudaSuccess) done[dev] = true;
  return err;
}

// The current device's SM count, read once per device (host).
inline int sm_count() {
  static int count[kMaxDevices] = {};
  const int dev = device_index();
  if (dev >= 0 && count[dev] > 0) return count[dev];
  int n = 0, d = 0;
  cudaGetDevice(&d);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, d);
  if (dev >= 0) count[dev] = n;
  return n;
}

// Bytes of dynamic shared memory, rounded up so the next region starts on
// a 128-byte boundary.
__host__ __device__ constexpr size_t align128(size_t n) { return (n + 127) & ~size_t(127); }

// Epilogues of the wgmma GEMMs (wgmma_ring.cuh), on y = acc + bias (bf16
// inputs) or the dequant acc * (sa * sw) + bias (int8 inputs), in f32:
enum Epilogue {
  kStore = 0,     // out bf16 = round(y)
  kResidual = 1,  // out bf16 = round(round(y) + res), res bf16 like out
  kGelu = 2,      // out bf16 = round(gelu_erf3(y)) (bf16 inputs only)
};

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
