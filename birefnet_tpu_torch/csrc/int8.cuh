// W8A8 building blocks shared by the int8 Swin kernels (fused_mlp_i8.cu,
// the int8 route of fused_block_attn.cu), built for sm_90a.
//
// Quantization, as birefnet_tpu/ops/pallas/fused_mlp.py::_quantize_rows:
// per token row, scale = max(amax, 1e-30) * (1/127) and
// q = clip(rint(h * (1/scale)), -127, 127), rounding half to even; weights
// are int8 per output channel, [N, K] row-major (torch [out, in]).
//
// 1. quant_rows_kernel: one warp per row. Optionally LayerNorm with f32
//    statistics first (the LN1/LN2 of the Swin block), optionally the
//    canvas's pad tokens zeroed and the normed row rounded to bf16 (the
//    block-attention kernel's order). Writes int8 [T, K] and f32 [T]
//    scales. The row is read once per pass (mean and variance with LN,
//    then absmax, then codes); the later reads hit L1/L2.
// 2. gemm_kernel<EPI>: out[M, N] = epilogue(acc * (sa[m] * sw[n]) + b[n])
//    with acc = A[M, K] W[N, K]^T exact in s32, on integer tensor-core
//    mma.sync m16n8k32 (s8 x s8 -> s32) written out in PTX. 128 x 128
//    output tiles, 8 warps of 32 x 64, 64-byte k steps staged through
//    shared memory with the next step's tile prefetched into registers.
//
// What bounds them on the card: the GEMMs are 2*M*N*K integer ops against
// 1,979 TOP/s dense int8 (wgmma); mma.sync with synchronous shared-memory
// staging reaches a fraction of that, and the row kernels are bound by
// bytes (each activation row read two to four times, written once as int8).
// The dequant epilogue uses round-to-nearest multiplies and adds without
// contraction, so the f32 values before each rounding point are those of
// the plain PyTorch version.

#pragma once

#include "common.cuh"

namespace bt {
namespace i8 {

constexpr int kRowWarps = 8;
constexpr int kRowThreads = kRowWarps * 32;

__device__ __forceinline__ void load4(const bf16* p, float v[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = __bfloat162float(e[i]);
}

__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 raw = *reinterpret_cast<const float4*>(p);
  v[0] = raw.x;
  v[1] = raw.y;
  v[2] = raw.z;
  v[3] = raw.w;
}

// int8 rows of h = x (neither flag), LN(x) (LN), or bf16(LN(x) with the
// canvas's pad tokens zeroed) (LN and PAD). K % 4 == 0.
template <typename Tin, bool LN, bool PAD>
__global__ void __launch_bounds__(kRowThreads)
quant_rows_kernel(const Tin* __restrict__ x, const float* __restrict__ ln_g,
                  const float* __restrict__ ln_b, int8_t* __restrict__ q,
                  float* __restrict__ scale, int T, int K, Geometry geo) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = blockIdx.x * kRowWarps + warp;
  if (t >= T) return;
  const Tin* xr = x + (size_t)t * K;
  float mean = 0.f, rstd = 1.f;
  if (LN) {
    float s = 0.f;
    for (int c = lane * 4; c < K; c += 128) {
      float v[4];
      load4(xr + c, v);
      s += (v[0] + v[1]) + (v[2] + v[3]);
    }
    mean = warp_sum(s) / K;
    float var = 0.f;
    for (int c = lane * 4; c < K; c += 128) {
      float v[4];
      load4(xr + c, v);
#pragma unroll
      for (int e = 0; e < 4; ++e) var += (v[e] - mean) * (v[e] - mean);
    }
    rstd = rsqrtf(warp_sum(var) / K + 1e-5f);
  }
  bool valid = true;
  if (PAD) {
    const int p = t % (geo.Hp * geo.Wp);
    valid = token_valid(geo, p / geo.Wp, p % geo.Wp);
  }
  auto value = [&](float v, int c) -> float {
    float h = v;
    if (LN) h = __fadd_rn(__fmul_rn(__fmul_rn(v - mean, rstd), ln_g[c]), ln_b[c]);
    if (PAD) h = valid ? round_bf16(h) : 0.f;
    return h;
  };
  float amax = 0.f;
  for (int c = lane * 4; c < K; c += 128) {
    float v[4];
    load4(xr + c, v);
#pragma unroll
    for (int e = 0; e < 4; ++e) amax = fmaxf(amax, fabsf(value(v[e], c + e)));
  }
  amax = warp_max(amax);
  const float s = fmaxf(amax, 1e-30f) * (1.0f / 127.0f);
  const float inv = 1.0f / s;
  for (int c = lane * 4; c < K; c += 128) {
    float v[4];
    load4(xr + c, v);
    uint32_t packed = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float r = fminf(fmaxf(rintf(__fmul_rn(value(v[e], c + e), inv)), -127.f), 127.f);
      packed |= (uint32_t)(uint8_t)(int8_t)r << (8 * e);
    }
    *reinterpret_cast<uint32_t*>(q + (size_t)t * K + c) = packed;
  }
  if (lane == 0) scale[t] = s;
}

template <typename Tin, bool LN, bool PAD>
cudaError_t quant_rows(const Tin* x, const float* ln_g, const float* ln_b, int8_t* q,
                       float* scale, int T, int K, Geometry geo, cudaStream_t s) {
  quant_rows_kernel<Tin, LN, PAD><<<(T + kRowWarps - 1) / kRowWarps, kRowThreads, 0, s>>>(
      x, ln_g, ln_b, q, scale, T, K, geo);
  return cudaGetLastError();
}

// A&S 7.1.25 (3-term) erf GELU in f32, as the JAX int8 MLP kernel computes
// it (`_erf(fast=True)`), with an exact reciprocal.
__device__ __forceinline__ float gelu_erf3(float h) {
  const float z = __fmul_rn(h, 0.70710678118654752f);
  const float a = fabsf(z);
  const float t = 1.0f / __fadd_rn(1.0f, __fmul_rn(0.47047f, a));
  const float poly = __fmul_rn(
      t, __fadd_rn(0.3480242f, __fmul_rn(t, __fadd_rn(-0.0958798f, __fmul_rn(t, 0.7478556f)))));
  const float e = __fsub_rn(1.0f, __fmul_rn(poly, expf(__fmul_rn(-a, a))));
  return __fmul_rn(__fmul_rn(h, 0.5f), __fadd_rn(1.0f, z < 0.f ? -e : e));
}

enum Epilogue {
  kStoreBf16 = 0,     // out bf16 = round(y)
  kResidualBf16 = 1,  // out bf16 = round(round(y) + res)
  kGeluF32 = 2,       // out f32 = gelu_erf3(y)
};

constexpr int kThreads = 256;
constexpr int kBM = 128, kBN = 128, kBK = 64;
// Shared-memory row stride in bytes: 80 puts the 8 rows x 4 words of every
// fragment load in 32 different banks.
constexpr int kLd = kBK + 16;

__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// M, N > 0 with N % 8 == 0; K % 64 == 0; A, W 16-byte aligned. res (for
// kResidualBf16) is [M, N] like out.
template <int EPI>
__global__ void __launch_bounds__(kThreads)
gemm_kernel(const int8_t* __restrict__ A, const float* __restrict__ sa,
            const int8_t* __restrict__ W, const float* __restrict__ sw,
            const float* __restrict__ bias, const bf16* __restrict__ res,
            void* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(16) int8_t As[kBM * kLd];
  __shared__ __align__(16) int8_t Bs[kBN * kLd];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;  // mma fragment row group, thread in group
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int wm = warp >> 1, wn = warp & 1;  // 4 x 2 warps, 32 x 64 each

  int acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  // Each thread stages 2 16-byte chunks of the A tile and 2 of the W tile;
  // the next k step's chunks load into registers during the mma.
  uint4 ra[2], rb[2];
  auto load_tile = [&](int k0) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int c = tid + u * kThreads, r = c >> 2, kc = (c & 3) * 16;
      ra[u] = m0 + r < M ? *reinterpret_cast<const uint4*>(A + (size_t)(m0 + r) * K + k0 + kc)
                         : make_uint4(0, 0, 0, 0);
      rb[u] = n0 + r < N ? *reinterpret_cast<const uint4*>(W + (size_t)(n0 + r) * K + k0 + kc)
                         : make_uint4(0, 0, 0, 0);
    }
  };
  load_tile(0);
  for (int k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int c = tid + u * kThreads, r = c >> 2, kc = (c & 3) * 16;
      *reinterpret_cast<uint4*>(As + r * kLd + kc) = ra[u];
      *reinterpret_cast<uint4*>(Bs + r * kLd + kc) = rb[u];
    }
    __syncthreads();
    if (k0 + kBK < K) load_tile(k0 + kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      // m16n8k32 fragments (PTX ISA): A reg 0/1/2/3 = rows g/g+8/g/g+8,
      // bytes 4tg..4tg+3 / same / +16 / +16; B reg 0/1 = column g, bytes
      // 4tg.. / 16+4tg.. of the k step, i.e. W row n0+g.
      uint32_t a[2][4], b[8][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int8_t* p = As + (wm * 32 + i * 16 + g) * kLd + kk + tg * 4;
        a[i][0] = *reinterpret_cast<const uint32_t*>(p);
        a[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * kLd);
        a[i][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        a[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * kLd + 16);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int8_t* p = Bs + (wn * 64 + j * 8 + g) * kLd + kk + tg * 4;
        b[j][0] = *reinterpret_cast<const uint32_t*>(p);
        b[j][1] = *reinterpret_cast<const uint32_t*>(p + 16);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) mma_s8(acc[i][j], a[i], b[j]);
    }
    __syncthreads();
  }

  // Accumulator (i, j) element e sits at row g + 8 (e / 2), column
  // 2 tg + e % 2 of the warp's 16 x 8 tile.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm * 32 + i * 16 + g + 8 * half;
      if (row >= M) continue;
      const float sx = sa[row];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = n0 + wn * 64 + j * 8 + tg * 2;
        if (col >= N) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = col + e;
          const size_t o = (size_t)row * N + n;
          const float y = __fadd_rn(
              __fmul_rn((float)acc[i][j][2 * half + e], __fmul_rn(sx, sw[n])), bias[n]);
          if (EPI == kStoreBf16) {
            static_cast<bf16*>(out)[o] = __float2bfloat16(y);
          } else if (EPI == kResidualBf16) {
            static_cast<bf16*>(out)[o] =
                __float2bfloat16(round_bf16(y) + __bfloat162float(res[o]));
          } else {
            static_cast<float*>(out)[o] = gelu_erf3(y);
          }
        }
      }
    }
  }
}

template <int EPI>
cudaError_t gemm(const int8_t* A, const float* sa, const int8_t* W, const float* sw,
                 const float* bias, const bf16* res, void* out, int M, int N, int K,
                 cudaStream_t s) {
  gemm_kernel<EPI><<<dim3((M + kBM - 1) / kBM, (N + kBN - 1) / kBN), kThreads, 0, s>>>(
      A, sa, W, sw, bias, res, out, M, N, K);
  return cudaGetLastError();
}

}  // namespace i8
}  // namespace bt
