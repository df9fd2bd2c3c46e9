// The f32 GEMM of f32.cuh for sm_90a: K1's qkv and proj products
// (bt_fused_block_attn_f32, the f32 branch of
// birefnet_tpu/ops/pallas/fused_block_attn.py::_fused) and K2's fc1 and fc2
// (bt_fused_mlp_f32, the f32 branch of fused_mlp.py::_fused), whose dots run
// at precision=HIGHEST: f32 products, f32 sums.
//
// Arithmetic: three TF32 products on the tensor cores (3xTF32). Each f32
// operand x is split into hi = x rounded to TF32 (to nearest, ties away
// from zero, as cvt.rna.tf32.f32) and lo = x - hi (exact), which the tensor
// cores read truncated to TF32 (common.cuh tf32_split), and a b is taken as
// lo_a hi_b + hi_a lo_b + hi_a hi_b, each TF32 x TF32 product exact in the
// f32 accumulator. Dropped: lo_a lo_b (2^-22 |a b| at most) and the
// truncation of the lo parts (2^-21 |a b| at most each), with random sign;
// one TF32 product would be off by up to 2^-11. On a TPU,
// precision=HIGHEST is itself such a multi-pass split (into bf16 pieces).
// PyTorch's TF32 flags do not govern this kernel.
// The tensor cores add into their f32 accumulators with truncation, which
// over a long k loop biases the sum toward zero (tools/tf32_accum_model.py:
// a mean error of 5.7e-5 at K = 6144 in one accumulator, over the 1e-5
// gate); so each k step of 32 values goes into a fresh accumulator (12
// tensor-core additions), which is then added to the tile's sums with an
// f32 add, rounded to nearest (3.6e-7 in the model).
//
// What bounds it on the card: 3 x 2 M N K TF32 operations against the
// 494.7 TFLOP/s of the dense TF32 tensor cores (165 TFLOP/s of f32-accurate
// work, 2.5x the 67 TFLOP/s of the f32 FMA units): K2's fc1 and fc2 are
// 16 C^2 f32 operations per token (2.3 TFLOP per Swin-L forward on the f32
// tier, 14 ms of TF32 work at that peak), K1's qkv and proj 8 C^2 (about
// 1.3 TFLOP, 8.8 ms). The bytes (4 (K + N) per row, the weights read twice
// as hi and lo) come to 5-6 ms at 3.35 TB/s, so the operations bound it.
//
// Design, on the wgmma/TMA ring of wgmma_ring.cuh (Mma<float>):
// - One block per SM walks 128 x 128 output tiles. Its 256 threads are
//   two consumer warpgroups, each owning 64 rows of the tile; thread 0
//   also issues the TMA loads (a producer warpgroup would cap the block at
//   168 registers a thread; a consumer holds 128 accumulators, 32 A
//   fragment registers and the addresses).
// - A k step is 128 bytes, 32 f32 values: the A tile [128, 32] and the
//   W_hi and W_lo tiles [128, 32] in a ring of 4 stages (48 KB each, 192
//   KB), with the 128-byte swizzle. W is split once on the host
//   (params.split_tf32_weights: [2, N, K], hi then lo, read by two TMA
//   maps), so no thread splits a weight. A is split by the consumer: each
//   thread loads its A fragments from the swizzled tile (conflict-free:
//   the 8 rows of a fragment column sit in 8 distinct 16-byte chunks),
//   forms hi and lo in registers and issues wgmma.m64n128k8.tf32 with A
//   from registers: per k8 slice lo_a W_hi, hi_a W_lo, then hi_a W_hi,
//   the small products first, into the step's accumulator.
// - Thread 0 issues step s + 3 while step s's wgmma run; a slot is free
//   once all eight consumer warps have waited for their wgmma on it.
// - Rows and columns past M, N and K are zero-filled by the TMA and not
//   stored. The epilogue adds the bias and runs the residual add or the
//   exact GELU by erff in f32, staging each 64 x 32 chunk in shared memory
//   so that rows are stored in 16-byte pieces, as the ring's f32 epilogue
//   does.

#include "f32.cuh"
#include "wgmma_ring.cuh"

namespace {

namespace ring = bt::ring;

constexpr int kBM = ring::kBM, kBN = ring::kBN;
constexpr int kK = 32;                        // f32 values per k step
constexpr int kStages = 4;
constexpr int kTileBytes = kBM * ring::kBK;   // one [128, 32] f32 tile
constexpr int kStageBytes = 3 * kTileBytes;   // A, W_hi, W_lo
constexpr int kThreads = 256;                 // two consumer warpgroups
constexpr int kStgRow = 40;                   // staging row stride, words
constexpr int kEpFloats = kBN + 64 * kStgRow;  // per consumer: bias, staging
// The ring (1024-byte aligned for the swizzle), 2 barriers a stage, the
// two consumers' bias and staging: 219,200 bytes.
constexpr int kSmem = 1024 + kStages * kStageBytes + 2 * kStages * 8 + 2 * kEpFloats * 4;
static_assert(kSmem <= 232448, "more shared memory than a block may have");

// The exact GELU as F.gelu computes it: x * 0.5 * (1 + erf(x / sqrt 2)).
__device__ __forceinline__ float gelu_exact(float x) {
  return x * 0.5f * (1.f + erff(x * 0.70710678118654752f));
}

template <int EPI>
__global__ void __launch_bounds__(kThreads, 1)
f32_gemm_kernel(const __grid_constant__ CUtensorMap tmA,
                   const __grid_constant__ CUtensorMap tmWh,
                   const __grid_constant__ CUtensorMap tmWl, const float* __restrict__ bias,
                   const float* __restrict__ res, float* __restrict__ out, int M, int N, int K) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring_base = (ring::smem_u32(smem_raw) + 1023) & ~1023u;
  uint8_t* ring_ptr = smem_raw + (ring_base - ring::smem_u32(smem_raw));
  const uint32_t full0 = ring_base + kStages * kStageBytes;
  const uint32_t empty0 = full0 + kStages * 8;
  const int tiles_n = (N + kBN - 1) / kBN;
  const int tiles = (M + kBM - 1) / kBM * tiles_n;
  const int ksteps = (K + kK - 1) / kK;
  // This block's tiles: blockIdx.x + i * gridDim.x for i < n_local.
  const int n_local = (tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int steps = n_local * ksteps;
  const int c = threadIdx.x >> 7, tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      ring::mbar_init(full0 + 8 * s, 1);
      ring::mbar_init(empty0 + 8 * s, 8);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Step s (local tile s / ksteps, k step s % ksteps): its three tiles,
  // once every consumer warp has released the slot's last use.
  auto issue = [&](int s) {
    const int stage = s % kStages;
    ring::mbar_wait(empty0 + 8 * stage, ((s / kStages) & 1) ^ 1);
    const int i = s / ksteps, k = s - i * ksteps;
    const int tile = blockIdx.x + i * gridDim.x;
    const int m0 = tile / tiles_n * kBM, n0 = tile % tiles_n * kBN;
    const uint32_t full = full0 + 8 * stage, a = ring_base + stage * kStageBytes;
    ring::mbar_expect_tx(full, kStageBytes);
    ring::tma_load(a, &tmA, full, k * kK, m0);
    ring::tma_load(a + kTileBytes, &tmWh, full, k * kK, n0);
    ring::tma_load(a + 2 * kTileBytes, &tmWl, full, k * kK, n0);
  };
  if (threadIdx.x == 0)
    for (int s = 0; s < kStages - 1 && s < steps; ++s) issue(s);

  float* ep = reinterpret_cast<float*>(ring_ptr + kStages * kStageBytes + 2 * kStages * 8) +
              c * kEpFloats;
  float* stg = ep + kBN;
  // This thread's A fragment rows in the tile; both sit at swizzle row g.
  const int r0 = 64 * c + 16 * warp + g;
  float acc[64], step_acc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) step_acc[e] = 0.f;
  for (int i = 0; i < n_local; ++i) {
    const int tile = blockIdx.x + i * gridDim.x;
    const int m0 = tile / tiles_n * kBM, n0 = tile % tiles_n * kBN;
    const float r_b = n0 + tid < N ? bias[n0 + tid] : 0.f;
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] = 0.f;
    for (int k = 0; k < ksteps; ++k) {
      const int s = i * ksteps + k, stage = s % kStages;
      ring::mbar_wait(full0 + 8 * stage, (s / kStages) & 1);
      __syncwarp();
      const float* As = reinterpret_cast<const float*>(ring_ptr + stage * kStageBytes);
      // A fragments of k8 slice kk: columns 8 kk + t (16-byte chunk 2 kk)
      // and 8 kk + t + 4 (chunk 2 kk + 1), swizzled by the row's g.
      uint32_t ah[4][4], al[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float x[4] = {As[r0 * kK + ((2 * kk) ^ g) * 4 + t],
                            As[(r0 + 8) * kK + ((2 * kk) ^ g) * 4 + t],
                            As[r0 * kK + ((2 * kk + 1) ^ g) * 4 + t],
                            As[(r0 + 8) * kK + ((2 * kk + 1) ^ g) * 4 + t]};
#pragma unroll
        for (int u = 0; u < 4; ++u) bt::tf32_split(x[u], ah[kk][u], al[kk][u]);
      }
      const uint32_t a = ring_base + stage * kStageBytes;
      const uint64_t dh = ring::sw128_desc(a + kTileBytes), dl = ring::sw128_desc(a + 2 * kTileBytes);
      ring::fence_acc(step_acc);
      ring::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        ring::Mma<float>::run(step_acc, al[kk], dh + 2 * kk, kk != 0);
        ring::Mma<float>::run(step_acc, ah[kk], dl + 2 * kk, 1);
        ring::Mma<float>::run(step_acc, ah[kk], dh + 2 * kk, 1);
      }
      ring::wgmma_commit();
      if (threadIdx.x == 0 && s + kStages - 1 < steps) issue(s + kStages - 1);
      __syncwarp();  // wgmma.wait_group is warp-aligned
      ring::wgmma_wait<0>();
      ring::fence_acc(step_acc);
      if (lane == 0) ring::mbar_arrive(empty0 + 8 * stage);
#pragma unroll
      for (int e = 0; e < 64; ++e) acc[e] = __fadd_rn(acc[e], step_acc[e]);
    }

    // Epilogue of this consumer's 64 rows, in chunks of 64 x 32 staged in
    // shared memory. Accumulator 4 j + 2 i + e: row 16 warp + g + 8 i,
    // column 8 j + 2 t + e of the consumer's rows.
    ring::bar_sync(1 + c, 128);  // the last tile's epilogue is done with ep
    ep[tid] = r_b;
#pragma unroll
    for (int ch = 0; ch < 4; ++ch) {
      // The residual at this thread's four 16-byte pieces of the chunk.
      float4 rf[EPI == bt::kResidual ? 4 : 1];
      if constexpr (EPI == bt::kResidual) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int sgm = tid + 128 * u, row = m0 + 64 * c + sgm / 8;
          const int col = n0 + 32 * ch + 4 * (sgm % 8);
          rf[u] = row < M && col < N ? *reinterpret_cast<const float4*>(res + (size_t)row * N + col)
                                     : make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
      ring::bar_sync(1 + c, 128);  // ep written; the last chunk's pieces read
#pragma unroll
      for (int i2 = 0; i2 < 2; ++i2) {
        const int r = 16 * warp + g + 8 * i2;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = 4 * ch + jj, col = 8 * j + 2 * t;
          const float2 bv = *reinterpret_cast<const float2*>(ep + col);
          float y0 = __fadd_rn(acc[4 * j + 2 * i2], bv.x);
          float y1 = __fadd_rn(acc[4 * j + 2 * i2 + 1], bv.y);
          if constexpr (EPI == bt::kGelu) {
            y0 = gelu_exact(y0);
            y1 = gelu_exact(y1);
          }
          *reinterpret_cast<float2*>(stg + r * kStgRow + 8 * jj + 2 * t) = make_float2(y0, y1);
        }
      }
      ring::bar_sync(1 + c, 128);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int sgm = tid + 128 * u, r = sgm / 8, q = sgm % 8;
        const int row = m0 + 64 * c + r, col = n0 + 32 * ch + 4 * q;
        if (row >= M || col >= N) continue;
        float4 y = *reinterpret_cast<const float4*>(stg + r * kStgRow + 4 * q);
        if constexpr (EPI == bt::kResidual)
          y = make_float4(__fadd_rn(y.x, rf[u].x), __fadd_rn(y.y, rf[u].y),
                          __fadd_rn(y.z, rf[u].z), __fadd_rn(y.w, rf[u].w));
        *reinterpret_cast<float4*>(out + (size_t)row * N + col) = y;
      }
    }
  }
}

}  // namespace

namespace bt {

template <int EPI>
cudaError_t gemm_f32(const float* A, const float* W, const float* bias, const float* res,
                     float* out, int M, int N, int K, cudaStream_t s) {
  if (M <= 0 || N <= 0 || K <= 0 || N % 4 != 0 || K % 8 != 0 ||
      (EPI == kResidual && res == nullptr))
    return cudaErrorInvalidValue;
  static bool attr[kMaxDevices];
  const cudaError_t err = once_per_device(attr, [] {
    return cudaFuncSetAttribute(f32_gemm_kernel<EPI>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  });
  if (err != cudaSuccess) return err;
  CUtensorMap tmA, tmWh, tmWl;
  if (!ring::encode(&tmA, A, M, K, kBM) || !ring::encode(&tmWh, W, N, K, kBN) ||
      !ring::encode(&tmWl, W + (size_t)N * K, N, K, kBN))
    return cudaErrorInvalidValue;
  const int tiles = (M + kBM - 1) / kBM * ((N + kBN - 1) / kBN);
  const int grid = tiles < bt::sm_count() ? tiles : bt::sm_count();
  f32_gemm_kernel<EPI><<<grid, kThreads, kSmem, s>>>(tmA, tmWh, tmWl, bias, res, out, M, N, K);
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
// out [M, N] f32 = epilogue(A W^T + bias): A [M, K] f32, W [2, N, K] f32
// (the weight's TF32 hi then lo parts, ops/kernels/tf32.py::split_weight),
// bias [N] f32, res [M, N] f32 (epi 1 only, else null); epi 0 store, 1
// residual, 2 exact GELU.
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
