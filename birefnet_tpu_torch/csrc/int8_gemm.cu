// The W8A8 kernels of int8.cuh for sm_90a: the per-token int8 row pass and
// the int8 GEMM with its dequant epilogues, shared by K1-int8
// (bt_fused_block_attn_i8, the int8 branch of
// birefnet_tpu/ops/pallas/fused_block_attn.py::_fused) and K3
// (fused_mlp_i8.cu, fused_mlp.py::_fused_i8). The TPU kernels quantize and
// multiply inside one body; here they are launches on one stream.
//
// What bounds them on the card. The GEMMs are 2 M N K integer operations
// against the 1,979 TOP/s dense int8 peak, which only wgmma reaches: K1-int8's
// qkv and proj are 1.24 TOP per Swin-L forward (0.63 ms at peak), K3's fc1 and
// fc2 1.93. The row pass is bound by bytes: a bf16 row read once (2 bytes an
// element), int8 codes written once (1 byte).
//
// gemm_kernel<EPI>: a persistent, warp-specialized wgmma kernel.
// - Tiles of 128 x 128 outputs, k steps of 128 bytes. One block per SM
//   walks the tiles in order with a stride of the grid.
// - Warpgroup 0 is the producer: one thread issues TMA loads of the A tile
//   [128, 128] and the W tile [128, 128] of each k step into a ring of 6
//   stages in dynamic shared memory (192 KB), with the 128-byte swizzle
//   the wgmma descriptors read. Each stage has a full barrier (the TMA's
//   transaction bytes) and an empty barrier (one arrival per consumer
//   warp). TMA zero-fills rows past M and N and columns past K, which add
//   nothing to the sums; stores are masked.
// - Warpgroups 1 and 2 are consumers in ping-pong: each takes every other
//   tile whole, 128 rows as two wgmma.mma_async m64n128k32 .s32.s8.s8 per
//   32 bytes of k, both operands K-major straight from the ring (A [M, K]
//   and W [N, K] already are), 128 accumulators a thread (setmaxnreg moves
//   registers from the producer to them). Their k loops take turns, so
//   one consumer's epilogue runs while the other's wgmma keep the tensor
//   cores busy. The epilogue dequantizes through shared memory and stores
//   16-byte pieces.
// Why ping-pong: with both consumers on one tile (64 rows each) the tensor
// cores idle during every epilogue. In an A/B on the H100 (profiler device
// time, both designs with the staged epilogue) ping-pong was faster at
// most K1-int8 and K3 shapes and in their sums per forward, and slower
// only where a block gets a single tile (the half-pass proj and fc2), as
// one consumer then works alone. Staging the epilogue through shared
// memory was itself faster, at every shape, than storing 4 bytes a thread
// straight from the accumulators.
// The TMA descriptors are encoded per call on the host
// (cuTensorMapEncodeTiled, reached through the runtime's driver entry
// point, so the library does not link libcuda), passed as
// __grid_constant__ kernel parameters.
//
// quant_rows_kernel: the register-resident row of rows.cuh. Statistics,
// the LN, pad zeroing and bf16 rounding, the absmax and the codes all come
// from the one read; the f32 hidden rows of K3 (4C = 3072 and 6144 floats)
// fit too, at 12 floats a thread in groups of 256 and 512 threads.

#include <cuda.h>

#include "int8.cuh"
#include "rows.cuh"

namespace bt {
namespace i8 {
namespace {

// ---------------------------------------------------------------- row pass

template <typename Tin, bool LN, bool PAD>
__global__ void __launch_bounds__(512)
quant_rows_kernel(const Tin* __restrict__ x, const float* __restrict__ ln_g,
                  const float* __restrict__ ln_b, int8_t* __restrict__ q,
                  float* __restrict__ scale, int T, int K, int nvec, int G, Geometry geo) {
  constexpr int E = rows::Vec<Tin>::E;
  __shared__ float red[32];
  const rows::Group grp(G);
  const bool live = grp.row < T;
  rows::Row<Tin> r;
  r.load(x + grp.row * K, grp, nvec, live);
  float mean = 0.f, rstd = 1.f;
  if (LN) r.stats(grp, nvec, K, 1e-5f, red, mean, rstd);
  bool valid = true;
  if (PAD) {
    const int p = (int)(grp.row % (geo.Hp * geo.Wp));
    valid = token_valid(geo, p / geo.Wp, p % geo.Wp);
  }
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < rows::kRowSlots; ++j) {
    const int i = grp.vec(j);
    if (i >= nvec) continue;
    float gv[E], bv[E];
    if (LN) {
#pragma unroll
      for (int u = 0; u < E; u += 4) {
        rows::Vec<float>::load(ln_g + i * E + u, gv + u);
        rows::Vec<float>::load(ln_b + i * E + u, bv + u);
      }
    }
#pragma unroll
    for (int e = 0; e < E; ++e) {
      float h = r.v[j][e];
      if (LN) h = __fadd_rn(__fmul_rn(__fmul_rn(h - mean, rstd), gv[e]), bv[e]);
      if (PAD) h = valid ? round_bf16(h) : 0.f;
      r.v[j][e] = h;
      amax = fmaxf(amax, fabsf(h));
    }
  }
  amax = rows::group_reduce<true>(amax, G, red);
  if (!live) return;
  const float s = fmaxf(amax, 1e-30f) * (1.0f / 127.0f);
  const float inv = 1.0f / s;
#pragma unroll
  for (int j = 0; j < rows::kRowSlots; ++j) {
    const int i = grp.vec(j);
    if (i >= nvec) continue;
    uint32_t packed[E / 4];
#pragma unroll
    for (int w = 0; w < E / 4; ++w) {
      packed[w] = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float c = fminf(fmaxf(rintf(__fmul_rn(r.v[j][4 * w + e], inv)), -127.f), 127.f);
        packed[w] |= (uint32_t)(uint8_t)(int8_t)c << (8 * e);
      }
    }
    int8_t* dst = q + grp.row * K + i * E;
    if (E == 8)
      *reinterpret_cast<uint2*>(dst) = make_uint2(packed[0], packed[E / 4 - 1]);
    else
      *reinterpret_cast<uint32_t*>(dst) = packed[0];
  }
  if (grp.lane == 0) scale[grp.row] = s;
}

// ------------------------------------------------------------------- GEMM

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

constexpr int kBM = 128;           // tile rows
constexpr int kBN = 128;           // tile columns
constexpr int kBK = 128;           // bytes (int8 values) per k step: one swizzle row
constexpr int kThreads = 3 * 128;  // producer warpgroup + two consumers
constexpr int kABytes = kBM * kBK;  // the A tile of a stage; the W tile is as large
constexpr int kStageBytes = 2 * kABytes;
constexpr int kStages = 6;  // a 192 KB ring
// Per consumer warpgroup, the tile's dequant vectors (sa of its rows, sw
// and bias of its columns) and the staging of one 64 x 32 chunk of
// outputs, in rows of 40 words (f32) or 20 (bf16 pairs), padded so that the
// accumulator layout's stores hit distinct banks.
constexpr int kEpFloats = kBM + 2 * kBN;
constexpr int kStgWords = 64 * 40;
// The ring (1024-byte aligned for the swizzle), 2 barriers a stage, then
// the two consumers' dequant vectors and staging.
constexpr int kSmem =
    1024 + kStages * kStageBytes + 2 * kStages * 8 + 2 * (kEpFloats + kStgWords) * 4;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Spin until the barrier's phase of this parity has completed. A phase
// that does not complete within 10 s (a lost arrival or a wrong parity)
// traps, so the launch fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const uint64_t t0 = global_ns();
  for (uint32_t n = 1;; ++n) {
    if (mbar_try(bar, parity)) return;
    if ((n & 1023) == 0 && global_ns() - t0 > 10000000000ull) __trap();
  }
}

// A [rows, 128-byte] box at (k0, r0) of a 2-D tensor map into shared
// memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int k0, int r0) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(k0), "r"(r0)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile of 128-byte rows with
// the 128-byte swizzle: start address, leading offset 1 (unused by this
// layout), 1024 bytes between groups of 8 rows, layout 1 (SWIZZLE_128B).
// Moving the start by 32 bytes steps k by 32 inside the swizzled row.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Named barrier `id` over `n` threads: wait for all of them, or arrive
// without waiting.
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

template <int N>
__device__ __forceinline__ void fence_acc(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// D[64, 128] (+)= A[64, 32] B[128, 32]^T, s8 x s8 -> s32; acc == 0
// overwrites.
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      " %0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

template <int EPI>
__global__ void __launch_bounds__(kThreads, 1)
gemm_kernel(const __grid_constant__ CUtensorMap tmA, const __grid_constant__ CUtensorMap tmW,
            const float* __restrict__ sa, const float* __restrict__ sw,
            const float* __restrict__ bias, const bf16* __restrict__ res,
            void* __restrict__ out, int M, int N, int K) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t full0 = ring + kStages * kStageBytes;
  const uint32_t empty0 = full0 + kStages * 8;
  const int tiles_n = (N + kBN - 1) / kBN;
  const int tiles = (M + kBM - 1) / kBM * tiles_n;
  const int ksteps = (K + kBK - 1) / kBK;
  // This block's tiles: blockIdx.x + i * gridDim.x for i < n_local.
  const int n_local = (tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 4);  // lane 0 of each warp of the consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // Producer. Its registers go to the consumers; one thread issues.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x != 0) return;
    int stage = 0;
    uint32_t phase = 0;
    for (int i = 0; i < n_local; ++i) {
      const int tile = blockIdx.x + i * gridDim.x;
      const int m0 = tile / tiles_n * kBM, n0 = tile % tiles_n * kBN;
      for (int k = 0; k < ksteps; ++k) {
        mbar_wait(empty0 + 8 * stage, phase ^ 1);
        const uint32_t full = full0 + 8 * stage;
        const uint32_t a = ring + stage * kStageBytes;
        mbar_expect_tx(full, kStageBytes);
        tma_load(a, &tmA, full, k * kBK, m0);
        tma_load(a + kABytes, &tmW, full, k * kBK, n0);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // Consumers, ping-pong: consumer c takes the block's tiles c, c + 2, ...
  // whole, and their k loops alternate (named barriers 3 and 4, 256
  // threads): each waits for the other's last wgmma to be issued before it
  // issues its own, so one consumer's epilogue runs under the other's MMA.
  // Each thread's loads for the epilogue (its sa, sw and bias entries, and
  // the residual it adds) are issued when a tile starts, so they arrive
  // during the k loop. The epilogue runs in chunks of 64 rows x 32 columns:
  // each thread dequantizes its accumulators into a shared-memory staging
  // chunk, then the warpgroup writes the chunk out in 16-byte pieces, a
  // row's 64 or 128 bytes contiguous (the accumulator layout alone would
  // store 4 bytes a thread, 16 bytes a row).
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int c = wg - 1, tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  float* ep = reinterpret_cast<float*>(smem_raw + (ring - smem_u32(smem_raw)) +
                                       kStages * kStageBytes + 2 * kStages * 8) +
              c * kEpFloats;
  uint32_t* stg = reinterpret_cast<uint32_t*>(ep + (2 - c) * kEpFloats) + c * kStgWords;
  constexpr bool kF32 = EPI == kGeluF32;
  constexpr bool kRes = EPI == kResidualBf16;
  constexpr int kRowWords = kF32 ? 40 : 20;   // staging row stride
  constexpr int kSegsRow = kF32 ? 8 : 4;      // 16-byte pieces of a chunk row
  constexpr int kSegs = 64 * kSegsRow / 128;  // pieces per thread per chunk
  if (c == 1 && n_local > 0) bar_arrive(3, 256);  // consumer 0 goes first
  for (int i = c; i < n_local; i += 2) {
    const int tile = blockIdx.x + i * gridDim.x;
    const int m0 = tile / tiles_n * kBM, n0 = tile % tiles_n * kBN;
    const float r_sa = m0 + tid < M ? sa[m0 + tid] : 0.f;
    const float r_sw = n0 + tid < N ? sw[n0 + tid] : 0.f;
    const float r_b = n0 + tid < N ? bias[n0 + tid] : 0.f;
    // The residual at this thread's 16-byte pieces of every chunk
    // (row half h, 32 columns ch).
    uint4 rv[kRes ? 2 : 1][kRes ? 4 : 1][kRes ? kSegs : 1];
    if (kRes) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int ch = 0; ch < 4; ++ch)
#pragma unroll
          for (int u = 0; u < kSegs; ++u) {
            const int sgm = tid + 128 * u, row = m0 + 64 * h + sgm / kSegsRow;
            const int col = n0 + 32 * ch + 8 * (sgm % kSegsRow);
            rv[kRes ? h : 0][kRes ? ch : 0][kRes ? u : 0] =
                row < M && col < N
                    ? *reinterpret_cast<const uint4*>(res + (size_t)row * N + col)
                    : make_uint4(0, 0, 0, 0);
          }
    }

    int acc[2][64];  // rows 0-63 and 64-127 of the tile
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 64; ++e) acc[h][e] = 0;
    bar_sync(3 + c, 256);
    // One k step's wgmma group stays in flight: a stage is released once
    // the group after it has been issued and it has completed.
    int prev = -1;
    for (int k = 0; k < ksteps; ++k) {
      const int step = i * ksteps + k;  // this stage's place in the ring's sequence
      const int stage = step % kStages;
      mbar_wait(full0 + 8 * stage, (step / kStages) & 1);
      const uint32_t a = ring + stage * kStageBytes;
      const uint64_t da = sw128_desc(a), db = sw128_desc(a + kABytes);
      fence_acc(acc[0]);
      fence_acc(acc[1]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 32; ++kk) {
        wgmma_s8(acc[0], da + 2 * kk, db + 2 * kk, (k | kk) != 0);
        wgmma_s8(acc[1], da + (64 * kBK >> 4) + 2 * kk, db + 2 * kk, (k | kk) != 0);
      }
      wgmma_commit();
      fence_acc(acc[0]);
      fence_acc(acc[1]);
      wgmma_wait<1>();
      if (prev >= 0 && lane == 0) mbar_arrive(empty0 + 8 * prev);
      prev = stage;
    }
    if (i + 1 < n_local) bar_arrive(4 - c, 256);  // the other consumer's turn
    wgmma_wait<0>();
    fence_acc(acc[0]);
    fence_acc(acc[1]);
    if (lane == 0) mbar_arrive(empty0 + 8 * prev);

    bar_sync(1 + c, 128);  // the last tile's epilogue is done with ep and stg
    ep[tid] = r_sa;
    ep[kBM + tid] = r_sw;
    ep[kBM + kBN + tid] = r_b;
    // Accumulator 4 j + 2 i + e of half h: row 64 h + 16 warp + lane / 4 +
    // 8 i, column 8 j + 2 (lane % 4) + e of the tile.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int ch = 0; ch < 4; ++ch) {
        bar_sync(1 + c, 128);  // ep written; the last chunk's pieces read
#pragma unroll
        for (int i2 = 0; i2 < 2; ++i2) {
          const int r = warp * 16 + (lane >> 2) + 8 * i2;
          const float sx = ep[64 * h + r];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int j = 4 * ch + jj, col = 8 * j + 2 * (lane & 3);
            const float2 swv = *reinterpret_cast<const float2*>(ep + kBM + col);
            const float2 bv = *reinterpret_cast<const float2*>(ep + kBM + kBN + col);
            const float y0 = __fadd_rn(
                __fmul_rn((float)acc[h][4 * j + 2 * i2], __fmul_rn(sx, swv.x)), bv.x);
            const float y1 = __fadd_rn(
                __fmul_rn((float)acc[h][4 * j + 2 * i2 + 1], __fmul_rn(sx, swv.y)), bv.y);
            if (kF32) {
              *reinterpret_cast<float2*>(stg + r * kRowWords + 8 * jj + 2 * (lane & 3)) =
                  make_float2(gelu_erf3(y0), gelu_erf3(y1));
            } else {
              *reinterpret_cast<__nv_bfloat162*>(stg + r * kRowWords + 4 * jj + (lane & 3)) =
                  __floats2bfloat162_rn(y0, y1);
            }
          }
        }
        bar_sync(1 + c, 128);
#pragma unroll
        for (int u = 0; u < kSegs; ++u) {
          const int sgm = tid + 128 * u, r = sgm / kSegsRow, q = sgm % kSegsRow;
          const int row = m0 + 64 * h + r, col = n0 + 32 * ch + q * (kF32 ? 4 : 8);
          if (row >= M || col >= N) continue;
          uint4 v = *reinterpret_cast<const uint4*>(stg + r * kRowWords + 4 * q);
          if (kRes) {
            // round(y) was staged; out = round(round(y) + res).
            const uint4 rr = rv[kRes ? h : 0][kRes ? ch : 0][kRes ? u : 0];
            const uint32_t* yw = &v.x;
            const uint32_t* rw = &rr.x;
            uint4 o;
            uint32_t* ow = &o.x;
#pragma unroll
            for (int w = 0; w < 4; ++w) {
              const float2 y =
                  __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(yw + w));
              const float2 x =
                  __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(rw + w));
              const __nv_bfloat162 sum = __floats2bfloat162_rn(y.x + x.x, y.y + x.y);
              ow[w] = *reinterpret_cast<const uint32_t*>(&sum);
            }
            v = o;
          }
          const size_t o = (size_t)row * N + col;
          if (kF32)
            *reinterpret_cast<uint4*>(static_cast<float*>(out) + o) = v;
          else
            *reinterpret_cast<uint4*>(static_cast<bf16*>(out) + o) = v;
        }
      }
    }
  }
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no link against libcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                     &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A row-major int8 [rows, K] matrix as TMA boxes of [box_rows, 128 bytes]
// with the 128-byte swizzle; out-of-range rows and columns read as 0.
bool encode(CUtensorMap* map, const int8_t* base, int rows, int K, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K};
  const cuuint32_t box[2] = {(cuuint32_t)kBK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<int8_t*>(base), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

}  // namespace

template <typename Tin, bool LN, bool PAD>
cudaError_t quant_rows(const Tin* x, const float* ln_g, const float* ln_b, int8_t* q,
                       float* scale, int T, int K, Geometry geo, cudaStream_t s) {
  if (T <= 0 || K <= 0 || K * (int)sizeof(Tin) % 16 != 0 ||
      K * (int)sizeof(Tin) / 16 > rows::kRowMaxVecs)
    return cudaErrorInvalidValue;
  const rows::Shape sh = rows::row_shape(K, sizeof(Tin));
  const int per_block = sh.threads / sh.G;
  quant_rows_kernel<Tin, LN, PAD><<<(T + per_block - 1) / per_block, sh.threads, 0, s>>>(
      x, ln_g, ln_b, q, scale, T, K, sh.nvec, sh.G, geo);
  return cudaGetLastError();
}

template <int EPI>
cudaError_t gemm(const int8_t* A, const float* sa, const int8_t* W, const float* sw,
                 const float* bias, const bf16* res, void* out, int M, int N, int K,
                 cudaStream_t s) {
  if (M <= 0 || N <= 0 || K <= 0 || N % 8 != 0 || K % 16 != 0) return cudaErrorInvalidValue;
  static bool attr = false;
  if (!attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        gemm_kernel<EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
    attr = true;
  }
  CUtensorMap tmA, tmW;
  if (!encode(&tmA, A, M, K, kBM) || !encode(&tmW, W, N, K, kBN)) return cudaErrorInvalidValue;
  const int tiles = (M + kBM - 1) / kBM * ((N + kBN - 1) / kBN);
  const int grid = tiles < sm_count() ? tiles : sm_count();
  gemm_kernel<EPI><<<grid, kThreads, kSmem, s>>>(tmA, tmW, sa, sw, bias, res, out, M, N, K);
  return cudaGetLastError();
}

template cudaError_t quant_rows<bf16, true, true>(const bf16*, const float*, const float*,
                                                  int8_t*, float*, int, int, Geometry,
                                                  cudaStream_t);
template cudaError_t quant_rows<bf16, false, false>(const bf16*, const float*, const float*,
                                                    int8_t*, float*, int, int, Geometry,
                                                    cudaStream_t);
template cudaError_t quant_rows<bf16, true, false>(const bf16*, const float*, const float*,
                                                   int8_t*, float*, int, int, Geometry,
                                                   cudaStream_t);
template cudaError_t quant_rows<float, false, false>(const float*, const float*, const float*,
                                                     int8_t*, float*, int, int, Geometry,
                                                     cudaStream_t);
template cudaError_t gemm<kStoreBf16>(const int8_t*, const float*, const int8_t*, const float*,
                                      const float*, const bf16*, void*, int, int, int,
                                      cudaStream_t);
template cudaError_t gemm<kResidualBf16>(const int8_t*, const float*, const int8_t*,
                                         const float*, const float*, const bf16*, void*, int,
                                         int, int, cudaStream_t);
template cudaError_t gemm<kGeluF32>(const int8_t*, const float*, const int8_t*, const float*,
                                    const float*, const bf16*, void*, int, int, int,
                                    cudaStream_t);

}  // namespace i8
}  // namespace bt

// Entries for the tests and chip_smoke.py only (the model reaches these
// kernels through bt_fused_block_attn_i8 and bt_fused_mlp_i8).

// out = epilogue(A W^T dequantized): A [M, K] and W [N, K] int8, sa [M],
// sw [N], bias [N] f32, res [M, N] bf16 (epi 1 only, else null), out [M, N]
// bf16 (epi 0, 1) or f32 (epi 2).
extern "C" int bt_i8_gemm(const void* A, const void* sa, const void* W, const void* sw,
                          const void* bias, const void* res, void* out, int M, int N, int K,
                          int epi, void* stream) {
  namespace i8 = bt::i8;
  auto s = static_cast<cudaStream_t>(stream);
  auto a = static_cast<const int8_t*>(A);
  auto w = static_cast<const int8_t*>(W);
  auto fa = static_cast<const float*>(sa);
  auto fw = static_cast<const float*>(sw);
  auto fb = static_cast<const float*>(bias);
  auto r = static_cast<const bf16*>(res);
  switch (epi) {
    case i8::kStoreBf16:
      return (int)i8::gemm<i8::kStoreBf16>(a, fa, w, fw, fb, nullptr, out, M, N, K, s);
    case i8::kResidualBf16:
      if (r == nullptr) return (int)cudaErrorInvalidValue;
      return (int)i8::gemm<i8::kResidualBf16>(a, fa, w, fw, fb, r, out, M, N, K, s);
    case i8::kGeluF32:
      return (int)i8::gemm<i8::kGeluF32>(a, fa, w, fw, fb, nullptr, out, M, N, K, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// int8 rows of x [T, K]: mode 0 plain (bf16 or f32 == 1), 1 LN (bf16), 2 LN
// with the canvas's pad tokens zeroed and bf16 rounding (bf16; the canvas
// is [T / (Hp Wp), Hp, Wp, K] with the geometry's shift, origin and real
// extent). q [T, K] int8, scale [T] f32.
extern "C" int bt_i8_quant_rows(const void* x, const void* ln_g, const void* ln_b, void* q,
                                void* scale, int T, int K, int f32, int mode, int Hp, int Wp,
                                int shift, int origin, int h_real, int w_real, void* stream) {
  namespace i8 = bt::i8;
  auto s = static_cast<cudaStream_t>(stream);
  auto g = static_cast<const float*>(ln_g);
  auto b = static_cast<const float*>(ln_b);
  auto qq = static_cast<int8_t*>(q);
  auto sc = static_cast<float*>(scale);
  const bt::Geometry geo{Hp, Wp, K, 0, 1, shift, origin, h_real, w_real};
  if (f32 && mode == 0)
    return (int)i8::quant_rows<float, false, false>(static_cast<const float*>(x), g, b, qq, sc,
                                                    T, K, geo, s);
  auto xb = static_cast<const bf16*>(x);
  if (f32 || (mode == 2 && (Hp <= 0 || Wp <= 0))) return (int)cudaErrorInvalidValue;
  switch (mode) {
    case 0:
      return (int)i8::quant_rows<bf16, false, false>(xb, g, b, qq, sc, T, K, geo, s);
    case 1:
      return (int)i8::quant_rows<bf16, true, false>(xb, g, b, qq, sc, T, K, geo, s);
    case 2:
      return (int)i8::quant_rows<bf16, true, true>(xb, g, b, qq, sc, T, K, geo, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
