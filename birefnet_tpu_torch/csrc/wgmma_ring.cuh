// The persistent, warp-specialized wgmma/TMA GEMM for sm_90a, shared by the
// int8 GEMM (int8_gemm.cu: K1-int8) and the bf16 GEMM (bf16_gemm.cu: K1 and
// K2); the f32 GEMM (f32_gemm.cu) runs its own kernel on the ring's
// pieces with the third input kind, Mma<float> (TF32, A from registers).
// Each source instantiates gemm_kernel<In, EPI, Out> for its own input
// type; nothing here is compiled twice for one type. Out is bf16, or f32
// for the int8 GEMM's store and residual epilogues (K1-int8 on f32
// activations). K3's cluster kernel
// (fused_mlp_i8.cu) takes the ring's pieces: the mbarrier helpers, TMA
// loads and descriptors, and the GELU. So do the key-tiled attention
// cores (window_core.cuh core_tiled, window_core_f32.cuh core_f32_tiled),
// with the pieces added for them below: wgmma of 64 and 32 columns (bf16
// with A from registers and B MN-major), 4-D tensor maps, and cp.async
// completing on an mbarrier.
//
//   out[M, N] = epilogue(A[M, K] W[N, K]^T), A and W row-major (K-major),
//   int8 with an exact s32 sum dequantized as acc * (sa[m] * sw[n]) + b[n],
//   or bf16 with an f32 sum, acc + b[n].
//
// - Tiles of 128 x 128 outputs, k steps of 128 bytes (128 int8 or 64 bf16
//   values: one row of the 128-byte swizzle). One block per SM walks the
//   tiles in order with a stride of the grid.
// - Warpgroup 0 is the producer: one thread issues TMA loads of the A tile
//   [128, 128 B] and the W tile [128, 128 B] of each k step into a ring of
//   6 stages in dynamic shared memory (192 KB), with the 128-byte swizzle
//   the wgmma descriptors read. Each stage has a full barrier (the TMA's
//   transaction bytes) and an empty barrier (one arrival per consumer
//   warp). TMA zero-fills rows past M and N and columns past K, which add
//   nothing to the sums; stores are masked.
// - Warpgroups 1 and 2 are consumers in ping-pong: each takes every other
//   tile whole, 128 rows as two wgmma.mma_async m64n128 per 32 bytes of k
//   (k32 s8 -> s32, or k16 bf16 -> f32), both operands K-major straight
//   from the ring, 128 accumulators a thread (setmaxnreg moves registers
//   from the producer to them). Their k loops take turns, so one
//   consumer's epilogue runs while the other's wgmma keep the tensor cores
//   busy. The epilogue goes through shared memory and stores 16-byte
//   pieces; a bf16 residual is loaded when the tile starts, during the k
//   loop, an f32 one when its 64 x 32 chunk starts.
// Why ping-pong: with both consumers on one tile (64 rows each) the tensor
// cores idle during every epilogue. In an A/B on the H100 (int8, profiler
// device time, both designs with the staged epilogue) ping-pong was faster
// at most K1-int8 and K3 shapes and in their sums per forward, and slower
// only where a block gets a single tile, as one consumer then works alone.
// Staging the epilogue through shared memory was itself faster, at every
// shape, than storing 4 bytes a thread straight from the accumulators.
// The TMA descriptors are encoded per call on the host
// (cuTensorMapEncodeTiled, reached through the runtime's driver entry
// point, so the library does not link libcuda), passed as
// __grid_constant__ kernel parameters. A barrier phase that does not
// complete within 10 s traps, so a fault fails the launch instead of
// hanging the card.

#pragma once

#include <cuda.h>

#include <type_traits>

#include "common.cuh"

namespace bt {
namespace ring {
namespace {

// A&S 7.1.25 (3-term) erf GELU in f32, as the JAX bf16 and int8 MLP kernels
// compute it (`_erf(fast=True)`), with an exact reciprocal.
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
constexpr int kBK = 128;           // bytes per k step: one swizzle row
constexpr int kThreads = 3 * 128;  // producer warpgroup + two consumers
constexpr int kABytes = kBM * kBK;  // the A tile of a stage; the W tile is as large
constexpr int kStageBytes = 2 * kABytes;
constexpr int kStages = 6;  // a 192 KB ring
// Per consumer warpgroup, the tile's epilogue vectors (sa of its rows, sw
// and bias of its columns) and the staging of one 64 x 32 chunk of
// outputs, in rows of 20 words (16 of bf16 pairs) or, for f32 outputs, 40
// words (32 floats), padded so that the accumulator layout's stores hit
// distinct banks.
constexpr int kEpFloats = kBM + 2 * kBN;
template <typename Out>
constexpr int kStgRow = std::is_same<Out, float>::value ? 40 : 20;
template <typename Out>
constexpr int kStgWords = 64 * kStgRow<Out>;
// The ring (1024-byte aligned for the swizzle), 2 barriers a stage, then
// the two consumers' epilogue vectors and staging: 211,040 bytes for bf16
// outputs, 221,280 for f32, of the 232,448 a block may have.
template <typename Out>
constexpr int kSmem =
    1024 + kStages * kStageBytes + 2 * kStages * 8 + 2 * (kEpFloats + kStgWords<Out>) * 4;
static_assert(kSmem<float> <= 232448, "more shared memory than a block may have");

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

// A [rows, 128-byte] box at (k0 elements, r0) of a 2-D tensor map into
// shared memory, completing on `bar`.
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
// Moving the start by 32 bytes (+2) steps k by one wgmma inside the row.
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
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The 64 accumulators of a thread as asm operands, for the wgmma below.
#define BT_WG_ACC(c)                                                                          \
  "+" c(d[0]), "+" c(d[1]), "+" c(d[2]), "+" c(d[3]), "+" c(d[4]), "+" c(d[5]), "+" c(d[6]),   \
      "+" c(d[7]), "+" c(d[8]), "+" c(d[9]), "+" c(d[10]), "+" c(d[11]), "+" c(d[12]),         \
      "+" c(d[13]), "+" c(d[14]), "+" c(d[15]), "+" c(d[16]), "+" c(d[17]), "+" c(d[18]),      \
      "+" c(d[19]), "+" c(d[20]), "+" c(d[21]), "+" c(d[22]), "+" c(d[23]), "+" c(d[24]),      \
      "+" c(d[25]), "+" c(d[26]), "+" c(d[27]), "+" c(d[28]), "+" c(d[29]), "+" c(d[30]),      \
      "+" c(d[31]), "+" c(d[32]), "+" c(d[33]), "+" c(d[34]), "+" c(d[35]), "+" c(d[36]),      \
      "+" c(d[37]), "+" c(d[38]), "+" c(d[39]), "+" c(d[40]), "+" c(d[41]), "+" c(d[42]),      \
      "+" c(d[43]), "+" c(d[44]), "+" c(d[45]), "+" c(d[46]), "+" c(d[47]), "+" c(d[48]),      \
      "+" c(d[49]), "+" c(d[50]), "+" c(d[51]), "+" c(d[52]), "+" c(d[53]), "+" c(d[54]),      \
      "+" c(d[55]), "+" c(d[56]), "+" c(d[57]), "+" c(d[58]), "+" c(d[59]), "+" c(d[60]),      \
      "+" c(d[61]), "+" c(d[62]), "+" c(d[63])
#define BT_WG_REGS                                                                             \
  "{ %0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"                    \
  " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"           \
  " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"           \
  " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// D[64, 128] (+)= A[64, 32 bytes of k] B[128, 32 bytes of k]^T from two
// shared-memory descriptors; acc == 0 overwrites. The input type decides
// the instruction: s8 x s8 -> s32 (k32), or bf16 x bf16 -> f32 (k16, both
// operands K-major: no transpose, unit scales).
template <typename In>
struct Mma;

template <>
struct Mma<int8_t> {
  using Acc = int;
  static constexpr CUtensorMapDataType kMapType = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  __device__ __forceinline__ static void run(int (&d)[64], uint64_t da, uint64_t db, int acc) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " BT_WG_REGS
                 ", %64, %65, p;\n}\n"
                 : BT_WG_ACC("r")
                 : "l"(da), "l"(db), "r"(acc));
  }
};

template <>
struct Mma<bf16> {
  using Acc = float;
  static constexpr CUtensorMapDataType kMapType = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  __device__ __forceinline__ static void run(float (&d)[64], uint64_t da, uint64_t db, int acc) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " BT_WG_REGS
                 ", %64, %65, p, 1, 1, 0, 0;\n}\n"
                 : BT_WG_ACC("f")
                 : "l"(da), "l"(db), "r"(acc));
  }
};

// The f32 GEMM's input kind (f32_gemm.cu): D[64, 128] (+)= A[64, 8]
// B[128, 8]^T in TF32 with f32 accumulators, B K-major from a descriptor
// and A from registers, the m64nNk8 tf32 A fragment of a warp's 16 rows:
// a[0] row g col t, a[1] row g + 8 col t, a[2] row g col t + 4, a[3] row
// g + 8 col t + 4 (g = lane / 4, t = lane % 4). Its kernel is its own
// (the operands are split into TF32 parts in registers); it shares the
// ring's TMA maps, barriers and descriptors.
template <>
struct Mma<float> {
  using Acc = float;
  static constexpr CUtensorMapDataType kMapType = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  __device__ __forceinline__ static void run(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                             int acc) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " BT_WG_REGS
                 ", {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
                 : BT_WG_ACC("f")
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
  }
};

#undef BT_WG_ACC
#undef BT_WG_REGS

// The key-tiled attention cores' products (window_core.cuh core_tiled,
// window_core_f32.cuh core_f32_tiled), on 32 or 16 accumulators a thread.
#define BT_WG_ACC32(c)                                                                        \
  "+" c(d[0]), "+" c(d[1]), "+" c(d[2]), "+" c(d[3]), "+" c(d[4]), "+" c(d[5]), "+" c(d[6]),   \
      "+" c(d[7]), "+" c(d[8]), "+" c(d[9]), "+" c(d[10]), "+" c(d[11]), "+" c(d[12]),         \
      "+" c(d[13]), "+" c(d[14]), "+" c(d[15]), "+" c(d[16]), "+" c(d[17]), "+" c(d[18]),      \
      "+" c(d[19]), "+" c(d[20]), "+" c(d[21]), "+" c(d[22]), "+" c(d[23]), "+" c(d[24]),      \
      "+" c(d[25]), "+" c(d[26]), "+" c(d[27]), "+" c(d[28]), "+" c(d[29]), "+" c(d[30]),      \
      "+" c(d[31])
#define BT_WG_REGS32                                                                           \
  "{ %0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"                    \
  " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// D[64, 64] (+)= A[64, 16] B[64, 16]^T in bf16 with f32 accumulators, both
// operands K-major from 128-byte-swizzled descriptors (sw128_desc).
__device__ __forceinline__ void wgmma_bf16_n64(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " BT_WG_REGS32
               ", %32, %33, p, 1, 1, 0, 0;\n}\n"
               : BT_WG_ACC32("f")
               : "l"(da), "l"(db), "r"(acc));
}

// D[64, 64] (+)= A[64, 16] B[16, 64] in bf16: A from registers (each warp's
// 16 rows as the mma.m16n8k16 A fragment: a[0] row g cols 2t, 2t + 1, a[1]
// row g + 8, a[2] row g cols 2t + 8, + 9, a[3] row g + 8 cols 2t + 8, + 9),
// B MN-major (its 64 columns contiguous, k rows of 128 bytes) from an
// sw128_mn_desc descriptor, read transposed.
__device__ __forceinline__ void wgmma_bf16_n64_rs_mn(float (&d)[32], const uint32_t (&a)[4],
                                                     uint64_t db, int acc) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " BT_WG_REGS32
               ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
               : BT_WG_ACC32("f")
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

#undef BT_WG_ACC32
#undef BT_WG_REGS32

// D[64, 32] (+)= A[64, 8] B[32, 8]^T in TF32 with f32 accumulators, both
// operands K-major from 128-byte-swizzled descriptors (rows of 32 floats).
__device__ __forceinline__ void wgmma_tf32_n32(float (&d)[16], uint64_t da, uint64_t db, int acc) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
               "{ %0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
               ", %16, %17, p, 1, 1;\n}\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
                 "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
                 "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
               : "l"(da), "l"(db), "r"(acc));
}

// wgmma descriptor of an MN-major tile one 128-byte swizzle atom wide (64
// bf16 columns, contiguous) with k rows of 128 bytes: 1024 bytes between
// groups of 8 k rows. Both offset fields hold 1024, so the descriptor does
// not depend on which of them the hardware reads for the k step (the other
// one, the step between atoms along N, is never taken at N = 64). Moving
// the start by 2048 bytes (+128) steps k by 16.
__device__ __forceinline__ uint64_t sw128_mn_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// A box of a 4-D tensor map at coordinates (c0, c1, c2, c3), innermost
// first, into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// 4 bytes from global memory into shared memory (zero-filled where !valid).
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

// 16 bytes from global memory into shared memory (zero-filled where
// !valid), bypassing L1; both addresses 16-byte aligned.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// One arrival on `bar` once this thread's earlier cp.async copies are done;
// the arrival is counted in the barrier's initial count (.noinc).
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// This thread's shared-memory writes made visible to the async proxy
// (wgmma operands, and TMA writes that follow into the same bytes).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// EPI is an Epilogue (common.cuh). The int8 GEMM's y is the dequant
// acc * (sa * sw) + b; the bf16 GEMM's y is acc + b (sa, sw unused). Out
// bf16: the epilogues as common.cuh states them. Out float (kStore and
// kResidual only): out = y, or out = y + res with res f32, nothing rounded
// to bf16.
template <typename In, int EPI, typename Out>
__global__ void __launch_bounds__(kThreads, 1)
gemm_kernel(const __grid_constant__ CUtensorMap tmA, const __grid_constant__ CUtensorMap tmW,
            const float* __restrict__ sa, const float* __restrict__ sw,
            const float* __restrict__ bias, const Out* __restrict__ res,
            void* __restrict__ out, int M, int N, int K) {
  using Acc = typename Mma<In>::Acc;
  constexpr bool kI8 = std::is_same<In, int8_t>::value;
  constexpr bool kF32 = std::is_same<Out, float>::value;
  static_assert(!kF32 || EPI != kGelu, "the f32 outputs take no GELU");
  constexpr int kElems = kBK / (int)sizeof(In);  // k values per step
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t full0 = ring + kStages * kStageBytes;
  const uint32_t empty0 = full0 + kStages * 8;
  const int tiles_n = (N + kBN - 1) / kBN;
  const int tiles = (M + kBM - 1) / kBM * tiles_n;
  const int ksteps = (K + kElems - 1) / kElems;
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
        tma_load(a, &tmA, full, k * kElems, m0);
        tma_load(a + kABytes, &tmW, full, k * kElems, n0);
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
  // each thread writes its values into a shared-memory staging chunk, then
  // the warpgroup writes the chunk out in 16-byte pieces, a row's 64 or 128
  // bytes contiguous (the accumulator layout alone would store 4 bytes a
  // thread, 16 bytes a row). An f32 residual (twice the bytes of a bf16
  // one) is loaded when its chunk starts instead: prefetched for the whole
  // tile it would take 128 registers a thread beside the 128 accumulators.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int c = wg - 1, tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  float* ep = reinterpret_cast<float*>(smem_raw + (ring - smem_u32(smem_raw)) +
                                       kStages * kStageBytes + 2 * kStages * 8) +
              c * kEpFloats;
  uint32_t* stg = reinterpret_cast<uint32_t*>(ep + (2 - c) * kEpFloats) + c * kStgWords<Out>;
  constexpr bool kRes = EPI == kResidual;
  constexpr bool kResPre = kRes && !kF32;      // the residual prefetched per tile
  constexpr int kRowWords = kStgRow<Out>;  // staging row stride
  constexpr int kSegsRow = kF32 ? 8 : 4;      // 16-byte pieces of a chunk row
  constexpr int kSegs = 64 * kSegsRow / 128;  // pieces per thread per chunk
  if (c == 1 && n_local > 0) bar_arrive(3, 256);  // consumer 0 goes first
  for (int i = c; i < n_local; i += 2) {
    const int tile = blockIdx.x + i * gridDim.x;
    const int m0 = tile / tiles_n * kBM, n0 = tile % tiles_n * kBN;
    const float r_sa = kI8 && m0 + tid < M ? sa[m0 + tid] : 0.f;
    const float r_sw = kI8 && n0 + tid < N ? sw[n0 + tid] : 0.f;
    const float r_b = n0 + tid < N ? bias[n0 + tid] : 0.f;
    // The residual at this thread's 16-byte pieces of every chunk
    // (row half h, 32 columns ch).
    uint4 rv[kResPre ? 2 : 1][kResPre ? 4 : 1][kResPre ? kSegs : 1];
    if (kResPre) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int ch = 0; ch < 4; ++ch)
#pragma unroll
          for (int u = 0; u < kSegs; ++u) {
            const int sgm = tid + 128 * u, row = m0 + 64 * h + sgm / kSegsRow;
            const int col = n0 + 32 * ch + 8 * (sgm % kSegsRow);
            rv[kResPre ? h : 0][kResPre ? ch : 0][kResPre ? u : 0] =
                row < M && col < N
                    ? *reinterpret_cast<const uint4*>(res + (size_t)row * N + col)
                    : make_uint4(0, 0, 0, 0);
          }
    }

    Acc acc[2][64];  // rows 0-63 and 64-127 of the tile
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
        Mma<In>::run(acc[0], da + 2 * kk, db + 2 * kk, (k | kk) != 0);
        Mma<In>::run(acc[1], da + (64 * kBK >> 4) + 2 * kk, db + 2 * kk, (k | kk) != 0);
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
        // The f32 residual of this chunk's pieces, loaded under the staging.
        float4 rf[kF32 && kRes ? kSegs : 1];
        if constexpr (kF32 && kRes) {
#pragma unroll
          for (int u = 0; u < kSegs; ++u) {
            const int sgm = tid + 128 * u, row = m0 + 64 * h + sgm / kSegsRow;
            const int col = n0 + 32 * ch + 4 * (sgm % kSegsRow);
            rf[u] = row < M && col < N
                        ? *reinterpret_cast<const float4*>(res + (size_t)row * N + col)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
          }
        }
        bar_sync(1 + c, 128);  // ep written; the last chunk's pieces read
#pragma unroll
        for (int i2 = 0; i2 < 2; ++i2) {
          const int r = warp * 16 + (lane >> 2) + 8 * i2;
          const float sx = ep[64 * h + r];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int j = 4 * ch + jj, col = 8 * j + 2 * (lane & 3);
            const float2 bv = *reinterpret_cast<const float2*>(ep + kBM + kBN + col);
            float y0, y1;
            if constexpr (kI8) {
              const float2 swv = *reinterpret_cast<const float2*>(ep + kBM + col);
              y0 = __fadd_rn(__fmul_rn((float)acc[h][4 * j + 2 * i2], __fmul_rn(sx, swv.x)), bv.x);
              y1 = __fadd_rn(__fmul_rn((float)acc[h][4 * j + 2 * i2 + 1], __fmul_rn(sx, swv.y)),
                             bv.y);
            } else {
              y0 = __fadd_rn(acc[h][4 * j + 2 * i2], bv.x);
              y1 = __fadd_rn(acc[h][4 * j + 2 * i2 + 1], bv.y);
            }
            if constexpr (EPI == kGelu) {
              y0 = gelu_erf3(y0);
              y1 = gelu_erf3(y1);
            }
            if constexpr (kF32)
              *reinterpret_cast<float2*>(stg + r * kRowWords + 8 * jj + 2 * (lane & 3)) =
                  make_float2(y0, y1);
            else
              *reinterpret_cast<__nv_bfloat162*>(stg + r * kRowWords + 4 * jj + (lane & 3)) =
                  __floats2bfloat162_rn(y0, y1);
          }
        }
        bar_sync(1 + c, 128);
#pragma unroll
        for (int u = 0; u < kSegs; ++u) {
          const int sgm = tid + 128 * u, r = sgm / kSegsRow, q = sgm % kSegsRow;
          const int row = m0 + 64 * h + r, col = n0 + 32 * ch + q * (kF32 ? 4 : 8);
          if (row >= M || col >= N) continue;
          uint4 v = *reinterpret_cast<const uint4*>(stg + r * kRowWords + 4 * q);
          if constexpr (kF32) {
            float4 y = *reinterpret_cast<const float4*>(&v);
            if constexpr (kRes) {
              // y was staged unrounded; out = y + res in f32.
              y = make_float4(__fadd_rn(y.x, rf[u].x), __fadd_rn(y.y, rf[u].y),
                              __fadd_rn(y.z, rf[u].z), __fadd_rn(y.w, rf[u].w));
            }
            *reinterpret_cast<float4*>(static_cast<float*>(out) + (size_t)row * N + col) = y;
          } else {
            if (kRes) {
              // round(y) was staged; out = round(round(y) + res).
              const uint4 rr = rv[kResPre ? h : 0][kResPre ? ch : 0][kResPre ? u : 0];
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
            *reinterpret_cast<uint4*>(static_cast<bf16*>(out) + (size_t)row * N + col) = v;
          }
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

// A row-major [rows, K] matrix of In as TMA boxes of [box_rows, 128 bytes]
// with the 128-byte swizzle; out-of-range rows and columns read as 0.
template <typename In>
bool encode(CUtensorMap* map, const In* base, int rows, int K, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K * sizeof(In)};
  const cuuint32_t box[2] = {(cuuint32_t)(kBK / sizeof(In)), (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, Mma<In>::kMapType, 2, const_cast<In*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A 4-D tensor map of `type` over dims[0..3] (dims[0] contiguous, the
// others at byte strides[0..2]) read in boxes of box[0..3] elements with
// the given swizzle; out-of-range elements read as 0.
bool encode_4d(CUtensorMap* map, CUtensorMapDataType type, const void* base,
               const cuuint64_t (&dims)[4], const cuuint64_t (&strides)[3],
               const cuuint32_t (&box)[4], CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, type, 4, const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// One launch of gemm_kernel<In, EPI, Out> on a grid of min(tiles, SMs)
// blocks. M, N, K > 0 with N % 8 == 0 and K * sizeof(In) % 16 == 0; A, W,
// res and out 16-byte aligned.
template <typename In, int EPI, typename Out = bf16>
cudaError_t launch(const In* A, const In* W, const float* sa, const float* sw,
                   const float* bias, const Out* res, void* out, int M, int N, int K,
                   cudaStream_t s) {
  if (M <= 0 || N <= 0 || K <= 0 || N % 8 != 0 || K * (int)sizeof(In) % 16 != 0)
    return cudaErrorInvalidValue;
  static bool attr[kMaxDevices];
  const cudaError_t err = once_per_device(attr, [] {
    return cudaFuncSetAttribute(gemm_kernel<In, EPI, Out>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem<Out>);
  });
  if (err != cudaSuccess) return err;
  CUtensorMap tmA, tmW;
  if (!encode(&tmA, A, M, K, kBM) || !encode(&tmW, W, N, K, kBN)) return cudaErrorInvalidValue;
  const int tiles = (M + kBM - 1) / kBM * ((N + kBN - 1) / kBN);
  const int grid = tiles < sm_count() ? tiles : sm_count();
  gemm_kernel<In, EPI, Out>
      <<<grid, kThreads, kSmem<Out>, s>>>(tmA, tmW, sa, sw, bias, res, out, M, N, K);
  return cudaGetLastError();
}

}  // namespace
}  // namespace ring
}  // namespace bt
