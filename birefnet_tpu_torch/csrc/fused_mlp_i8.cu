// W8A8 Swin MLP half-block:
//   out = x + dq(q(GELU3(dq(q(LN2(x)) W1q^T) + b1)) W2q^T) + b2
// with q() per-token int8, dq() the dequant acc * (s_token * s_channel)
// and GELU3 the 3-term erf GELU in f32.
//
// Replaces birefnet_tpu/ops/pallas/fused_mlp.py::_fused_i8 (body
// `_kernel_i8`, quantization `_quantize_rows`; ComputeConfig.int8_mlp).
//
// What bounds it on the card: the two int8 products, 16 C^2 operations per
// token against the 1,979 TOP/s dense int8 peak (1.93 TOP, 0.98 ms per
// Swin-L forward); its inputs and output are 4 C bytes a token (8 C with
// f32 activations). The TPU kernel kept the [tt, 4C] hidden of a token
// tile in VMEM. The fc2 input is quantized per token over all 4C hidden
// units, so a row's scale exists
// only once its whole f32 hidden row does: at C = 768 that is 786 KB for
// the 64 rows of one wgmma, and one SM holds 227 KB. Written to device
// memory, the hidden costs 40 C bytes a token (the f32 row out and back,
// the codes out and back), 1.8 times the bound's time.
//
// Design: one thread-block cluster of S = ceil(C / 96) CTAs (up to 16, the
// non-portable size) per block of 64 token rows; clusters are persistent
// and walk the row blocks with a stride of their count. Two launches per
// call: the int8 row pass of int8_gemm.cu (LN2 with f32 statistics, not
// rounded, -> codes [T, C] and scales [T]), then this kernel, in which the
// hidden never leaves the chip. CTA r of a cluster owns hidden units
// [384 r, 384 r + 384) and output columns [96 r, 96 r + 96). Its two
// warpgroups split the work and feed a 3-stage TMA ring themselves: the
// last warp to release a stage issues the stage that takes its slot. (A
// producer warpgroup, or even a producer warp, leaves 168 registers a
// thread, and the GELU and fc2 need more.) Per row block:
// 1. fc1: each warpgroup runs wgmma m64n192k32 (s8 -> s32) over K = C,
//    both operands from the ring (the LN2 codes box and two 192-row W1
//    boxes a stage, 128-byte swizzle);
// 2. in registers: acc * (sx * s1) + b1, then the 3-term erf GELU, 96 f32
//    values a thread, and each row's max |h| over the slice;
// 3. the row maxima go to every CTA of the cluster through distributed
//    shared memory (DSMEM), one remote mbarrier arrival per CTA; each CTA
//    then takes the row amax as the max of the S slice maxima (exact, so
//    every CTA gets the same scale) and quantizes its slice as the row
//    pass does, scale = max(amax, 1e-30) * (1/127), q = clip(rint(h *
//    (1/scale))), into its own shared memory, laid out as wgmma's register
//    fragments of A (one 16-byte piece per thread per 32 k values);
// 4. fc2: once every CTA's slice is written (a second arrival per CTA),
//    each warpgroup runs wgmma m64n96k32 over half of K = 4C (pairs of
//    128-byte k steps in turn), A from registers loaded from the owner
//    CTAs' slices through DSMEM (wgmma reads shared memory only from its
//    own CTA), B from W2 boxes in the ring; CTA r starts at its own slice
//    (the k order rotated by r), so the CTAs read different owners at a
//    time; the two s32 partial sums meet in shared memory (exact in any
//    split and order);
// 5. acc * (sx2 * s2) + b2 rounded to bf16, plus x in bf16 (kResidual's
//    order, common.cuh); on f32 activations (the TPU kernel's f32 branch,
//    whose .astype(x.dtype) is then a no-op) y + x in f32, unrounded.
// Padding: when S * 384 > 4C or S * 96 > C, TMA reads zeros past the
// weights' rows and columns and the epilogues zero or mask those columns.
// The slice and the row maxima are rewritten only after every CTA has
// reported the next row block's maxima, which each does only after its
// fc2 of the previous one: one buffer of each suffices. Every wait that
// does not complete within 10 s traps (wgmma_ring.cuh), so a lost arrival
// fails the launch instead of hanging the card.
// What the H100 showed (PERF.md §6; tools/k3_phases.py): per row block
// the GELU and the exchange and quantization between the MMA phases take
// over half the cycles, at 8 warps an SM; DSMEM reads cost a quarter of
// fc2; overlapping the GELU with the previous row block's fc2 spilled
// registers and ran slower.
//
// Activations: the kernel and its entries are templates on the type of x
// and out, bf16 (bt_fused_mlp_i8, bt_fused_mlp_i8_codes) or f32
// (bt_fused_mlp_i8_f32, bt_fused_mlp_i8_codes_f32, after the f32 LN2 row
// pass quant_rows<float, true, false>). Only step 5 differs: the residual
// is 24 floats a thread where bf16's is 12 words of pairs, loaded after
// the half sums' barrier, not before it as bf16's are, so that they are
// not live across the barrier beside acc2 in a kernel at its register
// ceiling (ptxas: 239 registers, no spills; bf16 247).
//
// Numerics: the arithmetic of the four-launch chain it replaces, step for
// step (the dequant products and sums rounded without contraction, the
// 3-term erf GELU of wgmma_ring.cuh with a call-free reciprocal that is
// bitwise the f32 division, the row pass's scale formula); given the same
// LN2 codes the output is bitwise the plain chain
// int8_linear -> gelu_erf3 -> quantize_rows -> int8_linear -> + x.

#include <type_traits>

#include "int8.cuh"
#include "wgmma_ring.cuh"

namespace bt {
namespace mlp8 {
namespace {

using namespace ring;

constexpr int kRows = 64;          // token rows per row block: one wgmma M
constexpr int kSlice = 384;        // hidden units per CTA: fc1's N, fc2's K slice
constexpr int kHalf = kSlice / 2;  // fc1 columns per warpgroup
constexpr int kOut = 96;           // fc2 output columns per CTA
constexpr int kMaxCluster = 16;
constexpr int kStep = 128;                 // bytes of k per box row
constexpr int kFrags = kSlice / 32;        // 32-k fragments of a slice
constexpr int kStages = 3;
constexpr int kThreads = 2 * 128;          // two warpgroups
constexpr int kABytes = kRows * kStep;     // the LN2 codes box
constexpr int kW1Bytes = kHalf * kStep;    // one warpgroup's W1 box
constexpr int kW2Bytes = kOut * kStep;     // one W2 box; an fc2 stage holds four
constexpr int kStageBytes = kABytes + 2 * kW1Bytes;
// Shared memory after the 1024-byte aligned ring: the codes slice, the
// row maxima of every CTA [16][64], the two warpgroups' maxima [2][64],
// the fc2 half sums [2][64][48], the epilogue vectors (s1, b1 of the
// slice, s2, b2 of the output columns), the barriers and the ring's
// release counters.
constexpr int kOffSlice = kStages * kStageBytes;
constexpr int kOffAmax = kOffSlice + kRows * kSlice;
constexpr int kOffComb = kOffAmax + kMaxCluster * kRows * 4;
constexpr int kOffRed = kOffComb + 2 * kRows * 4;
constexpr int kOffVec = kOffRed + 2 * kRows * (kOut / 2) * 4;
constexpr int kOffBar = kOffVec + (2 * kSlice + 2 * kOut) * 4;
constexpr int kSmem = 1024 + kOffBar + (kStages + 2) * 8 + kStages * 4;
static_assert(4 * kW2Bytes <= kStageBytes, "an fc2 stage holds four W2 boxes");
static_assert(kSmem <= 232448, "more shared memory than a block may have");

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_index() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%clusterid.x;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_count() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%nclusterid.x;\n" : "=r"(r));
  return r;
}

// The shared::cluster address of `addr` (this CTA's) in CTA `rank`.
__device__ __forceinline__ uint32_t peer(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

// Every thread of the cluster arrives and waits (release / acquire).
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive;\nbarrier.cluster.wait;\n" ::: "memory");
}

__device__ __forceinline__ void st_peer(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(addr), "f"(v) : "memory");
}

__device__ __forceinline__ uint4 ld_peer(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared::cluster.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// One arrival on the mbarrier at shared::cluster address `bar`, releasing
// this thread's writes at cluster scope.
__device__ __forceinline__ void arrive_peer(uint32_t bar) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// mbar_wait of wgmma_ring.cuh, acquiring at cluster scope what the
// arrivals of other CTAs released.
__device__ __forceinline__ bool mbar_try_cluster(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar, uint32_t parity) {
  if (mbar_try_cluster(bar, parity)) return;
  const uint64_t t0 = global_ns();
  for (uint32_t n = 1;; ++n) {
    if (mbar_try_cluster(bar, parity)) return;
    if ((n & 1023) == 0 && global_ns() - t0 > 10000000000ull) __trap();
  }
}

// 1 / d rounded to f32, bitwise 1.0f / d (IEEE round to nearest) for
// finite d >= 1, without the slow-path call that the f32 division carries
// at each of its 96 sites here (the calls keep the compiler from
// interleaving the GELUs). The f64 estimate refined by two Newton steps is
// within 2^-51 (relative) of 1/d, and 1/d is at least 2^-49 from every
// f32 rounding boundary: a midpoint m has 25 significant bits with the
// last one set, so d m = D M 2^k with D < 2^24, odd M < 2^25, and 1 - d m
// is a nonzero multiple of 2^k >= 2^-49. So rounding the estimate to f32
// rounds 1/d.
__device__ __forceinline__ float rcp_rn(float d) {
  const double x = (double)d;
  double y;
  asm("rcp.approx.ftz.f64 %0, %1;\n" : "=d"(y) : "d"(x));
  y = fma(y, fma(-x, y, 1.0), y);
  y = fma(y, fma(-x, y, 1.0), y);
  return __double2float_rn(y);
}

// gelu_erf3 of wgmma_ring.cuh with the reciprocal above: the same f32
// value for every finite h.
__device__ __forceinline__ float gelu_erf3_rcp(float h) {
  const float z = __fmul_rn(h, 0.70710678118654752f);
  const float a = fabsf(z);
  const float t = rcp_rn(__fadd_rn(1.0f, __fmul_rn(0.47047f, a)));
  const float poly = __fmul_rn(
      t, __fadd_rn(0.3480242f, __fmul_rn(t, __fadd_rn(-0.0958798f, __fmul_rn(t, 0.7478556f)))));
  const float e = __fsub_rn(1.0f, __fmul_rn(poly, expf(__fmul_rn(-a, a))));
  return __fmul_rn(__fmul_rn(h, 0.5f), __fadd_rn(1.0f, z < 0.f ? -e : e));
}

template <int N>
__device__ __forceinline__ void fence_frag(uint4 (&f)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
    asm volatile("" : "+r"(f[i].x), "+r"(f[i].y), "+r"(f[i].z), "+r"(f[i].w)::"memory");
}

#define BT_R4(a) "+r"(d[a]), "+r"(d[a + 1]), "+r"(d[a + 2]), "+r"(d[a + 3])
#define BT_R16(a) BT_R4(a), BT_R4(a + 4), BT_R4(a + 8), BT_R4(a + 12)
#define BT_R48 BT_R16(0), BT_R16(16), BT_R16(32)
#define BT_L48                                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "  \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "    \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}"
#define BT_L96                                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "  \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "    \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "    \
  "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "    \
  "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, "    \
  "%87, %88, %89, %90, %91, %92, %93, %94, %95}"

// D[64, 192] (+)= A[64, 32 k] B[192, 32 k]^T, s8 -> s32, both operands from
// shared-memory descriptors; acc == 0 overwrites.
__device__ __forceinline__ void mma_n192(int (&d)[96], uint64_t da, uint64_t db, int acc) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 " BT_L96
               ", %96, %97, p;\n}\n"
               : BT_R48, BT_R16(48), BT_R16(64), BT_R16(80)
               : "l"(da), "l"(db), "r"(acc));
}

// D[64, 96] += A[64, 32 k] B[96, 32 k]^T, s8 -> s32, A from registers (the
// 8-bit m64nNk32 fragment: register i of thread `lane` of warp w holds row
// 16 w + lane / 4 + 8 (i % 2), k 16 (i / 2) + 4 (lane % 4) + [0, 4)), B from
// a shared-memory descriptor.
__device__ __forceinline__ void mma_n96(int (&d)[48], const uint4& a, uint64_t db) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n96k32.s32.s8.s8 " BT_L48
               ", {%48, %49, %50, %51}, %52, p;\n}\n"
               : BT_R48
               : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "l"(db), "r"(1));
}

#undef BT_R4
#undef BT_R16
#undef BT_R48
#undef BT_L48
#undef BT_L96

// tmA: the LN2 codes [T, C]; tmW1: w1q [4C, C]; tmW2: w2q [C, 4C]; sx [T]
// the LN2 row scales; s1, b1 [4C], s2, b2 [C]; x, out [T, C] of Tx (bf16
// or float). Cluster of S CTAs along x; two warpgroups (256 threads).
template <typename Tx>
__global__ void __launch_bounds__(kThreads, 1)
fused_mlp_i8_kernel(const __grid_constant__ CUtensorMap tmA,
                    const __grid_constant__ CUtensorMap tmW1,
                    const __grid_constant__ CUtensorMap tmW2, const float* __restrict__ sx,
                    const float* __restrict__ s1, const float* __restrict__ b1,
                    const float* __restrict__ s2, const float* __restrict__ b2,
                    const Tx* __restrict__ x, Tx* __restrict__ out, int T, int C, int S) {
  constexpr bool kF32 = std::is_same<Tx, float>::value;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;
  uint8_t* base = smem_raw + (ring - raw);
  const uint32_t slice = ring + kOffSlice, amax_u = ring + kOffAmax;
  const uint32_t full0 = ring + kOffBar;
  const uint32_t amax_bar = full0 + 8 * kStages, ready_bar = amax_bar + 8;
  int* released = reinterpret_cast<int*>(base + kOffBar + 8 * kStages + 16);
  const float* amax = reinterpret_cast<const float*>(base + kOffAmax);
  float* comb = reinterpret_cast<float*>(base + kOffComb);
  int* red = reinterpret_cast<int*>(base + kOffRed);
  float* vec = reinterpret_cast<float*>(base + kOffVec);
  const int rank = (int)cluster_rank();
  const int hidden = 4 * C, hc0 = rank * kSlice, oc0 = rank * kOut;
  const int ks1 = (C + kStep - 1) / kStep;  // fc1 k steps (TMA zero-fills past C)
  const int ks2 = hidden / kStep;           // fc2 k steps: C % 64 == 0
  // fc2 stages of four W2 boxes, an even count (the warpgroups take them in
  // pairs); the boxes past K = 4C are zeros.
  const int groups2 = (ks2 + 7) / 8 * 2;
  const int row_blocks = (T + kRows - 1) / kRows;
  // fc2's k steps run from the CTA's own slice on (logical step s is k
  // step (s + 3 rank) mod 4 groups2), so at any time the CTAs read
  // different owners' slices.
  auto kstep2 = [&](int s) { return (s + 3 * rank) % (4 * groups2); };

  for (int i = threadIdx.x; i < 2 * kSlice + 2 * kOut; i += kThreads) {
    float v = 0.f;
    if (i < 2 * kSlice) {
      const int j = hc0 + i % kSlice;
      if (j < hidden) v = i < kSlice ? s1[j] : b1[j];
    } else {
      const int j = oc0 + (i - 2 * kSlice) % kOut;
      if (j < C) v = i < 2 * kSlice + kOut ? s2[j] : b2[j];
    }
    vec[i] = v;
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      released[s] = 0;
    }
    mbar_init(amax_bar, S);   // one arrival per CTA of the cluster
    mbar_init(ready_bar, S);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // Every CTA's barriers and vectors exist before any peer signals.
  cluster_sync();

  {
    const int c = threadIdx.x >> 7, tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
    const int q = lane & 3;
    const int r0 = 16 * warp + (lane >> 2);  // this thread's rows r0 and r0 + 8
    const float* vs1 = vec + c * kHalf;
    const float* vb1 = vec + kSlice + c * kHalf;
    const float* vs2 = vec + 2 * kSlice;
    const float* vb2 = vs2 + kOut;
    int* mine = red + c * kRows * (kOut / 2);         // the partner's half sums for me
    int* theirs = red + (1 - c) * kRows * (kOut / 2);  // mine for the partner
    uint32_t it = 0, phase = 0;  // stages consumed; row blocks' parity
    // The warps feed the ring themselves: stage L of the sequence (per row
    // block ks1 fc1 stages, then groups2 fc2 stages) goes to slot L %
    // kStages. Thread 0 issues the first kStages; after that, the last of
    // the 8 warps to release stage L (its wgmma groups complete) issues
    // stage L + kStages into the slot at once, counted in shared memory.
    const uint32_t per_rb = ks1 + groups2;
    auto issue = [&](uint32_t L) {
      const int rb = (int)cluster_index() + (int)(L / per_rb) * (int)cluster_count();
      if (rb >= row_blocks) return;
      const int j = (int)(L % per_rb), st = (int)(L % kStages);
      const uint32_t full = full0 + 8 * st, a = ring + st * kStageBytes;
      if (j < ks1) {
        mbar_expect_tx(full, kStageBytes);
        tma_load(a, &tmA, full, j * kStep, rb * kRows);
        tma_load(a + kABytes, &tmW1, full, j * kStep, hc0);
        tma_load(a + kABytes + kW1Bytes, &tmW1, full, j * kStep, hc0 + kHalf);
      } else {
        // Four boxes even past K = 4C, which TMA fills with zeros.
        mbar_expect_tx(full, 4 * kW2Bytes);
        for (int u = 0; u < 4; ++u)
          tma_load(a + u * kW2Bytes, &tmW2, full, kstep2(4 * (j - ks1) + u) * kStep, oc0);
      }
    };
    auto release = [&](uint32_t L) {  // lane 0 of each warp, once per stage
      if (atomicAdd(&released[L % kStages], 1) == 7) {
        atomicExch(&released[L % kStages], 0);
        issue(L + kStages);
      }
    };
    if (threadIdx.x == 0)
      for (uint32_t L = 0; L < kStages; ++L) issue(L);
    for (int rb = (int)cluster_index(); rb < row_blocks;
         rb += (int)cluster_count(), phase ^= 1) {
      const int m0 = rb * kRows;
      float sxr[2];
#pragma unroll
      for (int i2 = 0; i2 < 2; ++i2) sxr[i2] = m0 + r0 + 8 * i2 < T ? sx[m0 + r0 + 8 * i2] : 0.f;

      // ---- fc1: this warpgroup's 192 hidden units of the slice.
      int acc[96];
#pragma unroll
      for (int e = 0; e < 96; ++e) acc[e] = 0;
      for (int k = 0; k < ks1; ++k, ++it) {
        const int st = (int)(it % kStages);
        mbar_wait(full0 + 8 * st, (it / kStages) & 1);
        const uint32_t a = ring + st * kStageBytes;
        const uint64_t da = sw128_desc(a), db = sw128_desc(a + kABytes + c * kW1Bytes);
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kStep / 32; ++kk)
          mma_n192(acc, da + 2 * kk, db + 2 * kk, (k | kk) != 0);
        wgmma_commit();
        fence_acc(acc);
        wgmma_wait<1>();
        if (k > 0 && lane == 0) release(it - 1);
      }
      wgmma_wait<0>();
      fence_acc(acc);
      if (lane == 0) release(it - 1);

      // ---- dequant + b1 + GELU in registers; the rows' max |h| here.
      // Accumulator 4 j + 2 i2 + e: row r0 + 8 i2, column 8 j + 2 q + e.
      float h[96];
      float am[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < kHalf / 8; ++j) {
        const int col = 8 * j + 2 * q;
        const float2 sv = *reinterpret_cast<const float2*>(vs1 + col);
        const float2 bv = *reinterpret_cast<const float2*>(vb1 + col);
        const bool live = hc0 + c * kHalf + col < hidden;
#pragma unroll
        for (int i2 = 0; i2 < 2; ++i2) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int idx = 4 * j + 2 * i2 + e;
            float y = __fadd_rn(__fmul_rn((float)acc[idx], __fmul_rn(sxr[i2], e ? sv.y : sv.x)),
                                e ? bv.y : bv.x);
            y = live ? gelu_erf3_rcp(y) : 0.f;
            h[idx] = y;
            am[i2] = fmaxf(am[i2], fabsf(y));
          }
        }
      }
#pragma unroll
      for (int i2 = 0; i2 < 2; ++i2) {
        am[i2] = fmaxf(am[i2], __shfl_xor_sync(0xffffffffu, am[i2], 1));
        am[i2] = fmaxf(am[i2], __shfl_xor_sync(0xffffffffu, am[i2], 2));
      }
      if (q == 0) {
        comb[c * kRows + r0] = am[0];
        comb[c * kRows + r0 + 8] = am[1];
      }
      bar_sync(1, 256);
      // ---- this CTA's row maxima to every CTA of the cluster (slot `rank`).
      if (c == 0 && tid < kRows) {
        const float v = fmaxf(comb[tid], comb[kRows + tid]);
        const uint32_t off = amax_u + (uint32_t)(rank * kRows + tid) * 4;
        for (int p = 0; p < S; ++p) st_peer(peer(off, p), v);
        // The barrier orders the 64 stores before thread 0's arrivals,
        // which release them at cluster scope.
        bar_sync(2, kRows);
        if (tid == 0)
          for (int p = 0; p < S; ++p) arrive_peer(peer(amax_bar, p));
      }
      mbar_wait_cluster(amax_bar, phase);

      // ---- per-token int8 of the whole 4C row, into this CTA's slice.
      float rs[2], inv[2];
#pragma unroll
      for (int i2 = 0; i2 < 2; ++i2) {
        float a = 0.f;
        for (int p = 0; p < S; ++p) a = fmaxf(a, amax[p * kRows + r0 + 8 * i2]);
        rs[i2] = fmaxf(a, 1e-30f) * (1.0f / 127.0f);
        inv[i2] = 1.0f / rs[i2];
      }
      uint8_t* sl = base + kOffSlice;
#pragma unroll
      for (int j = 0; j < kHalf / 8; ++j) {
        const int col = c * kHalf + 8 * j + 2 * q, kb = col >> 5, k32 = col & 31;
        const int frag_lane = (lane & ~3) | ((k32 & 15) >> 2);
#pragma unroll
        for (int i2 = 0; i2 < 2; ++i2) {
          uint32_t pair = 0;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            // rint by adding 1.5 * 2^23 (|v| <= 127 here, so the add rounds
            // to an integer, ties to even, as rintf does) and reading the
            // integer from the bits: no conversion instructions.
            const float r = __fadd_rn(__fmul_rn(h[4 * j + 2 * i2 + e], inv[i2]), 12582912.0f);
            const int v = min(max((int)(__float_as_uint(r) - 0x4B400000u), -127), 127);
            pair |= (uint32_t)(v & 0xff) << (8 * e);
          }
          const int reg = i2 + 2 * (k32 >> 4);
          *reinterpret_cast<uint16_t*>(sl + ((kb * 4 + warp) * 32 + frag_lane) * 16 + reg * 4 +
                                       (k32 & 3)) = (uint16_t)pair;
        }
      }
      bar_sync(1, 256);  // the slice is written; every thread is done with amax and comb
      if (c == 0 && tid == 0)
        for (int p = 0; p < S; ++p) arrive_peer(peer(ready_bar, p));

      // ---- fc2 over K = 4C: k steps 4 g + 2 c and 4 g + 2 c + 1 of stage g.
      int acc2[48];
#pragma unroll
      for (int e = 0; e < 48; ++e) acc2[e] = 0;
      // Fragments of stage g (its two 128-k steps of this warpgroup, 8 x 32
      // k): 32-k fragment kb of the hidden row is fragment kb % 12 of CTA
      // kb / 12. Past K = 4C the last fragment is read again: its W2 box
      // there is zeros.
      const int last_frag = hidden / 32 - 1;
      auto load = [&](uint4(&f)[8], int g) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const int kb = min(4 * kstep2(4 * g + 2 * c + u) + kk, last_frag);
            const int owner = kb / kFrags;
            const uint32_t off = (uint32_t)(((kb - owner * kFrags) * 4 + warp) * 32 + lane) * 16;
            f[4 * u + kk] = ld_peer(peer(slice + off, owner));
          }
        }
      };
      uint4 fa0[8], fa1[8];
      mbar_wait_cluster(ready_bar, phase);
      load(fa0, 0);
      // One stage's wgmma group stays in flight; the fragments it reads
      // are reloaded only after it completes.
      auto stage = [&](int g, uint4(&cur)[8], uint4(&nxt)[8]) {
        const int st = (int)(it % kStages);
        mbar_wait(full0 + 8 * st, (it / kStages) & 1);
        const uint32_t a = ring + st * kStageBytes;
        fence_acc(acc2);
        fence_frag(cur);
        wgmma_fence();
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const uint64_t db = sw128_desc(a + (2 * c + u) * kW2Bytes);
#pragma unroll
          for (int kk = 0; kk < kStep / 32; ++kk) mma_n96(acc2, cur[4 * u + kk], db + 2 * kk);
        }
        wgmma_commit();
        fence_acc(acc2);
        wgmma_wait<1>();
        fence_frag(nxt);
        if (g > 0 && lane == 0) release(it - 1);
        ++it;
        load(nxt, g + 1);
      };
      for (int g = 0; g < groups2; g += 2) {
        stage(g, fa0, fa1);
        stage(g + 1, fa1, fa0);
      }
      wgmma_wait<0>();
      fence_acc(acc2);
      fence_frag(fa0);
      fence_frag(fa1);
      if (lane == 0) release(it - 1);

      // ---- the two half sums meet; dequant + b2, bf16, + x (f32: y + x).
      // Warpgroup c finishes n8 blocks [6 c, 6 c + 6) of the 96 columns;
      // the index of acc2 is a constant in each branch (a runtime one would
      // put acc2 in local memory).
      auto finish = [&](auto half) {
        constexpr int kC = decltype(half)::value;
        // The bf16 residual loads go out before the barrier (pairs in one
        // word each), the f32 ones after it.
        uint32_t xres[kF32 ? 1 : 12];
        if constexpr (!kF32) {
#pragma unroll
          for (int jj = 0; jj < 6; ++jj)
#pragma unroll
            for (int i2 = 0; i2 < 2; ++i2) {
              const int row = m0 + r0 + 8 * i2, col = oc0 + 8 * (6 * kC + jj) + 2 * q;
              xres[2 * jj + i2] =
                  row < T && col < C
                      ? *reinterpret_cast<const uint32_t*>(x + (size_t)row * C + col)
                      : 0u;
            }
        } else {
          (void)xres;
        }
#pragma unroll
        for (int jj = 0; jj < 6; ++jj)
#pragma unroll
          for (int i2 = 0; i2 < 2; ++i2)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              theirs[(r0 + 8 * i2) * (kOut / 2) + 8 * jj + 2 * q + e] =
                  acc2[4 * (6 * (1 - kC) + jj) + 2 * i2 + e];
        bar_sync(1, 256);
#pragma unroll
        for (int jj = 0; jj < 6; ++jj) {
          const int j = 6 * kC + jj, col = 8 * j + 2 * q;
          const float2 sv = *reinterpret_cast<const float2*>(vs2 + col);
          const float2 bv = *reinterpret_cast<const float2*>(vb2 + col);
#pragma unroll
          for (int i2 = 0; i2 < 2; ++i2) {
            const int row = m0 + r0 + 8 * i2;
            if (row >= T || oc0 + col >= C) continue;
            const int* other = mine + (r0 + 8 * i2) * (kOut / 2) + 8 * jj + 2 * q;
            const int y0 = acc2[4 * j + 2 * i2] + other[0];
            const int y1 = acc2[4 * j + 2 * i2 + 1] + other[1];
            const float f0 = __fadd_rn(__fmul_rn((float)y0, __fmul_rn(rs[i2], sv.x)), bv.x);
            const float f1 = __fadd_rn(__fmul_rn((float)y1, __fmul_rn(rs[i2], sv.y)), bv.y);
            if constexpr (kF32) {
              const float2 xr = *reinterpret_cast<const float2*>(x + (size_t)row * C + oc0 + col);
              *reinterpret_cast<float2*>(out + (size_t)row * C + oc0 + col) =
                  make_float2(__fadd_rn(f0, xr.x), __fadd_rn(f1, xr.y));
            } else {
              const float2 yr = __bfloat1622float2(__floats2bfloat162_rn(f0, f1));
              const uint32_t xw = xres[2 * jj + i2];
              const float2 xr =
                  __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xw));
              *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * C + oc0 + col) =
                  __floats2bfloat162_rn(yr.x + xr.x, yr.y + xr.y);
            }
          }
        }
      };
      if (c == 0)
        finish(std::integral_constant<int, 0>{});
      else
        finish(std::integral_constant<int, 1>{});
    }
  }
  // No CTA leaves while a peer may still read its slice.
  cluster_sync();
}

// One launch on clusters of S = ceil(C / 96) CTAs, as many as the card
// holds at once (cudaOccupancyMaxActiveClusters) up to one per row block.
template <typename Tx>
cudaError_t launch(const int8_t* codes, const float* sx, const int8_t* w1q, const float* s1,
                   const float* b1, const int8_t* w2q, const float* s2, const float* b2,
                   const Tx* x, Tx* out, int T, int C, cudaStream_t s) {
  if (T <= 0 || C <= 0 || C % 64 != 0 || C > kMaxCluster * kOut) return cudaErrorInvalidValue;
  const int S = (C + kOut - 1) / kOut;
  // Both per device: the attributes and the occupancy read under them.
  static int max_clusters[bt::kMaxDevices][kMaxCluster + 1];
  static bool attr[bt::kMaxDevices];
  cudaError_t set = bt::once_per_device(attr, [] {
    cudaError_t err = cudaFuncSetAttribute(
        fused_mlp_i8_kernel<Tx>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(fused_mlp_i8_kernel<Tx>,
                                 cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    return err;
  });
  if (set != cudaSuccess) return set;
  int* fits = max_clusters[bt::device_index()];
  CUtensorMap tmA, tmW1, tmW2;
  if (!encode(&tmA, codes, T, C, kRows) || !encode(&tmW1, w1q, 4 * C, C, kHalf) ||
      !encode(&tmW2, w2q, C, 4 * C, kOut))
    return cudaErrorInvalidValue;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = S;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = s;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  if (fits[S] == 0) {
    cfg.gridDim = dim3(S);
    int n = 0;
    const cudaError_t err = cudaOccupancyMaxActiveClusters(&n, fused_mlp_i8_kernel<Tx>, &cfg);
    if (err != cudaSuccess) return err;
    if (n <= 0) return cudaErrorLaunchOutOfResources;  // no cluster of S fits
    fits[S] = n;
  }
  const int row_blocks = (T + kRows - 1) / kRows;
  const int clusters = row_blocks < fits[S] ? row_blocks : fits[S];
  cfg.gridDim = dim3(clusters * S);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, fused_mlp_i8_kernel<Tx>, tmA, tmW1, tmW2, sx,
                                             s1, b1, s2, b2, x, out, T, C, S);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The two launches of a call: the LN2 row pass of x into codes and
// scales, then the cluster kernel.
template <typename Tx>
int run(const void* x, const void* ln_g, const void* ln_b, const void* w1q, const void* s1,
        const void* b1, const void* w2q, const void* s2, const void* b2, void* codes,
        void* scales, void* out, int T, int C, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto* xt = static_cast<const Tx*>(x);
  auto* q = static_cast<int8_t*>(codes);
  auto* sc = static_cast<float*>(scales);
  if (C % 64 != 0 || T <= 0) return (int)cudaErrorInvalidValue;
  const cudaError_t err = i8::quant_rows<Tx, true, false>(
      xt, static_cast<const float*>(ln_g), static_cast<const float*>(ln_b), q, sc, T, C,
      Geometry{}, s);
  if (err != cudaSuccess) return (int)err;
  return (int)launch<Tx>(q, sc, static_cast<const int8_t*>(w1q), static_cast<const float*>(s1),
                         static_cast<const float*>(b1), static_cast<const int8_t*>(w2q),
                         static_cast<const float*>(s2), static_cast<const float*>(b2), xt,
                         static_cast<Tx*>(out), T, C, s);
}

// The cluster kernel alone, from given LN2 codes and scales.
template <typename Tx>
int run_codes(const void* codes, const void* scales, const void* x, const void* w1q,
              const void* s1, const void* b1, const void* w2q, const void* s2, const void* b2,
              void* out, int T, int C, void* stream) {
  return (int)launch<Tx>(
      static_cast<const int8_t*>(codes), static_cast<const float*>(scales),
      static_cast<const int8_t*>(w1q), static_cast<const float*>(s1),
      static_cast<const float*>(b1), static_cast<const int8_t*>(w2q),
      static_cast<const float*>(s2), static_cast<const float*>(b2), static_cast<const Tx*>(x),
      static_cast<Tx*>(out), T, C, static_cast<cudaStream_t>(stream));
}

}  // namespace
}  // namespace mlp8
}  // namespace bt

// x, out [T, C] bf16; ln_g, ln_b [C] f32; w1q [4C, C] int8, s1 [4C] f32,
// b1 [4C] f32; w2q [C, 4C] int8, s2 [C] f32, b2 [C] f32; codes [T, C] int8
// and scales [T] f32 scratch for the LN2 rows. C % 64 == 0, C <= 1536.
// Two launches: the LN2 row pass, then the cluster kernel.
extern "C" int bt_fused_mlp_i8(const void* x, const void* ln_g, const void* ln_b,
                               const void* w1q, const void* s1, const void* b1,
                               const void* w2q, const void* s2, const void* b2, void* codes,
                               void* scales, void* out, int T, int C, void* stream) {
  return bt::mlp8::run<bf16>(x, ln_g, ln_b, w1q, s1, b1, w2q, s2, b2, codes, scales, out, T, C,
                             stream);
}

// As bt_fused_mlp_i8 with x, out [T, C] f32.
extern "C" int bt_fused_mlp_i8_f32(const void* x, const void* ln_g, const void* ln_b,
                                   const void* w1q, const void* s1, const void* b1,
                                   const void* w2q, const void* s2, const void* b2, void* codes,
                                   void* scales, void* out, int T, int C, void* stream) {
  return bt::mlp8::run<float>(x, ln_g, ln_b, w1q, s1, b1, w2q, s2, b2, codes, scales, out, T,
                              C, stream);
}

// The cluster kernel alone, from given LN2 codes [T, C] int8 and scales
// [T] f32 (for the tests and chip_smoke.py); x, out bf16 (or f32, the
// _f32 entry).
extern "C" int bt_fused_mlp_i8_codes(const void* codes, const void* scales, const void* x,
                                     const void* w1q, const void* s1, const void* b1,
                                     const void* w2q, const void* s2, const void* b2, void* out,
                                     int T, int C, void* stream) {
  return bt::mlp8::run_codes<bf16>(codes, scales, x, w1q, s1, b1, w2q, s2, b2, out, T, C,
                                   stream);
}

extern "C" int bt_fused_mlp_i8_codes_f32(const void* codes, const void* scales, const void* x,
                                         const void* w1q, const void* s1, const void* b1,
                                         const void* w2q, const void* s2, const void* b2,
                                         void* out, int T, int C, void* stream) {
  return bt::mlp8::run_codes<float>(codes, scales, x, w1q, s1, b1, w2q, s2, b2, out, T, C,
                                    stream);
}
