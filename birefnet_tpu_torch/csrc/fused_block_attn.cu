// Fused Swin window-attention block on a padded NHWC canvas:
//   out = x + proj(attention(qkv(zero_pads(LN1(x)))))
//
// Replaces birefnet_tpu/ops/pallas/fused_block_attn.py::_fused (the bf16,
// non-int8 branch of _kernel). The TPU kernel holds a whole strip of
// windows (up to 264 x 1536 tokens) in VMEM and runs every step in one
// body. A Hopper block has 227 KB of shared memory, and one 144x144 f32
// score tile alone takes 83 KB, so the work runs as three hand-written
// kernels on one stream:
//
// 1. gemm_kernel<LN>: qkv = LN1(x) Wqkv^T + b over all T = B*Hp*Wp tokens.
//    128x128 output tiles on bf16 tensor-core mma (wmma, f32 accumulation);
//    each 128x32 A tile is normalized with the rows' f32 LN statistics as
//    it is staged in shared memory, and pad tokens are zeroed after the
//    norm (the cyclic-shift remap or the roll-free `origin` offset, as the
//    TPU kernel does). qkv goes to a [T, 3C] bf16 scratch.
// 2. the window-attention core of window_core.cuh (CanvasRows): reads each
//    window's q/k/v rows straight from the scratch at the window's token
//    positions (no window_partition copy), keeps scores and probabilities
//    in registers, and writes the head outputs to a [T, C] scratch in
//    canvas order. The same core serves flash_window_attn.cu; its note
//    says what bounds it and how its design answers that.
// 3. gemm_kernel<false, true>: out = x + (attn Wproj^T + b), token-local.
//
// What bounds it on the card: the qkv and proj products are 8 C^2 flops
// per token (stage 2 of Swin-L: ~0.9 TFLOP per forward), so the GEMMs must
// run near tensor-core rate; here they use 16x16 wmma tiles with
// synchronous shared-memory staging, well below the wgmma/TMA rate. The
// attention core is small (4 * 144 * C flops per token) and bound by its
// 8 C bytes per token. The qkv round trip through device memory (6 C bytes per
// token each way) is the price of the split.
//
// The softmax stays in f32 with one normalization per row, unlike the
// TPU's packed head groups that round exp(s - m) to bf16 before P v.
// Rounding points (as in the JAX kernel): qkv + bias -> bf16; q * bf16(d^-0.5)
// -> bf16; rel-pos bias and mask -> bf16; softmax probabilities -> bf16; P v -> bf16; proj + bias -> bf16;
// + x -> bf16.
//
// W8A8 entry, bt_fused_block_attn_i8: the int8 branch of the same TPU
// kernel (fused_block_attn.py:100-112, 208-215; ComputeConfig.int8_attn).
// The proj input's per-token scale needs each token's absmax over all C
// channels, which come from C/32 different (window, head) blocks of the
// attention core, so both projections get a row pre-pass (int8.cuh; the
// kernels are in int8_gemm.cu):
// 1. quant_rows<LN, PAD>: LN1 (f32 statistics) -> pad tokens zeroed ->
//    rows rounded to bf16 -> per-token int8 codes [T, C] + scales [T],
//    each row read once into registers;
// 2. i8 gemm<kStoreBf16>: qkv = acc * (sx * sw) + b -> bf16 [T, 3C], on
//    wgmma s8 tensor cores fed by TMA;
// 3. the attention core, as in the bf16 entry, -> attention rows bf16 [T, C];
// 4. quant_rows: per-token int8 of the attention rows (same scratch);
// 5. i8 gemm<kResidualBf16>: out = x + bf16(acc * (sa * sw) + b).
// The int8 round trips add 2 C bytes per token each way; the qkv and proj
// products (8 C^2 integer ops per token) are bound by the int8 peak.

#include "common.cuh"
#include "int8.cuh"
#include "window_core.cuh"

using namespace nvcuda;

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kD = 32;  // head dim

using bt::Geometry;
using bt::token_valid;

// ---------------------------------------------------------------------------
// GEMM: out[M, N] = A'[M, K] W[N, K]^T + bias, A' = LN1(A) with pad tokens
// zeroed when LN, else A. With RESIDUAL, out = round(round(...) + res).
// Instantiated as <LN, !RESIDUAL> for qkv and <!LN, RESIDUAL> for proj.
// M and N are multiples of 16, K a multiple of 32.
// ---------------------------------------------------------------------------

constexpr int kBM = 128, kBN = 128, kBK = 32, kLd = kBK + 8;

__device__ __forceinline__ uint4 normalize8(uint4 raw, float mean, float rstd,
                                            bool valid, const float* g,
                                            const float* b) {
  const bf16* v = reinterpret_cast<const bf16*>(&raw);
  uint4 out;
  bf16* o = reinterpret_cast<bf16*>(&out);
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float h = (__bfloat162float(v[e]) - mean) * rstd * g[e] + b[e];
    o[e] = __float2bfloat16(valid ? h : 0.f);
  }
  return out;
}

template <bool LN, bool RESIDUAL>
__global__ void __launch_bounds__(kThreads)
gemm_kernel(const bf16* __restrict__ A, const bf16* __restrict__ W,
            const float* __restrict__ bias, const bf16* __restrict__ res,
            bf16* __restrict__ out, int M, int N, int K,
            const float* __restrict__ ln_g, const float* __restrict__ ln_b,
            Geometry geo) {
  __shared__ __align__(128) bf16 As[kBM * kLd];
  __shared__ __align__(128) bf16 Bs[kBN * kLd];
  __shared__ __align__(128) float stage[kWarps][16 * 16];
  __shared__ float mean_s[kBM], rstd_s[kBM];
  __shared__ bool valid_s[kBM];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int wm = warp >> 1, wn = warp & 1;  // 4 x 2 warps, 32 x 64 each

  if (LN) {
    // Two-pass f32 statistics of the tile's rows (eps 1e-5 inside rsqrt).
    for (int r = warp; r < kBM; r += kWarps) {
      const int t = m0 + r;
      float mean = 0.f, rstd = 0.f;
      bool valid = false;
      if (t < M) {
        const bf16* xr = A + (size_t)t * K;
        float s = 0.f;
        for (int c = lane; c < K; c += 32) s += __bfloat162float(xr[c]);
        mean = bt::warp_sum(s) / K;
        float v = 0.f;
        for (int c = lane; c < K; c += 32) {
          const float d = __bfloat162float(xr[c]) - mean;
          v += d * d;
        }
        rstd = rsqrtf(bt::warp_sum(v) / K + 1e-5f);
        const int hw = geo.Hp * geo.Wp, p = t % hw;
        valid = token_valid(geo, p / geo.Wp, p % geo.Wp);
      }
      if (lane == 0) {
        mean_s[r] = mean;
        rstd_s[r] = rstd;
        valid_s[r] = valid;
      }
    }
    __syncthreads();
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  // Each thread stages 2 16-byte chunks of the A tile and 2 of the B tile.
  // The next k step's chunks are loaded into registers while the tensor
  // cores work on the current tile, so the L2 latency overlaps the mma.
  constexpr int kChunks = kBM * kBK / 8 / kThreads;  // 2 (kBM == kBN)
  uint4 ra[kChunks], rb[kChunks];
  auto load_tile = [&](int k0) {
#pragma unroll
    for (int u = 0; u < kChunks; ++u) {
      const int c = tid + u * kThreads, r = c / (kBK / 8), kc = (c % (kBK / 8)) * 8;
      const int t = m0 + r, n = n0 + r;
      ra[u] = t < M ? *reinterpret_cast<const uint4*>(A + (size_t)t * K + k0 + kc)
                    : make_uint4(0, 0, 0, 0);
      rb[u] = n < N ? *reinterpret_cast<const uint4*>(W + (size_t)n * K + k0 + kc)
                    : make_uint4(0, 0, 0, 0);
    }
  };
  load_tile(0);
  for (int k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
    for (int u = 0; u < kChunks; ++u) {
      const int c = tid + u * kThreads, r = c / (kBK / 8), kc = (c % (kBK / 8)) * 8;
      uint4 a = ra[u];
      if (LN && m0 + r < M)
        a = normalize8(a, mean_s[r], rstd_s[r], valid_s[r], ln_g + k0 + kc,
                       ln_b + k0 + kc);
      *reinterpret_cast<uint4*>(As + r * kLd + kc) = a;
      *reinterpret_cast<uint4*>(Bs + r * kLd + kc) = rb[u];
    }
    __syncthreads();
    if (k0 + kBK < K) load_tile(k0 + kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], As + (wm * 32 + i * 16) * kLd + kk, kLd);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(fb[j], Bs + (wn * 64 + j * 16) * kLd + kk, kLd);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* st = stage[warp];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = m0 + wm * 32 + i * 16, col = n0 + wn * 64 + j * 16;
      if (row >= M || col >= N) continue;
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int r = e / 16, c = e % 16;
        const size_t gi = (size_t)(row + r) * N + col + c;
        float y = bt::round_bf16(st[e] + bias[col + c]);
        if (RESIDUAL) y += __bfloat162float(res[gi]);
        out[gi] = __float2bfloat16(y);
      }
      __syncwarp();
    }
  }
}

// The attention core on the qkv scratch (window_core.cuh, CanvasRows): head
// dim 32, N = ws^2 of 16, 64 or 144 tokens, a bias, and no mask, region ids
// or a dense f32 mask. Only those lean forms are built for this layout; the
// core refuses any other.
cudaError_t attention_core(const bf16* qkv, const void* bias, const void* mask,
                           int mask_kind, bf16* attn, int B, const Geometry& g,
                           cudaStream_t s) {
  namespace core = bt::core;
  const int nwin = (g.Hp / g.ws) * (g.Wp / g.ws), n = g.ws * g.ws;
  const bt::CanvasRows rows{qkv, attn, g.Hp, g.Wp, g.C, g.ws, (65536 + g.ws - 1) / g.ws};
  const bt::Addends ad{static_cast<const float*>(bias), mask, mask_kind, nwin};
  if (n <= 64)
    return core::launch_class<bt::CanvasRows, 8, kD, true, false>(rows, ad, B * nwin,
                                                                  g.heads, n, kD, false, s);
  return core::launch_class<bt::CanvasRows, 18, kD, true, false>(rows, ad, B * nwin,
                                                                 g.heads, n, kD, false, s);
}

}  // namespace

// x, out [B, Hp, Wp, C] bf16; ln_g, ln_b [C] f32; wqkv [3C, C] bf16;
// bqkv [3C] f32; wproj [C, C] bf16; bproj [C] f32; bias [heads, N, N] f32;
// mask by mask_kind (window_core.cuh): null, dense [nW, N, N] f32, or
// region ids [nW, N] int32, window win of an image taking entry win;
// qkv_scratch [B*Hp*Wp, 3C] bf16;
// attn_scratch [B, Hp, Wp, C] bf16. Head dim 32, N = ws*ws a multiple of
// 16 and at most 144, C a multiple of 64.
extern "C" int bt_fused_block_attn_bf16(
    const void* x, const void* ln_g, const void* ln_b, const void* wqkv,
    const void* bqkv, const void* wproj, const void* bproj, const void* bias,
    const void* mask, void* qkv_scratch, void* attn_scratch, void* out, int B,
    int Hp, int Wp, int C, int heads, int ws, int shift, int origin, int h_real,
    int w_real, int mask_kind, void* stream) {
  const int n = ws * ws;
  if (C != heads * kD || C % 64 != 0 || n % 16 != 0 || n > 144 || Hp % ws != 0 ||
      Wp % ws != 0 || B <= 0 || bias == nullptr ||
      (mask_kind != bt::kNoMask && mask_kind != bt::kMaskF32 && mask_kind != bt::kRegionIds) ||
      ((mask_kind == bt::kNoMask) != (mask == nullptr)))
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const Geometry g{Hp, Wp, C, heads, ws, shift, origin, h_real, w_real};
  const int T = B * Hp * Wp;
  auto* xb = static_cast<const bf16*>(x);
  auto* qkv = static_cast<bf16*>(qkv_scratch);
  auto* attn = static_cast<bf16*>(attn_scratch);

  gemm_kernel<true, false><<<dim3((T + kBM - 1) / kBM, (3 * C + kBN - 1) / kBN),
                             kThreads, 0, s>>>(
      xb, static_cast<const bf16*>(wqkv), static_cast<const float*>(bqkv), nullptr,
      qkv, T, 3 * C, C, static_cast<const float*>(ln_g),
      static_cast<const float*>(ln_b), g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  err = attention_core(qkv, bias, mask, mask_kind, attn, B, g, s);
  if (err != cudaSuccess) return (int)err;

  gemm_kernel<false, true><<<dim3((T + kBM - 1) / kBM, (C + kBN - 1) / kBN),
                             kThreads, 0, s>>>(
      attn, static_cast<const bf16*>(wproj), static_cast<const float*>(bproj), xb,
      static_cast<bf16*>(out), T, C, C, nullptr, nullptr, g);
  return (int)cudaGetLastError();
}

// As bt_fused_block_attn_bf16, with W8A8 projections: wqkv [3C, C] and
// wproj [C, C] int8, sqkv [3C] and sproj [C] f32 per-output-channel
// scales; codes [T, C] int8 and scales [T] f32 scratch (T = B*Hp*Wp).
extern "C" int bt_fused_block_attn_i8(
    const void* x, const void* ln_g, const void* ln_b, const void* wqkv,
    const void* sqkv, const void* bqkv, const void* wproj, const void* sproj,
    const void* bproj, const void* bias, const void* mask, void* codes,
    void* scales, void* qkv_scratch, void* attn_scratch, void* out, int B, int Hp,
    int Wp, int C, int heads, int ws, int shift, int origin, int h_real,
    int w_real, int mask_kind, void* stream) {
  namespace i8 = bt::i8;
  const int n = ws * ws;
  if (C != heads * kD || C % 64 != 0 || n % 16 != 0 || n > 144 || Hp % ws != 0 ||
      Wp % ws != 0 || B <= 0 || bias == nullptr ||
      (mask_kind != bt::kNoMask && mask_kind != bt::kMaskF32 && mask_kind != bt::kRegionIds) ||
      ((mask_kind == bt::kNoMask) != (mask == nullptr)))
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const Geometry g{Hp, Wp, C, heads, ws, shift, origin, h_real, w_real};
  const int T = B * Hp * Wp;
  auto* xb = static_cast<const bf16*>(x);
  auto* q = static_cast<int8_t*>(codes);
  auto* sc = static_cast<float*>(scales);
  auto* qkv = static_cast<bf16*>(qkv_scratch);
  auto* attn = static_cast<bf16*>(attn_scratch);

  cudaError_t err = i8::quant_rows<bf16, true, true>(
      xb, static_cast<const float*>(ln_g), static_cast<const float*>(ln_b), q, sc, T, C,
      g, s);
  if (err != cudaSuccess) return (int)err;
  err = i8::gemm<i8::kStoreBf16>(q, sc, static_cast<const int8_t*>(wqkv),
                                 static_cast<const float*>(sqkv),
                                 static_cast<const float*>(bqkv), nullptr, qkv, T,
                                 3 * C, C, s);
  if (err != cudaSuccess) return (int)err;

  err = attention_core(qkv, bias, mask, mask_kind, attn, B, g, s);
  if (err != cudaSuccess) return (int)err;

  err = i8::quant_rows<bf16, false, false>(attn, nullptr, nullptr, q, sc, T, C, g, s);
  if (err != cudaSuccess) return (int)err;
  return (int)i8::gemm<i8::kResidualBf16>(
      q, sc, static_cast<const int8_t*>(wproj), static_cast<const float*>(sproj),
      static_cast<const float*>(bproj), xb, out, T, C, C, s);
}
