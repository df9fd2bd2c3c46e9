// Fused Swin MLP half-block: out = x + fc2(GELU_erf(LN2(x) W1^T + b1)) W2^T + b2.
//
// Replaces birefnet_tpu/ops/pallas/fused_mlp.py::_fused (the bf16 _kernel).
// One block of 16 warps owns BM = 16 * RG token rows (RG = 4/4/4/2/1 at
// C = 96/192/384/768/1536) and a range of the 4C hidden units. It
// normalizes its rows into shared memory, then walks its hidden units in
// chunks of 256 (the last one shorter where 4C is no multiple of 256, as
// at C = 96: 384 = 256 + 128): each warp computes one 16-wide hidden tile
// for all RG row groups with bf16 tensor-core mma (f32 accumulation), bias
// and exact GELU are applied in f32 and the chunk is rounded to bf16 in
// shared memory, and
// each warp (row group rg, column group cg of 16 / RG) accumulates its
// share of the fc2 output in registers (at most 6 16x16 tiles). The
// [T, 4C] hidden never reaches device memory.
//
// When the rows alone give too few blocks to fill the card (the wide
// stages: T = 512 .. 8192 tokens at C = 768/1536), the hidden units are
// split over `splits` blocks per row block; each writes its f32 partial
// fc2 sum to a [splits, T, C] scratch, and mlp_split_epilogue adds the
// partials, b2 and the residual.
//
// What bounds it on the card: every block streams W1 and W2 for its hidden
// range from L2 (16 C^2 / splits bytes per BM rows) through 16x16 wmma
// fragments loaded straight from L2; with one block of 16 warps per SM the
// loads' latency is hidden only by the other warps. Shared-memory staging
// with cp.async/TMA and wgmma tiles are the next step.
//
// Numerics: LN statistics in f32, eps inside rsqrt; fc1 bias and exact
// GELU (erff) in f32, hidden rounded to bf16; fc2 + b2 rounded to bf16,
// then the residual add rounded to bf16 -- the rounding points of the
// JAX kernel, which used a 3-term erf instead of erff. With splits > 1 the
// f32 partial sums are added in split order before the bias.

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 256;  // hidden units per step: one 16-wide tile per warp
// Shared-memory row strides, padded off multiples of 128 bytes so the 16
// rows of a wmma fragment fall in different banks.
constexpr int kStageLd = kChunk + 4;  // f32
constexpr int kHidLd = kChunk + 8;    // bf16

size_t smem_bytes(int C, int rg) {
  const size_t rows = 16 * rg;
  const size_t body = bt::align128(rows * (C + 8) * 2) + rows * kStageLd * 4 +
                      rows * kHidLd * 2;
  return body > rows * C * 4 ? body : rows * C * 4;
}

template <int RG, int TILES>
__global__ void __launch_bounds__(kThreads)
fused_mlp_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_g,
                 const float* __restrict__ ln_b, const bf16* __restrict__ w1,
                 const float* __restrict__ b1, const bf16* __restrict__ w2,
                 const float* __restrict__ b2, bf16* __restrict__ out,
                 float* __restrict__ partial, int T, int C, int chunks_per_split,
                 float eps) {
  constexpr int kRows = 16 * RG, kCG = kWarps / RG;
  extern __shared__ __align__(128) unsigned char smem[];
  const int hs_ld = C + 8;
  bf16* hs = reinterpret_cast<bf16*>(smem);  // [BM, hs_ld]
  float* stage = reinterpret_cast<float*>(smem + bt::align128(kRows * hs_ld * 2));
  bf16* hid = reinterpret_cast<bf16*>(stage + kRows * kStageLd);  // [BM, kHidLd]
  float* ys = reinterpret_cast<float*>(smem);  // [BM, C], reuses the space at the end

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = warp / kCG, cg = warp % kCG;
  const int row0 = blockIdx.x * kRows;
  const int hidden = 4 * C;
  const int ntiles = C / 16;
  const int hc_begin = blockIdx.y * chunks_per_split * kChunk;
  const int hc_end = min(hidden, hc_begin + chunks_per_split * kChunk);

  // LayerNorm of the block's rows into hs (bf16); rows past T are zero.
  for (int r = warp; r < kRows; r += kWarps) {
    const int t = row0 + r;
    bf16* hrow = hs + r * hs_ld;
    if (t < T) {
      const bf16* xr = x + (size_t)t * C;
      float s = 0.f;
      for (int c = lane; c < C; c += 32) s += __bfloat162float(xr[c]);
      const float mean = bt::warp_sum(s) / C;
      float v = 0.f;
      for (int c = lane; c < C; c += 32) {
        const float d = __bfloat162float(xr[c]) - mean;
        v += d * d;
      }
      const float rstd = rsqrtf(bt::warp_sum(v) / C + eps);
      for (int c = lane; c < C; c += 32)
        hrow[c] = __float2bfloat16((__bfloat162float(xr[c]) - mean) * rstd * ln_g[c] + ln_b[c]);
    } else {
      for (int c = lane; c < C; c += 32) hrow[c] = __float2bfloat16(0.f);
    }
  }
  __syncthreads();

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[TILES];
#pragma unroll
  for (int i = 0; i < TILES; ++i) wmma::fill_fragment(acc[i], 0.f);

  for (int hc = hc_begin; hc < hc_end; hc += kChunk) {
    const int len = min(kChunk, hc_end - hc);  // a multiple of 64
    // fc1: warp w computes hidden units [hc + 16w, hc + 16w + 16) for every
    // row group, loading each weight fragment once.
    if (warp * 16 < len) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> a1[RG];
#pragma unroll
      for (int r = 0; r < RG; ++r) wmma::fill_fragment(a1[r], 0.f);
      const bf16* wrow = w1 + (size_t)(hc + warp * 16) * C;
      // Unrolled so that several weight-fragment loads from L2 are in
      // flight at once; a rolled loop waits out each load's latency.
#pragma unroll 8
      for (int k = 0; k < C; k += 16) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fb, wrow + k, C);
#pragma unroll
        for (int r = 0; r < RG; ++r) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
          wmma::load_matrix_sync(fa, hs + r * 16 * hs_ld + k, hs_ld);
          wmma::mma_sync(a1[r], fa, fb, a1[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < RG; ++r)
        wmma::store_matrix_sync(stage + r * 16 * kStageLd + warp * 16, a1[r],
                                kStageLd, wmma::mem_row_major);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kRows * kChunk; i += kThreads) {
      const int r = i / kChunk, c = i % kChunk;
      if (c >= len) continue;
      const float v = stage[r * kStageLd + c] + b1[hc + c];
      hid[r * kHidLd + c] =
          __float2bfloat16(v * 0.5f * (1.f + erff(v * 0.70710678118654752f)));
    }
    __syncthreads();
    // fc2: accumulate this chunk into the warp's output tiles of its rows.
#pragma unroll 4
    for (int kk = 0; kk < len; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, hid + rg * 16 * kHidLd + kk, kHidLd);
#pragma unroll
      for (int i = 0; i < TILES; ++i) {
        const int tile = cg + i * kCG;
        if (tile < ntiles) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
          wmma::load_matrix_sync(fb, w2 + (size_t)tile * 16 * hidden + hc + kk, hidden);
          wmma::mma_sync(acc[i], fa, fb, acc[i]);
        }
      }
    }
  }

  if (partial != nullptr) {
    // Split hidden range: f32 partial sums go to [split, T, C].
    float* pbase = partial + (size_t)blockIdx.y * T * C;
#pragma unroll
    for (int i = 0; i < TILES; ++i) {
      const int tile = cg + i * kCG, row = row0 + rg * 16;
      if (tile < ntiles && row < T)  // T % 16 == 0 on this path
        wmma::store_matrix_sync(pbase + (size_t)row * C + tile * 16, acc[i], C,
                                wmma::mem_row_major);
    }
    return;
  }
  __syncthreads();  // ys overlays hs/stage/hid
#pragma unroll
  for (int i = 0; i < TILES; ++i) {
    const int tile = cg + i * kCG;
    if (tile < ntiles)
      wmma::store_matrix_sync(ys + rg * 16 * C + tile * 16, acc[i], C, wmma::mem_row_major);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kRows * C; i += kThreads) {
    const int r = i / C, c = i % C, t = row0 + r;
    if (t < T) {
      const size_t g = (size_t)t * C + c;
      const float y = bt::round_bf16(ys[i] + b2[c]);
      out[g] = __float2bfloat16(__bfloat162float(x[g]) + y);
    }
  }
}

// out = round(x + round(sum_s partial[s] + b2)) over [T, C].
__global__ void mlp_split_epilogue(const bf16* __restrict__ x,
                                   const float* __restrict__ partial,
                                   const float* __restrict__ b2, bf16* __restrict__ out,
                                   int T, int C, int splits) {
  const size_t n = (size_t)T * C;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += partial[k * n + i];
    const float y = bt::round_bf16(s + b2[i % C]);
    out[i] = __float2bfloat16(__bfloat162float(x[i]) + y);
  }
}

template <int RG, int TILES>
cudaError_t launch(const bf16* x, const float* g, const float* b, const bf16* w1,
                   const float* b1, const bf16* w2, const float* b2, bf16* out,
                   float* partial, int T, int C, int splits, cudaStream_t stream) {
  const size_t smem = smem_bytes(C, RG);
  cudaError_t err = cudaFuncSetAttribute(fused_mlp_kernel<RG, TILES>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const int chunks = (4 * C + kChunk - 1) / kChunk;
  const int per_split = (chunks + splits - 1) / splits;
  const dim3 grid((T + 16 * RG - 1) / (16 * RG), splits);
  fused_mlp_kernel<RG, TILES><<<grid, kThreads, smem, stream>>>(
      x, g, b, w1, b1, w2, b2, out, splits > 1 ? partial : nullptr, T, C, per_split,
      1e-5f);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  mlp_split_epilogue<<<1024, 256, 0, stream>>>(x, partial, b2, out, T, C, splits);
  return cudaGetLastError();
}

}  // namespace

// x, out [T, C] bf16; ln_g, ln_b [C] f32; w1 [4C, C] bf16; b1 [4C] f32;
// w2 [C, 4C] bf16; b2 [C] f32. C % 16 == 0 and C <= 1536. `row_groups`
// (1, 2 or 4; BM = 16 * row_groups rows per block) must satisfy
// row_groups * C <= 1536; `splits` divides the ceil(4C/256) hidden chunks
// over that many blocks per row block (T % 16 == 0 and `partial` an f32
// [splits, T, C] scratch when splits > 1, ignored otherwise) and must
// divide ceil(4C/256) evenly.
extern "C" int bt_fused_mlp_bf16(const void* x, const void* ln_g, const void* ln_b,
                                 const void* w1, const void* b1, const void* w2,
                                 const void* b2, void* out, void* partial, int T,
                                 int C, int row_groups, int splits, void* stream) {
  const int rg = row_groups;
  if (C % 16 != 0 || C > 1536 || T <= 0 || (rg != 1 && rg != 2 && rg != 4) ||
      rg * C > 1536 || splits < 1 || ((4 * C + kChunk - 1) / kChunk) % splits != 0 ||
      (splits > 1 && (T % 16 != 0 || partial == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int cg = kWarps / rg;
  const int tiles = (C / 16 + cg - 1) / cg;  // output tiles per warp, <= 6
  auto* xs = static_cast<const bf16*>(x);
  auto* g = static_cast<const float*>(ln_g);
  auto* b = static_cast<const float*>(ln_b);
  auto* pw1 = static_cast<const bf16*>(w1);
  auto* pb1 = static_cast<const float*>(b1);
  auto* pw2 = static_cast<const bf16*>(w2);
  auto* pb2 = static_cast<const float*>(b2);
  auto* o = static_cast<bf16*>(out);
  auto* part = static_cast<float*>(partial);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (rg == 4) {
    if (tiles <= 1) err = launch<4, 1>(xs, g, b, pw1, pb1, pw2, pb2, o, part, T, C, splits, s);
    else if (tiles <= 3) err = launch<4, 3>(xs, g, b, pw1, pb1, pw2, pb2, o, part, T, C, splits, s);
    else err = launch<4, 6>(xs, g, b, pw1, pb1, pw2, pb2, o, part, T, C, splits, s);
  } else if (rg == 2) {
    err = launch<2, 6>(xs, g, b, pw1, pb1, pw2, pb2, o, part, T, C, splits, s);
  } else {
    err = launch<1, 6>(xs, g, b, pw1, pb1, pw2, pb2, o, part, T, C, splits, s);
  }
  return (int)err;
}
