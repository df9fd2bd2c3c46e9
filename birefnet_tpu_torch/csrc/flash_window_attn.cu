// Window attention core of the Swin ws=7 middle tier, and bias-free flash
// attention:
//   out[w, h] = softmax(bf16(q * s) k^T + bf16(bias[h]) [+ bf16(mask[w % nW])]) v
// with s = bf16(d^-0.5), for every window w and head h.
//
// Replaces the three Pallas kernels of
// birefnet_tpu/ops/pallas/flash_window_attn.py, which compute this one
// function on two layouts: _flash_qkv (K6, the packed [B_, N, 3C] qkv
// projection, all heads of a block of windows per grid step), _flash_masked
// (K7) and _flash_plain (K8) on [B_, heads, N, d]. Here one kernel takes
// element strides (window, head, token) for q, k, v and the output, so K6
// reads its head's columns straight out of the packed projection and writes
// the packed [B_, N, C] output the proj product consumes: no transpose is
// ever materialized, as on the TPU.
//
// One block of 4 warps per (window, head). The block stages its q (scaled),
// k and v rows in shared memory as [Np, Dp] bf16 tiles, with N padded to
// Np = 16 * ceil(N / 16) (49 -> 64) and d to Dp = 16 * ceil(d / 16) for the
// 16x16x16 bf16 tensor-core tiles (wmma, f32 accumulation): pad rows and
// columns are zero. Each warp owns 16-row query strips: scores q k^T for the
// strip into a [16, Np] f32 shared-memory strip, the f32 row softmax over the
// N real columns (pad columns get probability 0), the bf16 probabilities
// written over the scores in place, P v on the tensor cores, and the strip's
// real rows rounded to bf16 and stored. Pad query rows are never written.
//
// What bounds it on the card: per (window, head) it reads 3 N d and writes
// N d bf16 values, and does 4 N^2 d flops, so at N = 49, d = 32 it does
// about 25 flops per byte, far below the H100's ridge (~295): it is bound by
// device-memory bytes. Its design answers that only by reading each q/k/v
// element once and keeping the scores and probabilities on chip; the 16-byte
// row loads of the packed layout (64 bytes per head row at d = 32) and the
// one-block-per-head grid are the next things to improve.
//
// Rounding points, those of the JAX kernel (_attn_core): q * s rounded to
// bf16 with s rounded to bf16 first; scores in f32; the bias and mask
// addends rounded to bf16 and summed in f32 before they are added; softmax
// exp(s - m) / sum in f32; probabilities rounded to bf16; P v summed in f32
// and rounded to bf16.

#include <cstring>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxN = 256;
constexpr int kMaxD = 64;
constexpr int kCols = kMaxN / 32;  // score columns per lane

// Element strides of one operand: window, head, token (the head dim is
// contiguous).
struct Layout {
  long long window, head, token;
};

// f32 -> bf16 -> f32 with round-to-nearest-even, on the host (finite v).
float round_bf16_host(float v) {
  uint32_t u;
  std::memcpy(&u, &v, 4);
  u = (u + 0x7fffu + ((u >> 16) & 1u)) & 0xffff0000u;
  std::memcpy(&v, &u, 4);
  return v;
}

__host__ __device__ inline int pad16(int v) { return (v + 15) & ~15; }

__host__ __device__ inline size_t tile_bytes(int np, int dp) {
  return bt::align128((size_t)np * (dp + 8) * 2);
}

// One warp's strip: the [16, Np + 4] f32 scores, also the [16, Dp] f32
// staging of the output.
__host__ __device__ inline size_t strip_bytes(int np, int dp) {
  const int ld = np + 4 > dp ? np + 4 : dp;
  return bt::align128((size_t)16 * ld * 4);
}

size_t smem_bytes(int np, int dp) {
  return 3 * tile_bytes(np, dp) + kWarps * strip_bytes(np, dp);
}

template <int KD>
__global__ void __launch_bounds__(kThreads)
flash_window_attn_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, bf16* __restrict__ out,
                         Layout lq, Layout lk, Layout lv, Layout lo,
                         const float* __restrict__ bias,
                         const float* __restrict__ mask, int n, int d, int nw,
                         float scale) {
  constexpr int kDp = 16 * KD, kLd = kDp + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const int np = pad16(n);
  const int s_ld = np + 4;     // f32 score row stride
  const int p_ld = 2 * s_ld;   // bf16 probability row stride (same bytes)
  const size_t tile = tile_bytes(np, kDp);
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = reinterpret_cast<bf16*>(smem + tile);
  bf16* vs = reinterpret_cast<bf16*>(smem + 2 * tile);

  const int w = blockIdx.x, h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* S = reinterpret_cast<float*>(smem + 3 * tile + warp * strip_bytes(np, kDp));
  bf16* P = reinterpret_cast<bf16*>(S);

  const bf16* qb = q + w * lq.window + h * lq.head;
  const bf16* kb = k + w * lk.window + h * lk.head;
  const bf16* vb = v + w * lv.window + h * lv.head;

  // q/k/v rows, 8 bf16 (16 bytes) per load; zero pad rows and columns.
  constexpr int kChunks = kDp / 8;
  for (int idx = threadIdx.x; idx < 3 * np * kChunks; idx += kThreads) {
    const int part = idx / (np * kChunks), rem = idx % (np * kChunks);
    const int i = rem / kChunks, c8 = (rem % kChunks) * 8;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (i < n && c8 < d) {
      const bf16* src = part == 0 ? qb + i * lq.token
                                  : (part == 1 ? kb + i * lk.token : vb + i * lv.token);
      raw = *reinterpret_cast<const uint4*>(src + c8);
      if (part == 0) {
        bf16* e = reinterpret_cast<bf16*>(&raw);
#pragma unroll
        for (int u = 0; u < 8; ++u) e[u] = __float2bfloat16(__bfloat162float(e[u]) * scale);
      }
    }
    bf16* dst = part == 0 ? qs : (part == 1 ? ks : vs);
    *reinterpret_cast<uint4*>(dst + i * kLd + c8) = raw;
  }
  __syncthreads();

  const int mt = np / 16;
  const float* bias_h = bias + (size_t)h * n * n;
  const float* mask_w = mask ? mask + (size_t)(w % nw) * n * n : nullptr;
  bf16* ob = out + w * lo.window + h * lo.head;
  for (int rt = warp; rt < mt; rt += kWarps) {
    // Scores of the strip: S = q k^T.
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fq[KD];
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
      wmma::load_matrix_sync(fq[kk], qs + rt * 16 * kLd + kk * 16, kLd);
    for (int ct = 0; ct < mt; ++ct) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sc;
      wmma::fill_fragment(sc, 0.f);
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fk;
        wmma::load_matrix_sync(fk, ks + ct * 16 * kLd + kk * 16, kLd);
        wmma::mma_sync(sc, fq[kk], fk, sc);
      }
      wmma::store_matrix_sync(S + ct * 16, sc, s_ld, wmma::mem_row_major);
    }
    __syncwarp();
    // Row softmax in f32 over the N real columns. Each row is read into
    // registers before its bf16 probabilities overwrite it in place; pad
    // columns (and pad rows) get probability 0.
    for (int r = 0; r < 16; ++r) {
      const int i = rt * 16 + r;
      float val[kCols];
      float m = -INFINITY;
#pragma unroll
      for (int u = 0; u < kCols; ++u) {
        const int j = lane + 32 * u;
        val[u] = -INFINITY;
        if (i < n && j < n) {
          float extra = bt::round_bf16(bias_h[i * n + j]);
          if (mask_w) extra += bt::round_bf16(mask_w[i * n + j]);
          val[u] = S[r * s_ld + j] + extra;
        }
        m = fmaxf(m, val[u]);
      }
      m = bt::warp_max(m);
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < kCols; ++u) {
        val[u] = val[u] == -INFINITY ? 0.f : expf(val[u] - m);
        sum += val[u];
      }
      sum = bt::warp_sum(sum);  // also orders every lane's reads before the writes
#pragma unroll
      for (int u = 0; u < kCols; ++u) {
        const int j = lane + 32 * u;
        if (j < np) P[r * p_ld + j] = __float2bfloat16(sum > 0.f ? val[u] / sum : 0.f);
      }
    }
    __syncwarp();
    // O = P v for the strip, staged in the strip as [16, Dp] f32 (the
    // probabilities are consumed before the store).
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> o[KD];
#pragma unroll
    for (int ct = 0; ct < KD; ++ct) wmma::fill_fragment(o[ct], 0.f);
    for (int kk = 0; kk < np; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fp;
      wmma::load_matrix_sync(fp, P + kk, p_ld);
#pragma unroll
      for (int ct = 0; ct < KD; ++ct) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fv;
        wmma::load_matrix_sync(fv, vs + kk * kLd + ct * 16, kLd);
        wmma::mma_sync(o[ct], fp, fv, o[ct]);
      }
    }
    __syncwarp();
#pragma unroll
    for (int ct = 0; ct < KD; ++ct)
      wmma::store_matrix_sync(S + ct * 16, o[ct], kDp, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 16 * kDp; e += 32) {
      const int r = e / kDp, dd = e % kDp, i = rt * 16 + r;
      if (i < n && dd < d) ob[i * lo.token + dd] = __float2bfloat16(S[e]);
    }
    __syncwarp();
  }
}

template <int KD>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, bf16* out,
                   const Layout* l, const float* bias, const float* mask, int B,
                   int heads, int n, int d, int nw, float scale, cudaStream_t s) {
  const size_t smem = smem_bytes(pad16(n), 16 * KD);
  cudaError_t err = cudaFuncSetAttribute(flash_window_attn_kernel<KD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  flash_window_attn_kernel<KD><<<dim3(B, heads), kThreads, smem, s>>>(
      q, k, v, out, l[0], l[1], l[2], l[3], bias, mask, n, d, nw, scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, out: bf16, head dim contiguous, at element strides
// (window, head, token) = strides[0..2] (q), [3..5] (k), [6..8] (v),
// [9..11] (out), every stride and pointer 16-byte aligned (multiples of 8
// elements). bias [heads, N, N] f32; mask [nW, N, N] f32 or null (window w
// takes mask[w % nW]). 1 <= N <= 256, d a multiple of 8 up to 64, B windows,
// 1 <= heads <= 65535. The q scale is bf16(d^-0.5).
extern "C" int bt_flash_window_attn(const void* q, const void* k, const void* v,
                                    void* out, const void* bias, const void* mask,
                                    int sqw, int sqh, int sqt, int skw, int skh,
                                    int skt, int svw, int svh, int svt, int sow,
                                    int soh, int sot, int B, int heads, int n,
                                    int d, int nw, void* stream) {
  if (B <= 0 || heads <= 0 || heads > 65535 || n <= 0 || n > kMaxN || d <= 0 ||
      d > kMaxD || d % 8 != 0 || nw <= 0 || (mask != nullptr && B % nw != 0))
    return (int)cudaErrorInvalidValue;
  const Layout l[4] = {{sqw, sqh, sqt}, {skw, skh, skt}, {svw, svh, svt},
                       {sow, soh, sot}};
  const float scale = round_bf16_host(1.f / sqrtf((float)d));
  auto* qp = static_cast<const bf16*>(q);
  auto* kp = static_cast<const bf16*>(k);
  auto* vp = static_cast<const bf16*>(v);
  auto* op = static_cast<bf16*>(out);
  auto* bp = static_cast<const float*>(bias);
  auto* mp = static_cast<const float*>(mask);
  auto s = static_cast<cudaStream_t>(stream);
  switch ((d + 15) / 16) {
    case 1: return (int)launch<1>(qp, kp, vp, op, l, bp, mp, B, heads, n, d, nw, scale, s);
    case 2: return (int)launch<2>(qp, kp, vp, op, l, bp, mp, B, heads, n, d, nw, scale, s);
    case 3: return (int)launch<3>(qp, kp, vp, op, l, bp, mp, B, heads, n, d, nw, scale, s);
    default: return (int)launch<4>(qp, kp, vp, op, l, bp, mp, B, heads, n, d, nw, scale, s);
  }
}
