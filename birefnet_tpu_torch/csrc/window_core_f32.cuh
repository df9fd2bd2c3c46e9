// The f32 window-attention core, shared by the f32 window-attention entry
// (K6, K7, K8: bt_flash_window_attn_f32 in flash_window_attn.cu) and the
// f32 fused Swin block (K1: bt_fused_block_attn_f32 in fused_block_attn.cu):
//
//   out[w, h] = softmax(q s k^T + (bias[h] + mask[w % nW])) v
//
// all in f32, s = f32(d^-0.5), for every window w and head h. It ports the
// f32 branch of the attention part of
// birefnet_tpu/ops/pallas/fused_block_attn.py::_kernel (the per-head loop
// the JAX kernel runs for f32; its packed head groups are bf16 only) and of
// the three Pallas kernels of birefnet_tpu/ops/pallas/flash_window_attn.py,
// whose dots run at precision=HIGHEST: q is multiplied by s in f32, the
// scores are f32 sums of f32 products, the bias and mask are added
// unrounded (the mask as -100 where two region ids differ, or a dense f32
// mask, or -1e9 where a key lies after its query for flash_attention's
// causal bias, which JAX casts to q.dtype, f32 here), the softmax is
// exp(x - max) / sum in f32, and P v sums f32 products. No tensor core is
// used: every product is an FFMA.
//
// What bounds it on the card: per (window, head) 4 N^2 d operations against
// 16 N d bytes (q, k, v read, the output written): at N = 144, d = 32 that is
// 36 operations a byte, above the f32 ridge of 20 (67 TFLOP/s over 3.35
// TB/s), so the FMA units bound it, about 2 ms per Swin-L forward at peak.
//
// Design, one block per (window, head), FFMA throughout:
// - the block stages q (times s) and k transposed ([d][N], k-major) and v
//   ([N][d]) in shared memory, zero past N;
// - each warp takes groups of 8 query rows: lane l holds the scores of
//   keys l, l + 32, ... (TN blocks of 32 keys) for the 8 rows, so a k step
//   reads two float4 broadcasts of q and TN conflict-free words of k for
//   8 TN FFMAs;
// - the addends, row max, exp and sum run on those registers (the row's
//   max and sum by warp shuffles), and the probabilities go to the warp's
//   own [N][8] buffer in shared memory;
// - P v: lane l sums output column l (and l + 32 for d = 64) of the 8 rows
//   over the keys, reading each key's 8 probabilities as two float4
//   broadcasts and one word of v.
// Rows and columns at or past N never reach an output: pad keys get -inf,
// so probability 0, and pad query rows are not written. Eight rows a warp
// ran fastest on the H100 at Swin-L's shapes: 16 rows a warp took twice as
// long, 4 rows a warp (12 warps a block) and 9 warps of 8 rows 5-26%
// longer; the block runs at about a tenth of its FMA bound, for reasons
// not measured yet.
//
// Two layouts find a window's rows, as in window_core.cuh: F32StridedRows
// (element strides per window, head, token; K6's packed [B_, N, 3C] rows
// and K7/K8's [B_, heads, N, d]) and F32CanvasRows (K1's padded NHWC canvas
// of the [B, Hp, Wp, 3C] f32 qkv scratch, head dim 32).
#pragma once

#include <cmath>

#include "window_core.cuh"

namespace bt {

struct F32StridedRows {
  const float* q;
  const float* k;
  const float* v;
  float* out;
  Strides sq, sk, sv, so;
  __device__ __forceinline__ long long item(int w) const { return w; }
  __device__ __forceinline__ const float* in(int part, long long w, int h, int i) const {
    const float* base = part == 0 ? q : (part == 1 ? k : v);
    const long long sw = part == 0 ? sq.window : (part == 1 ? sk.window : sv.window);
    const long long sh = part == 0 ? sq.head : (part == 1 ? sk.head : sv.head);
    const long long st = part == 0 ? sq.token : (part == 1 ? sk.token : sv.token);
    return base + w * sw + h * sh + i * st;
  }
  __device__ __forceinline__ float* dst(long long w, int h, int i) const {
    return out + w * so.window + h * so.head + i * so.token;
  }
};

struct F32CanvasRows {
  const float* qkv;  // [B, Hp, Wp, 3C]
  float* out;        // [B, Hp, Wp, C]
  int Hp, Wp, C, ws;
  // The canvas token of the window's first row and column.
  __device__ __forceinline__ long long item(int w) const {
    const int wc = Wp / ws, nwin = (Hp / ws) * wc;
    const int b = w / nwin, win = w - b * nwin;
    const int wr = win / wc;
    return ((long long)b * Hp + wr * ws) * Wp + (win - wr * wc) * ws;
  }
  __device__ __forceinline__ long long token(long long base, int i) const {
    const int r = i / ws;
    return base + (long long)r * Wp + (i - r * ws);
  }
  __device__ __forceinline__ const float* in(int part, long long base, int h, int i) const {
    return qkv + token(base, i) * 3 * C + part * C + h * 32;
  }
  __device__ __forceinline__ float* dst(long long base, int h, int i) const {
    return out + token(base, i) * C + h * 32;
  }
};

namespace core_f32 {

constexpr int kRows = 8;       // query rows a warp takes at a time
constexpr int kMaxWarps = 8;
constexpr int kStageLoads = 4;  // loads a thread has in flight when staging

// Shared-memory layout in floats: qt [d][qs] (q times s, transposed), kt
// [d][ks] (k transposed; ks odd, so a transposing store of one k column
// hits distinct banks), v [32 TN][d], then one [32 TN][8] probability
// buffer per warp; every region starts on 16 bytes.
struct Plan {
  int warps, qs, ks;
  unsigned kt_off, v_off, p_off;
  size_t smem;
};

inline unsigned align4(size_t v) { return (unsigned)((v + 3) & ~size_t(3)); }

inline Plan plan(int tn, int n, int d) {
  Plan p{};
  const int rows = (n + kRows - 1) / kRows * kRows, groups = rows / kRows;
  // As many warps as balance the row groups, at most kMaxWarps; fewer where
  // shared memory runs short (N = 256, d = 64 takes 4).
  const int per_warp = (groups + kMaxWarps - 1) / kMaxWarps;
  p.warps = (groups + per_warp - 1) / per_warp;
  p.qs = rows + 4;
  p.ks = 32 * tn + 1;
  p.kt_off = align4((size_t)d * p.qs);
  p.v_off = align4(p.kt_off + (size_t)d * p.ks);
  p.p_off = align4(p.v_off + (size_t)32 * tn * d);
  for (;; --p.warps) {
    p.smem = ((size_t)p.p_off + (size_t)p.warps * 32 * tn * kRows) * 4;
    if (p.smem <= (size_t)core::kSmemLimit || p.warps == 1) break;
  }
  return p;
}

// One block: window blockIdx.x, head blockIdx.y. TN: blocks of 32 keys (2
// up to N = 64, 5 up to 160, 8 up to 256); DC: output columns a lane sums
// (1 for d <= 32, 2 up to 64).
template <class Rows, int TN, int DC>
__global__ void __launch_bounds__(kMaxWarps * 32)
window_core_f32_kernel(Rows rows, Addends ad, int n, int d, float scale, int qs, int ks,
                       unsigned kt_off, unsigned v_off, unsigned p_off) {
  extern __shared__ __align__(16) float sm[];
  constexpr int NK = 32 * TN;
  float* qt = sm;
  float* kt = sm + kt_off;
  float* vs = sm + v_off;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, nwarps = nthreads >> 5;
  const int w = blockIdx.x, h = blockIdx.y;
  const long long item = rows.item(w);
  const int nr = (n + kRows - 1) / kRows * kRows, d4 = d >> 2;

  // Stage q * s and k transposed, and v; zeros past N. A thread has
  // kStageLoads 16-byte loads in flight before it stores them.
  const int items = 3 * NK * d4;
  for (int e0 = tid; e0 < items; e0 += kStageLoads * nthreads) {
    float4 x[kStageLoads];
    int part[kStageLoads], row[kStageLoads], col[kStageLoads];
#pragma unroll
    for (int u = 0; u < kStageLoads; ++u) {
      const int e = e0 + u * nthreads;
      part[u] = e / (NK * d4);
      const int rem = e - part[u] * NK * d4;
      row[u] = rem / d4;
      col[u] = (rem - row[u] * d4) * 4;
      x[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (e < items && row[u] < n)
        x[u] = __ldg(reinterpret_cast<const float4*>(rows.in(part[u], item, h, row[u]) +
                                                     col[u]));
    }
#pragma unroll
    for (int u = 0; u < kStageLoads; ++u) {
      const int i = row[u], c = col[u];
      if (e0 + u * nthreads >= items || (part[u] == 0 && i >= nr)) continue;
      if (part[u] == 0) {
        qt[(c + 0) * qs + i] = x[u].x * scale;
        qt[(c + 1) * qs + i] = x[u].y * scale;
        qt[(c + 2) * qs + i] = x[u].z * scale;
        qt[(c + 3) * qs + i] = x[u].w * scale;
      } else if (part[u] == 1) {
        kt[(c + 0) * ks + i] = x[u].x;
        kt[(c + 1) * ks + i] = x[u].y;
        kt[(c + 2) * ks + i] = x[u].z;
        kt[(c + 3) * ks + i] = x[u].w;
      } else {
        *reinterpret_cast<float4*>(vs + i * d + c) = x[u];
      }
    }
  }
  __syncthreads();

  float* ps = sm + p_off + (size_t)warp * NK * kRows;
  const int wm = w % ad.nw;
  const float* bias = ad.bias != nullptr ? ad.bias + (size_t)h * n * n : nullptr;
  const int* ids = ad.mask_kind == kRegionIds ? static_cast<const int*>(ad.mask) + (size_t)wm * n
                                              : nullptr;
  const float* dense = ad.mask_kind == kMaskF32
                           ? static_cast<const float*>(ad.mask) + (size_t)wm * n * n
                           : nullptr;
  const bool causal = ad.mask_kind == kCausal;
  int id_key[TN];
#pragma unroll
  for (int t = 0; t < TN; ++t) {
    const int j = 32 * t + lane;
    id_key[t] = ids != nullptr && j < n ? __ldg(ids + j) : 0;
  }

  for (int grp = warp; grp < nr / kRows; grp += nwarps) {
    const int r0 = grp * kRows;
    float acc[kRows][TN];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int t = 0; t < TN; ++t) acc[r][t] = 0.f;
    // Scores: (q s) k^T, one k step at a time (d is a multiple of 8).
#pragma unroll 4
    for (int k = 0; k < d; ++k) {
      float q[kRows];
#pragma unroll
      for (int r = 0; r < kRows; r += 4)
        *reinterpret_cast<float4*>(q + r) = *reinterpret_cast<const float4*>(qt + k * qs + r0 + r);
      float kv[TN];
#pragma unroll
      for (int t = 0; t < TN; ++t) kv[t] = kt[k * ks + 32 * t + lane];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int t = 0; t < TN; ++t) acc[r][t] = fmaf(q[r], kv[t], acc[r][t]);
    }

    // Addends (bias + mask, summed first, as the JAX kernels sum them),
    // then the softmax of each row in f32, normalized by division. The
    // eight rows' maxima and sums reduce side by side, one shuffle of each
    // row per step.
    float mx[kRows], sum[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = r0 + r;
      const bool real = i < n;
      const int id_q = ids != nullptr && real ? __ldg(ids + i) : 0;
      mx[r] = -INFINITY;
#pragma unroll
      for (int t = 0; t < TN; ++t) {
        const int j = 32 * t + lane;
        float s = -INFINITY;
        if (j < n) {
          float a = bias != nullptr && real ? __ldg(bias + (size_t)i * n + j) : 0.f;
          if (ids != nullptr)
            a += real && id_key[t] != id_q ? -100.f : 0.f;
          else if (dense != nullptr)
            a += real ? __ldg(dense + (size_t)i * n + j) : 0.f;
          else if (causal)
            a += j > i ? -1e9f : 0.f;
          s = acc[r][t] + a;
        }
        acc[r][t] = s;
        mx[r] = fmaxf(mx[r], s);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], o));
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      sum[r] = 0.f;
#pragma unroll
      for (int t = 0; t < TN; ++t) {
        acc[r][t] = expf(acc[r][t] - mx[r]);
        sum[r] += acc[r][t];
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int r = 0; r < kRows; ++r) sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], o);
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int t = 0; t < TN; ++t) acc[r][t] = acc[r][t] / sum[r];
#pragma unroll
    for (int t = 0; t < TN; ++t)
#pragma unroll
      for (int r = 0; r < kRows; r += 4)
        *reinterpret_cast<float4*>(ps + (32 * t + lane) * kRows + r) =
            make_float4(acc[r][t], acc[r + 1][t], acc[r + 2][t], acc[r + 3][t]);
    __syncwarp();

    // O = P v over the real keys.
    float o[kRows][DC];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int cc = 0; cc < DC; ++cc) o[r][cc] = 0.f;
    int col[DC];
#pragma unroll
    for (int cc = 0; cc < DC; ++cc) col[cc] = lane + 32 * cc < d ? lane + 32 * cc : 0;
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      float p[kRows];
#pragma unroll
      for (int r = 0; r < kRows; r += 4)
        *reinterpret_cast<float4*>(p + r) = *reinterpret_cast<const float4*>(ps + j * kRows + r);
#pragma unroll
      for (int cc = 0; cc < DC; ++cc) {
        const float v = vs[j * d + col[cc]];
#pragma unroll
        for (int r = 0; r < kRows; ++r) o[r][cc] = fmaf(p[r], v, o[r][cc]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r0 + r >= n) break;
#pragma unroll
      for (int cc = 0; cc < DC; ++cc)
        if (lane + 32 * cc < d) rows.dst(item, h, r0 + r)[lane + 32 * cc] = o[r][cc];
    }
    // The next group's probabilities overwrite this group's buffer.
    __syncwarp();
  }
}

// Whether a kernel's shared-memory limit is raised yet, per instantiation
// and per translation unit.
namespace {
template <class Rows, int TN, int DC>
bool smem_raised = false;
}  // namespace

template <class Rows, int TN, int DC>
cudaError_t launch(const Rows& rows, const Addends& ad, int windows, int heads, int n, int d,
                   cudaStream_t s) {
  const Plan p = plan(TN, n, d);
  if (p.smem > (size_t)core::kSmemLimit) return cudaErrorInvalidValue;
  auto kernel = window_core_f32_kernel<Rows, TN, DC>;
  if (!smem_raised<Rows, TN, DC>) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             core::kSmemLimit);
    if (err != cudaSuccess) return err;
    smem_raised<Rows, TN, DC> = true;
  }
  // d^-0.5 as the JAX kernels take it: the double d ** -0.5, rounded to f32.
  const float scale = (float)std::pow((double)d, -0.5);
  kernel<<<dim3(windows, heads), p.warps * 32, p.smem, s>>>(rows, ad, n, d, scale, p.qs, p.ks,
                                                            p.kt_off, p.v_off, p.p_off);
  return cudaGetLastError();
}

// The core on `windows` x `heads` (window, head) items of N = n tokens and
// head dim d (a multiple of 8 up to 64; N up to 256); window w's mask is
// entry w % ad.nw. D32_ONLY layouts (K1's canvas) build d = 32 alone.
template <class Rows, bool D32_ONLY>
cudaError_t run(const Rows& rows, const Addends& ad, int windows, int heads, int n, int d,
                cudaStream_t s) {
  if (windows <= 0 || heads <= 0 || heads > 65535 || n <= 0 || n > 256 || d <= 0 || d > 64 ||
      d % 8 != 0 || ad.nw <= 0 || (D32_ONLY && d != 32) || ad.mask_kind < kNoMask ||
      ad.mask_kind > kCausal ||
      ((ad.mask_kind == kNoMask || ad.mask_kind == kCausal) != (ad.mask == nullptr)))
    return cudaErrorInvalidValue;
  const int tn = (n + 31) / 32;
  if (d <= 32 || D32_ONLY) {
    if (tn <= 2) return launch<Rows, 2, 1>(rows, ad, windows, heads, n, d, s);
    if (tn <= 5) return launch<Rows, 5, 1>(rows, ad, windows, heads, n, d, s);
    return launch<Rows, 8, 1>(rows, ad, windows, heads, n, d, s);
  }
  if constexpr (!D32_ONLY) {
    if (tn <= 2) return launch<Rows, 2, 2>(rows, ad, windows, heads, n, d, s);
    if (tn <= 5) return launch<Rows, 5, 2>(rows, ad, windows, heads, n, d, s);
    return launch<Rows, 8, 2>(rows, ad, windows, heads, n, d, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace core_f32
}  // namespace bt
