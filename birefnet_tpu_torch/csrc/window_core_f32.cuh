// The f32 window-attention core, shared by the f32 window-attention entry
// (K6, K7, K8: bt_flash_window_attn_f32 in flash_window_attn.cu) and the
// f32 fused Swin block (K1 and K1-int8 on f32 activations:
// bt_fused_block_attn_f32 and bt_fused_block_attn_i8_f32 in
// fused_block_attn.cu):
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
// exp(x - max) / sum in f32 (expf and an IEEE division, as PyTorch computes
// it), and P v sums f32 products.
//
// Arithmetic: both products run on the tensor cores as three TF32
// products (mma.sync m16n8k8 tf32, f32 accumulators): each f32 operand is
// split in registers into hi = x rounded to TF32 and lo = x - hi (which the
// tensor cores read truncated to TF32; common.cuh tf32_split), and a b is
// taken as lo_a hi_b + hi_a lo_b + hi_a hi_b, the small products first;
// what is dropped (lo_a lo_b and the truncation of the lo parts) is about
// 2^-21 |a b| per product at most, with random sign. PyTorch's TF32 flags do not govern this kernel. The scores' k sum
// is 3 d / 8 tensor-core additions (12 at d = 32); P v goes into a fresh
// accumulator every 64 keys, added to the output with an f32 add, so that
// no accumulator takes more than 24 of the tensor cores' truncating
// additions (see f32_gemm.cu).
//
// What bounds it on the card: per (window, head) 16 N d bytes (q, k, v
// read, the output written) against 4 N^2 d f32 operations, three TF32
// ones each: at N = 144, d = 32 that is 108 TF32 operations a byte, below
// the TF32 ridge of 148 (494.7 TFLOP/s over 3.35 TB/s), so the bytes bound
// it, about 1.45 ms per Swin-L forward (1.02 by operations).
//
// Design, after window_core.cuh:
// - Two warps share each 16-row query strip (18 at N = 144), each taking
//   half the key tiles: q k^T of its half lands in N/16 accumulator tiles
//   in registers (36 floats a thread at N = 144). The row max and sum take
//   two quad shuffles and one exchange with the other warp through shared
//   memory (a named barrier per pair); the two halves' P v sums are added
//   in f32 over the strip's q rows before the store. One warp per strip
//   (72 score registers, 9 warps an SM) ran 1.3x slower on the H100.
// - The probabilities go from the score tiles straight into P v's A
//   fragments: an m16n8 accumulator holds columns (2t, 2t + 1) where the
//   m16n8k8 A fragment wants columns (t, t + 4) (t = lane % 4), so A column
//   t is key 2t and column t + 4 key 2t + 1, and v's B fragment rows are
//   read in the same order (b0 = v[2t][g], b1 = v[2t + 1][g]); the sum over
//   keys does not depend on their order. No score or probability is
//   stored.
// - q, k and v are staged with 16-byte cp.async into tiles whose 16-byte
//   chunks are XOR-swizzled by row, so that every fragment load (q and k
//   by rows, v by keys) is free of bank conflicts. q s, k, v and P are
//   split as their fragments are loaded (splitting k and v once per window
//   into shared memory measured no faster).
// - A block takes one head over a run of R windows, sized so that the grid
//   is one round on the card's SMs, and copies the next window's rows
//   while the current one computes (two buffers where shared memory
//   allows). The head's bias is staged in shared memory once per block
//   (read from L2 in place where it does not fit: N > 144 at d = 64); a
//   dense mask is read from L2; region ids are staged per window.
// - The loops over key tiles, k slices and output tiles run to their
//   compile-time ends (tiles hold 8 NT rows, zero past N), with no branch
//   around an MMA: with a runtime guard per tile, ptxas issues each tile's
//   loads and three dependent MMAs alone behind a warp sync, and the core
//   ran 1.25x slower.
// Rows and columns at or past N never reach an output: pad keys get -inf,
// so probability 0, and pad query rows are not written.
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

// Per class of N (NT = n8 key tiles at most: 8 up to N = 64, 18 up to 144,
// 32 up to 256): warps per block at most (one per 16-row strip; N = 256
// runs 8 warps of two strips) and blocks per SM for the register budget.
__host__ __device__ constexpr int max_pairs(int nt) { return nt <= 8 ? 4 : (nt <= 18 ? 9 : 8); }
__host__ __device__ constexpr int min_blocks(int nt) { return nt <= 8 ? 2 : 1; }
// Row width of a staged tile in floats: d padded to 8, 16, 32 or 64.
__host__ __device__ constexpr int tile_width(int d) {
  return d <= 8 ? 8 : (d <= 16 ? 16 : (d <= 32 ? 32 : 64));
}

// Physical 16-byte chunk of logical chunk c in tile row r: the eight rows
// (or keys 2t, 2t + 1) a fragment load reads at one column land in
// distinct bank groups.
template <int DS>
__device__ __forceinline__ int swz(int r, int c) {
  constexpr int cpr = DS / 4;
  constexpr int sh = cpr == 2 ? 2 : (cpr == 4 ? 1 : 0);
  return c ^ ((r >> sh) & (cpr - 1));
}

__device__ __forceinline__ void mma1688(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Named barrier `id` over `n` threads (the two warps of a strip).
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// c += a b in three TF32 products, the small ones first.
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma1688(c, al, bh[0], bh[1]);
  mma1688(c, ah, bl[0], bl[1]);
  mma1688(c, ah, bh[0], bh[1]);
}

struct Plan {
  int R, runs, warps, nbuf, bld;
  size_t tile_floats, bias_off, ids_off, red_off, smem;
};

// Launch plan for N = n, head dim d, on `windows` x `heads` items: one
// head per block over a run of R windows, the runs sized so that the grid
// fits one round of the SMs' blocks; two copy buffers where R > 1 and
// shared memory allows. Tiles hold 8 NT rows (every key tile the kernel's
// unrolled loops touch), zero past N.
inline Plan plan(int nt, int n, int d, int windows, int heads, bool ids, bool bias) {
  Plan p{};
  const int nr = 8 * nt, strips = core::pad16(n) / 16;
  p.warps = 2 * (strips < max_pairs(nt) ? strips : max_pairs(nt));
  p.tile_floats = (size_t)nr * tile_width(d);
  const int slots = sm_count() * min_blocks(nt);
  int runs = slots / heads > 1 ? slots / heads : 1;
  runs = runs < windows ? runs : windows;
  p.R = (windows + runs - 1) / runs;
  p.runs = (windows + p.R - 1) / p.R;
  // The head's bias in rows of 8 NT + 8 floats (the rows of an accumulator
  // quad-row fall in distinct banks), where it fits beside the tiles;
  // else (N > 144 at d = 64) it is read from L2 in place (bld = 0).
  for (p.nbuf = p.R > 1 ? 2 : 1;; --p.nbuf) {
    for (p.bld = bias ? nr + 8 : 0;; p.bld = 0) {
      p.bias_off = align128((size_t)p.nbuf * 3 * p.tile_floats * 4);
      p.ids_off = align128(p.bias_off + (size_t)nr * p.bld * 4);
      p.red_off = align128(p.ids_off + (ids ? (size_t)p.nbuf * nr * 4 : 0));
      p.smem = p.red_off + (size_t)p.warps / 2 * 64 * 4;
      if (p.smem <= (size_t)core::kSmemLimit || p.bld == 0) break;
    }
    if (p.smem <= (size_t)core::kSmemLimit || p.nbuf == 1) break;
  }
  return p;
}

// One block: head blockIdx.y, windows [blockIdx.x R, +R). NT: n8 key tiles
// (8, 18 or 32); DS: tile width in floats. The loops over key tiles, k
// slices and output tiles run to their compile-time ends with no branch
// around the MMAs (tiles past N are zero and their scores -inf), so the
// tiles' loads, splits and MMAs interleave.
template <class Rows, int NT, int DS>
__global__ void __launch_bounds__(max_pairs(NT) * 64, min_blocks(NT))
window_core_f32_kernel(Rows rows, Addends ad, int windows, int n, int d, int R, int nbuf,
                       int bld, float scale, size_t tile_floats, size_t bias_off,
                       size_t ids_off, size_t red_off) {
  constexpr int KD = DS / 8;   // k8 slices of the head dim, n8 tiles of the output
  constexpr int cpr = DS / 4;  // 16-byte chunks of a tile row
  constexpr int NR = 8 * NT;   // tile rows
  constexpr int NH = NT / 2;   // key tiles of a warp: half of them
  extern __shared__ __align__(128) unsigned char smem[];
  float* tiles = reinterpret_cast<float*>(smem);
  float* bias_s = reinterpret_cast<float*>(smem + bias_off);
  int* ids_s = reinterpret_cast<int*>(smem + ids_off);

  const int mt = core::pad16(n) / 16;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // Warps 2p and 2p + 1 share a strip: keys of tiles [0, NH) and [NH, NT).
  const int pair = warp >> 1, hf = warp & 1, npairs = nthreads >> 6, j0 = hf * NH;
  float* rx = reinterpret_cast<float*>(smem + red_off) + 64 * pair;
  const int h = blockIdx.y;
  const int w0 = blockIdx.x * R;
  const int cnt = min(R, windows - w0);
  const bool ids = ad.mask_kind == kRegionIds;
  const bool causal = ad.mask_kind == kCausal;
  const float* bias = ad.bias != nullptr ? ad.bias + (size_t)h * n * n : nullptr;
  const bool staged = bld > 0;

  auto tile = [&](int buf, int part) -> float* {
    return tiles + (size_t)(buf * 3 + part) * tile_floats;
  };

  // Copy window w's q/k/v rows of head h into buffer buf (zero pad rows and
  // columns), and its region ids.
  auto prefetch = [&](int w, int buf) {
    const long long item = rows.item(w);
    for (int e = tid; e < NR * 3 * cpr; e += nthreads) {
      const int i = e / (3 * cpr), rem = e - i * (3 * cpr);
      const int part = rem / cpr, c = rem - part * cpr;
      const bool valid = i < n && c * 4 < d;
      const float* src = valid ? rows.in(part, item, h, i) + c * 4 : rows.in(0, item, h, 0);
      core::cp_async16(tile(buf, part) + i * DS + swz<DS>(i, c) * 4, src, valid);
    }
    if (ids) {  // pad tokens' ids are zero-filled: their columns get -inf anyway
      const int* src = static_cast<const int*>(ad.mask) + (size_t)(w % ad.nw) * n;
      for (int r = tid; r < NR; r += nthreads)
        core::cp_async4(ids_s + buf * NR + r, src + (r < n ? r : 0), r < n);
    }
  };

  // Window it + nbuf - 1 is requested while window it computes; every step
  // commits one group (empty past the end), so waiting for all but nbuf - 1
  // groups leaves window it's copies done. The head's bias is copied once
  // per block, in the first group.
  const int ahead = nbuf > 1 ? nbuf - 1 : 1;
  if (staged) {
    if (n % 4 == 0 && (reinterpret_cast<uintptr_t>(bias) & 15) == 0) {
      for (int e = tid; e < n * n / 4; e += nthreads) {
        const int r = e / (n / 4), c = e - r * (n / 4);
        core::cp_async16(bias_s + r * bld + 4 * c, bias + (size_t)r * n + 4 * c, true);
      }
    } else {
      for (int e = tid; e < n * n; e += nthreads) {
        const int r = e / n, c = e - r * n;
        core::cp_async4(bias_s + r * bld + c, bias + e, true);
      }
    }
  }
  for (int k = 0; k < ahead; ++k) {
    if (k < cnt) prefetch(w0 + k, k);
    asm volatile("cp.async.commit_group;\n");
  }

  for (int it = 0; it < cnt; ++it) {
    const int buf = it % nbuf, w = w0 + it, nxt = it + nbuf - 1;
    if (nxt >= ahead && nxt < cnt) prefetch(w0 + nxt, nxt % nbuf);
    asm volatile("cp.async.commit_group;\n");
    if (nbuf == 2)
      asm volatile("cp.async.wait_group 1;\n");
    else
      asm volatile("cp.async.wait_group 0;\n");
    __syncthreads();
    const long long item = rows.item(w);
    const int* idw = ids_s + buf * NR;
    const float* dense = ad.mask_kind == kMaskF32
                             ? static_cast<const float*>(ad.mask) + (size_t)(w % ad.nw) * n * n
                             : nullptr;

    for (int s = pair; s < mt; s += npairs) {
      // mma.sync needs every lane of the warp converged; the copies above
      // and the last strip's stores branch by lane.
      __syncwarp();
      float* qs = tile(buf, 0);
      const float* ks = tile(buf, 1);
      const float* vs = tile(buf, 2);
      const int r0 = 16 * s + g, r1 = r0 + 8;

      // Scores of this warp's half of the keys: tile j holds rows r0 / r1,
      // keys 8 (j0 + j) + 2t and + 1.
      float sc[NH][4];
#pragma unroll
      for (int j = 0; j < NH; ++j)
#pragma unroll
        for (int u = 0; u < 4; ++u) sc[j][u] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        // q s of the strip at columns 8kk + t (chunk 2kk) and 8kk + t + 4
        // (chunk 2kk + 1), split.
        const float x[4] = {qs[r0 * DS + swz<DS>(r0, 2 * kk) * 4 + t],
                            qs[r1 * DS + swz<DS>(r1, 2 * kk) * 4 + t],
                            qs[r0 * DS + swz<DS>(r0, 2 * kk + 1) * 4 + t],
                            qs[r1 * DS + swz<DS>(r1, 2 * kk + 1) * 4 + t]};
        uint32_t qh[4], ql[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) tf32_split(__fmul_rn(x[u], scale), qh[u], ql[u]);
#pragma unroll
        for (int j = 0; j < NH; ++j) {
          const int kr = 8 * (j0 + j) + g;
          uint32_t kh[2], kl[2];
          tf32_split(ks[kr * DS + swz<DS>(kr, 2 * kk) * 4 + t], kh[0], kl[0]);
          tf32_split(ks[kr * DS + swz<DS>(kr, 2 * kk + 1) * 4 + t], kh[1], kl[1]);
          mma3(sc[j], qh, ql, kh, kl);
        }
      }

      // Addends (bias + mask, summed first, as the JAX kernels sum them)
      // and the row max. Pad keys (at or past n) get -inf, so probability 0.
      const int id0 = ids ? idw[r0] : 0, id1 = ids ? idw[r1] : 0;
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < NH; ++j) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int r = u < 2 ? r0 : r1, cc = 8 * (j0 + j) + 2 * t + (u & 1);
          const bool real = r < n && cc < n;
          float a = 0.f;
          if (staged)
            a = real ? bias_s[r * bld + cc] : 0.f;
          else if (bias != nullptr)
            a = real ? __ldg(bias + (size_t)r * n + cc) : 0.f;
          if (ids)
            a += idw[cc] != (u < 2 ? id0 : id1) ? -100.f : 0.f;
          else if (dense != nullptr)
            a += real ? __ldg(dense + (size_t)r * n + cc) : 0.f;
          else if (causal)
            a += cc > r ? -1e9f : 0.f;
          sc[j][u] = cc < n ? sc[j][u] + a : -INFINITY;
        }
        mx0 = fmaxf(mx0, fmaxf(sc[j][0], sc[j][1]));
        mx1 = fmaxf(mx1, fmaxf(sc[j][2], sc[j][3]));
      }
      // The row max over both halves: the quad's, then the other warp's
      // through shared memory (rx: [half][max, sum][16 rows] per pair).
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      if (t == 0) {
        rx[32 * hf + g] = mx0;
        rx[32 * hf + g + 8] = mx1;
      }
      bar_sync(1 + pair, 64);
      mx0 = fmaxf(mx0, rx[32 * (hf ^ 1) + g]);
      mx1 = fmaxf(mx1, rx[32 * (hf ^ 1) + g + 8]);
      // The softmax in f32: exp(x - max) by expf, the sum over both halves,
      // normalized by division.
      float l0 = 0.f, l1 = 0.f;
#pragma unroll
      for (int j = 0; j < NH; ++j) {
        sc[j][0] = expf(sc[j][0] - mx0);
        sc[j][1] = expf(sc[j][1] - mx0);
        sc[j][2] = expf(sc[j][2] - mx1);
        sc[j][3] = expf(sc[j][3] - mx1);
        l0 += sc[j][0] + sc[j][1];
        l1 += sc[j][2] + sc[j][3];
      }
      l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
      l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
      if (t == 0) {
        rx[32 * hf + 16 + g] = l0;
        rx[32 * hf + 24 + g] = l1;
      }
      bar_sync(1 + pair, 64);
      l0 += rx[32 * (hf ^ 1) + 16 + g];
      l1 += rx[32 * (hf ^ 1) + 24 + g];

      // O = P v over this warp's keys. Key slice j: A column t is key
      // 8 (j0 + j) + 2t, column t + 4 the next key; v's B rows in the same
      // order. Every 8 slices (64 keys) the slice sums are added to the
      // output in f32.
      float o[KD][4], part[KD][4];
#pragma unroll
      for (int jd = 0; jd < KD; ++jd)
#pragma unroll
        for (int u = 0; u < 4; ++u) o[jd][u] = part[jd][u] = 0.f;
#pragma unroll
      for (int j = 0; j < NH; ++j) {
        uint32_t ph[4], pl[4];
        tf32_split(sc[j][0] / l0, ph[0], pl[0]);
        tf32_split(sc[j][2] / l1, ph[1], pl[1]);
        tf32_split(sc[j][1] / l0, ph[2], pl[2]);
        tf32_split(sc[j][3] / l1, ph[3], pl[3]);
        const int vr = 8 * (j0 + j) + 2 * t;
#pragma unroll
        for (int jd = 0; jd < KD; ++jd) {
          const int c = 2 * jd + (g >> 2), e = g & 3;
          uint32_t vh[2], vl[2];
          tf32_split(vs[vr * DS + swz<DS>(vr, c) * 4 + e], vh[0], vl[0]);
          tf32_split(vs[(vr + 1) * DS + swz<DS>(vr + 1, c) * 4 + e], vh[1], vl[1]);
          mma3(part[jd], ph, pl, vh, vl);
        }
        if ((j & 7) == 7 || j == NH - 1) {
#pragma unroll
          for (int jd = 0; jd < KD; ++jd)
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              o[jd][u] = __fadd_rn(o[jd][u], part[jd][u]);
              part[jd][u] = 0.f;
            }
        }
      }

      // The two halves' sums meet over the strip's q rows (both warps are
      // past their q reads): the second half stages its sums there, the
      // first adds its own and stores the rows as 16-byte chunks.
      if (hf == 1) {
#pragma unroll
        for (int jd = 0; jd < KD; ++jd) {
          const int c = 2 * jd + (t >> 1), e = 2 * (t & 1);
          *reinterpret_cast<float2*>(qs + r0 * DS + swz<DS>(r0, c) * 4 + e) =
              make_float2(o[jd][0], o[jd][1]);
          *reinterpret_cast<float2*>(qs + r1 * DS + swz<DS>(r1, c) * 4 + e) =
              make_float2(o[jd][2], o[jd][3]);
        }
      }
      bar_sync(1 + pair, 64);
      if (hf == 0) {
#pragma unroll
        for (int jd = 0; jd < KD; ++jd) {
          const int c = 2 * jd + (t >> 1), e = 2 * (t & 1);
          float2* p0 = reinterpret_cast<float2*>(qs + r0 * DS + swz<DS>(r0, c) * 4 + e);
          float2* p1 = reinterpret_cast<float2*>(qs + r1 * DS + swz<DS>(r1, c) * 4 + e);
          const float2 a0 = *p0, a1 = *p1;
          *p0 = make_float2(__fadd_rn(o[jd][0], a0.x), __fadd_rn(o[jd][1], a0.y));
          *p1 = make_float2(__fadd_rn(o[jd][2], a1.x), __fadd_rn(o[jd][3], a1.y));
        }
        __syncwarp();
        for (int e = lane; e < 16 * cpr; e += 32) {
          const int i = 16 * s + e / cpr, c = e % cpr;
          if (i < n && c * 4 < d)
            *reinterpret_cast<float4*>(rows.dst(item, h, i) + c * 4) =
                *reinterpret_cast<const float4*>(qs + i * DS + swz<DS>(i, c) * 4);
        }
      }
    }
    __syncthreads();
  }
}

// Whether a kernel's shared-memory limit is raised yet, per instantiation,
// per device (common.cuh) and per translation unit.
namespace {
template <class Rows, int NT, int DS>
bool smem_raised[kMaxDevices];
}  // namespace

template <class Rows, int NT, int DS>
cudaError_t launch(const Rows& rows, const Addends& ad, int windows, int heads, int n, int d,
                   cudaStream_t s) {
  const Plan p = plan(NT, n, d, windows, heads, ad.mask_kind == kRegionIds, ad.bias != nullptr);
  if (p.smem > (size_t)core::kSmemLimit) return cudaErrorInvalidValue;
  auto kernel = window_core_f32_kernel<Rows, NT, DS>;
  const cudaError_t err = once_per_device(smem_raised<Rows, NT, DS>, [&] {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                core::kSmemLimit);
  });
  if (err != cudaSuccess) return err;
  // d^-0.5 as the JAX kernels take it: the double d ** -0.5, rounded to f32.
  const float scale = (float)std::pow((double)d, -0.5);
  kernel<<<dim3(p.runs, heads), p.warps * 32, p.smem, s>>>(
      rows, ad, windows, n, d, p.R, p.nbuf, p.bld, scale, p.tile_floats, p.bias_off, p.ids_off,
      p.red_off);
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
  const int nt = (n + 7) / 8, ds = tile_width(d);
#define BT_CORE_F32_CASE(NT, DS)                                         \
  if (nt <= NT && ds == DS && (!D32_ONLY || DS == 32))                   \
    return launch<Rows, NT, (D32_ONLY ? 32 : DS)>(rows, ad, windows, heads, n, d, s);
#define BT_CORE_F32_CLASS(NT) \
  BT_CORE_F32_CASE(NT, 8) BT_CORE_F32_CASE(NT, 16) BT_CORE_F32_CASE(NT, 32) BT_CORE_F32_CASE(NT, 64)
  BT_CORE_F32_CLASS(8)
  BT_CORE_F32_CLASS(18)
  BT_CORE_F32_CLASS(32)
#undef BT_CORE_F32_CLASS
#undef BT_CORE_F32_CASE
  return cudaErrorInvalidValue;
}

}  // namespace core_f32


// The key-tiled f32 core: the f32 branch of K6-K8 at the shapes the core
// above does not take (N > 256, a head dim above 64, or a padded head dim
// with its true d^-0.5 given), on core_tiled's block walk, producer warp,
// mbarrier ring and tensor maps (window_core.cuh): blocks of 64 query rows
// walk the keys in tiles of 32 twice, pass 1 for each row's max and sum of
// exp(s - max) in f32 (rescaled at each new max), pass 2 recomputing the
// scores for exp(s - m) / l, kept in f32 and split for 3xTF32, and P v.
// The scale, the bias and a dense mask are unrounded f32, region ids give
// -100, the causal flag -1e9. Small grids split each block's key walk
// between two consumer warpgroups as core_tiled does (not at 128 output
// columns, whose 252 registers a thread leave no room for them). Bound:
// 3 x 6 N^2 d TF32 operations (q k^T twice, P v) against 16 N d bytes and
// the addends: the tensor cores at N = 1024, d = 128, latency at the small
// API shapes.
//
// Every product runs as three TF32 products (hi/lo splits, lo_a hi_b +
// hi_a lo_b + hi_a hi_b, as above):
// - q k^T is wgmma m64n32k8.tf32 with both operands from 128-byte-swizzled
//   shared memory. q s is split once per block, in place (hi) and into a lo
//   scratch: q is reused by every key tile, so neither registers nor a
//   per-tile split go to it (where d > 128 its columns stream with k's and
//   are split per stage). Each stage's k columns are split once, by the
//   consumer warpgroup (hi in place, lo into a scratch), where the earlier
//   body split every k fragment in each of its four warps.
// - P v stays on mma.sync m16n8k8: tf32 wgmma reads both operands K-major,
//   and v's tile is [keys, dv], so a wgmma P v would need each v tile
//   transposed and split into two more shared-memory tiles per stage, which
//   at d = 128 do not fit beside q's hi/lo, the k scratch and a two-stage
//   ring (the block then holds 176 of its 227 KB). The probabilities go
//   from the score accumulators (the wgmma accumulator layout is the
//   m16n8 one, per warp) straight into A fragments, key 8j + 2t in column
//   t and 8j + 2t + 1 in column t + 4, and v's B fragments are read in the
//   same key order from the TMA tile (conflict-free under its swizzle) and
//   split as they are loaded.
// - The fold rule of the earlier body stands: q k^T takes a fresh
//   accumulator per 32 columns of d and P v one per key tile of 32, each
//   added in f32, so that no accumulator takes more than 12 of the tensor
//   cores' truncating additions (tools/tf32_accum_model.py); the products
//   are issued in the same order, so the fold is the same.
namespace core_f32_tiled {

namespace ct = core_tiled;

// x s split into TF32 hi (in place) and lo (at the same offset in lo):
// `chunks` 16-byte pieces (a multiple of `threads`), by consumer threads
// tid < threads, every thread the same count.
__device__ __forceinline__ void split(uint8_t* hi, uint8_t* lo, int chunks, float s, int tid,
                                      int threads) {
  for (int e0 = 0; e0 < chunks; e0 += threads) {
    const int e = e0 + tid;
    float4 x = *reinterpret_cast<const float4*>(hi + 16 * e);
    uint32_t h[4], l[4];
    tf32_split(__fmul_rn(x.x, s), h[0], l[0]);
    tf32_split(__fmul_rn(x.y, s), h[1], l[1]);
    tf32_split(__fmul_rn(x.z, s), h[2], l[2]);
    tf32_split(__fmul_rn(x.w, s), h[3], l[3]);
    *reinterpret_cast<uint4*>(hi + 16 * e) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(lo + 16 * e) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// One block (core_tiled::block_item): one consumer warpgroup, or two that
// take every other key tile (p.cwg = 2), and the producer warp after them.
// DV: output columns, 32, 64 or 128 (one to four column blocks of v); at
// 128 the block is never split: its 252 registers a thread leave no room
// for a second warpgroup.
template <class Rows, int DV>
__global__ void __launch_bounds__(DV == 128 ? ct::kConsumers + 32 : ct::kBoundThreads, 1)
window_f32_tiled_kernel(const __grid_constant__ ct::Maps maps,
                        const __grid_constant__ ct::Params p, const Rows rows) {
  constexpr int KT = ct::Tile<float>::kKeys, OT = DV / 8;
  constexpr int kKeyBlock = KT * 128;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (ring::smem_u32(smem_raw) + 1023) & ~1023u;
  uint8_t* sm = smem_raw + (base - ring::smem_u32(smem_raw));
  const ct::Layout& L = p.L;
  int w, h, row0, nkt;
  ct::block_item<KT>(p, w, h, row0, nkt);
  ct::init_barriers(p, base);
  const int wg = ct::role();
  if (wg == p.cwg) {
    ct::produce<float>(maps, p, base, w, h, row0, nkt);
    return;
  }

  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int tid = threadIdx.x & (ct::kConsumers - 1);
  const int g = lane >> 2, t = lane & 3, n = p.n;
  const int rr0 = 16 * warp + g, r0 = row0 + rr0, r1 = r0 + 8;
  const int ngrp = (p.nqb + 3) / 4;
  const int* idw = p.kind == kRegionIds ? p.ids + (size_t)(w % p.nw) * n : nullptr;
  const int id0 = idw != nullptr && r0 < n ? __ldg(idw + r0) : 0;
  const int id1 = idw != nullptr && r1 < n ? __ldg(idw + r1) : 0;
  const ct::AddendRows ar = ct::addend_rows<KT>(p, w, h, row0, rr0);
  // This warpgroup's lo scratch: q's where it streams, and k's.
  const int qlo = L.qlo + wg * L.qlo_wg, klo = L.klo + wg * L.klo_wg;
  if (L.qres >= 0) {  // q split once, by every consumer thread
    ring::mbar_wait(base + L.bars + 16 * L.stages, 0);
    split(sm + L.qres, sm + L.qlo, p.nqb * ct::kRows * 8, p.scale, threadIdx.x,
          p.cwg * ct::kConsumers);
    ring::fence_proxy_async();
    ring::bar_sync(1, p.cwg * ct::kConsumers);
  }

  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f, inv0 = 0.f, inv1 = 0.f;
  float S[16], part[16], o[OT][4];
#pragma unroll
  for (int jd = 0; jd < OT; ++jd)
#pragma unroll
    for (int u = 0; u < 4; ++u) o[jd][u] = 0.f;
  ct::Cursor cur(wg * (L.stages / p.cwg), L.stages / p.cwg);
  for (int pass = 0; pass < 2; ++pass) {
    for (int kt = wg; kt < nkt; kt += p.cwg) {
      for (int gi = 0; gi < ngrp; ++gi, cur.next()) {
        const uint32_t full = base + L.bars + 8 * cur.slot, empty = full + 8 * L.stages;
        const uint32_t st = base + L.ring + cur.slot * L.stage;
        uint8_t* sp = sm + (st - base);
        const int kb = min(4, p.nqb - 4 * gi);
        ring::mbar_wait(full, cur.parity);
        // Every warp of the warpgroup is past its last wgmma on the lo
        // scratch before it is written again.
        ring::bar_sync(2 + wg, ct::kConsumers);
        uint32_t qh = base + L.qres;
        if (L.q >= 0) {  // q's columns of this group, streamed: split here
          split(sp + L.q, sm + qlo, kb * ct::kRows * 8, p.scale, tid, ct::kConsumers);
          qh = st + L.q;
        }
        split(sp + L.k, sm + klo, kb * KT * 8, 1.f, tid, ct::kConsumers);
        ring::fence_proxy_async();
        ring::bar_sync(2 + wg, ct::kConsumers);
        // S = q s k^T, a fresh accumulator per column block of 32 added in
        // f32; per k8 step lo_q hi_k, hi_q lo_k, hi_q hi_k.
        for (int b = 0; b < kb; ++b) {
          const int cols = min(32, p.dqk - (4 * gi + b) * 32);
          const uint64_t dqh = ring::sw128_desc(qh + b * ct::kBlock);
          const uint64_t dql = ring::sw128_desc(base + qlo + b * ct::kBlock);
          const uint64_t dkh = ring::sw128_desc(st + L.k + b * kKeyBlock);
          const uint64_t dkl = ring::sw128_desc(base + klo + b * kKeyBlock);
          ring::fence_acc(part);
          ring::wgmma_fence();
          for (int kk = 0; 8 * kk < cols; ++kk) {
            ring::wgmma_tf32_n32(part, dql + 2 * kk, dkh + 2 * kk, kk != 0);
            ring::wgmma_tf32_n32(part, dqh + 2 * kk, dkl + 2 * kk, 1);
            ring::wgmma_tf32_n32(part, dqh + 2 * kk, dkh + 2 * kk, 1);
          }
          ring::wgmma_commit();
          ring::wgmma_wait<0>();
          ring::fence_acc(part);
          const bool first = gi == 0 && b == 0;
#pragma unroll
          for (int e = 0; e < 16; ++e) S[e] = first ? part[e] : __fadd_rn(S[e], part[e]);
        }
        if (gi + 1 < ngrp) {
          __syncwarp();
          if (lane == 0) ring::mbar_arrive(empty);
          continue;
        }

        // The addends, unrounded (pad keys -inf).
        ct::score_epilogue<false, KT>(p, sp, ar, kt, row0, rr0, id0, id1, S);
        if (pass == 0) {
          float x0 = -INFINITY, x1 = -INFINITY;
#pragma unroll
          for (int j = 0; j < KT / 8; ++j) {
            x0 = fmaxf(x0, fmaxf(S[4 * j], S[4 * j + 1]));
            x1 = fmaxf(x1, fmaxf(S[4 * j + 2], S[4 * j + 3]));
          }
          x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, 1));
          x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, 2));
          x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, 1));
          x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, 2));
          const float n0 = fmaxf(m0, x0), n1 = fmaxf(m1, x1);
          float s0 = 0.f, s1 = 0.f;
#pragma unroll
          for (int j = 0; j < KT / 8; ++j) {
            s0 += expf(S[4 * j] - n0) + expf(S[4 * j + 1] - n0);
            s1 += expf(S[4 * j + 2] - n1) + expf(S[4 * j + 3] - n1);
          }
          s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
          s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
          s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
          s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
          l0 = l0 * expf(m0 - n0) + s0;
          l1 = l1 * expf(m1 - n1) + s1;
          m0 = n0;
          m1 = n1;
        } else {
          // O += P v with P = exp(s - m) (1 / l) in f32 (within an ulp of
          // the plain version's exp(s - m) / l, with one division a row);
          // the tile's sums in a fresh accumulator, added to O in f32. v
          // (key kr, column c) of the TMA tile: block c / 32, row kr, chunk
          // (c % 32) / 4 ^ kr % 8.
          const uint8_t* vt = sp + L.v;
          float pt[OT][4];
#pragma unroll
          for (int jd = 0; jd < OT; ++jd)
#pragma unroll
            for (int u = 0; u < 4; ++u) pt[jd][u] = 0.f;
#pragma unroll
          for (int j = 0; j < KT / 8; ++j) {
            uint32_t ph[4], pl[4];
            tf32_split(expf(S[4 * j] - m0) * inv0, ph[0], pl[0]);
            tf32_split(expf(S[4 * j + 2] - m1) * inv1, ph[1], pl[1]);
            tf32_split(expf(S[4 * j + 1] - m0) * inv0, ph[2], pl[2]);
            tf32_split(expf(S[4 * j + 3] - m1) * inv1, ph[3], pl[3]);
            const int kr = 8 * j + 2 * t;
#pragma unroll
            for (int jd = 0; jd < OT; ++jd) {
              const int chunk = 2 * (jd & 3) + (g >> 2);
              const uint8_t* col = vt + (jd >> 2) * kKeyBlock + ((g & 3) << 2);
              uint32_t vh[2], vl[2];
              tf32_split(*reinterpret_cast<const float*>(col + kr * 128 + ((chunk ^ (kr & 7)) << 4)),
                         vh[0], vl[0]);
              tf32_split(*reinterpret_cast<const float*>(col + (kr + 1) * 128 +
                                                         ((chunk ^ ((kr + 1) & 7)) << 4)),
                         vh[1], vl[1]);
              core_f32::mma3(pt[jd], ph, pl, vh, vl);
            }
          }
#pragma unroll
          for (int jd = 0; jd < OT; ++jd)
#pragma unroll
            for (int u = 0; u < 4; ++u) o[jd][u] = __fadd_rn(o[jd][u], pt[jd][u]);
        }
        __syncwarp();
        if (lane == 0) ring::mbar_arrive(empty);
      }
    }
    if (pass == 0 && p.cwg == 2) {
      float m[2] = {m0, m1}, l[2] = {l0, l1};
      ct::merge_stats<true>(sm, L, wg, m, l);
      m0 = m[0], m1 = m[1], l0 = l[0], l1 = l[1];
    }
    inv0 = 1.f / l0;
    inv1 = 1.f / l1;
  }
  if (p.cwg == 2 && !ct::merge_out(sm, L, wg, o)) return;

#pragma unroll
  for (int jd = 0; jd < OT; ++jd) {
    const int col = 8 * jd + 2 * t;
    if (col >= p.dv) continue;
    if (r0 < n)
      *reinterpret_cast<float2*>(rows.dst(w, h, r0) + col) = make_float2(o[jd][0], o[jd][1]);
    if (r1 < n)
      *reinterpret_cast<float2*>(rows.dst(w, h, r1) + col) = make_float2(o[jd][2], o[jd][3]);
  }
}

// Whether a kernel's shared-memory limit is raised yet, per instantiation,
// per device and per translation unit.
namespace {
template <class Rows, int DV>
bool smem_raised[kMaxDevices];
}  // namespace

template <class Rows, int DV>
cudaError_t launch(const Rows& rows, const Addends& ad, int windows, int heads, int n, int dqk,
                   int dv, float scale, cudaStream_t s) {
  ct::Maps maps;
  ct::Params p;
  int blocks = 0;
  cudaError_t err = ct::prepare<float>(rows, ad, windows, heads, n, dqk, dv, DV, DV < 128, scale,
                                       -1e9f, maps, p, blocks);
  if (err != cudaSuccess) return err;
  auto kernel = window_f32_tiled_kernel<Rows, DV>;
  err = once_per_device(smem_raised<Rows, DV>, [&] {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                core::kSmemLimit);
  });
  if (err != cudaSuccess) return err;
  kernel<<<blocks, p.cwg * ct::kConsumers + 32, p.L.bytes, s>>>(maps, p, rows);
  return cudaGetLastError();
}

// The f32 branch of K6-K8 on `windows` x `heads` items of any N = n: q k^T
// over dqk columns (a multiple of 8), dv <= 128 output columns (a multiple
// of 8) of v's and out's views, scores scaled by `scale`. Every pointer and
// stride 16-byte aligned, as the tensor maps need.
template <class Rows>
cudaError_t run(const Rows& rows, const Addends& ad, int windows, int heads, int n, int dqk,
                int dv, float scale, cudaStream_t s) {
  if (dv <= 32) return launch<Rows, 32>(rows, ad, windows, heads, n, dqk, dv, scale, s);
  if (dv <= 64) return launch<Rows, 64>(rows, ad, windows, heads, n, dqk, dv, scale, s);
  return launch<Rows, 128>(rows, ad, windows, heads, n, dqk, dv, scale, s);
}

}  // namespace core_f32_tiled
}  // namespace bt
