// Window-attention core shared by the window-attention kernels (K6, K7, K8:
// flash_window_attn.cu) and the fused Swin block (K1 and K1-int8:
// fused_block_attn.cu):
//
//   out[w, h] = bf16(bf16(softmax_f32(bf16(q * s) k^T + (bf16(bias[h])
//                                      + bf16(mask[w % nW])))) v)
//
// with s = bf16(d^-0.5), for every window w and head h. It replaces the
// attention part of birefnet_tpu/ops/pallas/fused_block_attn.py::_kernel
// and the three Pallas kernels of birefnet_tpu/ops/pallas/flash_window_attn.py
// (_flash_qkv, _flash_masked, _flash_plain), which compute this one
// function on their layouts.
//
// What bounds it on the card: per (window, head) it reads 3 N d and writes
// N d bf16 values and does 4 N^2 d flops; at N = 144, d = 32 that is about
// 70 flops per byte, at N = 49 about 25, both far below the H100's ridge
// (~295). So it is bound by device-memory bytes, and where a grid is short,
// by latency. The design answers that:
//
// - Scores stay in registers. Each warp owns a 16-row query strip and runs
//   mma.sync.m16n8k16 (bf16 in, f32 accumulators): q k^T lands in N/8
//   accumulator tiles (72 floats a thread at N = 144), the row max and sum
//   take two quad shuffles, exp is the hardware ex2 (__expf), the
//   probabilities are normalized (times 1 / sum), rounded to bf16 and
//   repacked, two n8 accumulator tiles to one k16 A fragment, for
//   P v. k and v fragments come from shared memory by ldmatrix (.trans for
//   v). No score or probability strip ever sits in shared memory.
// - The rel-pos bias is read once per block. A block takes one group of G
//   heads over a run of R windows and stages the G heads' f32 bias in
//   shared memory as bf16 before its first window ([N, N + 8], so that the
//   eight rows a quad-row of the accumulator reads fall in distinct banks),
//   through registers, with the first window's copies in flight. The
//   SW-MSA mask comes as per-token region ids, N int32 per window, and
//   mask(i, j) = -100 where the ids of tokens i and j differ; an arbitrary
//   dense mask (K7's API) is read from L2 in place, and a causal flag
//   (flash_attention) needs no memory at all.
// - Warps are balanced: a block has one warp per strip of its G heads (9
//   at N = 144, 4 G at N = 49), so no round leaves a warp idle; N = 256
//   runs 8 warps of two strips each. Two blocks of 9 warps share an SM
//   (96 registers a thread; ptxas spills a few values at N = 144).
// - Copies overlap compute: the q/k/v rows of the next window are copied
//   with cp.async into the second of two buffers while the current window
//   computes. A group of G heads (G d up to 128 elements) is copied as
//   contiguous 16-byte chunks, so K6 reads runs of G head slices out of
//   its packed [B_, N, 3C] rows; the tiles are XOR-swizzled by 16-byte
//   chunk so ldmatrix reads them without bank conflicts.
// - R is the shortest run of windows (up to 32) that fits the grid in one
//   round of 264 blocks, two per SM, so a call has no partial second wave
//   and long calls amortize the bias staging over many windows, while short
//   grids (Swin-L's stage 3: 8 windows x 48 heads) keep one window a block.
//   Above N = 144 (K7's API at N <= 256) the bias does not fit beside the
//   tiles: such blocks take one window each and read the bias from device
//   memory once, in place.
// - The main path's addend forms (bias staged, no mask or region ids) and
//   a dense f32 mask get lean epilogues of their own; the other forms of
//   K6-K8's API (causal, no bias, N > 144, d other than 32) share a generic
//   one. K1 takes the lean forms only, so its layout builds no generic
//   kernel.
//
// Rounding points, those of the JAX kernels and of the plain versions
// (ops/attention.py::window_attention with round_addends): q * s rounded to
// bf16 with s rounded to bf16 first; scores f32; the bias and the mask
// rounded to bf16 and summed in f32 before they are added; softmax
// exp(x - max) / sum in f32, normalized before the probabilities are
// rounded to bf16; P v summed in f32 and rounded to bf16. exp by ex2 and
// the reciprocal of the sum differ from the plain version's by an f32 ulp
// or two, as sums in another order do. The mask
// constant is -100 (a region-id mismatch) and the causal addend bf16(-1e9).
// For N not a multiple of 16, pad keys get probability 0 and pad query rows
// are never written.
//
// Two layouts find a window's rows, as a template argument:
// - StridedRows: element strides (window, head, token) for q, k, v and the
//   output, for K6's packed [B_, N, 3C] rows and K7/K8's [B_, heads, N, d];
// - CanvasRows: K1's padded NHWC canvas; token i of window w sits at row
//   wr0 + i / ws, column wc0 + i % ws of the [B, Hp, Wp, 3C] qkv scratch,
//   and its output at the same place in [B, Hp, Wp, C].
// Their kernels have distinct names, so a profile tells K1's share of the
// core's time from K6's.
#pragma once

#include <cstring>

#include "common.cuh"

namespace bt {

enum MaskKind : int {
  kNoMask = 0,
  kMaskF32 = 1,    // dense [nW, N, N] f32
  kRegionIds = 2,  // [nW, N] int32; mask -100 where the ids differ
  kCausal = 3,     // bf16(-1e9) where a key lies after its query
};

// The score addends: bias [heads, N, N] f32 (or null for none) and the
// mask of window w, which is entry w % nw of `mask`.
struct Addends {
  const float* bias;
  const void* mask;
  int mask_kind;
  int nw;
};

// Element strides of one operand: window, head, token (head dim contiguous).
struct Strides {
  long long window, head, token;
};

struct StridedRows {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* out;
  Strides sq, sk, sv, so;
  // The window's offset, computed once per window.
  __device__ __forceinline__ long long item(int w) const { return w; }
  __device__ __forceinline__ const bf16* in(int part, long long w, int h, int i) const {
    // Scalar selects, so that no copy of the struct goes to local memory.
    const bf16* base = part == 0 ? q : (part == 1 ? k : v);
    const long long sw = part == 0 ? sq.window : (part == 1 ? sk.window : sv.window);
    const long long sh = part == 0 ? sq.head : (part == 1 ? sk.head : sv.head);
    const long long st = part == 0 ? sq.token : (part == 1 ? sk.token : sv.token);
    return base + w * sw + h * sh + i * st;
  }
  __device__ __forceinline__ bf16* dst(long long w, int h, int i) const {
    return out + w * so.window + h * so.head + i * so.token;
  }
};

struct CanvasRows {
  const bf16* qkv;  // [B, Hp, Wp, 3C]
  bf16* out;        // [B, Hp, Wp, C]
  int Hp, Wp, C, ws;
  int ws_inv;       // ceil(2^16 / ws): i / ws = (i * ws_inv) >> 16 for i < ws^2
  // The canvas token of the window's first row and column.
  __device__ __forceinline__ long long item(int w) const {
    const int wc = Wp / ws, nwin = (Hp / ws) * wc;
    const int b = w / nwin, win = w - b * nwin;
    const int wr = win / wc;
    return ((long long)b * Hp + wr * ws) * Wp + (win - wr * wc) * ws;
  }
  __device__ __forceinline__ long long token(long long base, int i) const {
    const int r = (i * ws_inv) >> 16;
    return base + (long long)r * Wp + (i - r * ws);
  }
  __device__ __forceinline__ const bf16* in(int part, long long base, int h, int i) const {
    return qkv + token(base, i) * 3 * C + part * C + h * 32;
  }
  __device__ __forceinline__ bf16* dst(long long base, int h, int i) const {
    return out + token(base, i) * C + h * 32;
  }
};

namespace core {

constexpr int kMaxRun = 32;         // windows per block
constexpr int kTargetBlocks = 264;  // two blocks per SM on 132 SMs
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may use

// Per class of N (NT = n8 tiles of the padded N: 8 up to N = 64, 18 up to
// 144, 32 up to 256): warps per block at most, and blocks per SM for the
// register budget (two blocks of 9 warps leave 96 registers a thread).
__host__ __device__ constexpr int max_warps(int nt) { return nt <= 8 ? 12 : (nt <= 18 ? 9 : 8); }
__host__ __device__ constexpr int min_blocks(int nt) { return nt <= 18 ? 2 : 1; }
__host__ __device__ constexpr bool stages_bias(int nt) { return nt <= 18; }
// Copy stages: q/k/v buffers of windows in flight (one block a window
// above N = 144).
__host__ __device__ constexpr int stages(int nt) { return nt <= 18 ? 2 : 1; }

// How a kernel finds its addends: the main path's two forms (bias staged in
// shared memory, no mask or region ids) and a dense f32 mask of even N
// (read in pairs from L2) get lean epilogues; every other form (no bias,
// N > 144, an odd-N dense mask, causal, d other than 32) takes the generic
// one, which only K6-K8's layout builds.
enum Mode : int { kStagedNoMask = 0, kStagedIds = 1, kStagedDense = 2, kGeneric = 3 };

// Row width of a q/k/v tile in elements: 16, 32 or 64 (d padded to one of
// them), a power of two of 16-byte chunks.
__host__ __device__ constexpr int tile_width(int d) { return d <= 16 ? 16 : (d <= 32 ? 32 : 64); }

// Physical 16-byte chunk of logical chunk c in tile row r: eight rows read
// at one logical chunk (an ldmatrix phase) land in eight distinct 16-byte
// bank groups.
template <int DS>
__device__ __forceinline__ int swz(int r, int c) {
  constexpr int cpr = DS / 8;
  constexpr int sh = cpr == 2 ? 2 : (cpr == 4 ? 1 : 0);
  return c ^ ((r >> sh) & (cpr - 1));
}

__host__ __device__ inline int pad16(int v) { return (v + 15) & ~15; }

struct Plan {
  int G, R, warps, nbuf, runs, groups;
  size_t smem, bias_off, ids_off, tile_elems;
};

// Launch plan for N = n, head dim d, on `windows` x `heads` work items.
// heads_contiguous: the heads' slices sit side by side in a row (packed
// layouts), where a group of G heads copies as one run.
inline Plan plan(int nt, int n, int d, int windows, int heads, bool heads_contiguous,
                 bool staged_bias, bool ids) {
  Plan p{};
  const int np = pad16(n), mt = np / 16;
  p.G = 1;
  if (heads_contiguous)
    for (int g = 2; g <= 4; ++g)
      if (heads % g == 0 && g * d <= 128 && g * mt <= max_warps(nt)) p.G = g;
  p.groups = heads / p.G;
  const int strips = p.G * mt;
  p.warps = strips <= max_warps(nt) ? strips : max_warps(nt);
  // The fewest windows per block that fit the work in one round of
  // kTargetBlocks blocks (no second, partial wave), at most kMaxRun.
  const long long r = ((long long)windows * p.groups + kTargetBlocks - 1) / kTargetBlocks;
  p.R = stages_bias(nt) ? (int)(r > kMaxRun ? kMaxRun : r) : 1;
  p.runs = (windows + p.R - 1) / p.R;
  p.nbuf = p.R < stages(nt) ? p.R : stages(nt);
  p.tile_elems = (size_t)np * tile_width(d);
  p.bias_off = align128((size_t)p.nbuf * p.G * 3 * p.tile_elems * 2);
  const size_t bias = staged_bias ? (size_t)p.G * np * (np + 8) * 2 : 0;
  p.ids_off = align128(p.bias_off + bias);
  p.smem = p.ids_off + (ids ? (size_t)p.nbuf * np * 4 : 0);
  return p;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma16816(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(unsigned u) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
}

// An f32 addend rounded to bf16. Addends are read-only for the kernel's
// life: non-coherent loads, which the compiler may issue ahead of the
// shared-memory stores around them.
__device__ __forceinline__ float load_addend(const float* p, size_t i) {
  return round_bf16(__ldg(p + i));
}

// One block: head group blockIdx.y, windows [blockIdx.x R, +R).
// NT: n8 tiles of the padded N at most (8, 18 or 32); DS: tile width.
template <class Rows, int NT, int DS, int MODE>
__global__ void __launch_bounds__(max_warps(NT) * 32, min_blocks(NT))
window_core_kernel(Rows rows, Addends ad, int windows, int n, int d, int G, int R,
                   int nbuf, float scale, float causal_neg, size_t tile_elems,
                   size_t bias_off, size_t ids_off) {
  constexpr int KD = DS / 16, OT = DS / 8;
  constexpr bool kIds = MODE == kStagedIds;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* tiles = reinterpret_cast<bf16*>(smem);
  bf16* bias_s = reinterpret_cast<bf16*>(smem + bias_off);
  int* ids_s = reinterpret_cast<int*>(smem + ids_off);

  const int np = pad16(n), mt = np / 16, nt = np / 8, bld = np + 8;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, nwarps = nthreads >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int h0 = blockIdx.y * G;
  const int w0 = blockIdx.x * R;
  const int cnt = min(R, windows - w0);
  const bool ids = ad.mask_kind == kRegionIds;
  const bool staged = stages_bias(NT) && ad.bias != nullptr;

  auto tile = [&](int buf, int gh, int part) -> bf16* {
    return tiles + ((size_t)(buf * G + gh) * 3 + part) * tile_elems;
  };

  // Copy window w's q/k/v rows of the group into buffer buf (zero pad rows
  // and columns), and its region ids. A thread's chunks step through the
  // (row, part, head, chunk) order by nthreads, with no division per chunk.
  constexpr int cpr = DS / 8;  // 16-byte chunks of a tile row
  const int gc = G * cpr, slots = 3 * gc;
  const int di = nthreads / slots, dsl = nthreads - di * slots;
  auto prefetch = [&](int w, int buf) {
    const long long item = rows.item(w);
    int i = tid / slots, slot = tid - i * slots;
    while (i < np) {
      const int part = slot >= 2 * gc ? 2 : (slot >= gc ? 1 : 0);
      const int rem = slot - part * gc, gh = rem / cpr, c = rem % cpr;
      const bool valid = i < n && c * 8 < d;
      const bf16* src = valid ? rows.in(part, item, h0 + gh, i) + c * 8 : rows.in(0, item, h0, 0);
      cp_async16(tile(buf, gh, part) + i * DS + swz<DS>(i, c) * 8, src, valid);
      i += di;
      slot += dsl;
      if (slot >= slots) {
        slot -= slots;
        ++i;
      }
    }
    if (ids) {  // pad tokens' ids are zero-filled: their columns get -inf anyway
      const int* src = static_cast<const int*>(ad.mask) + (size_t)(w % ad.nw) * n;
      for (int r = tid; r < np; r += nthreads) cp_async4(ids_s + buf * np + r, src + (r < n ? r : 0), r < n);
    }
  };

  // Windows 0 .. P-1, P = max(nbuf - 1, 1), in flight before the loop and
  // before the bias is staged; window it + nbuf - 1 is requested while
  // window it computes. Every step commits one group (empty past the end), so waiting
  // for all but nbuf - 1 groups leaves window it's copies done.
  const int ahead = nbuf > 1 ? nbuf - 1 : 1;
  for (int k = 0; k < ahead; ++k) {
    if (k < cnt) prefetch(w0 + k, k);
    asm volatile("cp.async.commit_group;\n");
  }
  // The group's bias, rounded to bf16 through registers eight elements a
  // thread at a time, once per block (pad rows and columns zero).
  if (staged) {
    const bool vec = n == np && (reinterpret_cast<uintptr_t>(ad.bias) & 15) == 0;
#pragma unroll 3
    for (int e = tid; e < G * np * (np / 8); e += nthreads) {
      const int row = e / (np / 8), c0 = (e - row * (np / 8)) * 8;
      const int gh = row / np, r = row - gh * np;
      const size_t o = ((size_t)(h0 + gh) * n + r) * n + c0;
      float v[8];
      if (vec) {
        const float4* f = reinterpret_cast<const float4*>(ad.bias + o);
        const float4 a = __ldg(f), b = __ldg(f + 1);
        v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
        v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
      } else {
#pragma unroll
        for (int u = 0; u < 8; ++u)
          v[u] = r < n && c0 + u < n ? load_addend(ad.bias, o + u) : 0.f;
      }
      uint4 packed;
      packed.x = pack_bf16(v[0], v[1]);
      packed.y = pack_bf16(v[2], v[3]);
      packed.z = pack_bf16(v[4], v[5]);
      packed.w = pack_bf16(v[6], v[7]);
      *reinterpret_cast<uint4*>(bias_s + (size_t)row * bld + c0) = packed;
    }
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

    for (int s = warp; s < G * mt; s += nwarps) {
      // ldmatrix and mma.sync need every lane of the warp converged; the
      // copies above and the last strip's stores branch by lane, and a
      // block barrier does not reconverge a warp.
      __syncwarp();
      const int gh = s / mt, strip = s - gh * mt, h = h0 + gh;
      bf16* qs = tile(buf, gh, 0);
      const bf16* ks = tile(buf, gh, 1);
      const bf16* vs = tile(buf, gh, 2);
      const int r0 = strip * 16 + g, r1 = r0 + 8;

      // Scores: tile j holds rows r0 / r1, columns 8j + 2t, 8j + 2t + 1.
      float sc[NT][4];
      {
        // q fragments of the strip, scaled and rounded to bf16.
        unsigned qa[KD][4];
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
          const int r = strip * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
          const int c = 2 * kk + (lane >> 4);
          ldsm_x4(qa[kk], qs + r * DS + swz<DS>(r, c) * 8);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float2 f = unpack_bf16(qa[kk][u]);
            qa[kk][u] = pack_bf16(f.x * scale, f.y * scale);
          }
        }
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          if (j < nt) {
#pragma unroll
            for (int u = 0; u < 4; ++u) sc[j][u] = sc[j + 1][u] = 0.f;
#pragma unroll
            for (int kk = 0; kk < KD; ++kk) {
              // Keys 8j..8j+7 at chunks 2kk, 2kk+1, then keys 8j+8.. at both.
              const int r = 8 * j + (lane & 7) + (lane >> 4) * 8;
              const int c = 2 * kk + ((lane >> 3) & 1);
              unsigned kb[4];
              ldsm_x4(kb, ks + r * DS + swz<DS>(r, c) * 8);
              mma16816(sc[j], qa[kk], kb[0], kb[1]);
              mma16816(sc[j + 1], qa[kk], kb[2], kb[3]);
            }
          }
        }
      }

      // Addends (bias + mask, summed first) and the row max. Pad columns
      // (at or past n) get -inf, so probability 0.
      const int* idw = ids_s + buf * np;
      const int id0 = kIds ? idw[r0] : 0, id1 = kIds ? idw[r1] : 0;
      // Two partial maxima and sums per row (even and odd tiles) halve the
      // dependent chains.
      float m0[2] = {-INFINITY, -INFINITY}, m1[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (j < nt) {
          const int c = 8 * j + 2 * t;
          float a[4];
          if (MODE != kGeneric) {
            const float2 b0 = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(bias_s + (size_t)gh * np * bld + r0 * bld + c));
            const float2 b1 = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(bias_s + (size_t)gh * np * bld + r1 * bld + c));
            a[0] = b0.x;
            a[1] = b0.y;
            a[2] = b1.x;
            a[3] = b1.y;
            if (kIds) {
              const int2 ic = *reinterpret_cast<const int2*>(idw + c);
              a[0] += ic.x != id0 ? -100.f : 0.f;
              a[1] += ic.y != id0 ? -100.f : 0.f;
              a[2] += ic.x != id1 ? -100.f : 0.f;
              a[3] += ic.y != id1 ? -100.f : 0.f;
            } else if (MODE == kStagedDense && c < n) {
              const float* mw = static_cast<const float*>(ad.mask) + (size_t)(w % ad.nw) * n * n;
              if (r0 < n) {
                const float2 m = __ldg(reinterpret_cast<const float2*>(mw + r0 * n + c));
                a[0] += round_bf16(m.x);
                a[1] += round_bf16(m.y);
              }
              if (r1 < n) {
                const float2 m = __ldg(reinterpret_cast<const float2*>(mw + r1 * n + c));
                a[2] += round_bf16(m.x);
                a[3] += round_bf16(m.y);
              }
            }
          } else {
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int r = u < 2 ? r0 : r1, cc = c + (u & 1);
              float e = 0.f;
              if (staged)
                e = __bfloat162float(bias_s[(size_t)gh * np * bld + r * bld + cc]);
              else if (ad.bias != nullptr && r < n && cc < n)
                e = load_addend(ad.bias, ((size_t)h * n + r) * n + cc);
              if (ids)
                e += idw[cc] != idw[r] ? -100.f : 0.f;
              else if (ad.mask_kind == kCausal)
                e += cc > r ? causal_neg : 0.f;
              else if (ad.mask_kind != kNoMask && r < n && cc < n)
                e += load_addend(static_cast<const float*>(ad.mask),
                                 ((size_t)(w % ad.nw) * n + r) * n + cc);
              a[u] = e;
            }
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) sc[j][u] += a[u];
          if (8 * j + 8 > n) {
            if (c >= n) sc[j][0] = sc[j][2] = -INFINITY;
            if (c + 1 >= n) sc[j][1] = sc[j][3] = -INFINITY;
          }
          m0[j & 1] = fmaxf(m0[j & 1], fmaxf(sc[j][0], sc[j][1]));
          m1[j & 1] = fmaxf(m1[j & 1], fmaxf(sc[j][2], sc[j][3]));
        }
      }
      float mx0 = fmaxf(m0[0], m0[1]), mx1 = fmaxf(m1[0], m1[1]);
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      // exp(x - max) by the hardware ex2 (__expf; -inf gives 0) and the sum.
      float l0[2] = {0.f, 0.f}, l1[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (j < nt) {
          sc[j][0] = __expf(sc[j][0] - mx0);
          sc[j][1] = __expf(sc[j][1] - mx0);
          sc[j][2] = __expf(sc[j][2] - mx1);
          sc[j][3] = __expf(sc[j][3] - mx1);
          l0[j & 1] += sc[j][0] + sc[j][1];
          l1[j & 1] += sc[j][2] + sc[j][3];
        }
      }
      float s0 = l0[0] + l0[1], s1 = l1[0] + l1[1];
      s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
      s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
      s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
      s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
      const float inv0 = 1.f / s0, inv1 = 1.f / s1;

      // O = P v, P normalized (times 1 / sum) and then rounded to bf16.
      float o[OT][4];
#pragma unroll
      for (int jd = 0; jd < OT; ++jd)
#pragma unroll
        for (int u = 0; u < 4; ++u) o[jd][u] = 0.f;
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        if (j < nt) {
          const unsigned pa[4] = {pack_bf16(sc[j][0] * inv0, sc[j][1] * inv0),
                                  pack_bf16(sc[j][2] * inv1, sc[j][3] * inv1),
                                  pack_bf16(sc[j + 1][0] * inv0, sc[j + 1][1] * inv0),
                                  pack_bf16(sc[j + 1][2] * inv1, sc[j + 1][3] * inv1)};
#pragma unroll
          for (int jd = 0; jd < OT; jd += 2) {
            // Keys 8j..8j+7 and 8j+8.. at chunk jd, then at chunk jd+1.
            const int r = 8 * j + (lane & 7) + ((lane >> 3) & 1) * 8;
            const int c = jd + (lane >> 4);
            unsigned vb[4];
            ldsm_x4_trans(vb, vs + r * DS + swz<DS>(r, c) * 8);
            mma16816(o[jd], pa, vb[0], vb[1]);
            mma16816(o[jd + 1], pa, vb[2], vb[3]);
          }
        }
      }

      // The strip's output, rounded to bf16, staged over its own q rows
      // (no other warp reads them) and stored as 16-byte chunks.
#pragma unroll
      for (int jd = 0; jd < OT; ++jd) {
        *reinterpret_cast<unsigned*>(qs + r0 * DS + swz<DS>(r0, jd) * 8 + 2 * t) =
            pack_bf16(o[jd][0], o[jd][1]);
        *reinterpret_cast<unsigned*>(qs + r1 * DS + swz<DS>(r1, jd) * 8 + 2 * t) =
            pack_bf16(o[jd][2], o[jd][3]);
      }
      __syncwarp();
      for (int e = lane; e < 16 * cpr; e += 32) {
        const int i = strip * 16 + e / cpr, c = e % cpr;
        if (i < n && c * 8 < d)
          *reinterpret_cast<uint4*>(rows.dst(item, h, i) + c * 8) =
              *reinterpret_cast<const uint4*>(qs + i * DS + swz<DS>(i, c) * 8);
      }
    }
    __syncthreads();
  }
}

// Whether a kernel's shared-memory limit is raised yet, per instantiation,
// per device (common.cuh) and per translation unit (internal linkage: a
// process that loads two builds of the library keeps one flag per build).
namespace {
template <class Rows, int NT, int DS, int MODE>
bool smem_raised[kMaxDevices];
}  // namespace

template <class Rows, int NT, int DS, int MODE>
cudaError_t launch_mode(const Rows& rows, const Addends& ad, const Plan& p, int windows,
                        int n, int d, float scale, float causal_neg, cudaStream_t s) {
  auto kernel = window_core_kernel<Rows, NT, DS, MODE>;
  const cudaError_t err = once_per_device(smem_raised<Rows, NT, DS, MODE>, [&] {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                kSmemLimit);
  });
  if (err != cudaSuccess) return err;
  kernel<<<dim3(p.runs, p.groups), p.warps * 32, p.smem, s>>>(
      rows, ad, windows, n, d, p.G, p.R, p.nbuf, scale, causal_neg, p.tile_elems,
      p.bias_off, p.ids_off);
  return cudaGetLastError();
}

// f32 -> bf16 -> f32 with round-to-nearest-even, on the host (finite v).
inline float round_bf16_host(float v) {
  uint32_t u;
  memcpy(&u, &v, 4);
  u = (u + 0x7fffu + ((u >> 16) & 1u)) & 0xffff0000u;
  memcpy(&v, &u, 4);
  return v;
}

// The kernel for the addends' form: a lean mode where LEAN has one for it,
// else the generic one where GENERIC is built; any other form is refused.
template <class Rows, int NT, int DS, bool LEAN, bool GENERIC>
cudaError_t launch_class(const Rows& rows, const Addends& ad, int windows, int heads,
                         int n, int d, bool heads_contiguous, cudaStream_t s) {
  const bool ids = ad.mask_kind == kRegionIds;
  const bool staged = stages_bias(NT) && ad.bias != nullptr;
  const Plan p = plan(NT, n, d, windows, heads, heads_contiguous, staged, ids);
  if (p.smem > (size_t)kSmemLimit || p.groups > 65535) return cudaErrorInvalidValue;
  const float scale = round_bf16_host(1.f / sqrtf((float)d));
  const float causal_neg = round_bf16_host(-1e9f);
  if constexpr (LEAN) {
    if (staged && ad.mask_kind == kNoMask)
      return launch_mode<Rows, NT, DS, kStagedNoMask>(rows, ad, p, windows, n, d, scale,
                                                      causal_neg, s);
    if (staged && ids)
      return launch_mode<Rows, NT, DS, kStagedIds>(rows, ad, p, windows, n, d, scale,
                                                   causal_neg, s);
    if (staged && ad.mask_kind == kMaskF32 && n % 2 == 0 &&
        (reinterpret_cast<uintptr_t>(ad.mask) & 7) == 0)
      return launch_mode<Rows, NT, DS, kStagedDense>(rows, ad, p, windows, n, d, scale,
                                                     causal_neg, s);
  }
  if constexpr (GENERIC)
    return launch_mode<Rows, NT, DS, kGeneric>(rows, ad, p, windows, n, d, scale, causal_neg,
                                               s);
  return cudaErrorInvalidValue;
}

// K6-K8's core on `windows` x `heads` (window, head) items of N = n tokens
// and head dim d (a multiple of 8 up to 64; N up to 256). Only d = 32, the
// head dim of every model site, has lean epilogues; above N = 144 every
// form runs the generic one.
template <class Rows>
cudaError_t run(const Rows& rows, const Addends& ad, int windows, int heads, int n,
                int d, bool heads_contiguous, cudaStream_t s) {
  if (windows <= 0 || heads <= 0 || n <= 0 || n > 256 || d <= 0 || d > 64 ||
      d % 8 != 0 || ad.nw <= 0)
    return cudaErrorInvalidValue;
  const int np = pad16(n), ds = tile_width(d);
#define BT_CORE_CASE(NT, DS, LEAN)                                                     \
  if ((np <= 8 * NT) && ds == DS)                                                      \
    return launch_class<Rows, NT, DS, LEAN, true>(rows, ad, windows, heads, n, d,      \
                                                  heads_contiguous, s);
  BT_CORE_CASE(8, 16, false)
  BT_CORE_CASE(8, 32, true)
  BT_CORE_CASE(8, 64, false)
  BT_CORE_CASE(18, 16, false)
  BT_CORE_CASE(18, 32, true)
  BT_CORE_CASE(18, 64, false)
  BT_CORE_CASE(32, 16, false)
  BT_CORE_CASE(32, 32, false)
  BT_CORE_CASE(32, 64, false)
#undef BT_CORE_CASE
  return cudaErrorInvalidValue;
}

}  // namespace core
}  // namespace bt

// The key-tiled cores build on the wgmma/TMA ring's pieces.
#include "wgmma_ring.cuh"

namespace bt {

// The key-tiled core: K6-K8 at the shapes the core above does not take
// (N > 256, a head dim above 64, or a head dim that the wrapper padded to a
// multiple of 8 and that therefore needs its true d^-0.5 given), the same
// function with the same rounding points:
//
//   out = bf16(bf16(exp(s - m) / l) v),  s = bf16(q * scale) k^T + addends
//
// with m and l each query row's max and sum of exp(s - m) over all keys, in
// f32. It ports the JAX kernels' whole-window tile
// (birefnet_tpu/ops/pallas/flash_window_attn.py::_attn_core, which takes
// any N and d) to blocks of 64 query rows that walk the keys in tiles of
// 64, twice:
//
// - Pass 1 computes each tile's scores (q k^T plus the addends) and keeps
//   each row's running max and sum in f32, rescaling the sum at each new
//   max.
// - Pass 2 recomputes the same scores tile by tile (bitwise the first
//   pass's), forms exp(s - m) / l, rounds it to bf16 and accumulates P v in
//   f32 registers.
//
// A one-pass online softmax would round unnormalized probabilities to bf16
// and rescale the sums afterwards: another rounding than the JAX kernel's
// and the plain version's, which normalize before the cast. The price is a
// second q k^T, on an API path no forward calls.
//
// What bounds it: per (window, head) 6 N^2 d flops (two q k^T, one P v)
// against 8 N d bytes plus the addends; at N = 1024, d = 128 that is about
// 770 flops a byte, above the H100's bf16 ridge, so large calls are bound
// by the tensor cores (and, as in every attention kernel on this card, by
// the softmax's exp and max between the products), small ones (N = 257,
// 576: a few hundred blocks) by latency. The design, for sm_90a:
//
// - One block is a consumer warpgroup (128 threads, 64 query rows) and a
//   producer warp. The products are wgmma: S = q k^T as m64n64k16 with q
//   and k from 128-byte-swizzled shared memory (q scaled and rounded to
//   bf16 in place once per block, not once per tile: a q that stays in
//   shared memory costs no registers and takes any d), and P v as
//   m64n64k16 with P from registers (the probabilities straight from the
//   score accumulators, packed to bf16) and v MN-major, read transposed, in
//   one or two column blocks of 64.
// - The producer warp fills a ring of 2-8 stages (full and empty mbarriers,
//   wgmma_ring.cuh) ahead of the consumer: per key tile the k rows, in pass
//   2 the v rows, and the tile's f32 addends (the bias rows and dense mask
//   rows of the block's 64 query rows), so that they arrive before the
//   tile's epilogue instead of being read from L2 after its products. q, k
//   and v come by TMA through 4-D tensor maps of (d, then token, head and
//   window in the order of their strides), which take K6's strided heads
//   in the packed projection as well as K7/K8's [B_, heads, N, d] and zero
//   the rows past N and the columns past d. The addends come by TMA where
//   their rows are 16-byte aligned (N % 4 == 0), into 128-byte-swizzled
//   [64 rows, 32 keys] boxes that the epilogue reads as float pairs; else
//   (N = 257, 289, ...) the producer's 32 lanes copy the aligned 16-byte
//   chunks around each row with cp.async (4-byte copies ran at about one
//   element a cycle and bounded those shapes), into rows of KT + 4 floats
//   that the epilogue reads at each row's shift. The lanes' copies, and
//   the keys' region ids, complete on the same full barrier (.noinc
//   arrivals counted in its initial count).
// - Where one block an SM of half the length takes fewer block times than
//   two blocks an SM (grids of up to one block an SM, the small API shapes:
//   N = 144 at d = 96 or 160, K6 at N = 289; and grids whose last wave at
//   two an SM would be half full or less: 288 blocks at N = 576), a block
//   runs two consumer warpgroups on the same 64 query rows, each taking
//   every other key tile of the ring: after pass 1 they merge each row's
//   max and sum through shared memory, after pass 2 warpgroup 1 leaves its
//   P v sums in the (then idle) ring and warpgroup 0 adds them in f32 and
//   stores. Other grids run one warpgroup a block, two blocks an SM. Each
//   warpgroup owns half the ring's slots (a shared slot let one warpgroup
//   wait on a barrier a phase behind and take the older phase for its
//   own), so a block splits only where the ring has four slots or more.
// - A stage carries up to 128 columns of k; a head dim above 128 walks a
//   tile's columns over several stages. q stays for the block up to 256
//   columns; past that its columns stream beside k's (and are scaled per
//   stage).
// - flash_attention's causal flag skips the key tiles past a block's last
//   query row in both passes: their probabilities are exactly 0 (bf16(-1e9)
//   under every row's max, whose exp underflows) and their sums exactly 0,
//   so the output is bitwise what the whole walk gives. The grid runs the
//   query tiles in descending order, so the longest blocks start first.
//
// Head dim: q k^T contracts over dqk (a multiple of 8), and one launch
// writes dv <= 128 output columns of v's (the caller's) view: the wrapper
// launches one slice per 128 columns where d > 128. Pad keys get
// probability 0, pad query rows and columns are never written.
//
// The f32 key-tiled core (window_core_f32.cuh core_f32_tiled) shares this
// namespace's block walk, producer, ring layout and tensor maps.
namespace core_tiled {

constexpr int kRows = 64;         // query rows a block
constexpr int kConsumers = 128;   // threads of a consumer warpgroup
// A block runs one or two consumer warpgroups and the producer warp: 160
// or 288 threads. The kernels are bounded for 320 threads, a cap of 204
// registers a thread, so that two blocks of 160 fit an SM.
constexpr int kBoundThreads = 320;
constexpr int kBlock = kRows * 128;        // a [64 rows, 128 bytes] tile
constexpr float kLog2e = 1.4426950408889634f;

// Per element type: keys a tile, elements in a 128-byte row (a column
// block), and column blocks a stage carries (128 columns).
// q stays in shared memory for the block up to kQRes column blocks (256
// bf16 or 128 f32 columns), else its columns stream with k's.
template <typename T>
struct Tile;
template <>
struct Tile<bf16> {
  static constexpr int kKeys = 64, kCols = 64, kGroup = 2, kQRes = 4;
};
template <>
struct Tile<float> {
  static constexpr int kKeys = 32, kCols = 32, kGroup = 4, kQRes = 4;
};

// Byte offsets in the block's dynamic shared memory (after aligning it to
// 1024) and within a stage; -1 where a launch has no such region.
struct Layout {
  int stages, stage;        // ring slots and the bytes of one
  int ring, bars;           // the ring; the barriers (full, empty, q)
  int qres;                 // q's column blocks for the whole block, or -1
  int qlo, klo;             // f32: the lo parts of q's and k's blocks, else -1
                            // (per consumer warpgroup where they stream)
  int qlo_wg, klo_wg;       // bytes between the warpgroups' lo scratch
  int xch;                  // split blocks: the warpgroups' row max and sum
  int k, q, v, bias, mask, ids;  // in a stage (q: -1 unless streamed)
  int bytes;                // dynamic shared memory to request
};

struct Params {
  Layout L;
  int n, dqk, dv, nqt, items, heads, nw, kind;
  int nqb, nvb;             // column blocks of q (and k) and of v to load
  int cwg;                  // consumer warpgroups: 1, or 2 splitting the keys
  int tma_add;              // the bias and mask tiles come by TMA
  int use_cp;               // the producer's lanes copy (addends, ids)
  int perm_q, perm_k, perm_v;  // tensor-map positions of token, head, window
  float scale, causal_neg;
  const float* bias;
  const float* mask;
  const int* ids;
};

struct Maps {
  CUtensorMap q, k, v, bias, mask;
};

// The block's (window, head) item, first query row and key tiles to walk.
// blockIdx.x runs over items fastest, query tiles in descending order.
template <int KT>
__device__ __forceinline__ void block_item(const Params& p, int& w, int& h, int& row0,
                                           int& nkt) {
  const int step = blockIdx.x / p.items, item = blockIdx.x - step * p.items;
  w = item / p.heads;
  h = item - w * p.heads;
  row0 = (p.nqt - 1 - step) * kRows;
  nkt = (p.n + KT - 1) / KT;
  if (p.kind == kCausal) nkt = min(nkt, (min(row0 + kRows, p.n) - 1) / KT + 1);
}

// A consumer warpgroup's place in its share of the ring: in a split block
// each warpgroup owns stages / 2 slots and takes its stages in order, so
// that no warpgroup ever waits on a slot whose barrier is a phase behind (a
// parity wait would take that older phase for its own). Slots [first, last]
// are taken in turn, the phase parity flipping at each wrap.
struct Cursor {
  int slot, first, last;
  uint32_t parity;
  __device__ __forceinline__ Cursor(int f, int n) : slot(f), first(f), last(f + n - 1), parity(0) {}
  __device__ __forceinline__ void next() {
    parity ^= slot == last;
    slot = slot == last ? first : slot + 1;
  }
};

// A box of q, k or v: `col` along d, `row` along the tokens, of head h in
// window w; perm holds the map positions (1-3) of token, head and window.
__device__ __forceinline__ void load_rows(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int perm, int col, int row, int h, int w) {
  const int tp = perm & 3, hp = (perm >> 2) & 3;
  const int c1 = tp == 1 ? row : (hp == 1 ? h : w);
  const int c2 = tp == 2 ? row : (hp == 2 ? h : w);
  const int c3 = tp == 3 ? row : (hp == 3 ? h : w);
  ring::tma_load_4d(dst, map, bar, col, c1, c2, c3);
}

// Byte offset of f32 addend (r, c) of a tile in [64 rows, 32 keys] boxes
// of 128-byte rows with the 128-byte swizzle (as TMA writes them).
__device__ __forceinline__ int addend_at(int r, int c) {
  return (c >> 5) * kBlock + r * 128 + ((((c & 31) >> 2) ^ (r & 7)) << 4) + ((c & 3) << 2);
}

// An f32 addend tile (query rows row0.., keys key0..) of one [n, n] plane
// whose rows are not 16-byte aligned (n % 4 != 0), copied by the 32
// producer lanes with 16-byte cp.async: each real row's keys come with the
// aligned 16-byte chunks that hold them, into a row of KT + 4 floats whose
// first key sits at float `shift` (0-3, the row's misalignment; see
// row_shift). Chunks that start past the tensor's end are not read, and
// rows past n are not copied: pad rows and keys never reach an output.
template <int KT>
__device__ __forceinline__ void copy_addend(uint32_t dst, const float* plane, const float* end,
                                            int n, int row0, int key0, int lane) {
  constexpr int kChunks = KT / 4 + 1;
  const int rows = min(kRows, n - row0);
  for (int e = lane; e < rows * kChunks; e += 32) {
    const int r = e / kChunks, k = e - r * kChunks;
    const uintptr_t first = reinterpret_cast<uintptr_t>(plane + (size_t)(row0 + r) * n + key0);
    const float* chunk = reinterpret_cast<const float*>(first & ~uintptr_t(15)) + 4 * k;
    const bool valid = chunk < end;
    ring::cp_async16(dst + r * (KT * 4 + 16) + 16 * k, valid ? chunk : plane, valid);
  }
}

// The float position of row r's first key in copy_addend's rows.
__device__ __forceinline__ int row_shift(const float* plane, int n, int r) {
  return (int)((reinterpret_cast<uintptr_t>(plane + (size_t)r * n) >> 2) & 3);
}

// The producer warp: the block's resident q blocks, then every stage of
// both passes in the order the consumer takes them (per pass, per key
// tile, per group of up to kGroup column blocks; the tile's v rows, in
// pass 2, and its addends ride with its last group).
template <typename T>
__device__ __forceinline__ void produce(const Maps& maps, const Params& p, uint32_t base, int w,
                                        int h, int row0, int nkt) {
  constexpr int KT = Tile<T>::kKeys, CB = Tile<T>::kCols, GB = Tile<T>::kGroup;
  constexpr int kKeyBlock = KT * 128;
  const Layout& L = p.L;
  const int lane = threadIdx.x & 31;
  const int ngrp = (p.nqb + GB - 1) / GB;
  const bool dense = p.kind == kMaskF32, ids = p.kind == kRegionIds;
  const int wm = w % p.nw;
  const uint32_t qbar = base + L.bars + 16 * L.stages;
  if (L.qres >= 0 && lane == 0) {
    ring::mbar_expect_tx(qbar, p.nqb * kBlock);
    for (int b = 0; b < p.nqb; ++b)
      load_rows(base + L.qres + b * kBlock, &maps.q, qbar, p.perm_q, b * CB, row0, h, w);
  }
  // The two warpgroups' cursors (in a block of one, its tiles all take c0).
  const int per_wg = L.stages / p.cwg;
  Cursor c0(0, per_wg), c1(per_wg, per_wg);
  for (int s = 0; s < 2 * nkt * ngrp; ++s) {
    // Stage s: pass s / (nkt ngrp), key tile kt, column group g.
    const bool pass2 = s >= nkt * ngrp;
    const int kt = s / ngrp - (pass2 ? nkt : 0), g = s % ngrp;
    const bool odd = p.cwg == 2 && (kt & 1);
    const int slot = odd ? c1.slot : c0.slot;
    const uint32_t full = base + L.bars + 8 * slot, empty = full + 8 * L.stages;
    ring::mbar_wait(empty, (odd ? c1.parity : c0.parity) ^ 1);
    if (odd)
      c1.next();
    else
      c0.next();
    const bool last = g == ngrp - 1;
    const int kb = min(GB, p.nqb - g * GB);
    const uint32_t st = base + L.ring + slot * L.stage;
    if (lane == 0) {
      const int vb = pass2 && last ? p.nvb : 0;
      const int ab = last && p.tma_add ? KT / 32 : 0;  // boxes per addend
      const int na = (p.bias != nullptr) + dense;
      ring::mbar_expect_tx(full, kb * kKeyBlock + (L.q >= 0 ? kb * kBlock : 0) +
                                     vb * kKeyBlock + ab * na * kBlock);
      for (int b = 0; b < kb; ++b)
        load_rows(st + L.k + b * kKeyBlock, &maps.k, full, p.perm_k, (g * GB + b) * CB, kt * KT,
                  h, w);
      if (L.q >= 0)
        for (int b = 0; b < kb; ++b)
          load_rows(st + L.q + b * kBlock, &maps.q, full, p.perm_q, (g * GB + b) * CB, row0, h,
                    w);
      for (int b = 0; b < vb; ++b)
        load_rows(st + L.v + b * kKeyBlock, &maps.v, full, p.perm_v, b * CB, kt * KT, h, w);
      for (int b = 0; b < ab; ++b) {
        if (p.bias != nullptr)
          ring::tma_load_4d(st + L.bias + b * kBlock, &maps.bias, full, kt * KT + 32 * b, row0, h,
                            0);
        if (dense)
          ring::tma_load_4d(st + L.mask + b * kBlock, &maps.mask, full, kt * KT + 32 * b, row0,
                            wm, 0);
      }
    }
    if (p.use_cp) {
      if (last) {
        const size_t nn = (size_t)p.n * p.n;
        if (!p.tma_add && p.bias != nullptr)
          copy_addend<KT>(st + L.bias, p.bias + h * nn, p.bias + p.heads * nn, p.n, row0,
                          kt * KT, lane);
        if (!p.tma_add && dense)
          copy_addend<KT>(st + L.mask, p.mask + wm * nn, p.mask + p.nw * nn, p.n, row0, kt * KT,
                          lane);
        if (ids)
          for (int c = lane; c < KT; c += 32) {
            const int key = kt * KT + c;
            ring::cp_async4(st + L.ids + 4 * c, p.ids + (size_t)wm * p.n + (key < p.n ? key : 0),
                            key < p.n);
          }
      }
      ring::cp_async_arrive(full);
    }
  }
  if (p.use_cp) asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The thread's warpgroup: 0 (and 1 in a split block) consume, p.cwg is the
// producer warp. A value the compiler sees as warp-uniform (a broadcast),
// so that it does not take the consumers' wgmma for code on a divergent
// path and serialize them.
__device__ __forceinline__ int role() {
  return __shfl_sync(0xffffffffu, (int)threadIdx.x / kConsumers, 0);
}

// Barriers: full (the producer's expect_tx arrival, and the 32 lanes'
// cp.async arrivals where it copies), empty (lane 0 of each warp of the
// consumer warpgroup that takes the stage), q (the resident q blocks' TMA).
__device__ __forceinline__ void init_barriers(const Params& p, uint32_t base) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.L.stages; ++s) {
      ring::mbar_init(base + p.L.bars + 8 * s, 1 + (p.use_cp ? 32 : 0));
      ring::mbar_init(base + p.L.bars + 8 * (p.L.stages + s), kConsumers / 32);
    }
    ring::mbar_init(base + p.L.bars + 16 * p.L.stages, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// Where a thread finds its addends in a stage's copy_addend rows: the byte
// offsets of its two rows' key 0 in the bias and mask tiles, each row's
// shift included (unused for the TMA tiles, read through addend_at).
struct AddendRows {
  int b0, b1, m0, m1;
};

// The bias and dense-mask pair at tile column c (even) of a row at byte
// offset `row` (copy_addend's rows) or of row rr (TMA tiles), rounded to
// bf16 where ROUND (the bf16 core).
template <bool ROUND>
__device__ __forceinline__ float2 addend_pair(const Params& p, const uint8_t* tile, int row,
                                              int rr, int c) {
  float2 v;
  if (p.tma_add) {
    v = *reinterpret_cast<const float2*>(tile + addend_at(rr, c));
  } else {
    const float* f = reinterpret_cast<const float*>(tile + row) + c;
    v = make_float2(f[0], f[1]);
  }
  return ROUND ? __bfloat1622float2(__floats2bfloat162_rn(v.x, v.y)) : v;
}

// The thread's AddendRows for rows rr0 and rr0 + 8 of the block (row0..):
// in copy_addend's layout, row stride KT + 4 floats and each row's shift.
template <int KT>
__device__ __forceinline__ AddendRows addend_rows(const Params& p, int w, int h, int row0,
                                                  int rr0) {
  AddendRows a{0, 0, 0, 0};
  if (p.tma_add) return a;
  const size_t nn = (size_t)p.n * p.n;
  const int stride = KT * 4 + 16, r0 = row0 + rr0;
  const int ra = r0 < p.n ? r0 : 0, rb = r0 + 8 < p.n ? r0 + 8 : 0;
  if (p.bias != nullptr) {
    const float* plane = p.bias + h * nn;
    a.b0 = rr0 * stride + 4 * row_shift(plane, p.n, ra);
    a.b1 = (rr0 + 8) * stride + 4 * row_shift(plane, p.n, rb);
  }
  if (p.kind == kMaskF32) {
    const float* plane = p.mask + (w % p.nw) * nn;
    a.m0 = rr0 * stride + 4 * row_shift(plane, p.n, ra);
    a.m1 = (rr0 + 8) * stride + 4 * row_shift(plane, p.n, rb);
  }
  return a;
}

// The score epilogue's addends of one n8 tile at tile column c (even) for
// the thread's rows rr0 and rr0 + 8 of the block (r0 and r0 + 8 of the
// window): the bias and a dense mask from the stage, summed in f32;
// region ids (-100 where they differ); the causal addend where a key lies
// after its query, on the tiles that hold such a key (`diag`).
// a[0..1]: row rr0, a[2..3]: row rr0 + 8.
template <bool ROUND>
__device__ __forceinline__ void addends(const Params& p, const uint8_t* st, const AddendRows& ar,
                                        int rr0, int r0, int c, int key, int id0, int id1,
                                        bool diag, float (&a)[4]) {
  const Layout& L = p.L;
  a[0] = a[1] = a[2] = a[3] = 0.f;
  if (p.bias != nullptr) {
    const float2 b0 = addend_pair<ROUND>(p, st + L.bias, ar.b0, rr0, c);
    const float2 b1 = addend_pair<ROUND>(p, st + L.bias, ar.b1, rr0 + 8, c);
    a[0] = b0.x, a[1] = b0.y, a[2] = b1.x, a[3] = b1.y;
  }
  if (p.kind == kMaskF32) {
    const float2 m0 = addend_pair<ROUND>(p, st + L.mask, ar.m0, rr0, c);
    const float2 m1 = addend_pair<ROUND>(p, st + L.mask, ar.m1, rr0 + 8, c);
    a[0] += m0.x, a[1] += m0.y, a[2] += m1.x, a[3] += m1.y;
  } else if (p.kind == kRegionIds) {
    const int2 ic = *reinterpret_cast<const int2*>(st + L.ids + 4 * c);
    a[0] += ic.x != id0 ? -100.f : 0.f;
    a[1] += ic.y != id0 ? -100.f : 0.f;
    a[2] += ic.x != id1 ? -100.f : 0.f;
    a[3] += ic.y != id1 ? -100.f : 0.f;
  } else if (diag) {
    a[0] += key > r0 ? p.causal_neg : 0.f;
    a[1] += key + 1 > r0 ? p.causal_neg : 0.f;
    a[2] += key > r0 + 8 ? p.causal_neg : 0.f;
    a[3] += key + 1 > r0 + 8 ? p.causal_neg : 0.f;
  }
}

// Adds the addends of key tile kt to the scores (accumulator 4 j + u: row
// rr0 + 8 (u >> 1), tile column 8 j + 2 t + (u & 1)) and sets the pad keys
// to -inf, with uniform branches around what a tile does not need: no
// addend work where the call has no bias or mask and the tile holds no key
// after a query row, no pad test before the last tile.
template <bool ROUND, int KT>
__device__ __forceinline__ void score_epilogue(const Params& p, const uint8_t* st,
                                               const AddendRows& ar, int kt, int row0, int rr0,
                                               int id0, int id1, float (&S)[KT / 2]) {
  const int t = threadIdx.x & 3, r0 = row0 + rr0;
  const bool diag = p.kind == kCausal && kt * KT + KT - 1 > row0;
  const bool add = p.bias != nullptr || p.kind == kMaskF32 || p.kind == kRegionIds || diag;
  const bool pad = kt * KT + KT > p.n;
  if (add) {
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) {
      float a[4];
      addends<ROUND>(p, st, ar, rr0, r0, 8 * j + 2 * t, kt * KT + 8 * j + 2 * t, id0, id1, diag,
                     a);
#pragma unroll
      for (int u = 0; u < 4; ++u) S[4 * j + u] += a[u];
    }
  }
  if (pad) {
#pragma unroll
    for (int j = 0; j < KT / 8; ++j)
#pragma unroll
      for (int u = 0; u < 4; ++u)
        S[4 * j + u] = kt * KT + 8 * j + 2 * t + (u & 1) < p.n ? S[4 * j + u] : -INFINITY;
  }
}

// 2^x by the hardware ex2 (what __expf runs after its multiply by log2 e).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// q scaled by `scale` and rounded to bf16, in place: `chunks` 16-byte
// pieces from p (a multiple of `threads`), by consumer threads tid <
// threads, every thread the same count.
__device__ __forceinline__ void scale_q(uint8_t* p, int chunks, float scale, int tid,
                                        int threads) {
  for (int e0 = 0; e0 < chunks; e0 += threads) {
    const int e = e0 + tid;
    uint4 v = *reinterpret_cast<const uint4*>(p + 16 * e);
    uint32_t* u = &v.x;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = core::unpack_bf16(u[i]);
      u[i] = core::pack_bf16(f.x * scale, f.y * scale);
    }
    *reinterpret_cast<uint4*>(p + 16 * e) = v;
  }
}

// A split block's pass-1 merge: each consumer warpgroup has the max and sum
// of its own key tiles for the thread's two rows (m[0], l[0]: row rr0;
// m[1], l[1]: rr0 + 8); both leave with those of all the keys, merged in
// warpgroup order so that the two compute them alike. EXPF: the core's exp.
template <bool EXPF>
__device__ __forceinline__ void merge_stats(uint8_t* sm, const Layout& L, int wg, float (&m)[2],
                                            float (&l)[2]) {
  float* x = reinterpret_cast<float*>(sm + L.xch);
  const int tid = threadIdx.x & (kConsumers - 1);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    x[(2 * i) * 2 * kConsumers + wg * kConsumers + tid] = m[i];
    x[(2 * i + 1) * 2 * kConsumers + wg * kConsumers + tid] = l[i];
  }
  ring::bar_sync(1, 2 * kConsumers);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float ma = x[(2 * i) * 2 * kConsumers + tid];
    const float la = x[(2 * i + 1) * 2 * kConsumers + tid];
    const float mb = x[(2 * i) * 2 * kConsumers + kConsumers + tid];
    const float lb = x[(2 * i + 1) * 2 * kConsumers + kConsumers + tid];
    m[i] = fmaxf(ma, mb);
    l[i] = EXPF ? la * expf(ma - m[i]) + lb * expf(mb - m[i])
                : la * __expf(ma - m[i]) + lb * __expf(mb - m[i]);
  }
}

// A split block's pass-2 merge: warpgroup 1 leaves its `n` output sums a
// thread in the ring (free once both are past their last stage), and
// warpgroup 0 adds them to its own in f32; true for warpgroup 0, which
// then stores the rows.
template <int B, int N>
__device__ __forceinline__ bool merge_out(uint8_t* sm, const Layout& L, int wg,
                                          float (&o)[B][N]) {
  float* x = reinterpret_cast<float*>(sm + L.ring);
  const int tid = threadIdx.x & (kConsumers - 1);
  ring::bar_sync(1, 2 * kConsumers);
  if (wg == 1) {
#pragma unroll
    for (int b = 0; b < B; ++b)
#pragma unroll
      for (int e = 0; e < N; ++e) x[(b * N + e) * kConsumers + tid] = o[b][e];
  }
  ring::bar_sync(1, 2 * kConsumers);
  if (wg == 1) return false;
#pragma unroll
  for (int b = 0; b < B; ++b)
#pragma unroll
    for (int e = 0; e < N; ++e) o[b][e] = __fadd_rn(o[b][e], x[(b * N + e) * kConsumers + tid]);
  return true;
}

// One block (block_item): warpgroup 0, or warpgroups 0 and 1 each taking
// every other key tile (p.cwg = 2, for grids of no more blocks than SMs),
// consume; the warp after them produces. DV: output columns of P v, 64 or
// 128 (one or two MN-major column blocks of v).
template <class Rows, int DV>
__global__ void __launch_bounds__(kBoundThreads, 1)
window_tiled_kernel(const __grid_constant__ Maps maps, const __grid_constant__ Params p,
                    const Rows rows) {
  constexpr int KT = Tile<bf16>::kKeys, NB = DV / 64;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (ring::smem_u32(smem_raw) + 1023) & ~1023u;
  uint8_t* sm = smem_raw + (base - ring::smem_u32(smem_raw));
  const Layout& L = p.L;
  int w, h, row0, nkt;
  block_item<KT>(p, w, h, row0, nkt);
  init_barriers(p, base);
  const int wg = role();
  if (wg == p.cwg) {
    produce<bf16>(maps, p, base, w, h, row0, nkt);
    return;
  }

  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, n = p.n;
  const int rr0 = 16 * warp + g, r0 = row0 + rr0, r1 = r0 + 8;
  const int ngrp = (p.nqb + 1) / 2;
  const int* idw = p.kind == kRegionIds ? p.ids + (size_t)(w % p.nw) * n : nullptr;
  const int id0 = idw != nullptr && r0 < n ? __ldg(idw + r0) : 0;
  const int id1 = idw != nullptr && r1 < n ? __ldg(idw + r1) : 0;
  const AddendRows ar = addend_rows<KT>(p, w, h, row0, rr0);
  if (L.qres >= 0) {
    ring::mbar_wait(base + L.bars + 16 * L.stages, 0);
    scale_q(sm + L.qres, p.nqb * kRows * 8, p.scale, threadIdx.x, p.cwg * kConsumers);
    ring::fence_proxy_async();
    ring::bar_sync(1, p.cwg * kConsumers);
  }

  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f, inv0 = 0.f, inv1 = 0.f;
  float S[32], O[NB][32];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int e = 0; e < 32; ++e) O[b][e] = 0.f;
  Cursor cur(wg * (L.stages / p.cwg), L.stages / p.cwg);
  for (int pass = 0; pass < 2; ++pass) {
    for (int kt = wg; kt < nkt; kt += p.cwg) {
      for (int gi = 0; gi < ngrp; ++gi, cur.next()) {
        const uint32_t full = base + L.bars + 8 * cur.slot, empty = full + 8 * L.stages;
        const uint32_t st = base + L.ring + cur.slot * L.stage;
        ring::mbar_wait(full, cur.parity);
        __syncwarp();
        const int kb = min(2, p.nqb - 2 * gi);
        uint32_t qa = base + L.qres + 2 * gi * kBlock;
        if (L.q >= 0) {  // q's columns of this group, streamed: scaled here
          scale_q(sm + (st - base) + L.q, kb * kRows * 8, p.scale, threadIdx.x & 127,
                  kConsumers);
          ring::fence_proxy_async();
          ring::bar_sync(2 + wg, kConsumers);
          qa = st + L.q;
        }
        // S (+)= q k^T over the group's column blocks, k16 steps up to d.
        ring::fence_acc(S);
        ring::wgmma_fence();
        for (int b = 0; b < kb; ++b) {
          const int cols = min(64, p.dqk - (2 * gi + b) * 64);
          const uint64_t da = ring::sw128_desc(qa + b * kBlock);
          const uint64_t db = ring::sw128_desc(st + L.k + b * kBlock);
          for (int kk = 0; 16 * kk < cols; ++kk)
            ring::wgmma_bf16_n64(S, da + 2 * kk, db + 2 * kk, (gi | b | kk) != 0);
        }
        ring::wgmma_commit();
        ring::wgmma_wait<0>();
        ring::fence_acc(S);
        if (gi + 1 < ngrp) {
          __syncwarp();
          if (lane == 0) ring::mbar_arrive(empty);
          continue;
        }

        score_epilogue<true, KT>(p, sm + (st - base), ar, kt, row0, rr0, id0, id1, S);
        if (pass == 0) {
          float x0 = -INFINITY, x1 = -INFINITY;
#pragma unroll
          for (int j = 0; j < KT / 8; ++j) {
            x0 = fmaxf(x0, fmaxf(S[4 * j], S[4 * j + 1]));
            x1 = fmaxf(x1, fmaxf(S[4 * j + 2], S[4 * j + 3]));
          }
          // Each row's max and sum of exp(s - max), rescaled at a new max
          // (the tile holds a real key, so the new max is finite).
          x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, 1));
          x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, 2));
          x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, 1));
          x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, 2));
          const float n0 = fmaxf(m0, x0), n1 = fmaxf(m1, x1);
          const float c0 = n0 * kLog2e, c1 = n1 * kLog2e;
          float s0 = 0.f, s1 = 0.f;
#pragma unroll
          for (int j = 0; j < KT / 8; ++j) {
            s0 += ex2(fmaf(S[4 * j], kLog2e, -c0)) + ex2(fmaf(S[4 * j + 1], kLog2e, -c0));
            s1 += ex2(fmaf(S[4 * j + 2], kLog2e, -c1)) + ex2(fmaf(S[4 * j + 3], kLog2e, -c1));
          }
          s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
          s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
          s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
          s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
          l0 = l0 * __expf(m0 - n0) + s0;
          l1 = l1 * __expf(m1 - n1) + s1;
          m0 = n0;
          m1 = n1;
        } else {
          // O += P v, P normalized and then rounded to bf16, in the A
          // fragments of four k16 steps over the tile's keys.
          uint32_t pa[KT / 16][4];
          const float c0 = m0 * kLog2e, c1 = m1 * kLog2e;
          auto prob = [&](float x, float c, float inv) { return ex2(fmaf(x, kLog2e, -c)) * inv; };
#pragma unroll
          for (int kk = 0; kk < KT / 16; ++kk) {
            const float* s0 = S + 8 * kk;
            pa[kk][0] = core::pack_bf16(prob(s0[0], c0, inv0), prob(s0[1], c0, inv0));
            pa[kk][1] = core::pack_bf16(prob(s0[2], c1, inv1), prob(s0[3], c1, inv1));
            pa[kk][2] = core::pack_bf16(prob(s0[4], c0, inv0), prob(s0[5], c0, inv0));
            pa[kk][3] = core::pack_bf16(prob(s0[6], c1, inv1), prob(s0[7], c1, inv1));
          }
#pragma unroll
          for (int b = 0; b < NB; ++b) ring::fence_acc(O[b]);
          ring::wgmma_fence();
#pragma unroll
          for (int b = 0; b < NB; ++b) {
            const uint64_t dv = ring::sw128_mn_desc(st + L.v + b * KT * 128);
#pragma unroll
            for (int kk = 0; kk < KT / 16; ++kk)
              ring::wgmma_bf16_n64_rs_mn(O[b], pa[kk], dv + 128 * kk, 1);
          }
          ring::wgmma_commit();
          ring::wgmma_wait<0>();
#pragma unroll
          for (int b = 0; b < NB; ++b) ring::fence_acc(O[b]);
        }
        __syncwarp();
        if (lane == 0) ring::mbar_arrive(empty);
      }
    }
    if (pass == 0 && p.cwg == 2) {
      float m[2] = {m0, m1}, l[2] = {l0, l1};
      merge_stats<false>(sm, L, wg, m, l);
      m0 = m[0], m1 = m[1], l0 = l[0], l1 = l[1];
    }
    inv0 = 1.f / l0;
    inv1 = 1.f / l1;
  }
  if (p.cwg == 2 && !merge_out(sm, L, wg, O)) return;

  // The rows' outputs rounded to bf16, two columns a store.
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 64 * b + 8 * j + 2 * t;
      if (col >= p.dv) continue;
      if (r0 < n)
        *reinterpret_cast<uint32_t*>(rows.dst(w, h, r0) + col) =
            core::pack_bf16(O[b][4 * j], O[b][4 * j + 1]);
      if (r1 < n)
        *reinterpret_cast<uint32_t*>(rows.dst(w, h, r1) + col) =
            core::pack_bf16(O[b][4 * j + 2], O[b][4 * j + 3]);
    }
}

// A 4-D tensor map of q, k or v (`cols` elements of d, then token, head
// and window, ordered by stride) in boxes of [box_rows tokens, 128 bytes]
// with the 128-byte swizzle; perm gets the map positions of token, head
// and window (2 bits each). A dimension of extent 1 is never stepped and
// takes the largest stride, so that the strides ascend.
template <typename T>
bool encode_rows(CUtensorMap* map, const T* base, int cols, int n, int heads, int windows,
                 const Strides& st, int box_rows, int& perm) {
  struct Dim {
    long long ext, stride;
    int id;
  } d[3] = {{n, st.token, 0}, {heads, st.head, 1}, {windows, st.window, 2}};
  long long top = cols;
  for (const Dim& e : d)
    if (e.ext > 1 && e.stride > top) top = e.stride;
  for (Dim& e : d) {
    if (e.ext == 1) e.stride = top;
    if (e.stride <= 0 || (e.stride * (long long)sizeof(T)) % 16 != 0) return false;
  }
  for (int i = 1; i < 3; ++i)
    for (int j = i; j > 0 && d[j].stride < d[j - 1].stride; --j) {
      const Dim x = d[j];
      d[j] = d[j - 1];
      d[j - 1] = x;
    }
  const cuuint64_t dims[4] = {(cuuint64_t)cols, (cuuint64_t)d[0].ext, (cuuint64_t)d[1].ext,
                              (cuuint64_t)d[2].ext};
  const cuuint64_t strides[3] = {(cuuint64_t)(d[0].stride * sizeof(T)),
                                 (cuuint64_t)(d[1].stride * sizeof(T)),
                                 (cuuint64_t)(d[2].stride * sizeof(T))};
  cuuint32_t box[4] = {128 / (cuuint32_t)sizeof(T), 1, 1, 1};
  perm = 0;
  for (int i = 0; i < 3; ++i) {
    if (d[i].id == 0) box[i + 1] = box_rows;
    perm |= (i + 1) << (2 * d[i].id);
  }
  return ring::encode_4d(map, std::is_same<T, float>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                                            : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                         base, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// An f32 addend [planes, n, n] as [32 keys, 64 rows] boxes, 128-byte swizzle.
inline bool encode_addend(CUtensorMap* map, const float* base, int n, int planes) {
  const cuuint64_t dims[4] = {(cuuint64_t)n, (cuuint64_t)n, (cuuint64_t)planes, 1};
  const cuuint64_t row = (cuuint64_t)n * 4, plane = row * n;
  const cuuint64_t strides[3] = {row, plane, plane * planes};
  const cuuint32_t box[4] = {32, kRows, 1, 1};
  return ring::encode_4d(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, base, dims, strides, box,
                         CU_TENSOR_MAP_SWIZZLE_128B);
}

// The shared-memory layout of a launch: resident q where d fits (else
// streamed in each stage), f32's lo scratch, a split block's exchange, and
// as many ring stages (2 to kMaxStages) as fit two blocks an SM, else one
// (and always one for a split block): a
// consumer that is quick with its tiles waits on the copies' latency, which
// only more stages in flight hide.
constexpr int kMaxStages = 8;
template <typename T>
bool plan(Layout& L, int nqb, int nvb, bool bias, bool dense, bool ids, bool tma_add, int cwg) {
  constexpr int KT = Tile<T>::kKeys, GB = Tile<T>::kGroup;
  constexpr bool kF32 = std::is_same<T, float>::value;
  const int kb = nqb < GB ? nqb : GB;
  const bool qres = nqb <= Tile<T>::kQRes;
  int off = 0;
  L.qres = qres ? off : -1;
  off += qres ? nqb * kBlock : 0;
  // f32: q's lo parts (once per block, or per warpgroup where they stream)
  // and k's (per warpgroup).
  L.qlo = kF32 ? off : -1;
  L.qlo_wg = qres ? 0 : kb * kBlock;
  off += kF32 ? (qres ? nqb : kb) * kBlock + (cwg - 1) * L.qlo_wg : 0;
  L.klo = kF32 ? off : -1;
  L.klo_wg = kb * KT * 128;
  off += kF32 ? cwg * L.klo_wg : 0;
  L.xch = cwg == 2 ? off : -1;
  off += cwg == 2 ? 4 * 2 * kConsumers * 4 : 0;
  L.ring = off;
  int st = 0;
  L.k = st;
  st += kb * KT * 128;
  L.q = qres ? -1 : st;
  st += qres ? 0 : kb * kBlock;
  L.v = st;
  st += nvb * KT * 128;
  const int tile = tma_add ? KT / 32 * kBlock : kRows * (KT * 4 + 16);  // an addend tile
  L.bias = bias ? st : -1;
  st += bias ? tile : 0;
  L.mask = dense ? st : -1;
  st += dense ? tile : 0;
  L.ids = ids ? st : -1;
  st += ids ? KT * 4 : 0;
  L.stage = (int)align128(st);
  L.stage = (L.stage + 1023) & ~1023;
  auto bytes = [&](int stages) { return 1024 + off + stages * L.stage + 16 * stages + 8; };
  // A split block runs alone on its SM: it takes the whole budget.
  const int two_per_sm = cwg == 2 ? 0 : 113 * 1024;
  for (L.stages = kMaxStages; L.stages > 2 && bytes(L.stages) > two_per_sm; --L.stages) {
  }
  if (bytes(L.stages) > two_per_sm)
    for (L.stages = kMaxStages; L.stages > 2 && bytes(L.stages) > core::kSmemLimit; --L.stages) {
    }
  L.stages -= L.stages % cwg;  // a split block's warpgroups own half the slots each
  L.bars = off + L.stages * L.stage;
  L.bytes = bytes(L.stages);
  // A split block's warpgroup 1 leaves its output sums in the ring.
  const bool out_fits = cwg == 1 || L.stages * L.stage >= nvb * Tile<T>::kCols * kRows * 4;
  return L.bytes <= core::kSmemLimit && out_fits;
}

// The maps and parameters of a launch of DV output columns a block, and
// its grid; cudaErrorInvalidValue where a shape or layout is refused.
template <typename T, class Rows>
cudaError_t prepare(const Rows& rows, const Addends& ad, int windows, int heads, int n, int dqk,
                    int dv, int DV, bool split, float scale, float causal_neg, Maps& maps,
                    Params& p, int& blocks) {
  constexpr int KT = Tile<T>::kKeys, CB = Tile<T>::kCols;
  if (windows <= 0 || heads <= 0 || n <= 0 || dqk <= 0 || dqk % 8 != 0 || dv <= 0 ||
      dv > DV || dv % 8 != 0 || ad.nw <= 0 || ad.mask_kind < kNoMask || ad.mask_kind > kCausal ||
      ((ad.mask_kind == kNoMask || ad.mask_kind == kCausal) != (ad.mask == nullptr)))
    return cudaErrorInvalidValue;
  p = Params{};
  p.n = n, p.dqk = dqk, p.dv = dv, p.heads = heads, p.nw = ad.nw, p.kind = ad.mask_kind;
  p.nqt = (n + kRows - 1) / kRows;
  p.items = windows * heads;
  if ((long long)windows * heads * p.nqt > 0x7fffffffLL) return cudaErrorInvalidValue;
  blocks = p.items * p.nqt;
  p.nqb = (dqk + CB - 1) / CB;
  p.nvb = (dv + CB - 1) / CB;
  p.scale = scale, p.causal_neg = causal_neg;
  p.bias = ad.bias;
  const bool dense = ad.mask_kind == kMaskF32, ids = ad.mask_kind == kRegionIds;
  p.mask = dense ? static_cast<const float*>(ad.mask) : nullptr;
  p.ids = ids ? static_cast<const int*>(ad.mask) : nullptr;
  p.tma_add = n % 4 == 0 && (reinterpret_cast<uintptr_t>(p.bias) & 15) == 0 &&
              (reinterpret_cast<uintptr_t>(p.mask) & 15) == 0;
  p.use_cp = (!p.tma_add && (p.bias != nullptr || dense)) || ids;
  // Two consumer warpgroups split each block's key tiles (one block an SM,
  // each half as long) where that takes fewer block times than one
  // warpgroup a block at two blocks an SM: where ceil(blocks / SMs) is odd,
  // i.e. the last wave of two-per-SM blocks would be half full or less
  // (every grid up to one block an SM, 288 blocks at N = 576). Each
  // warpgroup needs two ring slots at least.
  const int waves = (blocks + sm_count() - 1) / sm_count();
  p.cwg = split && waves % 2 == 1 ? 2 : 1;
  if (p.cwg == 2 &&
      !(plan<T>(p.L, p.nqb, DV / CB, p.bias != nullptr, dense, ids, p.tma_add, 2) &&
        p.L.stages >= 4))
    p.cwg = 1;
  if (p.cwg == 1 && !plan<T>(p.L, p.nqb, DV / CB, p.bias != nullptr, dense, ids, p.tma_add, 1))
    return cudaErrorInvalidValue;
  maps = Maps{};
  if (!encode_rows<T>(&maps.q, rows.q, dqk, n, heads, windows, rows.sq, kRows, p.perm_q) ||
      !encode_rows<T>(&maps.k, rows.k, dqk, n, heads, windows, rows.sk, KT, p.perm_k) ||
      !encode_rows<T>(&maps.v, rows.v, dv, n, heads, windows, rows.sv, KT, p.perm_v))
    return cudaErrorInvalidValue;
  if (p.tma_add && ((p.bias != nullptr && !encode_addend(&maps.bias, p.bias, n, heads)) ||
                    (dense && !encode_addend(&maps.mask, p.mask, n, ad.nw))))
    return cudaErrorInvalidValue;
  return cudaSuccess;
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
  Maps maps;
  Params p;
  int blocks = 0;
  cudaError_t err = prepare<bf16>(rows, ad, windows, heads, n, dqk, dv, DV, true, scale,
                                  core::round_bf16_host(-1e9f), maps, p, blocks);
  if (err != cudaSuccess) return err;
  auto kernel = window_tiled_kernel<Rows, DV>;
  err = once_per_device(smem_raised<Rows, DV>, [&] {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                core::kSmemLimit);
  });
  if (err != cudaSuccess) return err;
  kernel<<<blocks, p.cwg * kConsumers + 32, p.L.bytes, s>>>(maps, p, rows);
  return cudaGetLastError();
}

// K6-K8 on `windows` x `heads` items of any N = n: q k^T over dqk columns
// (a multiple of 8), dv <= 128 output columns (a multiple of 8) of v's and
// out's views, scores scaled by `scale` (rounded to bf16 by the caller).
// Every pointer and stride 16-byte aligned, as the tensor maps need.
template <class Rows>
cudaError_t run(const Rows& rows, const Addends& ad, int windows, int heads, int n, int dqk,
                int dv, float scale, cudaStream_t s) {
  if (dv <= 64) return launch<Rows, 64>(rows, ad, windows, heads, n, dqk, dv, scale, s);
  return launch<Rows, 128>(rows, ad, windows, heads, n, dqk, dv, scale, s);
}

}  // namespace core_tiled
}  // namespace bt
