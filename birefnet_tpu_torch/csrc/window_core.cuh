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
// - Pass 1 computes each tile's scores (q k^T by mma.sync m16n8k16 over d
//   in chunks of up to 64 columns, plus the addends) and keeps each row's
//   running max and sum in f32, rescaling the sum at each new max.
// - Pass 2 recomputes the same scores tile by tile (bitwise the first
//   pass's), forms exp(s - m) / l, rounds it to bf16 and accumulates P v in
//   f32 registers.
//
// A one-pass online softmax would round unnormalized probabilities to bf16
// and rescale the sums afterwards: another rounding than the JAX kernel's
// and the plain version's, which normalize before the cast. The price is a
// second q k^T, on an API path no forward calls.
//
// What bounds it: the scores are recomputed, so per (window, head) it does
// 6 N^2 d flops (two q k^T, one P v) against 8 N d bytes plus the addends;
// at N = 1024, d = 128 that is about 770 flops a byte, above the H100's
// bf16 ridge, so large calls are bound by the tensor cores and small ones
// (N = 257, 576) by latency. The design answers the latency:
// - The key tiles stream through two buffers: the next (key tile, d chunk)
//   stage of k (and, in pass 2, the next tile's v rows) is copied by
//   cp.async while the current one computes. A first body that waited for
//   each tile's copies ran N = 4096 causal at 8.5x SDPA's time.
// - flash_attention's causal flag skips the key tiles past a block's last
//   query row in both passes: their probabilities are exactly 0 (bf16(-1e9)
//   under every row's max, whose exp underflows) and their sums exactly 0,
//   so the output is bitwise what the whole walk gives.
// - The addends are read in place: the f32 bias and a dense f32 mask from
//   device memory and L2 (too large to stage at these N), region ids from
//   L1, the causal flag from nothing. q stays in shared memory for the
//   whole block where d <= 128 (else its chunks stream beside k's).
//
// Head dim: q k^T contracts over dqk (a multiple of 8), and one launch
// writes dv <= 128 output columns of v's (the caller's) view: the wrapper
// launches one slice per 128 columns where d > 128. Pad keys get
// probability 0, pad query rows and columns are never written.
namespace core_tiled {

constexpr int kRows = 64;  // query rows a block: four warps of 16-row strips
constexpr int kKeys = 64;  // keys a tile
constexpr int kThreads = 128;

// Chunks of q kept in shared memory: two of 64 columns (d <= 128 stays for
// the whole block; above, the two slots hold the streamed chunks), one of a
// narrower chunk (d fits it).
__host__ __device__ constexpr int q_chunks(int dk) { return dk == 64 ? 2 : 1; }

// q's chunks, then two buffers each of k chunks and v tiles.
__host__ __device__ constexpr size_t smem_bytes(int dk, int dv) {
  return ((size_t)q_chunks(dk) * kRows * dk + 2 * (size_t)kKeys * dk + 2 * (size_t)kKeys * dv) *
         2;
}

// Copy rows [r0, r0 + 64) and columns [c0, c0 + W) of operand `part` of
// head h into a [64, W] tile, swizzled as core::swz; zero at rows past n
// and columns past `cols`.
template <class Rows, int W>
__device__ __forceinline__ void stage(const Rows& rows, bf16* dst, int part, long long item,
                                      int h, int r0, int n, int c0, int cols) {
  constexpr int cpr = W / 8;
  for (int e = threadIdx.x; e < 64 * cpr; e += kThreads) {
    const int i = e / cpr, c = e - (e / cpr) * cpr;
    const int r = r0 + i, col = c0 + c * 8;
    const bool valid = r < n && col < cols;
    const bf16* src = valid ? rows.in(part, item, h, r) + col : rows.in(part, item, h, 0);
    core::cp_async16(dst + i * W + core::swz<W>(i, c) * 8, src, valid);
  }
}

// One block: query rows [64 qt, +64) of window w, head h; blockIdx.x =
// w * nqt + qt. DK: width of a q/k chunk (16, 32 or 64); DV: width of the
// v tile and the output slice (16 to 128).
template <class Rows, int DK, int DV>
__global__ void __launch_bounds__(kThreads)
window_tiled_kernel(Rows rows, Addends ad, int n, int dqk, int dv, int nqt, float scale,
                    float causal_neg) {
  constexpr int KD = DK / 16, OT = DV / 8, NT = kKeys / 8, QC = q_chunks(DK);
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);  // QC x [64, DK]
  bf16* ks = qs + QC * kRows * DK;           // 2 x [64, DK]
  bf16* vs = ks + 2 * kKeys * DK;            // 2 x [64, DV]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int w = blockIdx.x / nqt, qt = blockIdx.x - w * nqt, h = blockIdx.y;
  const long long item = rows.item(w);
  const int row0 = qt * kRows;
  const int r0 = row0 + warp * 16 + g, r1 = r0 + 8;
  const int nck = (dqk + DK - 1) / DK;
  const bool qres = nck <= QC;
  const int kind = ad.mask_kind;
  // Key tiles to walk: all of them, or with the causal flag those up to the
  // block's last real query row.
  int nkt = (n + kKeys - 1) / kKeys;
  if (kind == kCausal) nkt = min(nkt, (min(row0 + kRows, n) - 1) / kKeys + 1);
  const int stages = nkt * nck;  // (key tile, d chunk) stages of one pass
  const float* bias = ad.bias != nullptr ? ad.bias + (size_t)h * n * n : nullptr;
  const float* dense = kind == kMaskF32
                           ? static_cast<const float*>(ad.mask) + (size_t)(w % ad.nw) * n * n
                           : nullptr;
  const int* ids = kind == kRegionIds
                       ? static_cast<const int*>(ad.mask) + (size_t)(w % ad.nw) * n
                       : nullptr;
  const int id0 = ids != nullptr && r0 < n ? __ldg(ids + r0) : 0;
  const int id1 = ids != nullptr && r1 < n ? __ldg(ids + r1) : 0;

  if (qres) {
    for (int c = 0; c < nck; ++c)
      stage<Rows, DK>(rows, qs + c * kRows * DK, 0, item, h, row0, n, c * DK, dqk);
    asm volatile("cp.async.commit_group;\n");
  }

  // Copy stage i (key tile i / nck, d chunk i % nck) into buffer i % 2: its
  // k chunk, q's chunk where q does not stay, and with with_v the tile's v
  // rows (at its first chunk) into v buffer kt % 2. One commit group a
  // stage, empty past the last.
  auto fetch = [&](int i, bool with_v) {
    if (i < stages) {
      const int kt = i / nck, c = i - kt * nck;
      if (!qres) stage<Rows, DK>(rows, qs + (i & 1) * kRows * DK, 0, item, h, row0, n, c * DK, dqk);
      stage<Rows, DK>(rows, ks + (i & 1) * kKeys * DK, 1, item, h, kt * kKeys, n, c * DK, dqk);
      if (with_v && c == 0)
        stage<Rows, DV>(rows, vs + (kt & 1) * kKeys * DV, 2, item, h, kt * kKeys, n, 0, dv);
    }
    asm volatile("cp.async.commit_group;\n");
  };

  // Scores of key tile kt (stages kt nck ..) with their addends (pad keys
  // -inf), the next stage's copies requested before each chunk computes.
  auto scores = [&](int kt, bool with_v, float (&sc)[NT][4]) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int u = 0; u < 4; ++u) sc[j][u] = 0.f;
    for (int c = 0; c < nck; ++c) {
      const int i = kt * nck + c;
      __syncthreads();  // every warp is past its reads of buffer (i + 1) % 2
      fetch(i + 1, with_v);
      asm volatile("cp.async.wait_group 1;\n");
      __syncthreads();
      __syncwarp();
      const bf16* qc = qs + (qres ? c : (i & 1)) * kRows * DK;
      const bf16* kc = ks + (i & 1) * kKeys * DK;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        unsigned qa[4];
        const int r = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int cq = 2 * kk + (lane >> 4);
        core::ldsm_x4(qa, qc + r * DK + core::swz<DK>(r, cq) * 8);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float2 f = core::unpack_bf16(qa[u]);
          qa[u] = core::pack_bf16(f.x * scale, f.y * scale);
        }
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          const int rk = 8 * j + (lane & 7) + (lane >> 4) * 8;
          const int ck = 2 * kk + ((lane >> 3) & 1);
          unsigned kb[4];
          core::ldsm_x4(kb, kc + rk * DK + core::swz<DK>(rk, ck) * 8);
          core::mma16816(sc[j], qa, kb[0], kb[1]);
          core::mma16816(sc[j + 1], qa, kb[2], kb[3]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int r = u < 2 ? r0 : r1, cc = kt * kKeys + 8 * j + 2 * t + (u & 1);
        if (cc >= n) {
          sc[j][u] = -INFINITY;
          continue;
        }
        float e = 0.f;
        if (bias != nullptr && r < n) e = core::load_addend(bias, (size_t)r * n + cc);
        if (ids != nullptr)
          e += __ldg(ids + cc) != (u < 2 ? id0 : id1) ? -100.f : 0.f;
        else if (kind == kCausal)
          e += cc > r ? causal_neg : 0.f;
        else if (dense != nullptr && r < n)
          e += core::load_addend(dense, (size_t)r * n + cc);
        sc[j][u] += e;
      }
  };

  // Pass 1: each row's max and sum of exp(s - max) over the key tiles.
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float sc[NT][4];
  fetch(0, false);
  for (int kt = 0; kt < nkt; ++kt) {
    scores(kt, false, sc);
    float x0 = -INFINITY, x1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      x0 = fmaxf(x0, fmaxf(sc[j][0], sc[j][1]));
      x1 = fmaxf(x1, fmaxf(sc[j][2], sc[j][3]));
    }
    x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, 1));
    x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, 2));
    x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, 1));
    x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, 2));
    // Every tile holds a real key, so the new max is finite; the old sum
    // (0 before the first tile) is rescaled to it.
    const float n0 = fmaxf(m0, x0), n1 = fmaxf(m1, x1);
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s0 += __expf(sc[j][0] - n0) + __expf(sc[j][1] - n0);
      s1 += __expf(sc[j][2] - n1) + __expf(sc[j][3] - n1);
    }
    s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
    s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
    s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
    s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
    l0 = l0 * __expf(m0 - n0) + s0;
    l1 = l1 * __expf(m1 - n1) + s1;
    m0 = n0;
    m1 = n1;
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;

  // Pass 2: O = P v, P normalized and then rounded to bf16.
  float o[OT][4];
#pragma unroll
  for (int jd = 0; jd < OT; ++jd)
#pragma unroll
    for (int u = 0; u < 4; ++u) o[jd][u] = 0.f;
  __syncthreads();  // every warp is past pass 1's reads of buffer 0
  fetch(0, true);
  for (int kt = 0; kt < nkt; ++kt) {
    scores(kt, true, sc);
    // The tile's v rows arrived with its first stage.
    const bf16* vt = vs + (kt & 1) * kKeys * DV;
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      const unsigned pa[4] = {
          core::pack_bf16(__expf(sc[j][0] - m0) * inv0, __expf(sc[j][1] - m0) * inv0),
          core::pack_bf16(__expf(sc[j][2] - m1) * inv1, __expf(sc[j][3] - m1) * inv1),
          core::pack_bf16(__expf(sc[j + 1][0] - m0) * inv0, __expf(sc[j + 1][1] - m0) * inv0),
          core::pack_bf16(__expf(sc[j + 1][2] - m1) * inv1, __expf(sc[j + 1][3] - m1) * inv1)};
#pragma unroll
      for (int jd = 0; jd < OT; jd += 2) {
        const int r = 8 * j + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int c = jd + (lane >> 4);
        unsigned vb[4];
        core::ldsm_x4_trans(vb, vt + r * DV + core::swz<DV>(r, c) * 8);
        core::mma16816(o[jd], pa, vb[0], vb[1]);
        core::mma16816(o[jd + 1], pa, vb[2], vb[3]);
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n");

  // The rows' outputs rounded to bf16, two columns a store.
#pragma unroll
  for (int jd = 0; jd < OT; ++jd) {
    const int col = 8 * jd + 2 * t;
    if (col >= dv) continue;
    if (r0 < n)
      *reinterpret_cast<unsigned*>(rows.dst(item, h, r0) + col) = core::pack_bf16(o[jd][0], o[jd][1]);
    if (r1 < n)
      *reinterpret_cast<unsigned*>(rows.dst(item, h, r1) + col) = core::pack_bf16(o[jd][2], o[jd][3]);
  }
}

// Whether a kernel's shared-memory limit is raised yet, per instantiation,
// per device and per translation unit.
namespace {
template <class Rows, int DK, int DV>
bool smem_raised[kMaxDevices];
}  // namespace

template <class Rows, int DK, int DV>
cudaError_t launch(const Rows& rows, const Addends& ad, int windows, int heads, int n, int dqk,
                   int dv, float scale, float causal_neg, cudaStream_t s) {
  const int nqt = (n + kRows - 1) / kRows;
  if ((long long)windows * nqt > 0x7fffffffLL) return cudaErrorInvalidValue;
  auto kernel = window_tiled_kernel<Rows, DK, DV>;
  const size_t smem = smem_bytes(DK, DV);
  const cudaError_t err = once_per_device(smem_raised<Rows, DK, DV>, [&] {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  });
  if (err != cudaSuccess) return err;
  kernel<<<dim3(windows * nqt, heads), kThreads, smem, s>>>(rows, ad, n, dqk, dv, nqt, scale,
                                                            causal_neg);
  return cudaGetLastError();
}

// K6-K8 on `windows` x `heads` items of any N = n: q k^T over dqk columns
// (a multiple of 8), dv <= 128 output columns (a multiple of 8) of v's and
// out's views, scores scaled by `scale` (rounded to bf16 by the caller).
template <class Rows>
cudaError_t run(const Rows& rows, const Addends& ad, int windows, int heads, int n, int dqk,
                int dv, float scale, cudaStream_t s) {
  if (windows <= 0 || heads <= 0 || heads > 65535 || n <= 0 || dqk <= 0 || dqk % 8 != 0 ||
      dv <= 0 || dv > 128 || dv % 8 != 0 || ad.nw <= 0 || ad.mask_kind < kNoMask ||
      ad.mask_kind > kCausal ||
      ((ad.mask_kind == kNoMask || ad.mask_kind == kCausal) != (ad.mask == nullptr)))
    return cudaErrorInvalidValue;
  const float causal_neg = core::round_bf16_host(-1e9f);
  if (dqk <= 16 && dv <= 16)
    return launch<Rows, 16, 16>(rows, ad, windows, heads, n, dqk, dv, scale, causal_neg, s);
  if (dqk <= 32 && dv <= 32)
    return launch<Rows, 32, 32>(rows, ad, windows, heads, n, dqk, dv, scale, causal_neg, s);
  if (dv <= 16)
    return launch<Rows, 64, 16>(rows, ad, windows, heads, n, dqk, dv, scale, causal_neg, s);
  if (dv <= 32)
    return launch<Rows, 64, 32>(rows, ad, windows, heads, n, dqk, dv, scale, causal_neg, s);
  if (dv <= 64)
    return launch<Rows, 64, 64>(rows, ad, windows, heads, n, dqk, dv, scale, causal_neg, s);
  return launch<Rows, 64, 128>(rows, ad, windows, heads, n, dqk, dv, scale, causal_neg, s);
}

}  // namespace core_tiled
}  // namespace bt
