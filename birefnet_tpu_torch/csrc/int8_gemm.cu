// The W8A8 kernels of int8.cuh for sm_90a: the per-token int8 row pass and
// the int8 GEMM with its dequant epilogues, shared by K1-int8
// (bt_fused_block_attn_i8, the int8 branch of
// birefnet_tpu/ops/pallas/fused_block_attn.py::_fused) and, for the row
// pass only, K3 (fused_mlp_i8.cu, fused_mlp.py::_fused_i8: its LN2 codes).
// The TPU kernels quantize and multiply inside one body; here they are
// launches on one stream.
//
// What bounds them on the card. The GEMMs are 2 M N K integer operations
// against the 1,979 TOP/s dense int8 peak, which only wgmma reaches: K1-int8's
// qkv and proj are 1.24 TOP per Swin-L forward (0.63 ms at peak). The row
// pass is bound by bytes: a bf16 or f32 row read once (2 or 4 bytes an
// element), int8 codes written once (1 byte).
//
// gemm<EPI>: the persistent, warp-specialized wgmma/TMA GEMM of
// wgmma_ring.cuh (which the bf16 GEMM of bf16_gemm.cu shares), instantiated
// for s8 x s8 -> s32 with the dequant epilogues into bf16 or f32; its note
// gives the design.
//
// quant_rows_kernel: the register-resident row of rows.cuh. Statistics,
// the LN, pad zeroing and the rounding to the row type, the absmax and the
// codes all come from the one read.

#include <type_traits>

#include "int8.cuh"
#include "rows.cuh"
#include "wgmma_ring.cuh"

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
      // The TPU kernel's h.astype(tokens.dtype): f32 rows stay unrounded.
      if (PAD) h = valid ? (std::is_same<Tin, bf16>::value ? round_bf16(h) : h) : 0.f;
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

template <int EPI, typename Out>
cudaError_t gemm(const int8_t* A, const float* sa, const int8_t* W, const float* sw,
                 const float* bias, const Out* res, Out* out, int M, int N, int K,
                 cudaStream_t s) {
  return ring::launch<int8_t, EPI, Out>(A, W, sa, sw, bias, res, out, M, N, K, s);
}

#define BT_QUANT_ROWS(T, LN, PAD)                                                            \
  template cudaError_t quant_rows<T, LN, PAD>(const T*, const float*, const float*, int8_t*, \
                                              float*, int, int, Geometry, cudaStream_t);
BT_QUANT_ROWS(bf16, true, true)
BT_QUANT_ROWS(bf16, false, false)
BT_QUANT_ROWS(bf16, true, false)
BT_QUANT_ROWS(float, true, true)
BT_QUANT_ROWS(float, false, false)
BT_QUANT_ROWS(float, true, false)
#undef BT_QUANT_ROWS

#define BT_GEMM(EPI, Out)                                                                   \
  template cudaError_t gemm<EPI, Out>(const int8_t*, const float*, const int8_t*,          \
                                      const float*, const float*, const Out*, Out*, int, int, \
                                      int, cudaStream_t);
BT_GEMM(kStore, bf16)
BT_GEMM(kResidual, bf16)
BT_GEMM(kStore, float)
BT_GEMM(kResidual, float)
#undef BT_GEMM

}  // namespace i8
}  // namespace bt

namespace {

// The GEMM entry at one output type.
template <typename Out>
int i8_gemm(const int8_t* a, const float* fa, const int8_t* w, const float* fw,
            const float* fb, const void* res, void* out, int M, int N, int K, int epi,
            cudaStream_t s) {
  namespace i8 = bt::i8;
  auto o = static_cast<Out*>(out);
  switch (epi) {
    case bt::kStore:
      return (int)i8::gemm<bt::kStore, Out>(a, fa, w, fw, fb, nullptr, o, M, N, K, s);
    case bt::kResidual:
      if (res == nullptr) return (int)cudaErrorInvalidValue;
      return (int)i8::gemm<bt::kResidual, Out>(a, fa, w, fw, fb, static_cast<const Out*>(res),
                                                o, M, N, K, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The row pass at one row type: mode 0 plain, 1 LN, 2 LN on a canvas.
template <typename T>
int i8_quant_rows(const void* x, const float* g, const float* b, int8_t* q, float* sc, int T_,
                  int K, int mode, const bt::Geometry& geo, cudaStream_t s) {
  namespace i8 = bt::i8;
  auto xt = static_cast<const T*>(x);
  switch (mode) {
    case 0:
      return (int)i8::quant_rows<T, false, false>(xt, g, b, q, sc, T_, K, geo, s);
    case 1:
      return (int)i8::quant_rows<T, true, false>(xt, g, b, q, sc, T_, K, geo, s);
    case 2:
      return (int)i8::quant_rows<T, true, true>(xt, g, b, q, sc, T_, K, geo, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Entries for the tests and chip_smoke.py only (the model reaches these
// kernels through bt_fused_block_attn_i8[_f32] and bt_fused_mlp_i8[_f32]).

// out = epilogue(A W^T dequantized): A [M, K] and W [N, K] int8, sa [M],
// sw [N], bias [N] f32, res [M, N] (epi 1 only, else null) and out [M, N]
// bf16 (out_f32 0) or f32 (out_f32 1).
extern "C" int bt_i8_gemm(const void* A, const void* sa, const void* W, const void* sw,
                          const void* bias, const void* res, void* out, int M, int N, int K,
                          int epi, int out_f32, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto a = static_cast<const int8_t*>(A);
  auto w = static_cast<const int8_t*>(W);
  auto fa = static_cast<const float*>(sa);
  auto fw = static_cast<const float*>(sw);
  auto fb = static_cast<const float*>(bias);
  return out_f32 ? i8_gemm<float>(a, fa, w, fw, fb, res, out, M, N, K, epi, s)
                 : i8_gemm<bf16>(a, fa, w, fw, fb, res, out, M, N, K, epi, s);
}

// int8 rows of x [T, K], bf16 (x_f32 0) or f32 (x_f32 1): mode 0 plain,
// 1 LN, 2 LN with the canvas's pad tokens zeroed and the rows rounded to
// x's type (the canvas is [T / (Hp Wp), Hp, Wp, K] with the geometry's
// shift, origin and real extent). q [T, K] int8, scale [T] f32.
extern "C" int bt_i8_quant_rows(const void* x, const void* ln_g, const void* ln_b, void* q,
                                void* scale, int T, int K, int mode, int x_f32, int Hp, int Wp,
                                int shift, int origin, int h_real, int w_real, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto g = static_cast<const float*>(ln_g);
  auto b = static_cast<const float*>(ln_b);
  auto qq = static_cast<int8_t*>(q);
  auto sc = static_cast<float*>(scale);
  const bt::Geometry geo{Hp, Wp, K, 0, 1, shift, origin, h_real, w_real};
  if (mode == 2 && (Hp <= 0 || Wp <= 0)) return (int)cudaErrorInvalidValue;
  return x_f32 ? i8_quant_rows<float>(x, g, b, qq, sc, T, K, mode, geo, s)
               : i8_quant_rows<bf16>(x, g, b, qq, sc, T, K, mode, geo, s);
}
