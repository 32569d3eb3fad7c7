// Kernel P1: int8 x int8 -> int32 convolution (NHWC input, OHWI weights)
// with a fused dequant epilogue, for sm_90a.
//
// The port's own kernel; it has no Pallas counterpart. It replaces the
// int8 lax.conv_general_dilated(..., preferred_element_type=int32) of
// nind_denoise_tpu/ops/qconv.py qconv_raw (:187-231) that UtNet's int8
// forward (models/utnet.py apply_int8) runs 20 times (dynamic scales) or
// 21 times (static scales) a forward.
//
//   acc[n, oy, ox, o] = sum_{a, b, c} xq[n, iy, ix, c] * wq[o, a, b, c]
//   with the input dilated by `dil` (lhs dilation) and zero padded by
//   (pt, pl) at the top and left: iy = (oy + a - pt) / dil when that is a
//   whole number in [0, h), else the tap reads zero.
//   out = int32 acc, or float(acc) * (sx[n] * sw[q][o]) (+ bias[o]) in
//   fp32 or bf16, with q the output column's parity when sw holds two
//   vectors (the level-4 composed conv) and 0 otherwise.
//
// Design (simple first): an implicit GEMM, M = output pixels, N = output
// channels, K = taps x input channels, on mma.sync.m16n8k32.s8 with exact
// int32 sums. A CTA of 4 warps computes a 128 x 64 tile; each warp 64 x 32.
// K advances 64 bytes (one tap, 64 channels) a stage through a 3-stage
// cp.async ring; cp.async's zero fill supplies the padding, the halo and
// the channel tail (a Cin that is no multiple of 64 is zero filled in
// shared memory, which is exact). Inputs with Cin % 16 != 0 take a
// byte-wise loader instead. Shared rows are 80 bytes, so that the
// fragments' 4-byte reads hit 32 distinct banks.
// With lhs dilation 2 the output is walked by phase (oy % 2, ox % 2):
// each phase is a conv over the undilated input with only the taps of
// matching parity, so no zero of the dilation is multiplied.
//
// What bounds it: operations (2 x MACs over the int8 peak of 1,979 TOPS)
// at the product's shapes; mma.sync without a warp-specialised TMA
// pipeline reaches a fraction of that. The epilogue writes from
// registers, two channels a store. wgmma with TMA is later work.
//
// The epilogue rounds like the plain version (ops/qconv.conv_int8_reference):
// __int2float_rn, then __fmul_rn by __fmul_rn(sx, sw), then __fadd_rn of
// the bias, then round-to-nearest-even to bf16: bit for bit.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BM = 128, BN = 64, BK = 64, STAGES = 3, THREADS = 128;
constexpr int ROWB = BK + 16;  // bytes per shared row (80)
constexpr int A_BYTES = BM * ROWB, B_BYTES = BN * ROWB;

enum OutKind { OUT_I32 = 0, OUT_F32 = 1, OUT_BF16 = 2 };

struct Params {
  const int8_t* x;
  const int8_t* wq;
  void* out;
  const float* sx;
  const float* sw;
  const float* bias;
  int n, h, w, cin;
  int ho, wo, cout;
  int kh, kw, pt, pl, dil;
  int sx_stride, sw_parity;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_s8(int* c, const unsigned* a, const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// first tap of parity class, count and step along one kernel axis for an
// output phase `ph` (dil 2) or all taps (dil 1)
__device__ __forceinline__ void tap_axis(int k, int pad, int ph, int dil, int& first,
                                         int& count) {
  if (dil == 1) {
    first = 0;
    count = k;
    return;
  }
  first = (((pad - ph) % 2) + 2) % 2;  // a with (ph + a - pad) even
  count = first < k ? (k - first + 1) / 2 : 0;
}

template <bool VEC, int OUT>
__global__ void __launch_bounds__(THREADS) qconv_kernel(Params p) {
  __shared__ __align__(16) int8_t smem[STAGES * (A_BYTES + B_BYTES)];
  int8_t* As = smem;
  int8_t* Bs = smem + STAGES * A_BYTES;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int warp_m = warp & 1, warp_n = warp >> 1;

  // this CTA's output phase, and the phase's pixel grid
  const int phase = blockIdx.z;
  const int py = p.dil == 2 ? phase >> 1 : 0, px = p.dil == 2 ? phase & 1 : 0;
  const int hp = p.dil == 2 ? (p.ho - py + 1) / 2 : p.ho;
  const int wp = p.dil == 2 ? (p.wo - px + 1) / 2 : p.wo;
  const long long m_total = (long long)p.n * hp * wp;
  const long long m0 = (long long)blockIdx.x * BM;
  if (m0 >= m_total || hp <= 0 || wp <= 0) return;
  const int n0 = blockIdx.y * BN;

  int a_first, a_count, b_first, b_count;
  tap_axis(p.kh, p.pt, py, p.dil, a_first, a_count);
  tap_axis(p.kw, p.pl, px, p.dil, b_first, b_count);
  const int tstep = p.dil;
  const int ncc = (p.cin + BK - 1) / BK;
  const int nk = a_count * b_count * ncc;

  // the A row this thread fills: output pixel m0 + tid
  const long long am = m0 + tid;
  const bool a_valid = am < m_total;
  int a_n = 0, a_oy = 0, a_ox = 0;
  if (a_valid) {
    const long long per = (long long)hp * wp;
    a_n = (int)(am / per);
    const int r = (int)(am % per);
    a_oy = (r / wp) * p.dil + py;
    a_ox = (r % wp) * p.dil + px;
  }
  // the B row and chunks this thread fills: channel n0 + tid/2, chunks 2*(tid&1)..+1
  const int bo = n0 + (tid >> 1);
  const int bchunk = (tid & 1) * 2;

  auto load_stage = [&](int buf, int k) {
    const int cc = k % ncc, ti = k / ncc;
    const int a = a_first + (ti / b_count) * tstep, b = b_first + (ti % b_count) * tstep;
    const int c0 = cc * BK;
    int8_t* as = As + buf * A_BYTES + tid * ROWB;
    int8_t* bs = Bs + buf * B_BYTES + (tid >> 1) * ROWB;
    // A: one output pixel's 64 channels at tap (a, b)
    int iy = a_oy + a - p.pt, ix = a_ox + b - p.pl;
    bool ok = a_valid;
    if (p.dil == 2) {  // the phase makes iy, ix even
      iy >>= 1;
      ix >>= 1;
    }
    ok = ok && iy >= 0 && iy < p.h && ix >= 0 && ix < p.w;
    const int8_t* src =
        ok ? p.x + (((long long)a_n * p.h + iy) * p.w + ix) * p.cin : p.x;
    // B: one output channel's 64 input channels at tap (a, b)
    const bool bok = bo < p.cout;
    const int8_t* wsrc =
        bok ? p.wq + (((long long)bo * p.kh + a) * p.kw + b) * p.cin : p.wq;
    if (VEC) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + 16 * j;
        const bool v = ok && c < p.cin;
        cp_async16(as + 16 * j, v ? src + c : p.x, v ? 16 : 0);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = c0 + 16 * (bchunk + j);
        const bool v = bok && c < p.cin;
        cp_async16(bs + 16 * (bchunk + j), v ? wsrc + c : p.wq, v ? 16 : 0);
      }
    } else {
      for (int j = 0; j < 16; ++j) {
        unsigned word = 0;
        for (int e = 0; e < 4; ++e) {
          const int c = c0 + 4 * j + e;
          const unsigned v = (ok && c < p.cin) ? (unsigned)(uint8_t)src[c] : 0u;
          word |= v << (8 * e);
        }
        *reinterpret_cast<unsigned*>(as + 4 * j) = word;
      }
      for (int j = 0; j < 8; ++j) {
        unsigned word = 0;
        for (int e = 0; e < 4; ++e) {
          const int c = c0 + 16 * bchunk + 4 * j + e;
          const unsigned v = (bok && c < p.cin) ? (unsigned)(uint8_t)wsrc[c] : 0u;
          word |= v << (8 * e);
        }
        *reinterpret_cast<unsigned*>(bs + 16 * bchunk + 4 * j) = word;
      }
    }
  };

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_async_commit();
  }
  for (int k = 0; k < nk; ++k) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int kn = k + STAGES - 1;
    if (kn < nk) load_stage(kn % STAGES, kn);
    cp_async_commit();

    const int8_t* as = As + (k % STAGES) * A_BYTES + (warp_m * 64) * ROWB;
    const int8_t* bs = Bs + (k % STAGES) * B_BYTES + (warp_n * 32) * ROWB;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      unsigned af[4][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int8_t* r0 = as + (i * 16 + g) * ROWB + kk + tg * 4;
        const int8_t* r1 = r0 + 8 * ROWB;
        af[i][0] = *reinterpret_cast<const unsigned*>(r0);
        af[i][1] = *reinterpret_cast<const unsigned*>(r1);
        af[i][2] = *reinterpret_cast<const unsigned*>(r0 + 16);
        af[i][3] = *reinterpret_cast<const unsigned*>(r1 + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* c0 = bs + (j * 8 + g) * ROWB + kk + tg * 4;
        bf[j][0] = *reinterpret_cast<const unsigned*>(c0);
        bf[j][1] = *reinterpret_cast<const unsigned*>(c0 + 16);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    }
  }
  cp_async_wait<0>();

  // epilogue: each thread holds rows g and g+8 of four m16 tiles and
  // channel pairs (2*tg, 2*tg+1) of four n8 tiles
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long m = m0 + warp_m * 64 + i * 16 + g + half * 8;
      if (m >= m_total) continue;
      const long long per = (long long)hp * wp;
      const int nn = (int)(m / per);
      const int r = (int)(m % per);
      const int oy = (r / wp) * p.dil + py, ox = (r % wp) * p.dil + px;
      const long long obase = (((long long)nn * p.ho + oy) * p.wo + ox) * p.cout;
      float sxv = 0.f;
      const float* swv = p.sw;
      if (OUT != OUT_I32) {
        sxv = p.sx[nn * p.sx_stride];
        if (p.sw_parity) swv += (ox & 1) * p.cout;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int o = n0 + warp_n * 32 + j * 8 + tg * 2;
        const int* c = acc[i][j] + half * 2;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int oc = o + e;
          if (oc >= p.cout) continue;
          if (OUT == OUT_I32) {
            reinterpret_cast<int*>(p.out)[obase + oc] = c[e];
          } else {
            float y = __fmul_rn(__int2float_rn(c[e]), __fmul_rn(sxv, swv[oc]));
            if (p.bias) y = __fadd_rn(y, p.bias[oc]);
            if (OUT == OUT_F32)
              reinterpret_cast<float*>(p.out)[obase + oc] = y;
            else
              reinterpret_cast<__nv_bfloat16*>(p.out)[obase + oc] = __float2bfloat16_rn(y);
          }
        }
      }
    }
  }
}

template <bool VEC>
cudaError_t launch_vec(const Params& p, int out_kind, dim3 grid, cudaStream_t st) {
  switch (out_kind) {
    case OUT_I32: qconv_kernel<VEC, OUT_I32><<<grid, THREADS, 0, st>>>(p); break;
    case OUT_F32: qconv_kernel<VEC, OUT_F32><<<grid, THREADS, 0, st>>>(p); break;
    case OUT_BF16: qconv_kernel<VEC, OUT_BF16><<<grid, THREADS, 0, st>>>(p); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// x (n, h, w, cin) int8; w (cout, kh, kw, cin) int8; out (n, ho, wo, cout)
// of out_kind (0 int32, 1 fp32, 2 bf16). sx: n floats (sx_stride 1) or one
// (sx_stride 0); sw: cout floats, or 2 x cout chosen by the output column's
// parity (sw_parity 1); bias: cout floats or null. vec: x and w 16-byte
// aligned with cin % 16 == 0.
extern "C" int qconv_launch(const void* x, const void* w, void* out, const void* sx,
                            const void* sw, const void* bias, int n, int h, int wd,
                            int cin, int ho, int wo, int cout, int kh, int kw, int pt,
                            int pl, int dil, int sx_stride, int sw_parity, int out_kind,
                            int vec, void* stream) {
  Params p;
  p.x = (const int8_t*)x;
  p.wq = (const int8_t*)w;
  p.out = out;
  p.sx = (const float*)sx;
  p.sw = (const float*)sw;
  p.bias = (const float*)bias;
  p.n = n; p.h = h; p.w = wd; p.cin = cin;
  p.ho = ho; p.wo = wo; p.cout = cout;
  p.kh = kh; p.kw = kw; p.pt = pt; p.pl = pl; p.dil = dil;
  p.sx_stride = sx_stride; p.sw_parity = sw_parity;
  if (dil != 1 && dil != 2) return (int)cudaErrorInvalidValue;
  // the largest phase has ceil(ho/dil) x ceil(wo/dil) pixels per image
  const long long hp = (ho + dil - 1) / dil, wp = (wo + dil - 1) / dil;
  const long long mt = ((long long)n * hp * wp + BM - 1) / BM;
  if (mt <= 0 || mt > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)mt, (unsigned)((cout + BN - 1) / BN), dil * dil);
  cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t e = vec ? launch_vec<true>(p, out_kind, grid, st)
                            : launch_vec<false>(p, out_kind, grid, st);
  return (int)e;
}
