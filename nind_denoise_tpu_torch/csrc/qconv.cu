// Kernel P1: int8 x int8 -> int32 convolution (NHWC input, OHWI weights)
// with a fused epilogue, for sm_90a.
//
// The port's own kernel; it has no Pallas counterpart. It replaces the
// int8 lax.conv_general_dilated(..., preferred_element_type=int32) of
// nind_denoise_tpu/ops/qconv.py qconv_raw (:187-231) that UtNet's int8
// forward (models/utnet.py apply_int8) runs 20 times (dynamic scales) or
// 21 times (static scales) a forward, and the XLA ops fused around it
// there: the dequant, the bias, the decoder's fp32 sum, the PReLU and, in
// static mode, the quantize of the next conv's input.
//
//   acc[n, oy, ox, o] = sum_{a, b, c} xq[n, iy, ix, c] * wq[o, a, b, c]
//   with the input dilated by `dil` (lhs dilation) and zero padded by
//   (pt, pl) at the top and left: iy = (oy + a - pt) / dil when that is a
//   whole number in [0, h), else the tap reads zero.
//   out = int32 acc, or, in this order (ops/qconv.dequant_reference):
//     y = float(acc) * (sx[n] * sw[q][o])   (q: output column parity when
//                                            sw holds two rows, else 0)
//     y = addend[n, oy, ox, o] + y          (fp32, optional)
//     y = y + bias_map[oy, ox, o]           (fp32, optional)
//     y = y + bias[o]                       (fp32, optional)
//     y = round to the work dtype (fp32 or bf16)
//     y = y >= 0 ? y : round(a * y)         (PReLU, one weight, optional)
//     out = y, or int8 clamp(rint(y / s), +-127) with a static scale s.
//   Each step rounds as the torch op it replaces (__fmul_rn, __fadd_rn,
//   __fdiv_rn, round-to-nearest-even), so the output is bit-equal to the
//   plain version. The int32 sums are exact in any order.
//
// Design: an implicit GEMM, M = output pixels, N = output channels, K =
// taps x input channels, on Hopper's wgmma.m64nNk32.s32.s8.s8 (N = BN,
// 64 or 128 by Cout). A CTA has two consumer warpgroups and a producer
// warpgroup (setmaxnreg hands the producer's registers to the consumers).
// It owns a 16 x 16 block of output pixels of one output phase x BN
// channels; each consumer warpgroup two m64 blocks (8 rows of the block),
// each warp one row of 16 pixels per m64 block. K advances by 64-channel
// chunks. A chunk is one stage of a ring in shared memory, filled by TMA
// from one producer lane: the block's input halo box (16 + taps - 1)^2 x
// 64 channels (a 4-D box of the NHWC tensor, its out-of-bounds zero fill
// giving the padding, the image edge and a channel tail), and the weights
// of the phase's taps, one BN x 64 box a tap; full and empty mbarriers
// pace the ring. All taps read the one box: A is the box shifted by the
// tap, brought into registers by ldmatrix, each lane giving its own
// pixel's row, so no pixel is loaded twice for a block. B is read by the
// tensor cores through a descriptor. Both are in TMA's 64-byte swizzle
// (rows of 64 bytes; 16-byte chunk c of pixel p at c ^ ((p >> 1) & 3)),
// which makes the ldmatrix reads of 8 consecutive pixels conflict-free and
// is the K-major layout the wgmma descriptor names (SBO 512 B). Three
// ldmatrix buffers rotate, so a step's A loads while the tensor cores run
// the two steps before it.
// With lhs dilation 2 the output is walked by phase (oy % 2, ox % 2):
// each phase is a conv over the undilated input with only the taps of
// matching parity (2 x 2 of the composed 4 x 4 kernel), so no zero of the
// dilation is multiplied and the box is of undilated input. The forward's
// two tap geometries (3 x 3 at dilation 1, 2 x 2 a phase at dilation 2)
// are compile-time (T), so that the unrolled step loop's ldmatrix
// addresses are constant offsets: the index arithmetic of a run-time tap
// loop cost a third of the main loop. Any other geometry runs at T = 0.
// CTAs are persistent (one an SM: 221 KB of shared memory at BN 128, two
// stages; 206 KB at BN 64, three stages) and walk (phase, image, block
// row, block column, channel block) in that order, the channel block
// fastest, so that the CTAs running at one time share their input boxes
// in L2. The ring runs across tiles: the next tile's chunks load while
// this tile's last chunk and its epilogue run.
// The epilogue goes warp by warp through a 16 x 64 int32 stage in shared
// memory, so that a lane then holds four channels of one pixel and each
// pixel's loads (the decoder's addend and bias map, four pixels' in
// flight at once, prefetched into L2 during the tile's last chunk) and
// stores are contiguous; it is compiled for each of the forward's three
// forms (Epi) without a branch on the options, and its pixel loop stays
// rolled, two pixels an iteration (unrolled, it missed the instruction
// cache).
//
// What bounds it: at funit 64 and 8 x 504^2 tiles, the four Cout-64 convs
// (inputs 504^2-506^2 x 64, or 252^2 x 128 with dilation) are bound by
// bytes (the bf16 output and the int8 input, about 0.1 ms each; the
// decoder's sum adds its fp32 addend and bias map), the other 17 by
// operations (2 x MACs over 1,979 TOPS). The main loop reaches about two
// thirds of the int8 peak (a bare wgmma loop of these shapes reaches 98 %;
// what is left is the per-step ldmatrix, waits and fences and each
// chunk's drain). The epilogue does not overlap the products of its own
// tile (both consumer warpgroups finish a tile together): on the
// byte-bound shapes it takes longer than the main loop.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TH = 16, TW = 16;       // output block (of one phase), pixels
constexpr int KC = 64;                // input channels a chunk: 64-byte rows
constexpr int MAXT = 3;               // taps along an axis of a phase, at most
constexpr int BOX_BYTES = (TH + MAXT - 1) * (TW + MAXT - 1) * KC;
constexpr int A_BYTES = (BOX_BYTES + 1023) / 1024 * 1024;
constexpr int CONSUMER_WARPS = 8;     // two warpgroups
constexpr int THREADS = 32 * CONSUMER_WARPS + 128;  // and a producer warpgroup
constexpr int SROW = 64 + 4;          // a pixel's row in an epilogue stage, int32

template <int BN>
struct Cfg {
  static constexpr int B_BYTES = MAXT * MAXT * BN * KC;  // a multiple of 1024
  static constexpr int STAGES = BN == 64 ? 3 : 2;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int BARS = STAGES * STAGE;        // full[STAGES], empty[STAGES]
  static constexpr int STG = BARS + 16 * STAGES;     // the warps' epilogue stages
  static constexpr int SMEM = 1024 + STG + CONSUMER_WARPS * 16 * SROW * 4;
  static_assert(SMEM <= 232448, "shared memory per CTA");
};

enum OutKind { OUT_I32 = 0, OUT_F32 = 1, OUT_BF16 = 2 };

struct Params {
  void* out;
  const float* sx;
  const float* sw;
  const float* bias;
  const float* addend;  // (n, ho, wo, cout) or null
  const float* bmap;    // (ho, wo, cout) or null
  const float* prelu;   // one value, already rounded to the work dtype, or null
  const float* qscale;  // one value: int8 output, or null
  int n, cin, ho, wo, cout, kh, kw, pt, pl, dil;
  int sx_stride, sw_parity, out_kind;
  int vec;  // cout % 4 == 0 and the epilogue's arrays 16-byte aligned
  int box_h, box_w;                          // the TMA box, pixels
  int tiles_y, tiles_x, nblocks, tiles, ncc;  // tile grid; 64-channel chunks
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// first tap and count along one kernel axis for an output phase `ph` (dil
// 2: the taps a with ph + a - pad even) or all taps (dil 1)
__device__ __forceinline__ void tap_axis(int k, int pad, int ph, int dil, int& first,
                                         int& count) {
  if (dil == 1) {
    first = 0;
    count = k;
    return;
  }
  first = (((pad - ph) % 2) + 2) % 2;
  count = first < k ? (k - first + 1) / 2 : 0;
}

struct Tile {
  int img, py, px, i0, j0, nb;  // phase (py, px); block origin in the phase
                                // grid; channel block
  int a0, ny, b0, nx;           // the phase's first tap and tap count per axis
  int dy, dx;                   // input offset of tap 0 from the phase grid
};

__device__ __forceinline__ Tile decode(const Params& p, int tile) {
  Tile t;
  t.nb = tile % p.nblocks;
  int r = tile / p.nblocks;
  const int tx = r % p.tiles_x;
  r /= p.tiles_x;
  const int ty = r % p.tiles_y;
  r /= p.tiles_y;
  t.img = r % p.n;
  const int phase = r / p.n;
  t.py = p.dil == 2 ? phase >> 1 : 0;
  t.px = p.dil == 2 ? phase & 1 : 0;
  t.i0 = ty * TH;
  t.j0 = tx * TW;
  tap_axis(p.kh, p.pt, t.py, p.dil, t.a0, t.ny);
  tap_axis(p.kw, p.pl, t.px, p.dil, t.b0, t.nx);
  t.dy = (t.py + t.a0 - p.pt) / p.dil;  // a whole number: the phase makes it even
  t.dx = (t.px + t.b0 - p.pl) / p.dil;
  return t;
}

// -- mbarrier, TMA --------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// -- ldmatrix, wgmma ------------------------------------------------------------

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of v across a wgmma
__device__ __forceinline__ void fence_operand(int& v) { asm volatile("" : "+r"(v)::"memory"); }

// d (m64 x n64, s32) += a (this warp's 16 rows x k32 int8, registers, the
// mma.m16n8k32 A fragment) x B (k32 x n64 int8 in shared memory, K-major,
// described by desc); asynchronous until wgmma_wait
__device__ __forceinline__ void wgmma_n64(int (&d)[32], const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// d (m64 x n128, s32) += a (this warp's 16 rows x k32 int8, registers, the
// mma.m16n8k32 A fragment) x B (k32 x n128 int8 in shared memory, K-major,
// described by desc); asynchronous until wgmma_wait
__device__ __forceinline__ void wgmma_n128(int (&d)[64], const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// -- the epilogue ---------------------------------------------------------------

__device__ __forceinline__ float round_work(float y, int out_kind) {
  return out_kind == OUT_BF16 ? __bfloat162float(__float2bfloat16_rn(y)) : y;
}

// The epilogue's forms. The forward's three run with no branch but on
// data: EPI_ACT (bf16 out, bias, PReLU or none; int8 out with a static
// scale or not), EPI_SUM (EPI_ACT after the decoder's fp32 addend and bias
// map) and EPI_RAW (fp32 out, nothing added). EPI_ANY takes every option
// at run time.
enum Epi { EPI_ANY = 0, EPI_ACT = 1, EPI_SUM = 2, EPI_RAW = 3 };

// Per-lane constants of four channels o..o+3: the dequant scales sx * sw
// of both output-column parities and the biases
struct Chan4 {
  float sc[2][4], bb[4];
};

__device__ __forceinline__ void load4(const float* src, float (&d)[4], int nv, bool vec) {
  if (vec) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(src));
    d[0] = t.x, d[1] = t.y, d[2] = t.z, d[3] = t.w;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) d[e] = e < nv ? __ldg(src + e) : 0.f;
  }
}

__device__ __forceinline__ Chan4 chan4(const Params& p, int img, int o, bool vec) {
  Chan4 k;
  const int nv = min(4, p.cout - o);
  const float sx = __ldg(p.sx + img * p.sx_stride);
  float sw[4];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    load4(p.sw + (p.sw_parity ? q * p.cout : 0) + o, sw, nv, vec);
#pragma unroll
    for (int e = 0; e < 4; ++e) k.sc[q][e] = __fmul_rn(sx, sw[e]);
  }
  if (p.bias) load4(p.bias + o, k.bb, nv, vec);
  return k;
}

__device__ __forceinline__ int8_t quant8(float y, float s) {
  return (int8_t)(int)fminf(fmaxf(rintf(__fdiv_rn(y, s)), -127.f), 127.f);
}

// four channels o..o+3 at output element `at` from their sums c[4] and
// addends ad, bm: the epilogue in the plain version's order, then the
// store. vec: one store (cout % 4 == 0, aligned). EPI_ANY only.
__device__ __forceinline__ void epilogue4_any(const Params& p, long long at, const float (&sc)[4],
                                              int o,
                                              const int (&c)[4], const Chan4& k,
                                              const float (&ad)[4], const float (&bm)[4],
                                              bool vec) {
  const int nv = min(4, p.cout - o);
  if (p.out_kind == OUT_I32) {
    int* out = reinterpret_cast<int*>(p.out) + at;
    if (vec) {
      *reinterpret_cast<int4*>(out) = make_int4(c[0], c[1], c[2], c[3]);
    } else {
      for (int e = 0; e < nv; ++e) out[e] = c[e];
    }
    return;
  }
  float v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float y = __fmul_rn(__int2float_rn(c[e]), sc[e]);
    if (p.addend) y = __fadd_rn(ad[e], y);
    if (p.bmap) y = __fadd_rn(y, bm[e]);
    if (p.bias) y = __fadd_rn(y, k.bb[e]);
    y = round_work(y, p.out_kind);
    if (p.prelu && !(y >= 0.f)) y = round_work(__fmul_rn(__ldg(p.prelu), y), p.out_kind);
    v[e] = y;
  }
  if (p.qscale) {
    const float s = __ldg(p.qscale);
    int8_t* out = reinterpret_cast<int8_t*>(p.out) + at;
    for (int e = 0; e < nv; ++e) out[e] = quant8(v[e], s);
  } else if (p.out_kind == OUT_F32) {
    float* out = reinterpret_cast<float*>(p.out) + at;
    if (vec) {
      *reinterpret_cast<float4*>(out) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      for (int e = 0; e < nv; ++e) out[e] = v[e];
    }
  } else {
    __nv_bfloat16* out = reinterpret_cast<__nv_bfloat16*>(p.out) + at;
    for (int e = 0; e < nv; ++e) out[e] = __float2bfloat16_rn(v[e]);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The epilogue of one warp's stage (16 pixels of output row oy x 64
// channels): lane l takes channels o..o+3 of pixels 2 i + l / 16. The
// pixel loop stays rolled: unrolled, its code, which every tile runs once
// a slice, missed the instruction cache and took most of the epilogue's
// time.
template <int EPI>
__device__ __forceinline__ void epilogue_rows(const Params& p, const int* stg, const Tile& tl,
                                              int oy, int o, int lane, bool vec, const Chan4& k,
                                              float a, float qs) {
  if (o >= p.cout || oy >= p.ho) return;
  const long long row0 = ((long long)tl.img * p.ho + oy) * p.wo * p.cout + o;
  const long long mrow0 = (long long)oy * p.wo * p.cout + o;
  const bool has_a = p.prelu != nullptr;
  const bool adds = EPI == EPI_SUM || (EPI == EPI_ANY && (p.addend || p.bmap));
  // pixel i's addends (the decoder sum's fp32 addend and bias map)
  auto load_adds = [&](int i, float (&ad)[4], float (&bm)[4]) {
    const int ox = (tl.j0 + 2 * i + (lane >> 4)) * p.dil + tl.px;
    const int nv = ox < p.wo ? min(4, p.cout - o) : 0;
    if (EPI == EPI_SUM || (EPI == EPI_ANY && p.addend))
      load4(p.addend + row0 + (long long)ox * p.cout, ad, nv, vec && nv);
    if (EPI == EPI_SUM || (EPI == EPI_ANY && p.bmap))
      load4(p.bmap + mrow0 + (long long)ox * p.cout, bm, nv, vec && nv);
  };
  auto pixel = [&](int i, const float (&ad)[4], const float (&bm)[4]) {
    const int pc = 2 * i + (lane >> 4);  // pixel column in the block
    const int ox = (tl.j0 + pc) * p.dil + tl.px;
    if (ox >= p.wo) return;
    const int4 c4 = *reinterpret_cast<const int4*>(stg + pc * SROW + 4 * (lane & 15));
    const int c[4] = {c4.x, c4.y, c4.z, c4.w};
    const long long at = row0 + (long long)ox * p.cout;
    // the column parity's scales, by select: an index would put k in local memory
    const bool q = p.sw_parity && (ox & 1);
    float sc[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[e] = q ? k.sc[1][e] : k.sc[0][e];
    if constexpr (EPI == EPI_ANY) {
      epilogue4_any(p, at, sc, o, c, k, ad, bm, vec);
    } else if constexpr (EPI == EPI_RAW) {
      *reinterpret_cast<float4*>(reinterpret_cast<float*>(p.out) + at) = make_float4(
          __fmul_rn(__int2float_rn(c[0]), sc[0]), __fmul_rn(__int2float_rn(c[1]), sc[1]),
          __fmul_rn(__int2float_rn(c[2]), sc[2]), __fmul_rn(__int2float_rn(c[3]), sc[3]));
    } else {
      // bf16 rounding two values at a time (one packed conversion a pair);
      // the halves of the packed words are the rounded values' bits
      float y[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        y[e] = __fmul_rn(__int2float_rn(c[e]), sc[e]);
        if (EPI == EPI_SUM) y[e] = __fadd_rn(__fadd_rn(ad[e], y[e]), bm[e]);
        y[e] = __fadd_rn(y[e], k.bb[e]);
      }
      uint32_t w[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t r = pack_bf16(y[2 * h], y[2 * h + 1]);
        const float lo = __uint_as_float(r << 16), hi = __uint_as_float(r & 0xffff0000u);
        const uint32_t n = pack_bf16(__fmul_rn(a, lo), __fmul_rn(a, hi));
        const bool nlo = has_a && !(lo >= 0.f), nhi = has_a && !(hi >= 0.f);
        w[h] = ((nlo ? n : r) & 0xffffu) | ((nhi ? n : r) & 0xffff0000u);
      }
      if (p.qscale) {
        const float v[4] = {__uint_as_float(w[0] << 16), __uint_as_float(w[0] & 0xffff0000u),
                            __uint_as_float(w[1] << 16), __uint_as_float(w[1] & 0xffff0000u)};
        const char4 q4 = make_char4(quant8(v[0], qs), quant8(v[1], qs), quant8(v[2], qs),
                                    quant8(v[3], qs));
        *reinterpret_cast<char4*>(reinterpret_cast<int8_t*>(p.out) + at) = q4;
      } else {
        *reinterpret_cast<uint2*>(reinterpret_cast<__nv_bfloat16*>(p.out) + at) =
            make_uint2(w[0], w[1]);
      }
    }
  };
  if (adds) {
    // four pixels' addends in flight at once: their loads wait on memory
#pragma unroll 1
    for (int i0 = 0; i0 < 8; i0 += 4) {
      float ad[4][4], bm[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u) load_adds(i0 + u, ad[u], bm[u]);
#pragma unroll
      for (int u = 0; u < 4; ++u) pixel(i0 + u, ad[u], bm[u]);
    }
  } else {
    const float none[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 1
    for (int i = 0; i < 8; i += 2) {  // two pixels an iteration, for their overlap
      pixel(i, none, none);
      pixel(i + 1, none, none);
    }
  }
}

// -- the kernel -----------------------------------------------------------------

template <int BN>
__device__ __forceinline__ void mma_step(int (&acc)[2][BN / 2], const uint32_t (&a)[2][4],
                                         uint64_t desc) {
  wgmma_fence();
  if constexpr (BN == 64) {
    wgmma_n64(acc[0], a[0], desc);
    wgmma_n64(acc[1], a[1], desc);
  } else {
    wgmma_n128(acc[0], a[0], desc);
    wgmma_n128(acc[1], a[1], desc);
  }
  wgmma_commit();
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

template <int BN, int EPI, int T>
__global__ void __launch_bounds__(THREADS, 1)
    qconv_kernel(const __grid_constant__ CUtensorMap tmx, const __grid_constant__ CUtensorMap tmw,
                 const __grid_constant__ Params p) {
  using C = Cfg<BN>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the 64-byte swizzle repeats every 512 B; TMA and the wgmma descriptor
  // both apply it from the address, so the stages start on 1024 B
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sbase = smem_u32(smem);
  const uint32_t full = sbase + C::BARS, empty = full + 8 * C::STAGES;

  const int tid = threadIdx.x, warp_id = tid >> 5, lane = tid & 31;
  const int my_tiles =
      (int)blockIdx.x < p.tiles ? (p.tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
  const int n_items = my_tiles * p.ncc;  // (tile, chunk) pairs, chunk fastest

  if (tid == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp_id >= CONSUMER_WARPS) {
    // the producer warpgroup hands its registers to the consumers; one lane
    // fills the ring, a stage once all eight consumer warps have released it
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp_id == CONSUMER_WARPS && lane == 0) {
      const CUtensorMap* mx = &tmx;
      const CUtensorMap* mw = &tmw;
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(mx)) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(mw)) : "memory");
      for (int it = 0; it < n_items; ++it) {
        const int s = it % C::STAGES;
        if (it >= C::STAGES) mbar_wait(empty + 8 * s, (uint32_t)((it / C::STAGES - 1) & 1));
        const Tile tl = decode(p, (int)blockIdx.x + (it / p.ncc) * (int)gridDim.x);
        const int c0 = (it % p.ncc) * KC;
        const uint32_t bar = full + 8 * s, a_dst = sbase + s * C::STAGE;
        mbar_expect_tx(bar, (uint32_t)(p.box_h * p.box_w * KC + tl.ny * tl.nx * BN * KC));
        tma_load_4d(a_dst, mx, bar, c0, tl.j0 + tl.dx, tl.i0 + tl.dy, tl.img);
        for (int j = 0; j < tl.ny; ++j)
          for (int l = 0; l < tl.nx; ++l)
            tma_load_3d(a_dst + A_BYTES + (j * tl.nx + l) * BN * KC, mw, bar, c0,
                        (tl.a0 + p.dil * j) * p.kw + tl.b0 + p.dil * l, tl.nb * BN);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = warp_id >> 2, warp = warp_id & 3;
  const int g = lane >> 2, t4 = lane & 3, q = lane >> 3, r8 = lane & 7;
  // this lane's ldmatrix row: pixel (row_m, col) of the block for m64 block
  // 0 (block 1 is 4 rows lower), 16-byte chunk q >> 1 of each k32 step
  const int row_m = 8 * wg + warp, col = r8 + 8 * (q & 1);
  // this warp's epilogue stage: 16 pixels x 64 channels of int32 sums
  int* stg = reinterpret_cast<int*>(smem + C::STG) + warp_id * 16 * SROW;

  int acc[2][BN / 2];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[m][i] = 0;

  for (int it = 0; it < n_items; ++it) {
    const int s = it % C::STAGES;
    const Tile tl = decode(p, (int)blockIdx.x + (it / p.ncc) * (int)gridDim.x);
    if (it % p.ncc == p.ncc - 1 && (p.addend || p.bmap)) {
      // the epilogue's addends into L2 while this chunk's products run:
      // the warp's 2 x 16 pixels, BN x 4 bytes each, in 128-byte lines
      constexpr int LINES = BN * 4 / 128;
      for (int k = lane; k < 2 * 16 * LINES; k += 32) {
        const int m = k / (16 * LINES), pc = (k / LINES) % 16, line = k % LINES;
        const int oy = (tl.i0 + row_m + 4 * m) * p.dil + tl.py;
        const int ox = (tl.j0 + pc) * p.dil + tl.px;
        if (oy >= p.ho || ox >= p.wo || tl.nb * BN + 32 * line >= p.cout) continue;
        const long long mp = (long long)oy * p.wo + ox;
        const long long off = (((long long)tl.img * p.ho * p.wo + mp) * p.cout + tl.nb * BN) +
                              32 * line;
        if (p.addend) asm volatile("prefetch.global.L2 [%0];" ::"l"(p.addend + off));
        if (p.bmap)
          asm volatile("prefetch.global.L2 [%0];" ::"l"(p.bmap + mp * p.cout + tl.nb * BN +
                                                         32 * line));
      }
    }
    mbar_wait(full + 8 * s, (uint32_t)((it / C::STAGES) & 1));

    const uint32_t a_base = sbase + s * C::STAGE;
    const uint32_t b_addr = a_base + A_BYTES;
    // K-major, 64-byte swizzle, 8-row groups 512 B apart
    const uint64_t desc0 =
        (2ull << 62) | (32ull << 32) | (1ull << 16) | (uint64_t)((b_addr >> 4) & 0x3fff);
    // T > 0: T x T taps a phase and the box width known at compile time,
    // so that the unrolled step loop's addresses are constant offsets
    const int nx = T ? T : tl.nx, bw = T ? TW + T - 1 : p.box_w;
    const int steps = T ? 2 * T * T : 2 * tl.ny * tl.nx;  // two k32 steps a tap
    auto load_a = [&](int st, uint32_t (&a)[2][4]) {
      const int tap = st >> 1, chunk = 2 * (st & 1) + (q >> 1);
      const int j = tap / nx, l = tap % nx;
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int pix = (row_m + 4 * m + j) * bw + col + l;
        ldsm_x4(a_base + pix * KC + ((chunk ^ ((pix >> 1) & 3)) << 4), a[m]);
      }
    };
    auto desc_of = [&](int st) {
      return desc0 + (uint64_t)(((st >> 1) * BN * KC + (st & 1) * 32) >> 4);
    };
    // three A buffers: a step's A loads while the two before it run on the
    // tensor cores (the buffer it overwrites was read three steps ago)
    uint32_t a0[2][4], a1[2][4], a2[2][4];
    if (steps > 0) load_a(0, a0);
#pragma unroll
    for (int st = 0; st < steps; st += 3) {
      mma_step<BN>(acc, a0, desc_of(st));
      if (st + 1 < steps) {
        wgmma_wait<2>();  // step st - 2 is done with a1
        load_a(st + 1, a1);
        mma_step<BN>(acc, a1, desc_of(st + 1));
      }
      if (st + 2 < steps) {
        wgmma_wait<2>();  // step st - 1 is done with a2
        load_a(st + 2, a2);
        mma_step<BN>(acc, a2, desc_of(st + 2));
      }
      if (st + 3 < steps) {
        wgmma_wait<2>();  // step st is done with a0
        load_a(st + 3, a0);
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) fence_operand(acc[m][i]);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);  // this warp is done with stage s

    if (it % p.ncc != p.ncc - 1) continue;
    // epilogue, warp by warp: lane (g, t4) holds pixels g and g + 8 of the
    // warp's row of each m64 block, channels 8 j + 2 t4, + 1 of each n8
    // tile j. Each 64-channel slice goes through the warp's stage, so that
    // a lane then holds four channels of one pixel: 16 lanes a pixel, the
    // loads and stores of a pixel's channels contiguous.
    const bool vec = p.vec != 0;
    // the per-lane constants once a tile and slice (global loads)
    const float a = (EPI == EPI_ACT || EPI == EPI_SUM) && p.prelu ? __ldg(p.prelu) : 0.f;
    const float qs = p.qscale ? __ldg(p.qscale) : 1.f;
#pragma unroll
    for (int sl = 0; sl < BN / 64; ++sl) {
      const int o = tl.nb * BN + 64 * sl + 4 * (lane & 15);
      Chan4 k{};
      if (p.out_kind != OUT_I32 && o < p.cout) k = chan4(p, tl.img, o, vec);  // int32: no scales
#pragma unroll
      for (int m = 0; m < 2; ++m) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<int2*>(stg + (g + 8 * h) * SROW + 8 * j + 2 * t4) =
                make_int2(acc[m][4 * (8 * sl + j) + 2 * h], acc[m][4 * (8 * sl + j) + 2 * h + 1]);
        __syncwarp();
        epilogue_rows<EPI>(p, stg, tl, (tl.i0 + row_m + 4 * m) * p.dil + tl.py, o, lane, vec, k,
                           a, qs);
        __syncwarp();
      }
    }
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[m][i] = 0;
  }
}

// -- the host side --------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up through the runtime, so that the
// library needs no -lcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult res;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &res) ==
            cudaSuccess &&
        res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// int8 (rank-dimensional, innermost first) with 64-byte-swizzled boxes
bool encode(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
            const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, (cuuint32_t)rank, const_cast<void*>(base), dims,
            strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN, int EPI, int T>
cudaError_t launch(const void* x, const void* w, Params p, int h, int wd, cudaStream_t st) {
  using C = Cfg<BN>;
  p.nblocks = (p.cout + BN - 1) / BN;
  const long long tiles = (long long)p.dil * p.dil * p.n * p.tiles_y * p.tiles_x * p.nblocks;
  if (tiles <= 0 || tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  p.tiles = (int)tiles;
  CUtensorMap tmx, tmw;
  const cuuint64_t xd[4] = {(cuuint64_t)p.cin, (cuuint64_t)wd, (cuuint64_t)h, (cuuint64_t)p.n};
  const cuuint64_t xs[3] = {(cuuint64_t)p.cin, (cuuint64_t)wd * p.cin,
                            (cuuint64_t)h * wd * p.cin};
  const cuuint32_t xb[4] = {KC, (cuuint32_t)p.box_w, (cuuint32_t)p.box_h, 1};
  const cuuint64_t wdims[3] = {(cuuint64_t)p.cin, (cuuint64_t)p.kh * p.kw, (cuuint64_t)p.cout};
  const cuuint64_t ws[2] = {(cuuint64_t)p.cin, (cuuint64_t)p.kh * p.kw * p.cin};
  const cuuint32_t wb[3] = {KC, 1, BN};
  if (!encode(&tmx, x, 4, xd, xs, xb) || !encode(&tmw, w, 3, wdims, ws, wb))
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(qconv_kernel<BN, EPI, T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  const int grid = p.tiles < sms ? p.tiles : sms;
  qconv_kernel<BN, EPI, T><<<grid, THREADS, C::SMEM, st>>>(tmx, tmw, p);
  return cudaGetLastError();
}

template <int BN, int EPI>
cudaError_t launch_taps(int t, const void* x, const void* w, const Params& p, int h, int wd,
                        cudaStream_t st) {
  switch (t) {
    case 3: return launch<BN, EPI, 3>(x, w, p, h, wd, st);
    case 2: return launch<BN, EPI, 2>(x, w, p, h, wd, st);
    default: return launch<BN, EPI, 0>(x, w, p, h, wd, st);
  }
}

template <int BN>
cudaError_t launch_epi(int epi, int t, const void* x, const void* w, const Params& p, int h,
                       int wd, cudaStream_t st) {
  switch (epi) {
    case EPI_ACT: return launch_taps<BN, EPI_ACT>(t, x, w, p, h, wd, st);
    case EPI_SUM: return launch_taps<BN, EPI_SUM>(t, x, w, p, h, wd, st);
    case EPI_RAW: return launch_taps<BN, EPI_RAW>(t, x, w, p, h, wd, st);
    default: return launch_taps<BN, EPI_ANY>(t, x, w, p, h, wd, st);
  }
}

}  // namespace

// x (n, h, w, cin) int8; w (cout, kh, kw, cin) int8; out (n, ho, wo, cout)
// of out_kind (0 int32, 1 fp32, 2 bf16), or int8 when qscale is given.
// sx: n floats (sx_stride 1) or one (sx_stride 0); sw: cout floats, or
// 2 x cout chosen by the output column's parity (sw_parity 1); bias: cout
// floats or null. vec must be 1: x and w 16-byte aligned, cin % 16 == 0
// (TMA's rule for the strides; ops/qconv.py pads the channels). The
// epilogue options (float outputs only): addend (n, ho, wo, cout) and
// bmap (ho, wo, cout) fp32 sums, prelu (one float, already rounded to the
// work dtype), qscale (one float: the static quantize to int8).
// Taps of a phase at most 3 along each axis: kh, kw <= 3 at dil 1, <= 6 at
// dil 2.
extern "C" int qconv_launch(const void* x, const void* w, void* out, const void* sx,
                            const void* sw, const void* bias, int n, int h, int wd,
                            int cin, int ho, int wo, int cout, int kh, int kw, int pt,
                            int pl, int dil, int sx_stride, int sw_parity, int out_kind,
                            int vec, const void* addend, const void* bmap, const void* prelu,
                            const void* qscale, void* stream) {
  Params p;
  p.out = out;
  p.sx = (const float*)sx;
  p.sw = (const float*)sw;
  p.bias = (const float*)bias;
  p.addend = (const float*)addend;
  p.bmap = (const float*)bmap;
  p.prelu = (const float*)prelu;
  p.qscale = (const float*)qscale;
  p.n = n; p.cin = cin; p.ho = ho; p.wo = wo; p.cout = cout;
  p.kh = kh; p.kw = kw; p.pt = pt; p.pl = pl; p.dil = dil;
  p.sx_stride = sx_stride; p.sw_parity = sw_parity; p.out_kind = out_kind;
  if ((dil != 1 && dil != 2) || out_kind < OUT_I32 || out_kind > OUT_BF16 || !vec ||
      cin % 16 || (reinterpret_cast<size_t>(x) & 15) || (reinterpret_cast<size_t>(w) & 15) ||
      n < 1 || h < 1 || wd < 1 || ho < 1 || wo < 1 || cout < 1 || kh < 1 || kw < 1)
    return (int)cudaErrorInvalidValue;
  const int ty = (kh + dil - 1) / dil, tx = (kw + dil - 1) / dil;  // taps a phase, at most
  if (ty > MAXT || tx > MAXT) return (int)cudaErrorInvalidValue;
  if (out_kind == OUT_I32 && (addend || bmap || prelu || qscale)) return (int)cudaErrorInvalidValue;
  auto al16 = [](const void* q) { return (reinterpret_cast<size_t>(q) & 15) == 0; };
  p.vec = cout % 4 == 0 && al16(out) && al16(sw) && al16(bias) && al16(addend) && al16(bmap);
  p.box_h = TH + ty - 1;
  p.box_w = TW + tx - 1;
  p.tiles_y = ((ho + dil - 1) / dil + TH - 1) / TH;
  p.tiles_x = ((wo + dil - 1) / dil + TW - 1) / TW;
  p.ncc = (cin + KC - 1) / KC;
  cudaStream_t st = (cudaStream_t)stream;
  // the epilogue's form (see Epi)
  const bool act = out_kind == OUT_BF16 && bias && p.vec;
  const int epi = act && !addend && !bmap             ? EPI_ACT
                  : act && addend && bmap             ? EPI_SUM
                  : out_kind == OUT_F32 && !addend && !bmap && !bias && !prelu && !qscale &&
                          p.vec                       ? EPI_RAW
                                                      : EPI_ANY;
  // the tap geometry: 3 x 3 at dil 1, the composed 4 x 4 at dil 2 (2 x 2
  // taps a phase), or any other at run time
  const int t = dil == 1 && kh == 3 && kw == 3 ? 3 : dil == 2 && kh == 4 && kw == 4 ? 2 : 0;
  const cudaError_t e = cout <= 64 ? launch_epi<64>(epi, t, x, w, p, h, wd, st)
                                   : launch_epi<128>(epi, t, x, w, p, h, wd, st);
  return (int)e;
}
