// Fused UtNet encoder level 1 for Hopper (sm_90a).
//
// Replaces the TPU kernel nind_denoise_tpu/ops/pallas_enc1.py enc1_pallas
// (pl.pallas_call at :262, kernel body _enc1_kernel). Same math, unfolded
// NCHW layout:
//   t0    = PReLU(conv3x3_valid(x_pad, w0) + b0), rounded to the I/O type
//   l1    = PReLU(conv3x3_valid(t0, w1) + b1)     (fp32 sums, then rounded)
//   l2_in = maxpool2x2(l1)                        (over the rounded values)
// x_pad (B, 3, H+4, W+4) -> l1 (B, 64, H, W), l2_in (B, 64, H/2, W/2).
//
// What bounds it: c1 is 64*64*9 MACs per output pixel, 150 GFLOP at B=8,
// 504x504, against about 340 MB of bytes (mostly the l1 write). At the
// bf16 tensor-core peak that is 0.1586 ms of operations against 0.10 ms of
// bytes, so the operations bound it.
//
// bf16 instance (enc1_bf16_kernel), steps 1 and 2 of the Hopper design:
// both convolutions on the tensor cores, fp32 sums in registers.
//   c1 is an implicit GEMM by tap on wgmma.m64n64k16: for each of the 9
//   taps and 4 k-steps of 16 input channels, A is the t0 tile shifted by
//   (ky, kx), one row per output pixel, in registers (ldmatrix), and B is
//   w1[:, :, ky, kx] read by the tensor cores from shared memory through a
//   descriptor. t0 lives in shared memory channel last, one pixel per 144 B
//   (64 channels + 16 B of padding), so ldmatrix reads a shifted window
//   with no bank conflict: a shift by kx starts one pixel later, and no data
//   moves per tap. w1 is packed by the wrapper (ops/enc1.py pack_w1) as
//   [tap][co][ci] bf16 with each co row's 16-byte chunks XOR-swizzled by co
//   mod 8: the canonical K-major 128-byte-swizzled layout of wgmma.
//   c0 is a K = 32 product (27 taps and 5 zeros) on mma.sync.m16n8k16 whose
//   A is gathered from the x patch in registers; it is rounded to bf16 into
//   t0.
//   Tiles: 16 x 16 output pixels. A CTA holds the whole w1 (loaded once
//   with cp.async) and runs two tiles at a time, one per group of 8 warps
//   (two warpgroups), each group with its own named barrier. Each warp owns
//   two output rows x 64 channels: its 16 rows of the two m64 blocks of its
//   warpgroup (64 fp32 accumulators a thread). Shared memory per CTA:
//   1,024 (alignment of the swizzle) + w1 73,728 + c0's B fragments 4,096
//   + b0, b1 and c0's tap offsets 640 + 2 x (t0 18 x 18 x 144 = 46,656 +
//   x patch 3 x 20 x 20 x 2 = 2,400) = 177,600 B, so one CTA per SM; the
//   epilogue's [co][pixel] stage (64 x 528 = 33,792 B) lies over the
//   group's t0 once c1 is done. The halo recomputes 27% of c0. CTAs are
//   persistent (one per SM at most) and walk the (image, tile) list; the
//   next tile's x patch is fetched by cp.async behind c1. Each output's sum
//   order depends only on its place in the tile, never on the batch or on
//   the CTA: no split-K, no atomics. The epilogue writes the stage with
//   stmatrix.trans, l1 with 16-byte stores along W and l2_in with 8-byte
//   stores (W % 8 == 0; element stores otherwise); tiles start on even rows
//   and columns, so the pool windows lie in one tile.
//   Where the time goes (tools/enc1_breakdown.py): the global stores
//   (325 MB at 8 x 504^2) do not overlap the compute, since every tile on
//   the card stores at about the same time.
//
// fp32 instance (enc1_f32_kernel): the CUDA-core kernel of the first port,
// one CTA per image x (8, 32) tile, t0 in shared memory, w1 in two 32-
// channel slices. It stays on CUDA cores because TF32 would break its
// 1e-4 x max(1, |l1|) limit; it runs only under --compute_dtype float32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int C = 64;  // funit: channels of t0 and l1

__device__ __forceinline__ float prelu(float v, float a) { return v >= 0.f ? v : a * v; }

// ---------------------------------------------------------------- bf16

namespace tc {

constexpr int T = 16;                       // output tile edge
constexpr int T0 = T + 2;                   // t0 patch edge
constexpr int XP = T + 4;                   // x patch edge
constexpr int GROUPS = 2;                   // tiles in flight per CTA
constexpr int GWARPS = 8;                   // warps per group
constexpr int GT = GWARPS * 32;             // threads per group
constexpr int NT = GROUPS * GT;             // threads per CTA
constexpr int PIX = C + 8;                  // t0 pixel stride, bf16 (144 B)
constexpr int SST = T * T + 8;              // stage stride per channel, bf16 (528 B)
constexpr int C0_MT = (T0 * T0 + 15) / 16;  // c0's 16-pixel m-tiles

constexpr int W1_BYTES = 9 * C * C * 2;
constexpr int W0F_BYTES = 2 * 8 * 32 * 8;   // c0's B fragments [ks][nt][lane]
constexpr int BA_BYTES = 640;               // b0[64], b1[64] (fp32); c0's tap offsets [32]
constexpr int T0_BYTES = T0 * T0 * PIX * 2;
constexpr int XS_BYTES = 3 * XP * XP * 2;
constexpr int G_BYTES = T0_BYTES + XS_BYTES;
constexpr int SMEM = 1024 + W1_BYTES + W0F_BYTES + BA_BYTES + GROUPS * G_BYTES;
static_assert(C * SST * 2 <= T0_BYTES, "the stage must fit over t0");
static_assert(G_BYTES % 16 == 0 && BA_BYTES % 16 == 0, "16-byte alignment");
static_assert(SMEM <= 232448, "shared memory per CTA");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// four 8x8 bf16 matrices from mma fragments (row = lane / 4), transposed:
// memory row i of matrix j (address from lane 8 j + i) gets fragment column i
__device__ __forceinline__ void stsm_x4_trans(uint32_t addr, const uint32_t (&r)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   addr),
               "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d (m64 x n64, fp32) += a (this warp's 16 rows x k16, registers, the
// mma.m16n8k16 A fragment) x B (k16 x n64 from shared memory, described by
// desc); asynchronous until wgmma_commit_wait
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving reads or writes of v across a wgmma
__device__ __forceinline__ void fence_operand(float& v) { asm volatile("" : "+f"(v)::"memory"); }

__device__ __forceinline__ void group_sync(int group) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(group + 1), "n"(GT) : "memory");
}

__device__ __forceinline__ uint32_t pack2(uint16_t lo, uint16_t hi) {
  return (uint32_t)lo | ((uint32_t)hi << 16);
}

// PReLU(lo + blo), PReLU(hi + bhi), rounded to bf16, lo in the low half
__device__ __forceinline__ uint32_t bias_prelu2(float lo, float hi, float blo, float bhi,
                                                float a) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(prelu(lo + blo, a), prelu(hi + bhi, a));
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t hmax2(uint32_t a, uint32_t b) {
  const __nv_bfloat162 m = __hmax2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                   *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&m);
}

// max of the two bf16 halves of v, as bits
__device__ __forceinline__ uint32_t hmax_halves(uint32_t v) {
  return __bfloat16_as_ushort(
      __hmax(__ushort_as_bfloat16((uint16_t)(v & 0xffff)), __ushort_as_bfloat16((uint16_t)(v >> 16))));
}

__global__ void __launch_bounds__(NT, 1)
enc1_bf16_kernel(const uint16_t* __restrict__ x,    // (B, 3, H+4, W+4) bf16 bits
                 const uint16_t* __restrict__ w0,   // (64, 27) bf16 bits
                 const uint16_t* __restrict__ w1p,  // pack_w1: (9, 64, 64) swizzled
                 const uint16_t* __restrict__ b0,   // (64,) bf16 bits
                 const uint16_t* __restrict__ b1,   // (64,)
                 const uint16_t* __restrict__ a0p,  // (1,)
                 const uint16_t* __restrict__ a1p,  // (1,)
                 __nv_bfloat16* __restrict__ l1,    // (B, 64, H, W)
                 __nv_bfloat16* __restrict__ l2,    // (B, 64, H/2, W/2)
                 int B, int H, int W, int tiles_y, int tiles_x) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // w1's 128-byte swizzle repeats every 1024 B, and the wgmma descriptor
  // assumes that the pattern starts at an address that is a multiple of it
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint2* w0f = reinterpret_cast<uint2*>(smem + W1_BYTES);
  float* bas = reinterpret_cast<float*>(smem + W1_BYTES + W0F_BYTES);  // b0, b1
  int* koffs = reinterpret_cast<int*>(bas + 2 * C);  // [t][ks * 4 + j]

  const int tid = threadIdx.x;
  const int group = tid / GT, gtid = tid % GT;
  const int warp = gtid / 32, lane = tid % 32;
  unsigned char* gs = smem + W1_BYTES + W0F_BYTES + BA_BYTES + group * G_BYTES;
  uint16_t* t0s = reinterpret_cast<uint16_t*>(gs);  // [T0*T0][PIX]; then stage [C][SST]
  uint16_t* xs = reinterpret_cast<uint16_t*>(gs + T0_BYTES);  // [3][XP][XP]

  const int HP = H + 4, WP = W + 4, H2 = H / 2, W2 = W / 2;
  const int per_img = tiles_y * tiles_x, n_tiles = B * per_img;

  // the x patch of `tile` into xs by cp.async, two pixels per copy (WP and
  // the patch's first column are even, so a pair is inside x_pad whole or
  // not at all); zero outside x_pad (those t0 values feed no stored output)
  const uint32_t xs_addr = smem_u32(xs);
  auto load_x = [&](int tile) {
    const int b = tile / per_img, rem = tile % per_img;
    const int y0 = (rem / tiles_x) * T, x0 = (rem % tiles_x) * T;
    for (int i = gtid; i < 3 * XP * XP / 2; i += GT) {
      const int c = i / (XP * XP / 2), r = (i / (XP / 2)) % XP, col = 2 * (i % (XP / 2));
      const int gy = y0 + r, gx = x0 + col;
      const bool in = gy < HP && gx < WP;
      const uint16_t* src = in ? x + (((size_t)b * 3 + c) * HP + gy) * WP + gx : x;
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(xs_addr + 4 * i),
                   "l"(src), "r"(in ? 4 : 0)
                   : "memory");
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  // the whole of w1, once per CTA
  const uint32_t w1_addr = smem_u32(smem);
  for (int i = tid; i < W1_BYTES / 16; i += NT)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(w1_addr + 16 * i),
                 "l"(w1p + 8 * i)
                 : "memory");
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  const int first = blockIdx.x * GROUPS + group;
  if (first < n_tiles)
    load_x(first);
  else
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  // c0's B operand: w0 as K = 32 (27 taps, 5 zeros) x N = 64, in fragment
  // order: lane (g, t) of n-tile nt holds k = 2t, 2t+1 and 2t+8, 2t+9 of
  // column 8 nt + g
  for (int i = tid; i < 2 * 8 * 32; i += NT) {
    const int ks = i / 256, nt = (i / 32) % 8, ln = i % 32;
    const int n = nt * 8 + ln / 4, k0 = ks * 16 + 2 * (ln % 4);
    uint16_t v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + (j & 1) + 8 * (j >> 1);
      v[j] = k < 27 ? w0[n * 27 + k] : (uint16_t)0;
    }
    w0f[i] = make_uint2(pack2(v[0], v[1]), pack2(v[2], v[3]));
  }
  for (int i = tid; i < 2 * C; i += NT)
    bas[i] = __bfloat162float(__ushort_as_bfloat16(i < C ? b0[i] : b1[i - C]));
  // c0: x-patch offset of A column k = ks*16 + 2t + (j & 1) + 8 (j >> 1)
  // (k = ci*9 + ky*3 + kx) for lane t = lane % 4; -1 past the 27 taps. In
  // shared memory, so that no register holds them through c1.
  if (tid < 32) {
    const int tt = tid / 8, ks = (tid / 4) % 2, j = tid % 4;
    const int k = ks * 16 + 2 * tt + (j & 1) + 8 * (j >> 1);
    koffs[tid] = k < 27 ? (k / 9) * XP * XP + ((k / 3) % 3) * XP + k % 3 : -1;
  }
  // w1 (every thread's share of it) has landed, the first x patch may not
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // w1 is read by wgmma
  __syncthreads();

  const int g = lane >> 2, t = lane & 3;
  // ldmatrix / stmatrix row addresses: lanes 8q..8q+7 give the rows of
  // matrix q. c1's A (x4): rows 0-7 (q even) or 8-15 (q odd) of the m-tile,
  // at k 0-7 (q < 2) or 8-15.
  const int q = lane >> 3, r8 = lane & 7;
  const uint32_t a_lane =
      smem_u32(t0s) + ((r8 + 8 * (q & 1)) * PIX + 8 * (q >> 1)) * 2 + warp * 2 * T0 * PIX * 2;
  // c1's B: w1 [tap][co][ci] as K-major 128-byte-swizzled tiles of 64 co
  // rows (8-row groups 1024 B apart); a k-step of 16 channels starts 32 B
  // further into the rows
  const uint64_t desc_w1 = (1ull << 62) | (64ull << 32) | (1ull << 16) | ((w1_addr >> 4) & 0x3fff);
  // the stage (x4.trans): co row 8 (q >> 1) + r8 of an n-tile pair, pixels
  // 8 (q & 1) .. + 7 of the m-tile
  const uint32_t st_lane = smem_u32(t0s) + ((8 * (q >> 1) + r8) * SST + 8 * (q & 1)) * 2;

  const float a0 = __bfloat162float(__ushort_as_bfloat16(a0p[0]));
  const float a1 = __bfloat162float(__ushort_as_bfloat16(a1p[0]));
  const bool vec = (W % 8) == 0;

  for (int tile = first; tile < n_tiles; tile += gridDim.x * GROUPS) {
    const int b = tile / per_img, rem = tile % per_img;
    const int y0 = (rem / tiles_x) * T, x0 = (rem % tiles_x) * T;
    // this tile's x patch has landed, and every thread is done with the
    // last tile's stage, which c0 overwrites
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    group_sync(group);

    // c0 on the tensor cores: t0 over the tile plus its 1-pixel halo
    for (int mt = warp; mt < C0_MT; mt += GWARPS) {
      const int p0 = mt * 16 + g, p1 = p0 + 8;
      const int s0 = min(p0, T0 * T0 - 1), s1 = min(p1, T0 * T0 - 1);
      const int xo0 = (s0 / T0) * XP + s0 % T0, xo1 = (s1 / T0) * XP + s1 % T0;
      float acc[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[nt][j] = 0.f;
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        uint16_t v0[4], v1[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int off = koffs[t * 8 + ks * 4 + j];
          v0[j] = off >= 0 ? xs[xo0 + off] : (uint16_t)0;
          v1[j] = off >= 0 ? xs[xo1 + off] : (uint16_t)0;
        }
        const uint32_t a[4] = {pack2(v0[0], v0[1]), pack2(v1[0], v1[1]),
                               pack2(v0[2], v0[3]), pack2(v1[2], v1[3])};
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const uint2 bb = w0f[(ks * 8 + nt) * 32 + lane];
          mma(acc[nt], a, bb.x, bb.y);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int co = nt * 8 + 2 * t;
        const float bl = bas[co], bh = bas[co + 1];
        if (p0 < T0 * T0)
          *reinterpret_cast<uint32_t*>(t0s + p0 * PIX + co) =
              bias_prelu2(acc[nt][0], acc[nt][1], bl, bh, a0);
        if (p1 < T0 * T0)
          *reinterpret_cast<uint32_t*>(t0s + p1 * PIX + co) =
              bias_prelu2(acc[nt][2], acc[nt][3], bl, bh, a0);
      }
    }
    group_sync(group);
    // xs is free: fetch the next tile's patch behind c1 and the epilogue
    if (tile + gridDim.x * GROUPS < n_tiles) load_x(tile + gridDim.x * GROUPS);

    // c1 on wgmma: this warp's output rows 2 warp + mi (mi = 0, 1) are its
    // 16 rows of the m64 blocks mi of its warpgroup, all 64 channels; 9 taps
    // x 4 k-steps of 16 input channels. acc[mi][4 nt + e] is the m16n8
    // fragment of n-tile nt.
    float acc[2][32];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int j = 0; j < 32; ++j) acc[mi][j] = 0.f;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3, kx = tap % 3;
      const uint32_t a_tap = a_lane + (ky * T0 + kx) * PIX * 2;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        uint32_t a[2][4];
        ldsm_x4(a_tap + ks * 32, a[0]);
        ldsm_x4(a_tap + T0 * PIX * 2 + ks * 32, a[1]);
        const uint64_t desc = desc_w1 + ((tap * C * C * 2 + ks * 32) >> 4);
        wgmma_fence();
        wgmma_m64n64k16(acc[0], a[0], desc);
        wgmma_m64n64k16(acc[1], a[1], desc);
        wgmma_commit_wait();
      }
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int j = 0; j < 32; ++j) fence_operand(acc[mi][j]);
    group_sync(group);  // every warp is done with t0: the stage goes over it

    // epilogue: bias, PReLU, bf16, staged as [co][pixel] by stmatrix.trans
    // (matrices: n-tiles 2p, 2p + 1 x pixels 0-7, 8-15 of the m-tile)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        uint32_t r[4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int nt = 2 * p + h, co = nt * 8 + 2 * t;
          const float bl = bas[C + co], bh = bas[C + co + 1];
          r[2 * h] = bias_prelu2(acc[mi][4 * nt], acc[mi][4 * nt + 1], bl, bh, a1);
          r[2 * h + 1] = bias_prelu2(acc[mi][4 * nt + 2], acc[mi][4 * nt + 3], bl, bh, a1);
        }
        stsm_x4_trans(st_lane + (16 * p * SST + (2 * warp + mi) * T) * 2, r);
      }
    group_sync(group);

    const uint16_t* st = t0s;
    // l1: 8 pixels along W per store
    for (int i = gtid; i < C * T * 2; i += GT) {
      const int co = i / (2 * T), row = (i / 2) % T, half = i % 2;
      const int oy = y0 + row, ox = x0 + 8 * half;
      if (oy >= H || ox >= W) continue;
      const uint16_t* src = st + co * SST + row * T + 8 * half;
      __nv_bfloat16* dst = l1 + (((size_t)b * C + co) * H + oy) * W + ox;
      if (vec) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int e = 0; e < 8 && ox + e < W; ++e) dst[e] = __ushort_as_bfloat16(src[e]);
      }
    }
    // l2_in: 2x2 max of the rounded values, 4 outputs per store; H and W
    // are even, so a window whose corner is inside is inside whole
    for (int i = gtid; i < C * (T / 2) * 2; i += GT) {
      const int co = i / T, pr = (i / 2) % (T / 2), half = i % 2;
      const int oy = y0 + 2 * pr, ox = x0 + 8 * half;
      if (oy >= H || ox >= W) continue;
      const uint16_t* src = st + co * SST + 2 * pr * T + 8 * half;
      const uint4 u = *reinterpret_cast<const uint4*>(src);
      const uint4 d = *reinterpret_cast<const uint4*>(src + T);
      const uint2 m = make_uint2(pack2(hmax_halves(hmax2(u.x, d.x)), hmax_halves(hmax2(u.y, d.y))),
                                 pack2(hmax_halves(hmax2(u.z, d.z)), hmax_halves(hmax2(u.w, d.w))));
      __nv_bfloat16* dst = l2 + (((size_t)b * C + co) * H2 + oy / 2) * W2 + ox / 2;
      if (vec) {
        *reinterpret_cast<uint2*>(dst) = m;
      } else {
        const uint32_t v[2] = {m.x, m.y};
        for (int e = 0; e < 4 && ox + 2 * e < W; ++e)
          dst[e] = __ushort_as_bfloat16((uint16_t)(v[e / 2] >> (16 * (e % 2))));
      }
    }
  }
}

}  // namespace tc

// ---------------------------------------------------------------- fp32

namespace cc {

constexpr int TH = 8, TW = 32;            // output tile
constexpr int XH = TH + 4, XW = TW + 4;   // input patch
constexpr int T0H = TH + 2, T0W = TW + 2; // t0 patch
constexpr int CHUNK = 32;                 // output channels per c1 pass
constexpr int NT = 256;                   // 64 2x2 blocks x 4 groups of 8 channels

constexpr int WS_FLOATS = C * 9 * CHUNK;
constexpr int XS_FLOATS = 3 * XH * XW;
constexpr int W0_FLOATS = C * 27;
constexpr int BA_FLOATS = 132;  // b0[64], b1[64], a0, a1, padding to 16 bytes
constexpr size_t SMEM =
    sizeof(float) * (WS_FLOATS + XS_FLOATS + W0_FLOATS + BA_FLOATS + C * T0H * T0W);

// one CTA per image x (8-row, 32-column) output tile: the input patch and
// t0 (tile plus 1-px halo) in shared memory, then c1 in two passes of 32
// output channels, each with its slice of w1 in shared memory. Each thread
// owns one 2x2 output block for 8 channels, so the pool happens in
// registers; threads of a warp share their channels (weight broadcasts).
__global__ void __launch_bounds__(NT, 1)
enc1_f32_kernel(const float* __restrict__ x,   // (B, 3, H+4, W+4)
                const float* __restrict__ w0,  // (64, 3, 3, 3)
                const float* __restrict__ w1,  // (64 ci, 3, 3, 64 co)
                const float* __restrict__ ba,  // b0[64], b1[64], a0, a1
                float* __restrict__ l1,        // (B, 64, H, W)
                float* __restrict__ l2,        // (B, 64, H/2, W/2)
                int H, int W) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ws = reinterpret_cast<float*>(smem_raw);  // [64*9][CHUNK]
  float* xs = ws + WS_FLOATS;                      // [3][XH][XW]
  float* w0s = xs + XS_FLOATS;                     // [64][27]
  float* bas = w0s + W0_FLOATS;                    // [132]
  float* t0s = bas + BA_FLOATS;                    // [64][T0H][T0W]

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const int HP = H + 4, WP = W + 4;
  const float* xb = x + (size_t)b * 3 * HP * WP;

  for (int i = tid; i < XS_FLOATS; i += NT) {
    const int c = i / (XH * XW), r = (i / XW) % XH, q = i % XW;
    const int gy = y0 + r, gx = x0 + q;
    xs[i] = (gy < HP && gx < WP) ? xb[((size_t)c * HP + gy) * WP + gx] : 0.f;
  }
  for (int i = tid; i < W0_FLOATS; i += NT) w0s[i] = w0[i];
  for (int i = tid; i < 2 * C + 2; i += NT) bas[i] = ba[i];
  __syncthreads();

  // c0 over the tile plus halo; positions past the image hold values no
  // stored output reads
  const float a0 = bas[2 * C], a1 = bas[2 * C + 1];
  for (int i = tid; i < C * T0H * T0W; i += NT) {
    const int co = i / (T0H * T0W), r = (i / T0W) % T0H, q = i % T0W;
    const float* wc = w0s + co * 27;
    float acc = 0.f;
#pragma unroll
    for (int ci = 0; ci < 3; ++ci)
#pragma unroll
      for (int ky = 0; ky < 3; ++ky)
#pragma unroll
        for (int kx = 0; kx < 3; ++kx)
          acc = fmaf(wc[(ci * 3 + ky) * 3 + kx], xs[(ci * XH + r + ky) * XW + q + kx], acc);
    t0s[i] = prelu(acc + bas[co], a0);
  }

  const int sub = tid >> 6;  // warp-uniform group of 8 output channels
  const int blk = tid & 63;
  const int br = blk >> 4, bc = blk & 15;
  const int oy = y0 + 2 * br, ox = x0 + 2 * bc;
  // H and W are even, so a block whose corner is inside is inside whole
  const bool valid = oy < H && ox < W;
  const int H2 = H / 2, W2 = W / 2;

  for (int pass = 0; pass < C / CHUNK; ++pass) {
    __syncthreads();  // t0s complete; the previous pass is done with ws
    for (int i = tid; i < WS_FLOATS / 4; i += NT) {
      const int row = i / (CHUNK / 4), q = i % (CHUNK / 4);
      reinterpret_cast<float4*>(ws)[i] =
          reinterpret_cast<const float4*>(w1 + (size_t)row * C + pass * CHUNK)[q];
    }
    __syncthreads();

    float acc[8][4];
#pragma unroll
    for (int k = 0; k < 8; ++k)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[k][j] = 0.f;

    for (int ci = 0; ci < C; ++ci) {
      float p[4][4];
      const float* tp = t0s + (ci * T0H + 2 * br) * T0W + 2 * bc;
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) p[r][q] = tp[r * T0W + q];
      const float* wp = ws + ci * 9 * CHUNK + sub * 8;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int ky = tap / 3, kx = tap % 3;
        const float4 wa = *reinterpret_cast<const float4*>(wp + tap * CHUNK);
        const float4 wb = *reinterpret_cast<const float4*>(wp + tap * CHUNK + 4);
        const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
        for (int k = 0; k < 8; ++k)
#pragma unroll
          for (int dy = 0; dy < 2; ++dy)
#pragma unroll
            for (int dx = 0; dx < 2; ++dx)
              acc[k][dy * 2 + dx] = fmaf(wv[k], p[dy + ky][dx + kx], acc[k][dy * 2 + dx]);
      }
    }

    if (valid) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int co = pass * CHUNK + sub * 8 + k;
        const float bias = bas[C + co];
        float* lo = l1 + (((size_t)b * C + co) * H + oy) * W + ox;
        float m = -INFINITY;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float v = prelu(acc[k][j] + bias, a1);
          lo[(j >> 1) * W + (j & 1)] = v;
          m = fmaxf(m, v);
        }
        l2[(((size_t)b * C + co) * H2 + oy / 2) * W2 + ox / 2] = m;
      }
    }
  }
}

}  // namespace cc

bool bad_shape(int B, int H, int W) {
  return B < 1 || H < 2 || W < 2 || (H & 1) || (W & 1);
}

}  // namespace

// Each entry returns cudaGetLastError() after the launch (0 on success).

// bf16: weights and biases as bf16 (w1 from pack_w1); tiles_y = ceil(H / 16),
// tiles_x = ceil(W / 16); n_ctas persistent CTAs walk the B * tiles_y *
// tiles_x tiles (ops/enc1.py computes all three). x must be 4-byte aligned.
extern "C" int enc1_bf16_launch(const void* x, const void* w0, const void* w1p, const void* b0,
                                const void* b1, const void* a0, const void* a1, void* l1,
                                void* l2, int B, int H, int W, int tiles_y, int tiles_x,
                                int n_ctas, void* stream) {
  if (bad_shape(B, H, W) || tiles_y != (H + tc::T - 1) / tc::T ||
      tiles_x != (W + tc::T - 1) / tc::T || n_ctas < 1 ||
      (long long)B * tiles_y * tiles_x > 0x7fffffffLL || (reinterpret_cast<size_t>(x) & 3) ||
      (reinterpret_cast<size_t>(w1p) & 15))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(tc::enc1_bf16_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, tc::SMEM);
  if (e != cudaSuccess) return (int)e;
  using u16 = const uint16_t*;
  tc::enc1_bf16_kernel<<<n_ctas, tc::NT, tc::SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<u16>(x), static_cast<u16>(w0), static_cast<u16>(w1p), static_cast<u16>(b0),
      static_cast<u16>(b1), static_cast<u16>(a0), static_cast<u16>(a1),
      static_cast<__nv_bfloat16*>(l1), static_cast<__nv_bfloat16*>(l2), B, H, W, tiles_y,
      tiles_x);
  return (int)cudaGetLastError();
}

// fp32: w0 (64, 3, 3, 3), w1 as (ci, ky, kx, co).
extern "C" int enc1_f32_launch(const void* x, const void* w0, const void* w1, const void* ba,
                               void* l1, void* l2, int B, int H, int W, void* stream) {
  if (bad_shape(B, H, W) || B > 65535 || H / cc::TH >= 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(cc::enc1_f32_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)cc::SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((W + cc::TW - 1) / cc::TW, (H + cc::TH - 1) / cc::TH, B);
  cc::enc1_f32_kernel<<<grid, cc::NT, cc::SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w0),
      static_cast<const float*>(w1), static_cast<const float*>(ba), static_cast<float*>(l1),
      static_cast<float*>(l2), H, W);
  return (int)cudaGetLastError();
}
