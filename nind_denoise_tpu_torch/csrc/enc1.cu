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
// fp32 instance (enc1_f32_kernel): CUDA cores, since TF32 would break its
// 1e-4 x max(1, |l1|) limit and its bit-equality with the plain version. It
// runs under --compute_dtype float32 (CLI, server) and wherever the model
// is fp32: the trainer's validation crops, the cGAN's generator forward
// before each discriminator step, a data-parallel rank's learn, and the
// bands of the sharded whole-image test. At fp32's 67 TFLOP/s the
// operations bound it (1.171 ms at 30 x 184^2 against 0.10 ms of bytes).
// Every output keeps one operation sequence: t0 = PReLU(fmaf chain over
// (ci, ky, kx) from 0, + b0); l1 = PReLU(fmaf chain over ci 0..63 outer and
// tap 0..8 inner from 0, + b1); l2_in = fmaxf over the window's four l1
// values in row order, from -inf. That is the first port's kernel's
// sequence, and the plain version (cuDNN fp32 without TF32) gives the same
// bits at every shape chip_smoke.py checks; nothing splits a sum (no
// split-K, no atomics).
//   Persistent CTAs, one per SM at most (ops/enc1.py f32_cta_count), walk
//   the (image, 8 x 32 tile) list (f32_walk). A CTA loads the whole of w1
//   once, [ci][tap][co]. A tile's t0 (the tile and its 1-pixel halo, 10 x
//   34, computed 10 x 36) comes in 4 chunks of 16 channels, double-
//   buffered: while c1 sums chunk k, c0 computes chunk k+1 into the other
//   buffer (the last chunk's interval computes the next tile's chunk 0, from
//   the next x patch, fetched by cp.async at the tile's start), one barrier
//   a chunk. The 64 accumulators stay in registers across the chunks, so
//   the ci order holds.
//   c1: warp g owns channels 8g..8g+7 for the whole tile; lane (lr, lc) =
//   (lane / 8, lane % 8) owns rows 2lr, 2lr+1 and columns 4lc..4lc+3: 8
//   channels x 8 pixels = two 2x2 pool windows, 64 accumulators. For each
//   input channel it reads its 4 x 6 t0 window (per row a float4 and a
//   float2; a quarter-warp reads one row's 128 contiguous bytes) and 9 x 8
//   weights (float4 broadcasts): 26 shared loads for 576 FMAs, against 34
//   for 288 in the first port's kernel. The next channel's window is loaded
//   ahead, with no branch around it.
//   c0: half-warp h of warp w computes chunk channel 2w + h, its 27 weights
//   in registers; a task is 2 rows x 4 columns of it (3 x 4 x-patch rows of
//   6, 216 FMAs, two float4 stores), 45 tasks in 3 rounds of 16. Warps 0-3
//   run c0 before c1 and warps 4-7 after it, so each scheduler has one warp
//   of each (all c0 first: 6 % slower, tools/enc1_breakdown.py).
//   The epilogue stores from registers, with no stage in shared memory:
//   per channel two float4 rows of l1 (a quarter-warp writes 128 contiguous
//   bytes) and a float2 of l2_in; element stores where W % 4 != 0. Cutting
//   either store changes the time by under 3 % (tools/enc1_breakdown.py):
//   they overlap the next tile.
//   Shared memory per CTA: w1 147,456 + t0 2 x 16 x 10 x 36 x 4 = 46,080 +
//   x patch 2 x 3 x 12 x 40 x 4 = 11,520 + w0 64 x 28 x 4 = 7,168 + b0, b1,
//   a0, a1 528 = 212,752 B (of 232,448): one CTA of 256 threads an SM.

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

constexpr int TH = 8, TW = 32;  // output tile
constexpr int T0H = TH + 2;     // t0 rows of a tile (1-pixel halo)
constexpr int T0S = TW + 4;     // t0 row stride and computed width (TW + 2 are read)
constexpr int XH = TH + 4;      // x-patch rows
constexpr int XS = TW + 8;      // x-patch row stride (c0 reads T0S + 2 columns)
constexpr int CC = 16;          // t0 channels per chunk
constexpr int NCH = C / CC;     // chunks per tile
constexpr int NT = 256;         // 8 warps; warp g owns output channels 8g..8g+7
constexpr int W0S = 28;         // w0 row stride: 27 taps and a zero
constexpr int C0_TASKS = (T0H / 2) * (T0S / 4);      // per t0 channel, 2 rows x 4 columns each
constexpr int C0_ROUNDS = (C0_TASKS + 15) / 16;     // a half-warp's turns at its channel

constexpr int W1_FLOATS = C * 9 * C;
constexpr int T0_FLOATS = CC * T0H * T0S;
constexpr int XP_FLOATS = 3 * XH * XS;
constexpr int W0_FLOATS = C * W0S;
constexpr int BA_FLOATS = 132;  // b0[64], b1[64], a0, a1, padding to 16 bytes
constexpr int SMEM = 4 * (W1_FLOATS + 2 * T0_FLOATS + 2 * XP_FLOATS + W0_FLOATS + BA_FLOATS);
static_assert(TH == 8 && TW == 32, "the lane map: 4 x 2 rows, 8 x 4 columns a warp");
static_assert((NT / 32) * 8 == C && 2 * (NT / 32) == CC, "c1: 8 channels a warp; c0: 2");
static_assert(T0S % 4 == 0 && XS % 4 == 0 && T0_FLOATS % 4 == 0 && XP_FLOATS % 4 == 0 &&
                  W0S % 4 == 0, "16-byte alignment of every row and region");
static_assert(XS >= T0S + 2 && T0S >= TW + 2, "windows inside their rows");
static_assert(SMEM <= 232448, "shared memory per CTA");
static_assert(2 * XP_FLOATS >= 4 * T0S, "c1's loads past a chunk stay in shared memory");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// t0 channels chunk*CC .. chunk*CC + CC-1 of the tile whose x patch is xp,
// into t0c: half-warp h of warp w computes chunk channel 2w + h with its 27
// weights in registers, a task (a lane's turn) 2 rows x 4 columns of it
__device__ __forceinline__ void c0(const float* xp, float* t0c, int chunk, const float* w0s,
                                   const float* bas, float a0, int warp, int lane) {
  const int ch = 2 * warp + (lane >> 4), co = chunk * CC + ch;
  float w[W0S];
#pragma unroll
  for (int j = 0; j < W0S / 4; ++j) {
    const float4 v = reinterpret_cast<const float4*>(w0s + co * W0S)[j];
    w[4 * j] = v.x, w[4 * j + 1] = v.y, w[4 * j + 2] = v.z, w[4 * j + 3] = v.w;
  }
  const float b = bas[co];
  for (int round = 0; round < C0_ROUNDS; ++round) {
    const int task = round * 16 + (lane & 15);
    if (task >= C0_TASKS) break;
    const int rp = task / (T0S / 4), cb = task % (T0S / 4);
    float acc[2][4];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
    // x row s feeds t0 row r at ky = s - r: each output still sums in
    // (ci, ky, kx) order
#pragma unroll
    for (int ci = 0; ci < 3; ++ci)
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const float* xr = xp + (ci * XH + 2 * rp + s) * XS + 4 * cb;
        const float4 u = *reinterpret_cast<const float4*>(xr);
        const float2 v = *reinterpret_cast<const float2*>(xr + 4);
        const float xv[6] = {u.x, u.y, u.z, u.w, v.x, v.y};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int ky = s - r;
          if (ky < 0 || ky > 2) continue;
#pragma unroll
          for (int kx = 0; kx < 3; ++kx)
#pragma unroll
            for (int q = 0; q < 4; ++q)
              acc[r][q] = fmaf(w[(ci * 3 + ky) * 3 + kx], xv[q + kx], acc[r][q]);
        }
      }
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<float4*>(t0c + (ch * T0H + 2 * rp + r) * T0S + 4 * cb) =
          make_float4(prelu(acc[r][0] + b, a0), prelu(acc[r][1] + b, a0),
                      prelu(acc[r][2] + b, a0), prelu(acc[r][3] + b, a0));
  }
}

// c1 over the chunk's CC input channels: acc[k][4 dy + dx] is channel
// 8 warp + k at tile row 2 lr + dy, column 4 lc + dx. The next channel's t0
// window is loaded ahead of its use. Past the chunk's last channel those
// loads read the next region of shared memory (the other t0 buffer or the x
// patches) and go unused: a branch around them cost 22 %
// (tools/enc1_breakdown.py, guarded_loads_ahead).
__device__ __forceinline__ void c1(const float* t0c, const float* w1c, float (&acc)[8][8],
                                   int lr, int lc) {
  const float* tb = t0c + 2 * lr * T0S + 4 * lc;
  float4 nu[4];
  float2 nv[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    nu[r] = *reinterpret_cast<const float4*>(tb + r * T0S);
    nv[r] = *reinterpret_cast<const float2*>(tb + r * T0S + 4);
  }
#pragma unroll 1
  for (int ci = 0; ci < CC; ++ci) {
    float p[4][6];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      p[r][0] = nu[r].x, p[r][1] = nu[r].y, p[r][2] = nu[r].z, p[r][3] = nu[r].w;
      p[r][4] = nv[r].x, p[r][5] = nv[r].y;
    }
    const float* tn = tb + (ci + 1) * T0H * T0S;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      nu[r] = *reinterpret_cast<const float4*>(tn + r * T0S);
      nv[r] = *reinterpret_cast<const float2*>(tn + r * T0S + 4);
    }
    const float* wc = w1c + ci * 9 * C;
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      const int ky = t / 3, kx = t % 3;
      const float4 wa = *reinterpret_cast<const float4*>(wc + t * C);
      const float4 wz = *reinterpret_cast<const float4*>(wc + t * C + 4);
      const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wz.x, wz.y, wz.z, wz.w};
#pragma unroll
      for (int k = 0; k < 8; ++k)
#pragma unroll
        for (int dy = 0; dy < 2; ++dy)
#pragma unroll
          for (int dx = 0; dx < 4; ++dx)
            acc[k][4 * dy + dx] = fmaf(wv[k], p[dy + ky][dx + kx], acc[k][4 * dy + dx]);
    }
  }
}

// the epilogue from registers: l1 and l2_in of the thread's 8 channels at
// rows oy, oy + 1 and columns ox .. ox + 3 of image b. H is even and rows
// come in pairs, so a thread's rows are both inside or both outside; W is
// even, so its columns are 4, 2 (W % 4 == 2) or 0 inside, whole pool windows.
__device__ __forceinline__ void store(const float (&acc)[8][8], float* __restrict__ l1,
                                      float* __restrict__ l2, const float* b1, float a1, int b,
                                      int oy, int ox, int H, int W, bool vec, int warp) {
  if (oy >= H || ox >= W) return;
  const int H2 = H / 2, W2 = W / 2;
  const bool full = vec && ox + 4 <= W;
#pragma unroll
  for (int kl = 0; kl < 8; ++kl) {
    const int co = 8 * warp + kl;
    const float bias = b1[co];
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = prelu(acc[kl][j] + bias, a1);
    float* lo = l1 + (((size_t)b * C + co) * H + oy) * W + ox;
    if (full) {
      *reinterpret_cast<float4*>(lo) = make_float4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<float4*>(lo + W) = make_float4(v[4], v[5], v[6], v[7]);
    } else {
      for (int dx = 0; dx < 4 && ox + dx < W; ++dx) {
        lo[dx] = v[dx];
        lo[W + dx] = v[4 + dx];
      }
    }
  }
#pragma unroll
  for (int kp = 0; kp < 8; ++kp) {
    const int co = 8 * warp + kp;
    const float bias = b1[co];
    float m[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // the window's four l1 values in row order, as the first port's kernel
      float mm = -INFINITY;
      mm = fmaxf(mm, prelu(acc[kp][2 * h] + bias, a1));
      mm = fmaxf(mm, prelu(acc[kp][2 * h + 1] + bias, a1));
      mm = fmaxf(mm, prelu(acc[kp][4 + 2 * h] + bias, a1));
      mm = fmaxf(mm, prelu(acc[kp][5 + 2 * h] + bias, a1));
      m[h] = mm;
    }
    float* po = l2 + (((size_t)b * C + co) * H2 + oy / 2) * W2 + ox / 2;
    if (full) {
      *reinterpret_cast<float2*>(po) = make_float2(m[0], m[1]);
    } else {
      po[0] = m[0];
      if (ox + 2 < W) po[1] = m[1];
    }
  }
}

__global__ void __launch_bounds__(NT, 1)
enc1_f32_kernel(const float* __restrict__ x,   // (B, 3, H+4, W+4)
                const float* __restrict__ w0,  // (64, 3, 3, 3)
                const float* __restrict__ w1,  // (64 ci, 3, 3, 64 co)
                const float* __restrict__ ba,  // b0[64], b1[64], a0, a1
                float* __restrict__ l1,        // (B, 64, H, W)
                float* __restrict__ l2,        // (B, 64, H/2, W/2)
                int B, int H, int W, int tiles_y, int tiles_x) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* w1s = reinterpret_cast<float*>(smem_raw);  // [ci][tap][co]
  float* t0s = w1s + W1_FLOATS;                     // 2 x [CC][T0H][T0S]
  float* xs = t0s + 2 * T0_FLOATS;                  // 2 x [3][XH][XS]
  float* w0s = xs + 2 * XP_FLOATS;                  // [co][W0S]
  float* bas = w0s + W0_FLOATS;                     // b0, b1, a0, a1

  const int per_img = tiles_y * tiles_x, n_tiles = B * per_img;
  int tile = blockIdx.x;
  if (tile >= n_tiles) return;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int lr = lane >> 3, lc = lane & 7;
  const int HP = H + 4, WP = W + 4;

  // the x patch of tile t into buf by cp.async; zero outside x_pad (those
  // t0 values feed no stored output)
  auto load_x = [&](int t, float* buf) {
    const int b = t / per_img, rem = t % per_img;
    const int y0 = (rem / tiles_x) * TH, x0 = (rem % tiles_x) * TW;
    const float* xb = x + (size_t)b * 3 * HP * WP;
    const uint32_t base = smem_addr(buf);
    for (int i = tid; i < XP_FLOATS; i += NT) {
      const int c = i / (XH * XS), r = (i / XS) % XH, q = i % XS;
      const int gy = y0 + r, gx = x0 + q;
      const bool in = gy < HP && gx < WP;
      const float* src = in ? xb + ((size_t)c * HP + gy) * WP + gx : x;
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(base + 4 * i),
                   "l"(src), "r"(in ? 4 : 0)
                   : "memory");
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  // the whole of w1, once per CTA, then the first tile's x patch
  const uint32_t w1_addr = smem_addr(w1s);
  for (int i = tid; i < W1_FLOATS / 4; i += NT)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(w1_addr + 16 * i),
                 "l"(w1 + 4 * i)
                 : "memory");
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  load_x(tile, xs);
  for (int i = tid; i < W0_FLOATS; i += NT) {
    const int co = i / W0S, k = i % W0S;
    w0s[i] = k < 27 ? w0[co * 27 + k] : 0.f;
  }
  for (int i = tid; i < 2 * C + 2; i += NT) bas[i] = ba[i];
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  const float a0 = bas[2 * C], a1 = bas[2 * C + 1];
  const bool vec = (W % 4) == 0 && (reinterpret_cast<size_t>(l1) & 15) == 0 &&
                   (reinterpret_cast<size_t>(l2) & 7) == 0;
  // warps w and w + 4 share a scheduler: one runs c0 before c1, the other after
  const bool c0_first = warp < 4;

  c0(xs, t0s, 0, w0s, bas, a0, warp, lane);
  __syncthreads();
  float acc[8][8];
  for (int it = 0; tile < n_tiles; tile += gridDim.x, ++it) {
    const int b = tile / per_img, rem = tile % per_img;
    const int y0 = (rem / tiles_x) * TH, x0 = (rem % tiles_x) * TW;
    const int next = tile + gridDim.x;
    const float* xcur = xs + (it & 1) * XP_FLOATS;
    float* xnext = xs + ((it + 1) & 1) * XP_FLOATS;
    // the buffer of the tile before: its last reader passed a barrier
    if (next < n_tiles) load_x(next, xnext);
#pragma unroll
    for (int k = 0; k < 8; ++k)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[k][j] = 0.f;

    // chunk k's t0 is in buffer k & 1; c0 fills the other one with chunk
    // k + 1, or with the next tile's chunk 0 from the next x patch
#pragma unroll 1
    for (int chunk = 0; chunk < NCH; ++chunk) {
      const bool last = chunk + 1 == NCH;
      const bool more = !last || next < n_tiles;
      const float* xsrc = last ? xnext : xcur;
      float* t0n = t0s + ((chunk + 1) & 1) * T0_FLOATS;
      const int nchunk = last ? 0 : chunk + 1;
      if (c0_first && more) c0(xsrc, t0n, nchunk, w0s, bas, a0, warp, lane);
      c1(t0s + (chunk & 1) * T0_FLOATS, w1s + chunk * CC * 9 * C + 8 * warp, acc, lr, lc);
      if (!c0_first && more) c0(xsrc, t0n, nchunk, w0s, bas, a0, warp, lane);
      // this thread's copies of the next x patch have landed; the barrier
      // shows them to the CTA before the last chunk's c0 reads them
      if (chunk == NCH - 2) asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      __syncthreads();
    }

    store(acc, l1, l2, bas + C, a1, b, y0 + 2 * lr, x0 + 4 * lc, H, W, vec, warp);
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

// fp32: w0 (64, 3, 3, 3), w1 as (ci, ky, kx, co), 16-byte aligned; tiles_y =
// ceil(H / 8), tiles_x = ceil(W / 32); n_ctas persistent CTAs walk the B *
// tiles_y * tiles_x tiles (ops/enc1.py computes all three).
extern "C" int enc1_f32_launch(const void* x, const void* w0, const void* w1, const void* ba,
                               void* l1, void* l2, int B, int H, int W, int tiles_y,
                               int tiles_x, int n_ctas, void* stream) {
  if (bad_shape(B, H, W) || tiles_y != (H + cc::TH - 1) / cc::TH ||
      tiles_x != (W + cc::TW - 1) / cc::TW || n_ctas < 1 ||
      (long long)B * tiles_y * tiles_x > 0x7fffffffLL || (reinterpret_cast<size_t>(w1) & 15))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(cc::enc1_f32_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, cc::SMEM);
  if (e != cudaSuccess) return (int)e;
  cc::enc1_f32_kernel<<<n_ctas, cc::NT, cc::SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w0),
      static_cast<const float*>(w1), static_cast<const float*>(ba), static_cast<float*>(l1),
      static_cast<float*>(l2), B, H, W, tiles_y, tiles_x);
  return (int)cudaGetLastError();
}
