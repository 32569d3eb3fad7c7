// Fused UtNet encoder level 1 for Hopper (sm_90a), CUDA-core FMAs.
//
// Replaces the TPU kernel nind_denoise_tpu/ops/pallas_enc1.py enc1_pallas
// (kernel body _enc1_kernel). Same math, unfolded NCHW layout:
//   t0    = PReLU(conv3x3_valid(x_pad, w0) + b0), rounded to the I/O type
//   l1    = PReLU(conv3x3_valid(t0, w1) + b1)     (fp32 sums, then rounded)
//   l2_in = maxpool2x2(l1)
// x_pad (B, 3, H+4, W+4) -> l1 (B, 64, H, W), l2_in (B, 64, H/2, W/2); the
// I/O type T is bf16 or fp32, every sum is fp32.
//
// What bounds it: c1 is 64*64*9 MACs per output pixel, about 150 GFLOP at
// B=8, 504x504, while the bytes are about 340 MB (mostly the l1 write). On
// tensor cores that is ~0.16 ms of operations against ~0.10 ms of bytes,
// so the operations bound it. This first kernel runs on CUDA cores (fp32
// FMA peak 67 TFLOP/s, so >= 2.3 ms); the tensor-core version (wgmma)
// is later work.
//
// Design: one CTA per image x (8-row, 32-column) output tile. The CTA
// stages its input patch (3 x 12 x 36) in shared memory, computes t0 for
// the tile plus its 1-px halo (64 x 10 x 34) into shared memory (t0 never
// touches device memory: that is the traffic the fusion removes), then c1
// in two passes of 32 output channels, each pass with its slice of w1 in
// shared memory. Each thread owns one 2x2 output block for 8 channels, so
// the 2x2 max pool happens in registers and l2_in is written by the same
// CTA (tiles start at even rows and columns). Threads of a warp share
// their output channels, so every weight load is a shared-memory
// broadcast.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int C = 64;                     // funit: channels of t0 and l1
constexpr int TH = 8, TW = 32;            // output tile
constexpr int XH = TH + 4, XW = TW + 4;   // input patch
constexpr int T0H = TH + 2, T0W = TW + 2; // t0 patch
constexpr int CHUNK = 32;                 // output channels per c1 pass
constexpr int NT = 256;                   // 64 2x2 blocks x 4 groups of 8 channels

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

constexpr int WS_FLOATS = C * 9 * CHUNK;
constexpr int XS_FLOATS = 3 * XH * XW;
constexpr int W0_FLOATS = C * 27;
constexpr int BA_FLOATS = 132;  // b0[64], b1[64], a0, a1, padding to 16 bytes

template <typename T>
size_t smem_bytes() {
  return sizeof(float) * (WS_FLOATS + XS_FLOATS + W0_FLOATS + BA_FLOATS) +
         sizeof(T) * C * T0H * T0W;
}

template <typename T>
__global__ void __launch_bounds__(NT, 1)
enc1_kernel(const T* __restrict__ x,       // (B, 3, H+4, W+4)
            const float* __restrict__ w0,  // (64, 3, 3, 3)
            const float* __restrict__ w1,  // (64 ci, 3, 3, 64 co)
            const float* __restrict__ ba,  // b0[64], b1[64], a0, a1
            T* __restrict__ l1,            // (B, 64, H, W)
            T* __restrict__ l2,            // (B, 64, H/2, W/2)
            int H, int W) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ws = reinterpret_cast<float*>(smem_raw);  // [64*9][CHUNK]
  float* xs = ws + WS_FLOATS;                      // [3][XH][XW]
  float* w0s = xs + XS_FLOATS;                     // [64][27]
  float* bas = w0s + W0_FLOATS;                    // [132]
  T* t0s = reinterpret_cast<T*>(bas + BA_FLOATS);  // [64][T0H][T0W]

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const int HP = H + 4, WP = W + 4;
  const T* xb = x + (size_t)b * 3 * HP * WP;

  for (int i = tid; i < XS_FLOATS; i += NT) {
    const int c = i / (XH * XW), r = (i / XW) % XH, q = i % XW;
    const int gy = y0 + r, gx = x0 + q;
    xs[i] = (gy < HP && gx < WP) ? to_f(xb[((size_t)c * HP + gy) * WP + gx]) : 0.f;
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
    acc += bas[co];
    t0s[i] = from_f<T>(acc >= 0.f ? acc : a0 * acc);
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
      const T* tp = t0s + (ci * T0H + 2 * br) * T0W + 2 * bc;
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) p[r][q] = to_f(tp[r * T0W + q]);
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
        T* lo = l1 + (((size_t)b * C + co) * H + oy) * W + ox;
        float m = -INFINITY;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float v = acc[k][j] + bias;
          const T t = from_f<T>(v >= 0.f ? v : a1 * v);
          lo[(j >> 1) * W + (j & 1)] = t;
          m = fmaxf(m, to_f(t));
        }
        l2[(((size_t)b * C + co) * H2 + oy / 2) * W2 + ox / 2] = from_f<T>(m);
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w0, const void* w1, const void* ba,
                   void* l1, void* l2, int B, int H, int W, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>();
  cudaError_t e = cudaFuncSetAttribute(enc1_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  enc1_kernel<T><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w0), static_cast<const float*>(w1),
      static_cast<const float*>(ba), static_cast<T*>(l1), static_cast<T*>(l2), H, W);
  return cudaGetLastError();
}

}  // namespace

// is_bf16: 1 for bf16 I/O, 0 for fp32. Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int enc1_launch(const void* x, const void* w0, const void* w1, const void* ba,
                           void* l1, void* l2, int B, int H, int W, int is_bf16,
                           void* stream) {
  if (B < 1 || H < 2 || W < 2 || (H & 1) || (W & 1) || B > 65535 || H / TH >= 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = is_bf16 ? launch<__nv_bfloat16>(x, w0, w1, ba, l1, l2, B, H, W, s)
                                : launch<float>(x, w0, w1, ba, l1, l2, B, H, W, s);
  return (int)e;
}
