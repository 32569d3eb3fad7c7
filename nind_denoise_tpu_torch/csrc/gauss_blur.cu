// Separable Gaussian blur for Hopper (sm_90a):
//   out = G_W * (G_H * x)
// on fp32 (H, W, C) images with interleaved channels, G the truncated
// Gaussian of 2R+1 taps (1 <= R <= 64), each pass edge-replicating its own
// input. A second entry takes planar (P, H, W) fp32 as P images of one
// channel, an image per blockIdx.z: the RL deblur's route above radius 32
// (ops/rl_deblur.py, "separable_k3") blurs its state that way.
//
// Replaces the TPU kernel nind_denoise_tpu/ops/pallas_blur.py
// gauss_blur_pallas (through _gauss_blur_planar; body _kernel/_blur_band).
//
// What bounds it: the function reads every element once and writes it
// once, 8 bytes, against 4(2R+1) flops (two passes of 2R+1 multiplies and
// adds). Up to R ~ 9 the bytes bound it (about 0.043 ms at 2000x3000x3 at
// 3.35 TB/s); above, the fp32 operations do. Every multiply and add is
// rounded on its own (__fmul_rn/__fadd_rn, no FMA), in the order of the
// plain PyTorch version, so that the two agree to the bit: that takes two
// issue slots a tap, twice the operation bound. What the card spends on
// top is instruction issue around the taps, shared-memory loads and the
// tile's halo. The design keeps the vertical pass in shared memory, so
// each element crosses device memory once each way, and cuts the rest:
//   - R is a template parameter (64 instances, a table of launchers), so
//     every width and tap index is a constant: the taps sit in registers,
//     the tap loops unroll, and a flat index splits by a multiply;
//   - the passes are register-blocked: in the vertical pass a thread blurs
//     a strip of KV rows of one column, in the horizontal pass four
//     adjacent columns of one row, reading each of its inputs once (16
//     bytes at a time across a row) and adding it to every sum it feeds;
//   - one CTA takes all C channels of its TW x TH output tile, one after
//     another, so the interleaved input lines come from device memory once
//     and the later channels find them in L1/L2. Where shared memory
//     allows without costing a CTA an SM (R <= 16 at C = 3), the output
//     tile of all channels is gathered in shared memory and stored row by
//     row, 16 bytes a thread, instead of 4 bytes every C floats;
//   - the tile is 64 x 32 up to R = 16 and 128 x 32 above, which takes
//     the vertical pass's halo work (TW + 2R) / TW from 2.97 (64-wide) to
//     1.98 at R = 63, in 192 KB at R = 64 (one CTA an SM; two or more up
//     to R = 38).
// Phases per channel, with a barrier after the first two:
//   1. load the tile plus an R halo on every side through clamped indices
//      (the edge replicate, at no extra pass);
//   2. blur it vertically over the tile's rows and all halo columns; at
//      out-of-image columns that is the vertical blur of the clamped
//      column, i.e. exactly the edge-replicated input of the second pass;
//   3. blur horizontally and store (or gather) the tile's outputs.
// The next channel's load overwrites only the input, which no thread reads
// after the second barrier. Adds run in ascending tap order for every
// output, which register blocking keeps: input m feeds output j as tap
// m - j, rising with m.

#include <array>
#include <utility>

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;
constexpr int MAX_R = 64;
constexpr int TH = 32;             // output tile rows
constexpr int KV = 8;              // rows a thread blurs in the vertical pass
constexpr int SM_BYTES = 233472;   // shared memory of one SM (228 KB)
constexpr int CTA_BYTES = 232448;  // the most one CTA may take (227 KB)

constexpr int cmin(int a, int b) { return a < b ? a : b; }
constexpr int cmax(int a, int b) { return a > b ? a : b; }
// CTAs an SM holds by shared memory (1 KB of each CTA's is reserved)
constexpr int fit(long long bytes) { return (int)(SM_BYTES / (bytes + 1024)); }

template <int R>
struct Tile {
  static constexpr int TW = R <= 16 ? 64 : 128;  // output tile columns
  static constexpr int NK = 2 * R + 1;
  static constexpr int UH = TH + 2 * R, UW = TW + 2 * R;  // input, from y0-R / x0-R
  static constexpr int LD = (UW + 3) / 4 * 4;             // vertical pass's row stride
  static constexpr int SMEM = (UH * UW + TH * LD) * 4;
  // CTAs an SM should hold: by shared memory, and by registers at about
  // NK + 40 a thread (the taps live in registers), at most 4
  static constexpr int MIN_CTAS = cmax(1, cmin(4, cmin(fit(SMEM), 65536 / (NT * (NK + 40)))));
  static_assert(SMEM <= CTA_BYTES, "the tile does not fit one CTA's shared memory");
  static_assert(TH % KV == 0 && TW % 4 == 0, "strips and groups must tile the output");
};

__device__ __forceinline__ int clampi(int v, int hi) { return v < 0 ? 0 : (v > hi ? hi : v); }

// V[r][q] = sum_t k[t] * U[r + t][q] for r < TH, q < UW, taps in order. A
// thread takes KV consecutive rows of one column and reads each of its
// KV + 2R inputs once.
template <int NK, int UW, int LD>
__device__ __forceinline__ void vertical(const float* __restrict__ U, float* __restrict__ V,
                                         const float (&k)[NK]) {
  for (int i = threadIdx.x; i < TH / KV * UW; i += NT) {
    const int s = i / UW, q = i - s * UW;
    const float* src = U + s * KV * UW + q;
    float* dst = V + s * KV * LD + q;
    float acc[KV];
#pragma unroll
    for (int m = 0; m < KV + NK - 1; ++m) {
      const float v = src[m * UW];
#pragma unroll
      for (int j = 0; j < KV; ++j) {
        const int t = m - j;
        if (t >= 0 && t < NK) {
          const float p = __fmul_rn(k[t], v);
          if (t == 0)
            acc[j] = p;
          else
            acc[j] = __fadd_rn(acc[j], p);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < KV; ++j) dst[j * LD] = acc[j];
  }
}

// o[j] = sum_t k[t] * s[j + t] for j < 4, taps in order: the 2R + 4
// inputs are read once, 16 bytes at a time (s 16-byte aligned), and each
// is added to the sums it feeds as it arrives
template <int NK>
__device__ __forceinline__ void horizontal4(const float* __restrict__ s, const float (&k)[NK],
                                            float (&o)[4]) {
  constexpr int N = NK + 3;  // even
#pragma unroll
  for (int m0 = 0; m0 < N; m0 += 4) {
    float w[4];
    if (m0 + 4 <= N) {
      const float4 v = *reinterpret_cast<const float4*>(s + m0);
      w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
    } else {
      const float2 v = *reinterpret_cast<const float2*>(s + m0);
      w[0] = v.x, w[1] = v.y, w[2] = w[3] = 0.f;  // w[2], w[3] feed no sum
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = m0 + e - j;
        if (t >= 0 && t < NK) {
          const float p = __fmul_rn(k[t], w[e]);
          if (t == 0)
            o[j] = p;
          else
            o[j] = __fadd_rn(o[j], p);
        }
      }
    }
  }
}

// One CTA: all C channels of the TW x TH output tile at (blockIdx.x,
// blockIdx.y) of image blockIdx.z, one after another. stage: gather the
// outputs in shared memory and store them row by row at the end.
template <int R>
__global__ void __launch_bounds__(NT, Tile<R>::MIN_CTAS)
gauss_blur_kernel(const float* __restrict__ in, float* __restrict__ out,
                  const float* __restrict__ taps, int H, int W, int C, bool stage) {
  using T = Tile<R>;
  constexpr int TW = T::TW, NK = T::NK, UH = T::UH, UW = T::UW, LD = T::LD, NG = TW / 4;
  extern __shared__ __align__(16) float sm[];
  float* U = sm;           // [UH][UW]      one channel of the input, rows/cols from y0-R / x0-R
  float* V = U + UH * UW;  // [TH][LD]      its vertical pass, rows from y0
  float* O = V + TH * LD;  // [TH][TW * C]  the output tile, channels interleaved (stage)

  float k[NK];
#pragma unroll
  for (int t = 0; t < NK; ++t) k[t] = __ldg(taps + t);
  const size_t image = (size_t)blockIdx.z * H * W * C;
  const float* ip = in + image;
  float* op = out + image;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const bool vec = C == 1 && (W & 3) == 0 && (reinterpret_cast<size_t>(op) & 15) == 0;

  for (int c = 0; c < C; ++c) {
    for (int i = threadIdx.x; i < UH * UW; i += NT) {
      const int r = i / UW, q = i - r * UW;
      U[i] = ip[((size_t)clampi(y0 - R + r, H - 1) * W + clampi(x0 - R + q, W - 1)) * C + c];
    }
    __syncthreads();
    vertical<NK, UW, LD>(U, V, k);
    __syncthreads();
    for (int i = threadIdx.x; i < TH * NG; i += NT) {
      const int r = i / NG, q0 = (i - r * NG) * 4;
      const int gy = y0 + r, gx0 = x0 + q0;
      if (gy >= H || gx0 >= W) continue;
      float o[4];
      horizontal4(V + r * LD + q0, k, o);
      if (stage) {
        float* dst = O + (r * TW + q0) * C + c;
#pragma unroll
        for (int j = 0; j < 4; ++j) dst[j * C] = o[j];
      } else if (vec) {
        *reinterpret_cast<float4*>(op + (size_t)gy * W + gx0) = make_float4(o[0], o[1], o[2], o[3]);
      } else {
        float* dst = op + ((size_t)gy * W + gx0) * C + c;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (gx0 + j < W) dst[j * C] = o[j];
      }
    }
  }
  if (!stage) return;
  __syncthreads();
  // the tile's rows in the image are runs of n floats, ldo apart
  const int rows = min(TH, H - y0), n = min(TW, W - x0) * C;
  const size_t ldo = (size_t)W * C;
  float* dst = op + ((size_t)y0 * W + x0) * C;
  if ((n & 3) == 0 && (ldo & 3) == 0 && (reinterpret_cast<size_t>(dst) & 15) == 0) {
    const int n4 = n / 4;
    for (int i = threadIdx.x; i < rows * n4; i += NT) {
      const int r = i / n4, q = i - r * n4;
      *reinterpret_cast<float4*>(dst + r * ldo + 4 * q) =
          *reinterpret_cast<const float4*>(O + r * TW * C + 4 * q);
    }
  } else {
    for (int i = threadIdx.x; i < rows * n; i += NT) {
      const int r = i / n, q = i - r * n;
      dst[r * ldo + q] = O[r * TW * C + q];
    }
  }
}

using Launch = int (*)(const float*, float*, const float*, int, int, int, int, cudaStream_t);

// P images of (H, W, C), one after another
template <int R>
int launch(const float* in, float* out, const float* taps, int P, int H, int W, int C,
           cudaStream_t stream) {
  using T = Tile<R>;
  if ((H + TH - 1) / TH > 65535) return (int)cudaErrorInvalidValue;
  // gather the output tile where it costs no CTA an SM
  const long long gather = (long long)TH * T::TW * C * 4;
  const bool stage = C > 1 && fit(T::SMEM + gather) >= T::MIN_CTAS;
  const int smem = T::SMEM + (stage ? (int)gather : 0);
  cudaError_t e = cudaFuncSetAttribute(gauss_blur_kernel<R>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((W + T::TW - 1) / T::TW, (H + TH - 1) / TH, P);
  gauss_blur_kernel<R><<<grid, NT, smem, stream>>>(in, out, taps, H, W, C, stage);
  return (int)cudaGetLastError();
}

template <int... I>
std::array<Launch, sizeof...(I)> launch_table(std::integer_sequence<int, I...>) {
  return {&launch<I + 1>...};
}

const std::array<Launch, MAX_R> kLaunch = launch_table(std::make_integer_sequence<int, MAX_R>{});

int launch_any(const void* in, void* out, const void* taps, int P, int H, int W, int C, int R,
               void* stream) {
  if (R < 1 || R > MAX_R || P < 1 || P > 65535 || H < 1 || W < 1 || C < 1)
    return (int)cudaErrorInvalidValue;
  return kLaunch[R - 1](static_cast<const float*>(in), static_cast<float*>(out),
                        static_cast<const float*>(taps), P, H, W, C,
                        static_cast<cudaStream_t>(stream));
}

}  // namespace

// in, out: (H, W, C) fp32 contiguous, distinct; taps: 2R+1 fp32 on the
// device. Returns cudaGetLastError() after the launch.
extern "C" int gauss_blur_launch(const void* in, void* out, const void* taps,
                                 int H, int W, int C, int R, void* stream) {
  return launch_any(in, out, taps, 1, H, W, C, R, stream);
}

// in, out: (P, H, W) fp32 contiguous, distinct; each plane blurred alone.
extern "C" int gauss_blur_planes_launch(const void* in, void* out, const void* taps,
                                        int P, int H, int W, int R, void* stream) {
  return launch_any(in, out, taps, P, H, W, 1, R, stream);
}
