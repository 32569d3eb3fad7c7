// One Richardson-Lucy iteration for Hopper (sm_90a):
//   u_out = u * G*(d / max(G*u, 1e-8))
// on planar fp32 (P, H, W), G the separable truncated Gaussian (2R+1 taps,
// 1 <= R <= 32, H pass then W pass), edge-replicate boundary.
//
// Replaces the TPU kernel nind_denoise_tpu/ops/pallas_blur.py
// rl_deblur_pallas_fused (kernel body _rl_iter_kernel2), which takes the
// same radii (its _fused_band_h stops at 4R > 128). Each blur
// edge-replicates its own input, as the XLA path does
// (ops/rl_deblur.py:_blur_axis), so the RATIO is edge-replicated: that is
// not the same as blurring an edge-replicated input.
//
// What bounds it: per iteration the function reads u and d and writes u,
// 12 bytes a pixel (about 216 MB at 2000x3000x3, ~0.065 ms at 3.35 TB/s),
// against 8(2R+1)+3 flops a pixel, so the bytes bound it up to R ~ 6 and
// the fp32 operations above. What the card spends, though, is instruction
// issue and shared-memory loads: every tap is a rounded multiply and a
// rounded add (no FMA, to stay bit-equal), and the tile's halo is blurred
// too. The design keeps everything between the reads and the write in
// shared memory, one CTA per plane x TW x 32 output tile, and spends as
// few instructions as it can around the taps:
//   - R is a template parameter, so every loop bound, width and tap index
//     is a constant: the taps sit in registers, the tap loops unroll, and a
//     flat index splits into row and column by a multiply, not a division;
//   - the passes are register-blocked: in a vertical pass a thread blurs a
//     strip of KV rows of one column, in a horizontal pass four columns of
//     one row, loading each of its inputs once (16 bytes at a time across
//     a row), instead of once per tap;
//   - the ratio at an out-of-image halo cell is computed directly at its
//     clamped coordinate (the same bits as the edge replicate), so no fill
//     pass and no barrier follow the ratio;
//   - 64-wide tiles up to R = 8 cut the halo's share of the work.
// Phases, with a barrier after each but the last:
//   1. load u over the tile plus a 2R halo through clamped indices;
//   2. blur it vertically (rows of the tile plus an R halo);
//   3. blur horizontally (est) and form d / max(est, eps) over the tile
//      plus an R halo;
//   4. blur the ratio vertically over the tile's rows;
//   5. blur horizontally, multiply by u and store (16-byte stores where
//      the rows are 16-byte aligned).
// u is read through an input buffer and written to another (the caller
// swaps them each iteration), so no CTA reads a value another CTA has
// already overwritten. Multiplies and adds are rounded one by one
// (__fmul_rn/__fadd_rn) in the order of the plain PyTorch version, so the
// two agree to the bit.

#include <array>
#include <utility>

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;
constexpr int MAX_R = 32;  // sigma <= 10.67; 200,704 bytes of shared memory
constexpr int TH = 32;     // output tile rows
constexpr int KV = 8;      // rows a thread blurs in a vertical pass
constexpr int SM_BYTES = 233472;  // shared memory of one SM (228 KB)

template <int R>
struct Tile {
  static constexpr int TW = R <= 8 ? 64 : 32;  // output tile columns
  static constexpr int NK = 2 * R + 1;
  static constexpr int UH = TH + 4 * R, UW = TW + 4 * R;  // u
  static constexpr int VH = TH + 2 * R;                   // vertical pass of u
  static constexpr int EW = TW + 2 * R;                   // est / ratio, VH rows
  static constexpr int EP = (EW + 3) / 4 * 4;             // their row stride
  static constexpr int SMEM = (UH * UW + VH * UW + VH * EP) * 4;
  // CTAs an SM can hold (1 KB of each CTA's shared memory is reserved),
  // capped at 4 so that a thread keeps 64 registers
  static constexpr int FIT = SM_BYTES / (SMEM + 1024);
  static constexpr int MIN_CTAS = FIT < 1 ? 1 : (FIT > 4 ? 4 : FIT);
};

__device__ __forceinline__ int clampi(int v, int hi) { return v < 0 ? 0 : (v > hi ? hi : v); }

// out[r][q] = sum_t k[t] * in[r + t][q] for r < OH, q < WD (row stride LD),
// taps in order. A thread takes KV consecutive rows of one column; the last
// strip starts at OH - KV, so it may rewrite rows of the one before with
// the same values.
template <int NK, int WD, int LD, int OH>
__device__ __forceinline__ void vertical(const float* __restrict__ in, float* __restrict__ out,
                                         const float (&k)[NK]) {
  constexpr int NS = (OH + KV - 1) / KV;
  for (int i = threadIdx.x; i < NS * WD; i += NT) {
    const int s = i / WD, q = i - s * WD;
    const int r0 = min(s * KV, OH - KV);
    const float* src = in + r0 * LD + q;
    float acc[KV];
#pragma unroll
    for (int m = 0; m < KV + NK - 1; ++m) {
      const float v = src[m * LD];
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
    for (int j = 0; j < KV; ++j) out[(r0 + j) * LD + q] = acc[j];
  }
}

template <int NK>
__device__ __forceinline__ float horizontal(const float* __restrict__ s, const float (&k)[NK]) {
  float acc = __fmul_rn(k[0], s[0]);
#pragma unroll
  for (int t = 1; t < NK; ++t) acc = __fadd_rn(acc, __fmul_rn(k[t], s[t]));
  return acc;
}

// o[j] = sum_t k[t] * s[j + t] for j < 4: the 4 + 2R inputs are read once,
// 16 bytes at a time (s 16-byte aligned)
template <int NK>
__device__ __forceinline__ void horizontal4(const float* __restrict__ s, const float (&k)[NK],
                                            float (&o)[4]) {
  constexpr int N = NK + 3;  // even
  float w[N];
#pragma unroll
  for (int m = 0; m + 4 <= N; m += 4) {
    const float4 v = *reinterpret_cast<const float4*>(s + m);
    w[m] = v.x, w[m + 1] = v.y, w[m + 2] = v.z, w[m + 3] = v.w;
  }
  if (N % 4 == 2) {
    const float2 v = *reinterpret_cast<const float2*>(s + N - 2);
    w[N - 2] = v.x, w[N - 1] = v.y;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float acc = __fmul_rn(k[0], w[j]);
#pragma unroll
    for (int t = 1; t < NK; ++t) acc = __fadd_rn(acc, __fmul_rn(k[t], w[j + t]));
    o[j] = acc;
  }
}

template <int R>
__global__ void __launch_bounds__(NT, Tile<R>::MIN_CTAS)
rl_iter_kernel(const float* __restrict__ u, const float* __restrict__ d,
               float* __restrict__ out, const float* __restrict__ taps, int H, int W) {
  using T = Tile<R>;
  constexpr int TW = T::TW, NK = T::NK, UH = T::UH, UW = T::UW, VH = T::VH, EW = T::EW,
                EP = T::EP;
  extern __shared__ __align__(16) float sm[];
  float* U = sm;            // [UH][UW]  u, rows/cols from y0-2R / x0-2R
  float* V = U + UH * UW;   // [VH][UW]  vertical pass of u, rows from y0-R;
                            // then [TH][EP] vertical pass of the ratio, rows
                            // from y0, cols from x0-R
  float* E = V + VH * UW;   // [VH][EP]  ratio, rows/cols from y0-R / x0-R

  float k[NK];
#pragma unroll
  for (int t = 0; t < NK; ++t) k[t] = __ldg(taps + t);
  const size_t plane = (size_t)blockIdx.z * H * W;
  const float* up = u + plane;
  const float* dp = d + plane;
  float* op = out + plane;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;

  for (int i = threadIdx.x; i < UH * UW; i += NT) {
    const int r = i / UW, q = i - r * UW;
    U[i] = up[(size_t)clampi(y0 - 2 * R + r, H - 1) * W + clampi(x0 - 2 * R + q, W - 1)];
  }
  __syncthreads();

  vertical<NK, UW, UW, VH>(U, V, k);
  __syncthreads();

  // est and the ratio, four columns a thread, at the clamped coordinate:
  // for an in-image cell that is the cell itself, for a halo cell outside
  // the image the edge replicate of the ratio. Groups wholly inside the
  // image and the region take the vector path, the others go cell by cell.
  constexpr int NG = (EW + 3) / 4;
  for (int i = threadIdx.x; i < VH * NG; i += NT) {
    const int r = i / NG, q0 = (i - r * NG) * 4;
    const int gy = clampi(y0 - R + r, H - 1), gx0 = x0 - R + q0;
    const float* vrow = V + (gy - (y0 - R)) * UW;
    const float* drow = dp + (size_t)gy * W;
    float* e = E + r * EP + q0;
    if (q0 + 4 <= EW && gx0 >= 0 && gx0 + 3 < W) {
      float est[4];
      horizontal4(vrow + q0, k, est);
      *reinterpret_cast<float4*>(e) = make_float4(
          __fdiv_rn(drow[gx0], fmaxf(est[0], 1e-8f)),
          __fdiv_rn(drow[gx0 + 1], fmaxf(est[1], 1e-8f)),
          __fdiv_rn(drow[gx0 + 2], fmaxf(est[2], 1e-8f)),
          __fdiv_rn(drow[gx0 + 3], fmaxf(est[3], 1e-8f)));
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (q0 + j < EW) {
          const int gx = clampi(gx0 + j, W - 1);
          e[j] = __fdiv_rn(drow[gx], fmaxf(horizontal(vrow + (gx - (x0 - R)), k), 1e-8f));
        }
      }
    }
  }
  __syncthreads();

  vertical<NK, EW, EP, TH>(E, V, k);
  __syncthreads();

  // four output columns a thread; 16-byte stores where rows are aligned
  constexpr int NG5 = TW / 4;
  const bool vec = (W & 3) == 0 && (reinterpret_cast<size_t>(op) & 15) == 0;
  for (int i = threadIdx.x; i < TH * NG5; i += NT) {
    const int r = i / NG5, q0 = (i - r * NG5) * 4;
    const int gy = y0 + r, gx0 = x0 + q0;
    if (gy >= H || gx0 >= W) continue;
    float corr[4];
    horizontal4(V + r * EP + q0, k, corr);
    const float* uc = U + (r + 2 * R) * UW + q0 + 2 * R;
    float res[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) res[j] = __fmul_rn(uc[j], corr[j]);
    float* o = op + (size_t)gy * W + gx0;
    if (vec) {
      *reinterpret_cast<float4*>(o) = make_float4(res[0], res[1], res[2], res[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (gx0 + j < W) o[j] = res[j];
    }
  }
}

using Launch = int (*)(const float*, const float*, float*, const float*, int, int, int,
                       cudaStream_t);

template <int R>
int launch(const float* u, const float* d, float* out, const float* taps, int P, int H, int W,
           cudaStream_t stream) {
  using T = Tile<R>;
  if ((H + TH - 1) / TH > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(rl_iter_kernel<R>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((W + T::TW - 1) / T::TW, (H + TH - 1) / TH, P);
  rl_iter_kernel<R><<<grid, NT, T::SMEM, stream>>>(u, d, out, taps, H, W);
  return (int)cudaGetLastError();
}

template <int... I>
std::array<Launch, sizeof...(I)> launch_table(std::integer_sequence<int, I...>) {
  return {&launch<I + 1>...};
}

const std::array<Launch, MAX_R> kLaunch = launch_table(std::make_integer_sequence<int, MAX_R>{});

}  // namespace

// u, d, out: (P, H, W) fp32 contiguous, out must not alias u or d; taps:
// 2R+1 fp32 on the device. Returns cudaGetLastError() after the launch.
extern "C" int rl_iter_launch(const void* u, const void* d, void* out, const void* taps,
                              int P, int H, int W, int R, void* stream) {
  if (R < 1 || R > MAX_R || P < 1 || P > 65535 || H < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  return kLaunch[R - 1](static_cast<const float*>(u), static_cast<const float*>(d),
                        static_cast<float*>(out), static_cast<const float*>(taps), P, H, W,
                        static_cast<cudaStream_t>(stream));
}
