// One Richardson-Lucy iteration for Hopper (sm_90a):
//   u_out = u * G*(d / max(G*u, 1e-8))
// on planar fp32 (P, H, W), G the separable truncated Gaussian (2R+1 taps,
// H pass then W pass), edge-replicate boundary.
//
// Replaces the TPU kernel nind_denoise_tpu/ops/pallas_blur.py
// rl_deblur_pallas_fused (kernel body _rl_iter_kernel2). Each blur
// edge-replicates its own input, as the XLA path does
// (ops/rl_deblur.py:_blur_axis), so the RATIO is edge-replicated: that is
// not the same as blurring an edge-replicated input.
//
// What bounds it: per iteration the function reads u and d and writes u,
// 12 bytes a pixel (about 216 MB at 2000x3000x3), against about 8R+5
// flops a pixel, so the bytes bound it (~0.065 ms per iteration at
// 3.35 TB/s). The design keeps everything between the reads and the write
// in shared memory: one CTA per plane x 32x32 output tile
//   1. loads u over the tile plus a 2R halo through clamped indices (the
//      edge replicate);
//   2. blurs it, H then W, over the tile plus an R halo (est);
//   3. forms d / max(est, eps) at in-image positions;
//   4. fills out-of-image halo positions with the ratio at their clamped
//      coordinate, which is exactly the edge-replicated ratio;
//   5. blurs the ratio, multiplies by u and stores.
// u is read through an input buffer and written to another (the caller
// swaps them each iteration), so no CTA reads a value another CTA has
// already overwritten. Multiplies and adds are rounded one by one
// (__fmul_rn/__fadd_rn) in the order of the plain PyTorch version, so the
// two agree to the bit.

#include <cuda_runtime.h>

namespace {

constexpr int TS = 32;     // output tile edge
constexpr int NT = 256;
constexpr int MAX_R = 16;  // sigma <= 5.33
constexpr int KPAD = 36;   // taps region, 16-byte multiple >= 2*MAX_R+1

size_t smem_floats(int R) {
  const int UW = TS + 4 * R, EW = TS + 2 * R;
  return KPAD + (size_t)UW * UW + (size_t)EW * UW + (size_t)EW * EW + (size_t)TS * EW;
}

__device__ __forceinline__ int clampi(int v, int hi) { return v < 0 ? 0 : (v > hi ? hi : v); }

__global__ void __launch_bounds__(NT)
rl_iter_kernel(const float* __restrict__ u, const float* __restrict__ d,
               float* __restrict__ out, const float* __restrict__ taps,
               int H, int W, int R) {
  extern __shared__ __align__(16) float sm[];
  const int UW = TS + 4 * R, EW = TS + 2 * R, NK = 2 * R + 1;
  float* k = sm;             // [NK]
  float* U = sm + KPAD;      // [UW][UW]  u, rows/cols from y0-2R / x0-2R
  float* V = U + UW * UW;    // [EW][UW]  H-pass of u, rows from y0-R
  float* E = V + EW * UW;    // [EW][EW]  est, then the ratio, from y0-R / x0-R
  float* V2 = E + EW * EW;   // [TS][EW]  H-pass of the ratio, rows from y0

  const int tid = threadIdx.x;
  const size_t plane = (size_t)blockIdx.z * H * W;
  const float* up = u + plane;
  const float* dp = d + plane;
  float* op = out + plane;
  const int y0 = blockIdx.y * TS, x0 = blockIdx.x * TS;

  for (int i = tid; i < NK; i += NT) k[i] = taps[i];
  for (int i = tid; i < UW * UW; i += NT) {
    const int r = i / UW, q = i % UW;
    U[i] = up[(size_t)clampi(y0 - 2 * R + r, H - 1) * W + clampi(x0 - 2 * R + q, W - 1)];
  }
  __syncthreads();

  for (int i = tid; i < EW * UW; i += NT) {
    const int r = i / UW, q = i % UW;
    const float* s = U + r * UW + q;
    float acc = __fmul_rn(k[0], s[0]);
    for (int t = 1; t < NK; ++t) acc = __fadd_rn(acc, __fmul_rn(k[t], s[t * UW]));
    V[i] = acc;
  }
  __syncthreads();

  for (int i = tid; i < EW * EW; i += NT) {
    const int r = i / EW, q = i % EW;
    const int gy = y0 - R + r, gx = x0 - R + q;
    float ratio = 0.f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      const float* s = V + r * UW + q;
      float est = __fmul_rn(k[0], s[0]);
      for (int t = 1; t < NK; ++t) est = __fadd_rn(est, __fmul_rn(k[t], s[t]));
      ratio = __fdiv_rn(dp[(size_t)gy * W + gx], fmaxf(est, 1e-8f));
    }
    E[i] = ratio;
  }
  __syncthreads();

  // out-of-image positions copy the ratio at their clamped coordinate,
  // which lies inside the image and inside this region
  for (int i = tid; i < EW * EW; i += NT) {
    const int r = i / EW, q = i % EW;
    const int gy = y0 - R + r, gx = x0 - R + q;
    if (gy < 0 || gy >= H || gx < 0 || gx >= W) {
      const int cr = clampi(gy, H - 1) - (y0 - R), cq = clampi(gx, W - 1) - (x0 - R);
      E[i] = E[cr * EW + cq];
    }
  }
  __syncthreads();

  for (int i = tid; i < TS * EW; i += NT) {
    const int r = i / EW, q = i % EW;
    const float* s = E + r * EW + q;
    float acc = __fmul_rn(k[0], s[0]);
    for (int t = 1; t < NK; ++t) acc = __fadd_rn(acc, __fmul_rn(k[t], s[t * EW]));
    V2[i] = acc;
  }
  __syncthreads();

  for (int i = tid; i < TS * TS; i += NT) {
    const int r = i / TS, q = i % TS;
    const int gy = y0 + r, gx = x0 + q;
    if (gy < H && gx < W) {
      const float* s = V2 + r * EW + q;
      float corr = __fmul_rn(k[0], s[0]);
      for (int t = 1; t < NK; ++t) corr = __fadd_rn(corr, __fmul_rn(k[t], s[t]));
      op[(size_t)gy * W + gx] = __fmul_rn(U[(r + 2 * R) * UW + q + 2 * R], corr);
    }
  }
}

}  // namespace

// u, d, out: (P, H, W) fp32 contiguous, out must not alias u or d; taps:
// 2R+1 fp32 on the device. Returns cudaGetLastError() after the launch.
extern "C" int rl_iter_launch(const void* u, const void* d, void* out, const void* taps,
                              int P, int H, int W, int R, void* stream) {
  if (R < 1 || R > MAX_R || P < 1 || P > 65535 || H < 1 || W < 1 ||
      (H + TS - 1) / TS > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_floats(R) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(rl_iter_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((W + TS - 1) / TS, (H + TS - 1) / TS, P);
  rl_iter_kernel<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(u), static_cast<const float*>(d), static_cast<float*>(out),
      static_cast<const float*>(taps), H, W, R);
  return (int)cudaGetLastError();
}
