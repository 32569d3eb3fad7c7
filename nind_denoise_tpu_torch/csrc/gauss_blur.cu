// Separable Gaussian blur for Hopper (sm_90a):
//   out = G_W * (G_H * x)
// on fp32 (H, W, C) images with interleaved channels, G the truncated
// Gaussian of 2R+1 taps (1 <= R <= 64), each pass edge-replicating its own
// input. A second entry takes planar (P, H, W) fp32 as P images of one
// channel, a plane per blockIdx.z: the RL deblur's route above radius 32
// (ops/rl_deblur.py, "separable_k3") blurs its state that way.
//
// Replaces the TPU kernel nind_denoise_tpu/ops/pallas_blur.py
// gauss_blur_pallas (through _gauss_blur_planar; body _kernel/_blur_band).
//
// What bounds it: the function reads every element once and writes it
// once, 8 bytes, against 4(2R+1) flops (two passes of 2R+1 multiply-adds).
// Up to sigma 3 (R <= 9) the bytes bound it, about 0.043 ms at
// 2000x3000x3 at 3.35 TB/s; at large R the fp32 operations do (R = 64:
// 516 flops an element). The design keeps the vertical pass's output in
// shared memory, so each element crosses device memory once each way:
// one CTA per channel x TS x TS output tile (TS = 32 up to R = 16, else
// 64, so that R = 64 still fits: 192 KB)
//   1. loads the tile plus an R halo on every side through clamped
//      indices (the edge replicate, at no extra pass);
//   2. blurs it vertically over the tile's rows and all halo columns; at
//      out-of-image columns that is the vertical blur of the clamped
//      column, i.e. exactly the edge-replicated input of the second pass;
//   3. blurs horizontally and stores the tile.
// The C channel CTAs of one tile are adjacent in launch order, so they
// share the L2 lines of the interleaved input. Multiplies and adds are
// rounded one by one (__fmul_rn/__fadd_rn) in the order of the plain
// PyTorch version, so the two agree to the bit.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;
constexpr int MAX_R = 64;
constexpr int KPAD = 132;  // taps region, 16-byte multiple >= 2*MAX_R+1

int tile_for(int R) { return R <= 16 ? 32 : 64; }

size_t smem_floats(int R, int TS) {
  const int UW = TS + 2 * R;
  return KPAD + (size_t)UW * UW + (size_t)TS * UW;
}

__device__ __forceinline__ int clampi(int v, int hi) { return v < 0 ? 0 : (v > hi ? hi : v); }

__global__ void __launch_bounds__(NT)
gauss_blur_kernel(const float* __restrict__ in, float* __restrict__ out,
                  const float* __restrict__ taps, int H, int W, int C, int R, int TS) {
  extern __shared__ __align__(16) float sm[];
  const int UW = TS + 2 * R, NK = 2 * R + 1;
  float* k = sm;           // [NK]
  float* U = sm + KPAD;    // [UW][UW]  input, rows/cols from y0-R / x0-R
  float* V = U + UW * UW;  // [TS][UW]  vertical pass, rows from y0

  const int tid = threadIdx.x;
  const size_t plane = (size_t)blockIdx.z * H * W * C;
  in += plane;
  out += plane;
  const int c = blockIdx.x % C;
  const int x0 = (blockIdx.x / C) * TS, y0 = blockIdx.y * TS;

  for (int i = tid; i < NK; i += NT) k[i] = taps[i];
  for (int i = tid; i < UW * UW; i += NT) {
    const int r = i / UW, q = i % UW;
    const size_t gy = clampi(y0 - R + r, H - 1), gx = clampi(x0 - R + q, W - 1);
    U[i] = in[(gy * W + gx) * C + c];
  }
  __syncthreads();

  for (int i = tid; i < TS * UW; i += NT) {
    const int r = i / UW, q = i % UW;
    const float* s = U + r * UW + q;
    float acc = __fmul_rn(k[0], s[0]);
    for (int t = 1; t < NK; ++t) acc = __fadd_rn(acc, __fmul_rn(k[t], s[t * UW]));
    V[i] = acc;
  }
  __syncthreads();

  for (int i = tid; i < TS * TS; i += NT) {
    const int r = i / TS, q = i % TS;
    const int gy = y0 + r, gx = x0 + q;
    if (gy < H && gx < W) {
      const float* s = V + r * UW + q;
      float acc = __fmul_rn(k[0], s[0]);
      for (int t = 1; t < NK; ++t) acc = __fadd_rn(acc, __fmul_rn(k[t], s[t]));
      out[((size_t)gy * W + gx) * C + c] = acc;
    }
  }
}

// P images of (H, W, C), one after another
int launch(const void* in, void* out, const void* taps, int P, int H, int W, int C, int R,
           void* stream) {
  if (R < 1 || R > MAX_R || P < 1 || P > 65535 || H < 1 || W < 1 || C < 1)
    return (int)cudaErrorInvalidValue;
  const int TS = tile_for(R);
  const long long gx = (long long)((W + TS - 1) / TS) * C;
  const int gy = (H + TS - 1) / TS;
  if (gx > INT_MAX || gy > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_floats(R, TS) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(gauss_blur_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  gauss_blur_kernel<<<dim3((unsigned)gx, gy, P), NT, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<float*>(out), static_cast<const float*>(taps),
      H, W, C, R, TS);
  return (int)cudaGetLastError();
}

}  // namespace

// in, out: (H, W, C) fp32 contiguous, distinct; taps: 2R+1 fp32 on the
// device. Returns cudaGetLastError() after the launch.
extern "C" int gauss_blur_launch(const void* in, void* out, const void* taps,
                                 int H, int W, int C, int R, void* stream) {
  return launch(in, out, taps, 1, H, W, C, R, stream);
}

// in, out: (P, H, W) fp32 contiguous, distinct; each plane blurred alone.
extern "C" int gauss_blur_planes_launch(const void* in, void* out, const void* taps,
                                        int P, int H, int W, int R, void* stream) {
  return launch(in, out, taps, P, H, W, 1, R, stream);
}
