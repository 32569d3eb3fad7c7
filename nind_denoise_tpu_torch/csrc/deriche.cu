// Kernel P2: the Deriche order-0 recursive Gaussian along one axis of
// planar fp32 (P, H, W), neumann boundary — CImg's causal + anticausal
// second-order recurrences, summed.
//
// The port's own kernel; it has no Pallas counterpart. It replaces the two
// lax.scans of nind_denoise_tpu/ops/rl_deblur.py _deriche_axis (:132-161)
// that RL's psf='gmic_fast' runs along H, then along W, twice an
// iteration. One thread walks one line: along H thread (p, w) walks down
// a column, so the loads of a warp coalesce; along W thread (p, h) walks a
// row. The causal pass writes its result, the anticausal pass walks back
// and adds its own, so each element is read twice from x and once from y
// and written twice.
//
// What bounds it: the byte bound is 8 bytes an element (x read once, y
// written once), but each line is a chain of H or W dependent steps and
// there are only P*W (or P*H) lines — 9,000 along H and 6,000 along W at
// 6 MP against 132 SMs — so the chain's latency sets the time. A chunked
// scan that composes the affine step, or a shared-memory transpose for
// the W pass, is later work.
//
// Every multiply, add and subtract is rounded on its own in the plain
// version's order (ops/deriche.deriche_axis_reference), so the kernel
// equals it bit for bit: no FMA contraction.

#include <cuda_runtime.h>

namespace {

struct Coefs {
  float a0, a1, a2, a3, b1, b2, coefp, coefn;
};

__device__ __forceinline__ float step(float ka, float xa, float kb, float xb,
                                      float b1, float y1, float b2, float y2) {
  // ((ka*xa + kb*xb) - b1*y1) - b2*y2, each operation rounded
  float s = __fadd_rn(__fmul_rn(ka, xa), __fmul_rn(kb, xb));
  s = __fsub_rn(s, __fmul_rn(b1, y1));
  return __fsub_rn(s, __fmul_rn(b2, y2));
}

__global__ void deriche_kernel(const float* __restrict__ x, float* __restrict__ y,
                               int p, int h, int w, int axis, Coefs c) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long base, stride;
  int n;
  if (axis == 1) {  // along H: thread (plane, column)
    if (t >= (long long)p * w) return;
    const long long pi = t / w, wi = t % w;
    base = pi * h * (long long)w + wi;
    stride = w;
    n = h;
  } else {  // along W: thread (plane, row)
    if (t >= (long long)p * h) return;
    base = t * (long long)w;
    stride = 1;
    n = w;
  }
  const float* xs = x + base;
  float* ys = y + base;

  // causal: carry (x[i-1], y[i-1], y[i-2]) from (x0, coefp*x0, coefp*x0)
  const float x0 = xs[0];
  float xp = x0, yp = __fmul_rn(c.coefp, x0), yb = yp;
  for (int i = 0; i < n; ++i) {
    const float xc = xs[i * stride];
    const float yc = step(c.a0, xc, c.a1, xp, c.b1, yp, c.b2, yb);
    ys[i * stride] = yc;
    xp = xc;
    yb = yp;
    yp = yc;
  }
  // anticausal: carry (x[i+1], x[i+2], y[i+1], y[i+2]) from
  // (xl, xl, coefn*xl, coefn*xl); the output is causal + anticausal
  const float xl = xs[(long long)(n - 1) * stride];
  float xn = xl, xa = xl, yn = __fmul_rn(c.coefn, xl), ya = yn;
  for (int i = n - 1; i >= 0; --i) {
    const float xc = xs[i * stride];
    const float yc = step(c.a2, xn, c.a3, xa, c.b1, yn, c.b2, ya);
    ys[i * stride] = __fadd_rn(ys[i * stride], yc);
    xa = xn;
    xn = xc;
    ya = yn;
    yn = yc;
  }
}

}  // namespace

extern "C" int deriche_launch(const void* x, void* y, int p, int h, int w, int axis,
                              float a0, float a1, float a2, float a3, float b1,
                              float b2, float coefp, float coefn, void* stream) {
  const Coefs c{a0, a1, a2, a3, b1, b2, coefp, coefn};
  const long long lines = axis == 1 ? (long long)p * w : (long long)p * h;
  // 64-thread blocks: a 6 MP image has only 6,000-9,000 lines, and small
  // blocks spread them over more of the 132 SMs
  const int threads = 64;
  const unsigned blocks = (unsigned)((lines + threads - 1) / threads);
  deriche_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)y, p, h, w, axis, c);
  return (int)cudaGetLastError();
}
