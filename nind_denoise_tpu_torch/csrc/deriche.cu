// Kernel P2: the Deriche order-0 recursive Gaussian along one axis of
// planar fp32 (P, H, W), neumann boundary — CImg's causal + anticausal
// second-order recurrences, summed.
//
// The port's own kernel; it has no Pallas counterpart. It replaces the two
// lax.scans of nind_denoise_tpu/ops/rl_deblur.py _deriche_axis (:132-161)
// that RL's psf='gmic_fast' runs along H, then along W, twice an
// iteration.
//
// What bounds it: 8 bytes an element (x read once, y written once) against
// about 25 flops, so bytes. A thread walking a whole line (this kernel's
// first form) ran a chain of 2,000-3,000 dependent steps, one memory round
// trip each, on only 6,000-9,000 lines: 5 % of the byte bound. So this is a
// chunked scan over lines staged in shared memory (Nehab et al., "GPU-
// efficient recursive filtering and summed-area tables", 2011, in one
// dimension):
//
// - A CTA takes a tile of whole lines (or one segment of them): along H,
//   GH = 32, 16 or 8 adjacent columns, stored row by row with a pad word
//   after each chunk of rows; along W, whole rows, stored chunk by chunk
//   with the chunk's eight 16-byte granules swizzled (granule q at
//   q ^ (chunk & 7)). Either way the chunks a warp walks fall in distinct
//   banks, and the tile moves in 16-byte cp.asyncs and stores: x is read
//   from HBM once and y written once. Two CTAs share an SM (64 registers
//   a thread), so one's loads and stores can run under the other's
//   compute.
// - Each line splits into chunks of L elements, one thread a chunk. (a)
//   The thread runs its chunk causal, then anticausal, from a zero state
//   (the line's first chunk causal and last chunk anticausal from their
//   true starts), writes their sum over x and keeps the two end states.
//   (b) The end states are scanned, s_k = A^L s_{k-1} + e_k (A the 2 x 2
//   companion matrix, its powers computed on the host in double and
//   rounded once), each line and direction on `lanes` threads: a lane
//   folds `per_lane` chunks, the lanes scan their folds with shuffles,
//   and each lane walks its chunks again from the state before it. (c)
//   Each element gets what its chunk's true start states add: row 0 of
//   A^(j+1) times the causal one, of A^(L-j) times the anticausal one.
// - A line longer than a segment (more than 64 chunks along H, 512 along
//   W) takes two launches: a carry pass (mode CARRY) that writes each
//   segment's end states, then the main pass, whose CTAs compose the
//   earlier segments' end states with A^segment.
//
// Every multiply, add and subtract is rounded on its own (no FMA
// contraction), in the order of ops/deriche.deriche_axis_chunked, which
// the kernel equals bit for bit. It does not equal the sequential loop:
// both are held to a bound against the loop in float64 (ops/deriche.py
// error_bound).

#include <cuda_runtime.h>

namespace {

constexpr int L = 32;           // chunk length (ops/deriche.py CHUNK)
constexpr int LP = L + 1;       // along H, a chunk's rows with their pad word
constexpr int SWZ = L / 4 - 1;  // along W, the granule swizzle's mask
constexpr int MAXT = 512;       // threads a CTA at most (ops/deriche.py THREADS)
constexpr int MAIN = 0, CARRY = 1;

struct Params {
  const float* x;
  float* y;
  float4* carry;  // (line, segment): causal end (y[e], y[e-1]), anticausal (y[s], y[s+1])
  int p, h, w, seg, nseg, K, G, lanes, per_lane, mode;
  int tiles;  // tiles of lines a segment
  int lg_lanes;
  bool vec;  // 16-byte loads and stores
  float a0, a1, a2, a3, b1, b2, coefp, coefn;
  float ms[4];      // A^seg
  float mat[6][4];  // A^L, then A^(L*per_lane*d) for d = 1, 2, 4, ... < lanes
  float pw[L][2];   // row 0 of A^(j+1): output j of a chunk from its start state
};

__device__ __forceinline__ float step(float ka, float xa, float kb, float xb,
                                      float b1, float y1, float b2, float y2) {
  // ((ka*xa + kb*xb) - b1*y1) - b2*y2, each operation rounded
  float s = __fadd_rn(__fmul_rn(ka, xa), __fmul_rn(kb, xb));
  s = __fsub_rn(s, __fmul_rn(b1, y1));
  return __fsub_rn(s, __fmul_rn(b2, y2));
}

// (t1, t2) <- M (t1, t2) + (e1, e2)
__device__ __forceinline__ void advance(const float* m, float& t1, float& t2, float e1,
                                        float e2) {
  const float n1 = __fadd_rn(__fadd_rn(__fmul_rn(m[0], t1), __fmul_rn(m[1], t2)), e1);
  const float n2 = __fadd_rn(__fadd_rn(__fmul_rn(m[2], t1), __fmul_rn(m[3], t2)), e2);
  t1 = n1;
  t2 = n2;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

// Shared-memory word of element j of chunk k of tile line g (along W the
// chunk's index in the tile is c = g*K + k).
template <int GH>
__device__ __forceinline__ int word(int g, int k, int K, int j) {
  if (GH > 0) return (k * LP + j) * GH + g;
  const int c = g * K + k;
  return c * L + (((j >> 2) ^ (c & SWZ)) << 2) + (j & 3);
}

struct Tile {
  long long base0, lstride, pstride, line0;  // line g at base0 + g*lstride, element i + i*pstride
  int nl, s, start, seff, keff;
};

template <int GH>
__device__ __forceinline__ Tile tile_of(const Params& q, int u) {
  Tile t;
  const int n = GH > 0 ? q.h : q.w;
  t.s = u / q.tiles;
  const int lt = u - t.s * q.tiles;
  t.start = t.s * q.seg;
  t.seff = min(q.seg, n - t.start);
  t.keff = (t.seff + L - 1) / L;
  if (GH > 0) {
    const int tpp = (q.w + GH - 1) / GH;
    const int pi = lt / tpp, c0 = (lt - pi * tpp) * GH;
    t.nl = min(GH, q.w - c0);
    t.base0 = (long long)pi * q.h * q.w + c0;
    t.lstride = 1;
    t.pstride = q.w;
    t.line0 = (long long)pi * q.w + c0;
  } else {
    const long long r0 = (long long)lt * q.G;
    t.nl = (int)min((long long)q.G, (long long)q.p * q.h - r0);
    t.base0 = r0 * q.w;
    t.lstride = q.w;
    t.pstride = 1;
    t.line0 = r0;
  }
  return t;
}

// Issue the cp.asyncs of tile t into (xs, xe): the segment and, a line,
// the x beside it (xe: x[start-1], x[start+seff], x[start+seff+1], clamped).
template <int GH>
__device__ __forceinline__ void load_tile(const Params& q, const Tile& t, float* xs, float* xe) {
  const int T = blockDim.x, tid = threadIdx.x;
  const float* xg = q.x + t.base0 + (long long)t.start * t.pstride;
  if (GH > 0) {
    if (q.vec) {  // four adjacent columns of a row
      constexpr int G4 = GH / 4;
      for (int e = tid; e < t.seff * G4; e += T) {
        const int i = e / G4, g = (e % G4) * 4;
        if (g < t.nl) cp_async16(xs + word<GH>(g, i / L, 0, i % L), xg + i * t.pstride + g);
      }
    } else {
      for (int e = tid; e < t.seff * GH; e += T) {
        const int i = e / GH, g = e % GH;
        if (g < t.nl) cp_async4(xs + word<GH>(g, i / L, 0, i % L), xg + i * t.pstride + g);
      }
    }
  } else {
    // granules (four elements of one chunk) of all the tile's rows, then
    // each row's last few elements
    const int K = q.K, full = q.vec ? t.seff / 4 : 0, rest = t.seff - 4 * full;
    auto granule = [&](int g, int r) {
      cp_async16(xs + word<0>(g, r / (L / 4), K, (r % (L / 4)) * 4), xg + g * t.lstride + 4 * r);
    };
    if (full >= T) {  // long rows: row by row, no division
      for (int g = 0; g < t.nl; ++g)
        for (int r = tid; r < full; r += T) granule(g, r);
    } else {
      for (int e = tid; e < t.nl * full; e += T) granule(e / full, e % full);
    }
    for (int e = tid; e < t.nl * rest; e += T) {
      const int g = e / rest, i = 4 * full + e - g * rest;
      cp_async4(xs + word<0>(g, i / L, K, i % L), xg + g * t.lstride + i);
    }
  }
  if (tid < t.nl) {
    const int n = GH > 0 ? q.h : q.w;
    const float* line = q.x + t.base0 + tid * t.lstride;
    cp_async4(xe + 4 * tid, line + (long long)max(t.start - 1, 0) * t.pstride);
    cp_async4(xe + 4 * tid + 1, line + (long long)min(t.start + t.seff, n - 1) * t.pstride);
    cp_async4(xe + 4 * tid + 2, line + (long long)min(t.start + t.seff + 1, n - 1) * t.pstride);
  }
}

template <int GH>
__device__ __forceinline__ void store_tile(const Params& q, const Tile& t, const float* xs) {
  const int T = blockDim.x, tid = threadIdx.x;
  float* yg = q.y + t.base0 + (long long)t.start * t.pstride;
  if (GH > 0) {
    if (q.vec) {
      constexpr int G4 = GH / 4;
      for (int e = tid; e < t.seff * G4; e += T) {
        const int i = e / G4, g = (e % G4) * 4;
        if (g < t.nl)
          *reinterpret_cast<float4*>(yg + i * t.pstride + g) =
              *reinterpret_cast<const float4*>(xs + word<GH>(g, i / L, 0, i % L));
      }
    } else {
      for (int e = tid; e < t.seff * GH; e += T) {
        const int i = e / GH, g = e % GH;
        if (g < t.nl) yg[i * t.pstride + g] = xs[word<GH>(g, i / L, 0, i % L)];
      }
    }
  } else {
    const int K = q.K, full = q.vec ? t.seff / 4 : 0, rest = t.seff - 4 * full;
    auto granule = [&](int g, int r) {
      *reinterpret_cast<float4*>(yg + g * t.lstride + 4 * r) =
          *reinterpret_cast<const float4*>(xs + word<0>(g, r / (L / 4), K, (r % (L / 4)) * 4));
    };
    if (full >= T) {  // long rows: row by row, no division
      for (int g = 0; g < t.nl; ++g)
        for (int r = tid; r < full; r += T) granule(g, r);
    } else {
      for (int e = tid; e < t.nl * full; e += T) granule(e / full, e % full);
    }
    for (int e = tid; e < t.nl * rest; e += T) {
      const int g = e / rest, i = 4 * full + e - g * rest;
      yg[g * t.lstride + i] = xs[word<0>(g, i / L, K, i % L)];
    }
  }
}

// a whole chunk between shared memory and registers
template <int GH>
__device__ __forceinline__ void get_chunk(const float* xs, int g, int k, int K, float (&v)[L]) {
  if (GH > 0) {
    const float* p = xs + word<GH>(g, k, 0, 0);
#pragma unroll
    for (int j = 0; j < L; ++j) v[j] = p[j * GH];
  } else {
#pragma unroll
    for (int j = 0; j < L; j += 4) {
      const float4 f = *reinterpret_cast<const float4*>(xs + word<0>(g, k, K, j));
      v[j] = f.x;
      v[j + 1] = f.y;
      v[j + 2] = f.z;
      v[j + 3] = f.w;
    }
  }
}

template <int GH>
__device__ __forceinline__ void put_chunk(float* xs, int g, int k, int K, const float (&v)[L]) {
  if (GH > 0) {
    float* p = xs + word<GH>(g, k, 0, 0);
#pragma unroll
    for (int j = 0; j < L; ++j) p[j * GH] = v[j];
  } else {
#pragma unroll
    for (int j = 0; j < L; j += 4)
      *reinterpret_cast<float4*>(xs + word<0>(g, k, K, j)) =
          make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
  }
}

// four elements j..j+3 (j a multiple of 4) of a chunk
template <int GH>
__device__ __forceinline__ void get4(const float* xs, int g, int k, int K, int j, float (&o)[4]) {
  if (GH > 0) {
#pragma unroll
    for (int r = 0; r < 4; ++r) o[r] = xs[word<GH>(g, k, 0, j + r)];
  } else {
    const float4 f = *reinterpret_cast<const float4*>(xs + word<0>(g, k, K, j));
    o[0] = f.x;
    o[1] = f.y;
    o[2] = f.z;
    o[3] = f.w;
  }
}

template <int GH>
__device__ __forceinline__ void put4(float* xs, int g, int k, int K, int j, const float (&o)[4]) {
  if (GH > 0) {
#pragma unroll
    for (int r = 0; r < 4; ++r) xs[word<GH>(g, k, 0, j + r)] = o[r];
  } else {
    *reinterpret_cast<float4*>(xs + word<0>(g, k, K, j)) = make_float4(o[0], o[1], o[2], o[3]);
  }
}

// A CTA a tile (two CTAs an SM); GH > 0: along H, GH columns a tile;
// GH == 0: along W.
template <int GH>
__global__ void __launch_bounds__(MAXT, 2) deriche_kernel(const Params q) {
  extern __shared__ float4 smem4[];
  const int G = GH > 0 ? GH : q.G, K = q.K, tid = threadIdx.x;
  float4* st = smem4;  // G*K chunk states, line by line
  float* xe = reinterpret_cast<float*>(st + G * K);  // G x 4 edge values
  float* xs = xe + 4 * G;                              // the tile
  const int u = blockIdx.x;

  // this thread's chunk
  const int g = GH > 0 ? tid % GH : tid / K;
  const int k = GH > 0 ? tid / GH : tid - g * K;
  {
    const Tile t = tile_of<GH>(q, u);
    load_tile<GH>(q, t, xs, xe);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
    const int s = t.s, seff = t.seff, keff = t.keff;
    const bool mine = tid < G * K && g < t.nl && k < keff;
    const int len = min(L, seff - k * L);
    const float* ed = xe + 4 * g;

    // the chunk, the line's true start states (its first chunk causal, its
    // last anticausal) and the x beside the chunk, read before any chunk is
    // overwritten
    float v[L];
    float xp0 = 0.f, xn0 = 0.f, xa0 = 0.f, c1 = 0.f, c2 = 0.f, a1 = 0.f, a2 = 0.f;
    if (mine) {
      if (len == L) {
        get_chunk<GH>(xs, g, k, K, v);
      } else {
#pragma unroll
        for (int j = 0; j < L; ++j) v[j] = j < len ? xs[word<GH>(g, k, K, j)] : 0.f;
      }
      const float4* cl = q.carry + (t.line0 + g) * q.nseg;
      if (k == 0) {
        if (s == 0) {
          c1 = c2 = __fmul_rn(q.coefp, v[0]);
        } else if (q.mode == MAIN) {
          c1 = cl[0].x;
          c2 = cl[0].y;
          for (int m = 1; m < s; ++m) advance(q.ms, c1, c2, cl[m].x, cl[m].y);
        }
      }
      if (k == keff - 1) {
        if (s == q.nseg - 1) {
          a1 = a2 = __fmul_rn(q.coefn, xs[word<GH>(g, k, K, len - 1)]);
        } else if (q.mode == MAIN) {
          a1 = cl[q.nseg - 1].z;
          a2 = cl[q.nseg - 1].w;
          for (int m = q.nseg - 2; m > s; --m) advance(q.ms, a1, a2, cl[m].z, cl[m].w);
        }
      }
      xp0 = k == 0 ? ed[0] : xs[word<GH>(g, k - 1, K, L - 1)];
      const int q0 = k * L + len;
      xn0 = q0 < seff ? xs[word<GH>(g, k + 1, K, 0)] : ed[1 + (q0 - seff)];
      xa0 = q0 + 1 < seff ? xs[word<GH>(g, (q0 + 1) / L, K, (q0 + 1) % L)]
                          : ed[1 + (q0 + 1 - seff)];
    }
    __syncthreads();

    // (a) causal, then anticausal, from a zero state (or the line's true
    // start); their sum replaces the chunk's x
    if (mine) {
      float y1 = c1, y2 = c2, xp = xp0;
      float z1 = a1, z2 = a2, xn = xn0, xa = xa0;
      if (len == L) {
#pragma unroll
        for (int j = 0; j < L; j += 4) {
          float o[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            o[r] = step(q.a0, v[j + r], q.a1, xp, q.b1, y1, q.b2, y2);
            y2 = y1;
            y1 = o[r];
            xp = v[j + r];
          }
          put4<GH>(xs, g, k, K, j, o);
        }
#pragma unroll
        for (int j = L - 4; j >= 0; j -= 4) {
          float o[4];
          get4<GH>(xs, g, k, K, j, o);
#pragma unroll
          for (int r = 3; r >= 0; --r) {
            const float yc = step(q.a2, xn, q.a3, xa, q.b1, z1, q.b2, z2);
            xa = xn;
            xn = v[j + r];
            z2 = z1;
            z1 = yc;
            o[r] = __fadd_rn(o[r], yc);
          }
          put4<GH>(xs, g, k, K, j, o);
        }
      } else {
        float zc[L];
#pragma unroll
        for (int j = 0; j < L; ++j) {
          if (j < len) {
            zc[j] = step(q.a0, v[j], q.a1, xp, q.b1, y1, q.b2, y2);
            y2 = y1;
            y1 = zc[j];
            xp = v[j];
          }
        }
#pragma unroll
        for (int j = L - 1; j >= 0; --j) {
          if (j < len) {
            const float yc = step(q.a2, xn, q.a3, xa, q.b1, z1, q.b2, z2);
            xa = xn;
            xn = v[j];
            z2 = z1;
            z1 = yc;
            xs[word<GH>(g, k, K, j)] = __fadd_rn(zc[j], yc);
          }
        }
      }
      st[g * K + k] = make_float4(y1, y2, z1, z2);
    }
    __syncthreads();

    // (b) the chunk scans, one a line and direction, each on `lanes`
    // threads: a lane folds `per_lane` consecutive chunks (in the scan's
    // direction), the lanes scan their folds, then each lane walks its
    // chunks from the state before it; a chunk's entry becomes its true
    // start state (zeros for the first chunk: its run began there)
    {
      const int lanes = q.lanes, pl = q.per_lane, lane = tid & (lanes - 1);
      float2* st2 = reinterpret_cast<float2*>(st);
      for (int base = 0; base < 2 * G; base += blockDim.x >> q.lg_lanes) {
        const int sid = base + (tid >> q.lg_lanes);
        const bool anti = sid >= G;
        const int gl = anti ? sid - G : sid;
        const bool live = sid < 2 * G && gl < t.nl;
        // scan position c: chunk c causal, keff-1-c anticausal
        const int half = anti ? 1 : 0;
        auto slot = [&](int c) { return 2 * (gl * K + (anti ? keff - 1 - c : c)) + half; };
        float f1 = 0.f, f2 = 0.f;
        for (int i = 0, c = lane * pl; i < pl; ++i, ++c) {
          const float2 e = live && c < keff ? st2[slot(c)] : make_float2(0.f, 0.f);
          if (i == 0) {
            f1 = e.x;
            f2 = e.y;
          } else {
            advance(q.mat[0], f1, f2, e.x, e.y);
          }
        }
#pragma unroll
        for (int m = 1; m < 6; ++m) {
          const int d = 1 << (m - 1);
          if (d >= lanes) break;
          const float o1 = __shfl_up_sync(0xffffffffu, f1, d, lanes);
          const float o2 = __shfl_up_sync(0xffffffffu, f2, d, lanes);
          if (lane >= d) {
            float t1 = o1, t2 = o2;
            advance(q.mat[m], t1, t2, f1, f2);
            f1 = t1;
            f2 = t2;
          }
        }
        float s1 = __shfl_up_sync(0xffffffffu, f1, 1, lanes);
        float s2 = __shfl_up_sync(0xffffffffu, f2, 1, lanes);
        if (lane == 0) s1 = s2 = 0.f;
        for (int i = 0, c = lane * pl; i < pl; ++i, ++c) {
          if (live && c < keff) {
            const float2 e = st2[slot(c)];
            st2[slot(c)] = c == 0 ? make_float2(0.f, 0.f) : make_float2(s1, s2);
            advance(q.mat[0], s1, s2, e.x, e.y);
            if (c == keff - 1 && q.mode == CARRY)
              reinterpret_cast<float2*>(q.carry + (t.line0 + gl) * q.nseg + s)[half] =
                  make_float2(s1, s2);
          }
        }
      }
    }
    __syncthreads();

    if (q.mode == MAIN) {
      // (c) each element plus what its chunk's true start states add:
      // row 0 of A^(j+1) from the causal start, of A^(L-j) from the
      // anticausal one
      if (mine) {
        const float4 in = st[g * K + k];
        if (len == L) {
          get_chunk<GH>(xs, g, k, K, v);
#pragma unroll
          for (int j = 0; j < L; ++j) {
            const float hc = __fadd_rn(__fmul_rn(q.pw[j][0], in.x), __fmul_rn(q.pw[j][1], in.y));
            const float ha = __fadd_rn(__fmul_rn(q.pw[L - 1 - j][0], in.z),
                                       __fmul_rn(q.pw[L - 1 - j][1], in.w));
            v[j] = __fadd_rn(__fadd_rn(v[j], hc), ha);
          }
          put_chunk<GH>(xs, g, k, K, v);
        } else {
#pragma unroll
          for (int j = 0; j < L; ++j) {
            if (j < len) {
              const float hc =
                  __fadd_rn(__fmul_rn(q.pw[j][0], in.x), __fmul_rn(q.pw[j][1], in.y));
              const float ha = __fadd_rn(__fmul_rn(q.pw[L - 1 - j][0], in.z),
                                         __fmul_rn(q.pw[L - 1 - j][1], in.w));
              float* p = xs + word<GH>(g, k, K, j);
              *p = __fadd_rn(__fadd_rn(*p, hc), ha);
            }
          }
        }
      }
      __syncthreads();
      store_tile<GH>(q, t, xs);
    }
  }
}

template <int GH>
cudaError_t launch(const Params& q, unsigned grid, int threads, size_t smem,
                   cudaStream_t stream) {
  // every launch: a function attribute belongs to the current device, so a
  // flag kept once per process would leave a second GPU without it
  // (the largest tile: MAXT chunks, and MAXT lines of one chunk)
  const int most = MAXT * 16 + (4 * MAXT + MAXT * LP) * 4;
  const cudaError_t e = cudaFuncSetAttribute(
      deriche_kernel<GH>, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
  if (e != cudaSuccess) return e;
  deriche_kernel<GH><<<grid, threads, smem, stream>>>(q);
  return cudaGetLastError();
}

}  // namespace

extern "C" int deriche_launch(const void* x, void* y, void* carry, int p, int h, int w,
                              int axis, int seg, int nseg, int K, int G, int lanes,
                              int per_lane, int mode, const float* f, int nf, void* stream) {
  const int threads = (G * K + 31) / 32 * 32;
  if (threads > MAXT || G < 1 || K < 1 || (axis == 1 && G != 8 && G != 16 && G != 32) ||
      (axis != 1 && axis != 2) || (nseg > 1 && (carry == nullptr || seg != K * L)) ||
      (mode == CARRY && nseg < 2) || lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) ||
      per_lane * lanes < K || nf != 36 + 2 * L)
    return (int)cudaErrorInvalidValue;
  const long long tiles = axis == 1 ? (long long)p * ((w + G - 1) / G)
                                    : ((long long)p * h + G - 1) / G;
  const bool vec = w % 4 == 0 && ((size_t)x & 15) == 0 && ((size_t)y & 15) == 0;
  Params q{(const float*)x, (float*)y, (float4*)carry, p, h, w, seg, nseg, K, G,
           lanes, per_lane, mode, (int)tiles, __builtin_ctz(lanes), vec, f[0], f[1], f[2],
           f[3], f[4], f[5], f[6], f[7]};
  for (int i = 0; i < 4; ++i) q.ms[i] = f[8 + i];
  for (int i = 0; i < 24; ++i) q.mat[i / 4][i % 4] = f[12 + i];
  for (int i = 0; i < 2 * L; ++i) q.pw[i / 2][i % 2] = f[36 + i];
  const size_t tilesz = axis == 1 ? (size_t)K * LP * G : (size_t)G * K * L;
  const size_t smem = (size_t)G * K * 16 + ((size_t)4 * G + tilesz) * 4;
  const unsigned grid = (unsigned)(tiles * nseg);
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e;
  if (axis == 2)
    e = launch<0>(q, grid, threads, smem, st);
  else if (G == 8)
    e = launch<8>(q, grid, threads, smem, st);
  else if (G == 16)
    e = launch<16>(q, grid, threads, smem, st);
  else
    e = launch<32>(q, grid, threads, smem, st);
  return (int)e;
}
