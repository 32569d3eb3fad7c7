"""A numpy model of K3 (``csrc/gauss_blur.cu``) held bit for bit against
its plain version, ``gauss_blur_reference``.

The model replays the kernel's index math with its constants: the tile
per radius, the flat thread loops split into row and column, the clamped
halo load, the vertical strips of KV rows, the horizontal groups of four
read through 16- and 8-byte windows, the channel walk, and the output
tile gathered in shared memory where the launcher stages it. Shared
memory starts as NaN, so a read of a cell no phase wrote shows in the
result, and an index outside a region raises. Every CTA of a launch is a
row of one array; the thread loops are vectorised over their flat index.
The test reads the constants it assumes from the source, so a change to
the kernel's geometry fails here until the model follows it.
"""

import re

import numpy as np
import pytest
import torch

from nind_denoise_tpu_torch.ops import _build
from nind_denoise_tpu_torch.ops import gauss_blur as tgb
from nind_denoise_tpu_torch.ops import rl_fused
from nind_denoise_tpu_torch.ops.rl_deblur import gaussian_taps_np

SRC = (_build.CSRC / "gauss_blur.cu").read_text()


def _const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


NT, TH, KV = _const("NT"), _const("TH"), _const("KV")
SM_BYTES, CTA_BYTES = _const("SM_BYTES"), _const("CTA_BYTES")


def _fit(nbytes):
    return SM_BYTES // (nbytes + 1024)


class Tile:
    """``Tile<R>`` of the kernel."""

    def __init__(self, r):
        self.tw = 64 if r <= 16 else 128
        self.nk = 2 * r + 1
        self.uh, self.uw = TH + 2 * r, self.tw + 2 * r
        self.ld = (self.uw + 3) // 4 * 4
        self.smem = (self.uh * self.uw + TH * self.ld) * 4
        self.min_ctas = max(1, min(4, _fit(self.smem), 65536 // (NT * (self.nk + 40))))
        assert self.smem <= CTA_BYTES


def test_model_constants_are_the_kernels():
    assert "TW = R <= 16 ? 64 : 128;" in SRC
    assert "LD = (UW + 3) / 4 * 4;" in SRC
    assert "SMEM = (UH * UW + TH * LD) * 4;" in SRC
    assert "cmin(fit(SMEM), 65536 / (NT * (NK + 40)))" in SRC
    assert "stage = C > 1 && fit(T::SMEM + gather) >= T::MIN_CTAS;" in SRC
    assert "smem = T::SMEM + (stage ? (int)gather : 0);" in SRC
    assert "float* O = V + TH * LD;" in SRC


def _thread_loop(n):
    """Every flat index the loop ``for (i = threadIdx.x; i < n; i += NT)``
    visits over the CTA's threads."""
    return np.arange(n)


def launch_plan(r, c_):
    """The launcher's choice: (stage, shared-memory bytes)."""
    t = Tile(r)
    gather = TH * t.tw * c_ * 4
    stage = c_ > 1 and _fit(t.smem + gather) >= t.min_ctas
    return stage, t.smem + (gather if stage else 0)


def kernel_model(x, taps):
    """(P, H, W, C) float32 -> the kernel's output, launch by launch."""
    p_, h, w, c_ = x.shape
    k = np.asarray(taps, np.float32)
    r = (len(k) - 1) // 2
    t = Tile(r)
    n_tw = -(-w // t.tw)
    n_th = -(-h // TH)
    stage, smem = launch_plan(r, c_)
    assert smem <= CTA_BYTES
    nfl = smem // 4
    up, vp = t.uh * t.uw, TH * t.ld
    U0, V0 = 0, up
    O0 = V0 + vp
    assert V0 % 4 == 0 and O0 % 4 == 0  # 16-byte aligned regions
    flat_in = x.reshape(-1)
    out = np.full(p_ * h * w * c_, np.nan, np.float32)
    # one row per CTA: (z, by, bx)
    z, by, bx = (a.reshape(-1) for a in np.meshgrid(
        np.arange(p_), np.arange(n_th), np.arange(n_tw), indexing="ij"))
    ncta = z.size
    y0, x0 = (by * TH)[:, None], (bx * t.tw)[:, None]
    image = (z * h * w * c_)[:, None]
    sm = np.full((ncta, nfl), np.nan, np.float32)
    rows = np.arange(ncta)[:, None]

    def rd(off):
        assert off.min() >= 0 and off.max() < nfl
        return sm[rows, off] if off.ndim == 2 else sm[:, off]

    def wr(off, val, mask=None):
        assert off.min() >= 0 and off.max() < nfl
        if off.ndim == 1:
            off = np.broadcast_to(off, (ncta, off.size))
        rr = np.broadcast_to(rows, off.shape)
        if mask is None:
            sm[rr, off] = val
        else:
            sm[rr[mask], off[mask]] = val[mask]

    ng, ns = t.tw // 4, TH // KV
    n_win = t.nk + 3
    for c in range(c_):
        # 1. load channel c through clamped indices
        i = _thread_loop(up)
        rr, q = i // t.uw, i - (i // t.uw) * t.uw
        gy = np.clip(y0 - r + rr, 0, h - 1)
        gx = np.clip(x0 - r + q, 0, w - 1)
        wr(U0 + i, flat_in[image + (gy * w + gx) * c_ + c])
        # 2. vertical strips of KV rows
        i = _thread_loop(ns * t.uw)
        s, q = i // t.uw, i - (i // t.uw) * t.uw
        src = U0 + s * KV * t.uw + q
        dst = V0 + s * KV * t.ld + q
        acc = [None] * KV
        for m in range(KV + t.nk - 1):
            v = rd(src + m * t.uw)
            for j in range(KV):
                tt = m - j
                if 0 <= tt < t.nk:
                    pr = k[tt] * v
                    acc[j] = pr if tt == 0 else acc[j] + pr
        for j in range(KV):
            wr(dst + j * t.ld, acc[j])
        # 3. horizontal groups of four
        i = _thread_loop(TH * ng)
        rr, q0 = i // ng, (i - (i // ng) * ng) * 4
        gy, gx0 = y0 + rr, x0 + q0
        live = (gy < h) & (gx0 < w)
        base = V0 + rr * t.ld + q0
        o = [None] * 4
        for m0 in range(0, n_win, 4):
            if m0 + 4 <= n_win:
                assert ((base + m0) % 4 == 0).all()
                win = [rd(base + m0 + e) for e in range(4)]
            else:
                assert ((base + m0) % 2 == 0).all()
                win = [rd(base + m0 + e) for e in range(2)] + [None, None]
            for e in range(4):
                for j in range(4):
                    tt = m0 + e - j
                    if 0 <= tt < t.nk:
                        pr = k[tt] * win[e]
                        o[j] = pr if tt == 0 else o[j] + pr
        live = np.broadcast_to(live, (ncta, i.size))
        if stage:
            for j in range(4):
                wr(np.broadcast_to(O0 + (rr * t.tw + q0) * c_ + c + j * c_, live.shape),
                   o[j], live)
        else:
            for j in range(4):
                ok = live & (gx0 + j < w)
                dst = np.broadcast_to(image + (gy * w + gx0 + j) * c_ + c, ok.shape)
                out[dst[ok]] = o[j][ok]
    if stage:
        for b in range(ncta):
            nrows = min(TH, h - int(y0[b, 0]))
            n = min(t.tw, w - int(x0[b, 0])) * c_
            ldo = w * c_
            first = int(image[b, 0]) + (int(y0[b, 0]) * w + int(x0[b, 0])) * c_
            for ri in range(nrows):
                out[first + ri * ldo: first + ri * ldo + n] = \
                    sm[b, O0 + ri * t.tw * c_: O0 + ri * t.tw * c_ + n]
    return out.reshape(x.shape)


def _planes_reference(x, taps):
    return rl_fused.blur(torch.from_numpy(x), taps.tolist()).numpy()


@pytest.mark.parametrize("radius,shape", [
    (1, (2, 75, 77)), (3, (75, 77, 3)), (16, (2, 40, 70)), (17, (40, 70, 3)),
    (33, (2, 75, 77)), (64, (30, 150, 3)), (63, (2, 9, 131))])
def test_kernel_model_is_bit_equal_to_the_plain_version(radius, shape):
    rng = np.random.default_rng(radius)
    x = rng.random(shape, dtype=np.float32)
    sigma = (radius - 0.5) / 3
    taps = gaussian_taps_np(sigma)
    assert len(taps) == 2 * radius + 1
    if len(shape) == 3 and shape[-1] == 3:  # HWC, the public entry
        got = kernel_model(x[None], taps)[0]
        ref = tgb.gauss_blur_reference(torch.from_numpy(x), sigma).numpy()
    else:  # planar, blur_planes
        got = kernel_model(x[..., None], taps)[..., 0]
        ref = _planes_reference(x, taps)
    assert np.array_equal(got, ref)


def test_launch_plan_at_the_product_radii():
    # sigma 1 gathers its output tile; from R 17 (128-wide tiles) the
    # gather would cost a CTA an SM, except where one CTA is all that fits
    # and the gather still fits beside it (R 39-60 at C = 3)
    assert launch_plan(3, 3) == (True, Tile(3).smem + TH * 64 * 3 * 4)
    assert launch_plan(16, 3)[0] and not launch_plan(17, 3)[0]
    assert launch_plan(50, 3)[0] and not launch_plan(63, 3)[0]
    assert launch_plan(33, 1) == (False, Tile(33).smem)
    assert [Tile(r).min_ctas for r in (3, 16, 17, 33, 38, 39, 64)] == [4, 3, 3, 2, 2, 1, 1]
