"""A numpy model of kernel P1's index math (``csrc/qconv.cu``), lane by
lane, held bit-equal to the plain int32 conv (``conv_i32_reference``) on
the CPU. The model fills each stage as the kernel's TMA boxes do (the
halo box at the tile's input origin, each tap's B box, out-of-bounds and
channel tails zero, 64-byte swizzle), gathers each lane's ldmatrix rows
from the addresses the kernel computes, reads B through the wgmma
descriptor's K-major 64-byte-swizzled layout, accumulates by the wgmma
fragment layouts and writes the epilogue's pixels and channels. It reads
the tile and chunk constants from the source, so a change there shows
here."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from nind_denoise_tpu_torch.ops import qconv as Q

SRC = (Path(Q.__file__).resolve().parents[1] / "csrc" / "qconv.cu").read_text()


def _const(name):
    return int(re.search(rf"\b{name} = (\d+)", SRC).group(1))


TH, TW, KC, MAXT = _const("TH"), _const("TW"), _const("KC"), _const("MAXT")


def _tap_axis(k, pad, ph, dil):
    if dil == 1:
        return 0, k
    first = ((pad - ph) % 2 + 2) % 2
    return first, ((k - first + 1) // 2 if first < k else 0)


def _swz(addr):
    """TMA's and wgmma's 64-byte swizzle of a shared-memory byte offset."""
    return addr ^ (((addr >> 7) & 3) << 4)


def model(xq, wk, pads, dil):
    """The kernel's int32 output, from its addressing alone."""
    n, h, w, cin = xq.shape
    cout, kh, kw, _ = wk.shape
    ho, wo = Q.out_hw(h, w, kh, kw, pads, dil)
    pt, _, pl, _ = pads
    bn = 64 if cout <= 64 else 128
    ty, tx = -(-kh // dil), -(-kw // dil)
    assert ty <= MAXT and tx <= MAXT
    box_h, box_w = TH + ty - 1, TW + tx - 1
    tiles_y, tiles_x = -(-(-(-ho // dil)) // TH), -(-(-(-wo // dil)) // TW)
    nblocks, ncc = -(-cout // bn), -(-cin // KC)
    out = np.full((n, ho, wo, cout), -(2 ** 31), np.int64)
    lane = np.arange(32)
    g, t4, q, r8 = lane >> 2, lane & 3, lane >> 3, lane & 7
    col = r8 + 8 * (q & 1)
    for tile in range(dil * dil * n * tiles_y * tiles_x * nblocks):
        nb, r = tile % nblocks, tile // nblocks
        tj, r = r % tiles_x, r // tiles_x
        ti, r = r % tiles_y, r // tiles_y
        img, phase = r % n, r // n
        py, px = (phase >> 1, phase & 1) if dil == 2 else (0, 0)
        a0, ny = _tap_axis(kh, pt, py, dil)
        b0, nx = _tap_axis(kw, pl, px, dil)
        dy, dx = (py + a0 - pt) // dil, (px + b0 - pl) // dil
        i0, j0 = ti * TH, tj * TW
        acc = np.zeros((2, 2, 4, 16, bn), np.int64)  # [wg][m][warp][row][channel]
        for cc in range(ncc):
            # the stage, as TMA fills it
            sa = np.zeros(box_h * box_w * KC, np.int64)
            for br in range(box_h):
                for bc in range(box_w):
                    iy, ix, pix = i0 + dy + br, j0 + dx + bc, br * box_w + bc
                    if not (0 <= iy < h and 0 <= ix < w):
                        continue
                    for c in range(KC):
                        if cc * KC + c < cin:
                            sa[_swz(pix * KC + c)] = xq[img, iy, ix, cc * KC + c]
            sb = np.zeros(ny * nx * bn * KC, np.int64)
            for j in range(ny):
                for l in range(nx):
                    a, b = a0 + dil * j, b0 + dil * l
                    for o in range(bn):
                        oc = nb * bn + o
                        for c in range(KC):
                            if oc < cout and cc * KC + c < cin:
                                sb[_swz(((j * nx + l) * bn + o) * KC + c)] = wk[oc, a, b, cc * KC + c]
            for st in range(2 * ny * nx):
                tap, chunk = st >> 1, 2 * (st & 1) + (q >> 1)
                j, l = tap // nx, tap % nx
                # B through the descriptor: start + (o // 8) * SBO + (o % 8) * 64 + k
                start = (st >> 1) * bn * KC + (st & 1) * 32
                o = np.arange(bn)[:, None]
                k = np.arange(32)[None]
                bmat = sb[_swz(start + (o // 8) * 512 + (o % 8) * 64 + k)]  # (bn, 32)
                for wg in range(2):
                    for warp in range(4):
                        for m in range(2):
                            pix = (8 * wg + warp + 4 * m + j) * box_w + col + l
                            addr = pix * KC + ((chunk ^ ((pix >> 1) & 3)) << 4)
                            # ldmatrix: lane L's register qq is row L >> 2 of matrix qq,
                            # whose row addresses come from lanes 8 qq .. 8 qq + 7
                            regs = np.stack([np.stack([sa[addr[8 * qq + (L >> 2)] + 4 * (L & 3) + e]
                                                       for e in range(4)], -1)
                                             for L in range(32) for qq in range(4)]).reshape(32, 4, 4)
                            # the wgmma A fragment: reg 0 (g, 4t), 1 (g+8, 4t), 2 (g, 16+4t), 3 (g+8, 16+4t)
                            amat = np.zeros((16, 32), np.int64)
                            for rr in range(4):
                                rows = g + 8 * (rr & 1)
                                ks = 4 * t4 + 16 * (rr >> 1)
                                for e in range(4):
                                    amat[rows, ks + e] = regs[:, rr, e]
                            acc[wg, m, warp] += amat @ bmat.T
        # the epilogue: lane (g, t4), d[4 j + 2 h + e] = (row g + 8 h, channel 8 j + 2 t4 + e)
        for wg in range(2):
            for warp in range(4):
                for m in range(2):
                    for hh in range(2):
                        for L in range(32):
                            oi, oj = i0 + 8 * wg + warp + 4 * m, j0 + g[L] + 8 * hh
                            oy, ox = oi * dil + py, oj * dil + px
                            if oy >= ho or ox >= wo:
                                continue
                            for jj in range(bn // 8):
                                for e in range(2):
                                    oc = nb * bn + 8 * jj + 2 * t4[L] + e
                                    if oc < cout:
                                        out[img, oy, ox, oc] = acc[wg, m, warp, g[L] + 8 * hh,
                                                                   8 * jj + 2 * t4[L] + e]
    return out


@pytest.mark.parametrize("shape,cout,k,pads,dil", [
    ((1, 18, 21, 16), 8, 3, (0, 0, 0, 0), 1),      # ragged tile, one chunk with a tail
    ((2, 9, 7, 80), 72, 3, (2, 2, 2, 2), 1),        # FULL, two chunks, two channel blocks
    ((1, 7, 9, 16), 6, 4, (3, 3, 3, 3), 2),         # the composed up-conv's phases
    ((1, 6, 5, 32), 4, 3, (1, 2, 0, 1), 2),         # uneven taps by phase
    ((1, 35, 19, 16), 130, 3, (0, 0, 0, 0), 1)])    # 3 x 2 tiles, a channel-block tail
def test_lane_model_equals_the_plain_conv(shape, cout, k, pads, dil):
    rng = np.random.default_rng(sum(shape) + cout)
    xq = rng.integers(-127, 128, shape, dtype=np.int8)
    wk = rng.integers(-127, 128, (cout, k, k, shape[3]), dtype=np.int8)
    ref = Q.conv_i32_reference(torch.from_numpy(xq), torch.from_numpy(wk), pads, dil)
    np.testing.assert_array_equal(model(xq.astype(np.int64), wk.astype(np.int64), pads, dil),
                                  ref.numpy())
