"""K2's host side (``nind_denoise_tpu_torch/ops/enc1.py``): the packed w1
layout the bf16 kernel reads, the tiles its persistent CTAs walk, and the
CPU path. The kernel itself runs only on the card (``chip_smoke.py`` holds
it against ``enc1_reference``); its level-1 math is held against the JAX
package in tests/test_torch_utnet.py."""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from nind_denoise_tpu_torch.ops import enc1 as E


def _distinct_bf16(shape):
    """bf16 weights whose values are all distinct (finite, nonzero bit
    patterns), so that a wrong index cannot hide behind an equal value."""
    bits = np.concatenate([np.arange(1, 0x7F80), np.arange(0x8001, 0xFF80)])
    n = int(np.prod(shape))
    assert n <= bits.size
    perm = np.random.default_rng(0).permutation(bits.size)[:n]
    return torch.from_numpy(bits[perm].astype(np.uint16).view(np.int16)) \
        .view(torch.bfloat16).reshape(shape)


def _bits(t):
    return t.contiguous().view(torch.int16).numpy()


def _unpack(packed, f):
    """Inverse of pack_w1: undo the chunk swizzle (an XOR, its own
    inverse), then (tap, co, ci) -> (co, ci, ky, kx)."""
    s = math.gcd(8, f // 8)
    co = torch.arange(f)[:, None]
    chunk = torch.arange(f // 8)[None, :] ^ (co % s)
    w = packed.reshape(9, f, f // 8, 8)[:, co, chunk].reshape(3, 3, f, f)
    return w.permute(2, 3, 0, 1)


@pytest.mark.parametrize("funit", [8, 64])
@pytest.mark.parametrize("check", ["permutation", "round_trip", "index_formula"])
def test_pack_w1(funit, check):
    w1 = _distinct_bf16((funit, funit, 3, 3))
    packed = E.pack_w1(w1)
    assert packed.dtype == torch.bfloat16 and tuple(packed.shape) == (9, funit, funit)
    if check == "permutation":
        assert np.array_equal(np.sort(_bits(packed).ravel()), np.sort(_bits(w1).ravel()))
    elif check == "round_trip":
        assert np.array_equal(_bits(_unpack(packed, funit)), _bits(w1))
    else:
        # w1[co, ci, ky, kx] sits at [tap][co][((ci // 8) ^ (co % s)) * 8 + ci % 8]
        co, ci, ky, kx = np.meshgrid(*(np.arange(n) for n in w1.shape), indexing="ij")
        s = math.gcd(8, funit // 8)
        pos = ((ky * 3 + kx) * funit + co) * funit + ((ci // 8) ^ (co % s)) * 8 + ci % 8
        assert np.array_equal(_bits(packed).ravel()[pos], _bits(w1))


def test_pack_w1_casts_to_bf16_and_rejects_other_shapes():
    w1 = torch.rand(16, 16, 3, 3, generator=torch.Generator().manual_seed(1))
    assert torch.equal(E.pack_w1(w1), E.pack_w1(w1.to(torch.bfloat16)))
    with pytest.raises(ValueError):
        E.pack_w1(torch.zeros(12, 12, 3, 3))
    with pytest.raises(ValueError):
        E.pack_w1(torch.zeros(16, 8, 3, 3))


@pytest.mark.parametrize("n_sms", [132, 5])
@pytest.mark.parametrize("bsz,h,w", [(8, 504, 504), (2, 104, 136), (1, 136, 136),
                                     (1, 104, 104)])
def test_tiles_cover_each_output_once_and_each_pool_window_whole(bsz, h, w, n_sms):
    ty, tx = E.tile_grid(h, w)
    n_ctas = E.cta_count(bsz * ty * tx, n_sms)
    assert 1 <= n_ctas <= n_sms
    owner = np.full((bsz, h, w), -1)
    count = np.zeros((bsz, h, w), int)
    tiles = 0
    for cta in range(n_ctas):
        for group in range(E.GROUPS):
            for b, y0, x0 in E.walk(cta, group, n_ctas, bsz, h, w):
                assert y0 % 2 == 0 and x0 % 2 == 0
                count[b, y0:y0 + E.TILE, x0:x0 + E.TILE] += 1
                owner[b, y0:y0 + E.TILE, x0:x0 + E.TILE] = tiles
                tiles += 1
    assert tiles == bsz * ty * tx
    assert (count == 1).all()
    # every 2x2 pool window lies within one tile
    win = owner.reshape(bsz, h // 2, 2, w // 2, 2)
    assert (win == win[:, :, :1, :, :1]).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_tensors_take_the_plain_version(dtype):
    gen = torch.Generator().manual_seed(2)

    def u(*shape):
        return (torch.rand(*shape, generator=gen) - 0.5).to(dtype)

    args = (u(2, 3, 24, 28), u(64, 3, 3, 3), u(64), torch.full((1,), 0.25, dtype=dtype),
            u(64, 64, 3, 3), u(64), torch.full((1,), 0.25, dtype=dtype))
    before = E.launches
    l1, l2 = E.enc1(*args)
    assert E.launches == before
    r1, r2 = E.enc1_reference(*args)
    assert l1.dtype == dtype and tuple(l1.shape) == (2, 64, 20, 24)
    assert tuple(l2.shape) == (2, 64, 10, 12)
    assert torch.equal(l1, r1) and torch.equal(l2, r2)


# ---------------------------------------------------------------- fp32 kernel

_SRC = (Path(E.__file__).resolve().parents[1] / "csrc" / "enc1.cu").read_text()


def _cc_constants():
    """The ``constexpr int`` constants of the fp32 kernel's namespace in
    ``csrc/enc1.cu``, evaluated in order (C = 64 from the file's top)."""
    body = _SRC[_SRC.index("namespace cc {"):_SRC.index("}  // namespace cc")]
    env = {"C": int(re.search(r"constexpr int C = (\d+);", _SRC).group(1))}
    for decl in re.findall(r"constexpr int ([^;]+);", body):
        for part in decl.split(","):
            name, expr = (s.strip() for s in part.split("=", 1))
            env[name] = eval(expr.replace("/", "//"), {}, dict(env))
    return env


K = _cc_constants()

_F32_SHAPES = [(30, 184, 184), (15, 184, 184), (1, 184, 184), (1, 1208, 3000),
               (1, 1192, 3000), (8, 504, 504), (2, 104, 136),
               # the x_pad shapes as sizes of their own
               (30, 188, 188), (1, 1212, 3004), (1, 1196, 3004)]


@pytest.mark.parametrize("n_sms", [132, 5])
@pytest.mark.parametrize("bsz,h,w", _F32_SHAPES)
def test_f32_tiles_cover_each_output_once_and_each_pool_window_whole(bsz, h, w, n_sms):
    ty, tx = E.f32_tile_grid(h, w)
    n_ctas = E.f32_cta_count(bsz * ty * tx, n_sms)
    assert 1 <= n_ctas <= min(n_sms, bsz * ty * tx)
    owner = np.full((bsz, h, w), -1, np.int32)
    count = np.zeros((bsz, h, w), np.int8)
    tiles = 0
    for cta in range(n_ctas):
        walked = list(E.f32_walk(cta, n_ctas, bsz, h, w))
        # each CTA's share differs from another's by one tile at most
        assert len(walked) in (bsz * ty * tx // n_ctas, -(-bsz * ty * tx // n_ctas))
        for b, y0, x0 in walked:
            assert y0 % 2 == 0 and x0 % 2 == 0
            count[b, y0:y0 + E.F32_TH, x0:x0 + E.F32_TW] += 1
            owner[b, y0:y0 + E.F32_TH, x0:x0 + E.F32_TW] = tiles
            tiles += 1
    assert tiles == bsz * ty * tx
    assert (count == 1).all()
    win = owner.reshape(bsz, h // 2, 2, w // 2, 2)
    assert (win == win[:, :, :1, :, :1]).all()


def test_f32_shared_memory_reckoning_fits_and_matches_the_source():
    assert (K["TH"], K["TW"], K["CC"]) == (E.F32_TH, E.F32_TW, E.F32_CHUNK)
    assert K["SMEM"] == E.f32_smem_bytes() == 212752
    assert E.f32_smem_bytes() <= 232448  # a CTA's shared memory on Hopper
    # the header's sum, term by term
    assert 147456 + 46080 + 11520 + 7168 + 528 == E.f32_smem_bytes()
    assert "= 212,752 B (of 232,448)" in _SRC


def _prelu(v, a):
    return np.where(v >= 0, v, a * v)


def _f32_model(x, w0, b0, a0, w1, b1, a1, n_sms):
    """The fp32 kernel's output from its index math alone, in float64: the
    persistent walk, the double-buffered x patches and t0 chunks (each
    filled with NaN before it is written, so a read of a place nothing wrote
    shows), c0's tasks by warp, round and lane (a half-warp a channel), c1's
    window and weights by warp and lane, and the epilogue's stores (each
    place written once)."""
    bsz, _, hp, wp = x.shape
    h, w = hp - 4, wp - 4
    th, tw, t0h, t0s, xh, xs_, cc, nch, w0s_ = (K[k] for k in (
        "TH", "TW", "T0H", "T0S", "XH", "XS", "CC", "NCH", "W0S"))
    n_warps = K["NT"] // 32
    ty, tx = E.f32_tile_grid(h, w)
    n_tiles = bsz * ty * tx
    n_ctas = E.f32_cta_count(n_tiles, n_sms)
    w0s = np.zeros((64, w0s_))
    w0s[:, :27] = w0.reshape(64, 27)
    w1s = w1.transpose(1, 2, 3, 0).reshape(64, 9, 64)  # [ci][tap][co]
    l1 = np.full((bsz, 64, h, w), np.nan)
    l2 = np.full((bsz, 64, h // 2, w // 2), np.nan)
    n1, n2 = np.zeros(l1.shape, int), np.zeros(l2.shape, int)
    lane = np.arange(32)
    lr, lc = lane >> 3, lane & 7
    # c0's tasks: every warp's rounds x lanes, a half-warp a channel, those
    # past its channel's tasks out
    warp_t, rnd, ln = (a.ravel() for a in np.meshgrid(
        np.arange(n_warps), np.arange(K["C0_ROUNDS"]), lane, indexing="ij"))
    task = rnd * 16 + (ln & 15)
    keep = task < K["C0_TASKS"]
    ch = (2 * warp_t + (ln >> 4))[keep]
    rp, cb = task[keep] // (t0s // 4), task[keep] % (t0s // 4)

    def tile_at(t):
        rem_ = t % (ty * tx)
        return t // (ty * tx), (rem_ // tx) * th, (rem_ % tx) * tw

    for cta in range(n_ctas):
        mine = list(range(cta, n_tiles, n_ctas))
        assert [tile_at(t) for t in mine] == list(E.f32_walk(cta, n_ctas, bsz, h, w))
        xbuf = np.full((2, 3, xh, xs_), np.nan)
        t0buf = np.full((2, cc, t0h, t0s), np.nan)

        def load_x(t, buf):
            b, y0, x0 = tile_at(t)
            patch = np.zeros((3, xh, xs_))
            rows, cols = min(xh, hp - y0), min(xs_, wp - x0)
            patch[:, :rows, :cols] = x[b, :, y0:y0 + rows, x0:x0 + cols]
            xbuf[buf] = patch

        def c0(xb, tb, chunk):
            t0buf[tb] = np.nan
            co = chunk * cc + ch
            acc = np.zeros((co.size, 2, 4))
            for ci in range(3):
                for s in range(4):
                    xr = xbuf[xb][ci, (2 * rp + s)[:, None], (4 * cb)[:, None] + np.arange(6)]
                    for r in range(2):
                        ky = s - r
                        if 0 <= ky <= 2:
                            for kx in range(3):
                                acc[:, r] += w0s[co, (ci * 3 + ky) * 3 + kx][:, None] \
                                    * xr[:, kx:kx + 4]
            v = _prelu(acc + b0[co][:, None, None], a0)
            for r in range(2):
                t0buf[tb][ch[:, None], (2 * rp + r)[:, None], (4 * cb)[:, None] + np.arange(4)] \
                    = v[:, r]

        def c1(tb, chunk, acc):
            rows = (2 * lr)[:, None] + np.arange(4)
            cols = (4 * lc)[:, None] + np.arange(6)
            win = t0buf[tb][:, rows[:, :, None], cols[:, None, :]]  # (cc, lane, 4, 6)
            for g in range(n_warps):
                wts = w1s[chunk * cc:(chunk + 1) * cc, :, 8 * g:8 * g + 8]
                for t in range(9):
                    ky, kx = divmod(t, 3)
                    acc[g] += np.einsum("ck,clyx->lkyx", wts[:, t],
                                        win[:, :, ky:ky + 2, kx:kx + 4])

        load_x(mine[0], 0)
        c0(0, 0, 0)
        for it, t in enumerate(mine):
            b, y0, x0 = tile_at(t)
            nxt = mine[it + 1] if it + 1 < len(mine) else None
            if nxt is not None:
                load_x(nxt, (it + 1) & 1)
            acc = np.zeros((n_warps, 32, 8, 2, 4))
            for chunk in range(nch):
                last = chunk + 1 == nch
                if not last or nxt is not None:
                    c0((it + 1) & 1 if last else it & 1, (chunk + 1) & 1, 0 if last else chunk + 1)
                c1(chunk & 1, chunk, acc)
            for g in range(n_warps):
                for ln in range(32):
                    oy, ox = y0 + 2 * lr[ln], x0 + 4 * lc[ln]
                    if oy >= h or ox >= w:
                        continue
                    full = w % 4 == 0 and ox + 4 <= w
                    n = 4 if full else len([d for d in range(4) if ox + d < w])
                    for k in range(8):
                        co = 8 * g + k
                        v = _prelu(acc[g, ln, k] + b1[co], a1)
                        l1[b, co, oy:oy + 2, ox:ox + n] = v[:, :n]
                        n1[b, co, oy:oy + 2, ox:ox + n] += 1
                        m = v.reshape(2, 2, 2).max(axis=(0, 2))
                        n_pool = 2 if full or ox + 2 < w else 1
                        l2[b, co, oy // 2, ox // 2:ox // 2 + n_pool] = m[:n_pool]
                        n2[b, co, oy // 2, ox // 2:ox // 2 + n_pool] += 1
    assert (n1 == 1).all() and (n2 == 1).all()
    return l1, l2


@pytest.mark.parametrize("bsz,h,w,n_sms", [(1, 2, 2, 132), (2, 20, 70, 3), (3, 18, 36, 2),
                                           (1, 40, 98, 5)])
def test_f32_kernel_model_matches_float64_level_1(bsz, h, w, n_sms):
    """Ragged tiles (rows and columns), W % 4 == 2 (element stores), and
    CTAs that walk several tiles (the next tile's x patch and chunk 0)."""
    rng = np.random.default_rng(7)
    x = rng.uniform(0, 1, (bsz, 3, h + 4, w + 4))
    w0 = rng.uniform(-1, 1, (64, 3, 3, 3)) / math.sqrt(27)
    b0 = rng.uniform(-1, 1, 64) / math.sqrt(27)
    w1 = rng.uniform(-1, 1, (64, 64, 3, 3)) / 24
    b1 = rng.uniform(-1, 1, 64) / 24
    l1, l2 = _f32_model(x, w0, b0, 0.25, w1, b1, 0.25, n_sms)
    t = torch.from_numpy
    t0 = torch.nn.functional.conv2d(t(x), t(w0), t(b0))
    t0 = torch.where(t0 >= 0, t0, 0.25 * t0)
    r1 = torch.nn.functional.conv2d(t0, t(w1), t(b1))
    r1 = torch.where(r1 >= 0, r1, 0.25 * r1)
    r2 = torch.nn.functional.max_pool2d(r1, 2)
    np.testing.assert_allclose(l1, r1.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(l2, r2.numpy(), rtol=0, atol=1e-12)
