"""K2's host side (``nind_denoise_tpu_torch/ops/enc1.py``): the packed w1
layout the bf16 kernel reads, the tiles its persistent CTAs walk, and the
CPU path. The kernel itself runs only on the card (``chip_smoke.py`` holds
it against ``enc1_reference``); its level-1 math is held against the JAX
package in tests/test_torch_utnet.py."""

import math

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
