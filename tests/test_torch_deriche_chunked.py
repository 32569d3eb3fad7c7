"""Kernel P2's order in plain torch (``ops/deriche.deriche_axis_chunked``)
on the CPU: the chunked scan against JAX's ``_deriche_axis`` and against
the sequential loop run in float64, within ``ops/deriche.error_bound``
(``BOUND_C * 2**-24 * (sum|g_causal| + sum|g_anti|) * max|x|``), at sigma
0.05 (under the 0.1 clamp), 1 and 10, along H and W, at lengths around the
chunk length L and past one segment of a tile scaled down to two chunks.
The plain fp32 loop meets the same bound, and planted faults (one chunk's
carry dropped, A**(L-1) taken for A**L, A**(segment-1) for A**segment)
break it."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nind_denoise_tpu.ops import rl_deblur as jrl
from nind_denoise_tpu_torch.ops import deriche

L = deriche.CHUNK
LENGTHS = [1, 2, 3, L - 1, L, L + 1, 2 * L + 5]


def _lines(n, axis, seed):
    shape = (2, n, 5) if axis == 1 else (2, 5, n)
    return torch.from_numpy(np.random.default_rng(seed).random(shape, dtype=np.float32) + 0.05)


def _jax(x, sigma, axis):
    """JAX's pass on the same planes as one NHWC image."""
    img = jnp.asarray(x.numpy().transpose(1, 2, 0)[None])
    y = np.array(jrl._deriche_axis(img, sigma, axis))[0].transpose(2, 0, 1)
    return torch.from_numpy(np.ascontiguousarray(y))


def _err(y, y64):
    return (y.double() - y64).abs().max().item()


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("axis", [1, 2])
@pytest.mark.parametrize("sigma", [0.05, 1.0, 10.0])
def test_chunked_order_within_the_bound(sigma, axis, n):
    x = _lines(n, axis, n)
    y64 = deriche.deriche_axis_reference(x.double(), sigma, axis)
    bound = deriche.error_bound(sigma, x.abs().max())
    chunked = deriche.deriche_axis_chunked(x, sigma, axis)
    loop = deriche.deriche_axis_reference(x, sigma, axis)
    assert chunked.dtype == torch.float32 and chunked.shape == x.shape
    assert _err(chunked, y64) <= bound
    assert _err(loop, y64) <= bound
    assert _err(chunked, _jax(x, sigma, axis).double()) <= bound
    if n <= L:  # one chunk runs from the true starts: the loop's own order
        assert torch.equal(chunked, loop)


@pytest.mark.parametrize("axis", [1, 2])
@pytest.mark.parametrize("sigma", [1.0, 10.0])
def test_segments_of_a_scaled_down_tile(sigma, axis):
    """Two chunks a segment: 5L + 7 elements are three segments, the last
    ragged, joined by the carry pass and A**segment."""
    n = 5 * L + 7
    assert deriche.geometry(n, axis, max_chunks=2)[:3] == (2 * L, 3, 2)
    x = _lines(n, axis, 7)
    y64 = deriche.deriche_axis_reference(x.double(), sigma, axis)
    bound = deriche.error_bound(sigma, x.abs().max())
    segmented = deriche.deriche_axis_chunked(x, sigma, axis, max_chunks=2)
    assert _err(segmented, y64) <= bound
    assert _err(deriche.deriche_axis_chunked(x, sigma, axis), y64) <= bound


@pytest.mark.parametrize("fault,sigma", [("carry", 1.0), ("carry", 10.0), ("power", 10.0),
                                         ("segment_carry", 30.0)])
def test_planted_faults_break_the_bound(fault, sigma, monkeypatch):
    """A dropped carry moves the chunk's first outputs by about b1 * y;
    A**(L-1) matters where the pole's L-th power does (sigma 10: 0.84**32);
    A**(segment-1) where its 2L-th power does (sigma 30: 0.945**64, read
    12x the bound; at sigma 10 the fault reads 0.6x)."""
    axis, n = 2, 2 * L + 5
    max_chunks = 2 if fault == "segment_carry" else None
    if fault == "segment_carry":
        n = 5 * L + 7
    x = _lines(n, axis, 3)
    y64 = deriche.deriche_axis_reference(x.double(), sigma, axis)
    bound = deriche.error_bound(sigma, x.abs().max())
    assert _err(deriche.deriche_axis_chunked(x, sigma, axis, max_chunks=max_chunks),
                y64) <= bound
    if fault == "carry":
        scan = deriche._chunk_scan

        def drop(e1, e2, mats, g, reverse):
            i1, i2, t1, t2 = scan(e1, e2, mats, g, reverse)
            i1[1], i2[1] = 0.0, 0.0
            return i1, i2, t1, t2

        monkeypatch.setattr(deriche, "_chunk_scan", drop)
    elif fault == "power":
        power = deriche.companion_power
        monkeypatch.setattr(deriche, "companion_power",
                            lambda s, length: power(s, length - (length == L)))
    else:  # the segments' A**segment taken one step short
        power = deriche.companion_power
        monkeypatch.setattr(deriche, "companion_power",
                            lambda s, length: power(s, length - (length == 2 * L)))
    assert _err(deriche.deriche_axis_chunked(x, sigma, axis, max_chunks=max_chunks),
                y64) > bound


def test_geometry_of_the_main_shapes():
    """(segment, segments, chunks, lines, lanes, chunks a lane) of the
    CLI's 6 MP passes, a server group's, and lines past one segment; a
    tile never needs more than THREADS threads, along H it is 8, 16 or 32
    columns, and its scans' lanes fit in its threads."""
    assert deriche.geometry(2000, 1) == (2000, 1, 63, 8, 32, 2)
    assert deriche.geometry(3000, 2) == (3000, 1, 94, 5, 32, 3)
    assert deriche.geometry(480, 1) == (480, 1, 15, 32, 4, 4)
    assert deriche.geometry(480, 2) == (480, 1, 15, 34, 4, 4)
    assert deriche.geometry(12000, 2) == (12000, 1, 375, 1, 32, 12)
    assert deriche.geometry(9000, 1) == (64 * L, 5, 64, 8, 32, 2)
    assert deriche.geometry(40000, 2) == (512 * L, 3, 512, 1, 32, 16)
    for n in (1, 31, 33, 700, 2048, 2049, 6000, 8200):
        for axis in (1, 2):
            seg, nseg, k, lines, lanes, per_lane = deriche.geometry(n, axis)
            threads = -(-k * lines // 32) * 32
            assert threads <= deriche.THREADS and seg * (nseg - 1) < n <= seg * nseg
            assert nseg == 1 or seg == k * L
            assert axis == 2 or lines in (8, 16, 32)
            assert lanes & (lanes - 1) == 0 and lanes * per_lane >= k
            assert lanes == 1 or 2 * lines * lanes <= threads
