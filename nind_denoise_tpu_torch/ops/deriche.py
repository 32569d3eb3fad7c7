"""Deriche order-0 recursive Gaussian (kernel P2, ``csrc/deriche.cu``).

Counterpart of ``nind_denoise_tpu/ops/rl_deblur.py`` ``_deriche_coeffs``,
``_deriche_axis`` and ``_deriche_blur``: the IIR approximation of a
Gaussian that G'MIC's fast blur runs (CImg ``deriche()``), and that RL
uses for ``psf='gmic_fast'``. Along one axis of planar fp32 (P, H, W), a
causal and an anticausal second-order recurrence with neumann starts,
summed; ``deriche_blur`` runs along H, then along W.

``deriche_axis`` launches the CUDA kernel for a CUDA tensor and runs
``deriche_axis_reference``, the plain PyTorch version (a loop over the
axis), for a CPU tensor. ``launches`` counts kernel launches. The
coefficients are host math in double, rounded to fp32 once: the JAX
package multiplies its fp32 arrays by the same Python floats.

The kernel is a chunked scan (``csrc/deriche.cu`` says how), so it does
not round as the sequential loop does. ``deriche_axis_chunked`` is its
order in plain torch, and ``error_bound`` the bound both are held to
against the loop run in float64: ``BOUND_C * 2**-24 * (sum|g_causal| +
sum|g_anti|) * max|x|``, where ``g`` is the impulse response of the
recurrences' feedback ``1 / (1 + b1 z^-1 + b2 z^-2)`` (its sum is
``1 / (1 - p)^2`` for the double pole ``p = exp(-1.695 / sigma)``: 1.50
at sigma 1, 41 at sigma 10).

A line longer than one tile's segment (``geometry``) takes two launches:
a carry pass that writes each segment's end states, then the main pass,
which composes them with ``A**segment``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from . import _build

KEYS = ("a0", "a1", "a2", "a3", "b1", "b2", "coefp", "coefn")
# the kernel's compile-time chunk length L and its threads a CTA at most
# (csrc/deriche.cu L and MAXT): one thread a chunk of a line
CHUNK = 32
THREADS = 512
# the stated constant of error_bound: the fp32 loop and the chunked order
# both read under 1 on the tests' and chip_smoke's inputs
BOUND_C = 4.0
MAIN, CARRY = 0, 1
launches = 0

_SIG = {"deriche_launch": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 11
        + [ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_void_p]}


def coeffs(sigma: float) -> Dict[str, float]:
    """CImg's Deriche order-0 coefficients for ``sigma`` (clamped at 0.1),
    each rounded to fp32 (the values are Python floats that are exactly
    fp32)."""
    nsigma = max(float(sigma), 0.1)
    alpha = 1.695 / nsigma
    ema = math.exp(-alpha)
    ema2 = math.exp(-2.0 * alpha)
    b1, b2 = -2.0 * ema, ema2
    k = (1.0 - ema) ** 2 / (1.0 + 2.0 * alpha * ema - ema2)
    a0, a1 = k, k * (alpha - 1.0) * ema
    a2, a3 = k * (alpha + 1.0) * ema, -k * ema2
    coefp = (a0 + a1) / (1.0 + b1 + b2)
    coefn = (a2 + a3) / (1.0 + b1 + b2)
    vals = dict(a0=a0, a1=a1, a2=a2, a3=a3, b1=b1, b2=b2, coefp=coefp, coefn=coefn)
    return {k: float(np.float32(v)) for k, v in vals.items()}


def deriche_axis_reference(x: torch.Tensor, sigma: float, axis: int) -> torch.Tensor:
    """Plain PyTorch version: the two recurrences as loops over ``axis``,
    each step ``a*x + a'*x' - b1*y' - b2*y''`` in that order."""
    c = coeffs(sigma)
    a0, a1, a2, a3, b1, b2, cp, cn = (c[k] for k in KEYS)
    xm = x.movedim(axis, 0)
    n = xm.shape[0]
    x0 = xm[0]
    xp, yp, yb = x0, cp * x0, cp * x0
    causal = []
    for i in range(n):
        xc = xm[i]
        yc = a0 * xc + a1 * xp - b1 * yp - b2 * yb
        causal.append(yc)
        xp, yb, yp = xc, yp, yc
    xl = xm[n - 1]
    xn, xa, yn, ya = xl, xl, cn * xl, cn * xl
    anti = [None] * n
    for i in range(n - 1, -1, -1):
        xc = xm[i]
        yc = a2 * xn + a3 * xa - b1 * yn - b2 * ya
        anti[i] = yc
        xa, xn, ya, yn = xn, xc, yn, yc
    return (torch.stack(causal) + torch.stack(anti)).movedim(0, axis)


class Geometry(NamedTuple):
    """How the kernel cuts a pass over lines of one length (``geometry``)."""

    segment: int  # elements of a line a tile holds
    segments: int  # segments a line (more than one: a carry pass first)
    chunks: int  # chunks a segment, one thread each
    lines: int  # lines a tile
    lanes: int  # threads that scan one line's chunks (a power of two <= 32)
    per_lane: int  # chunks each of them folds


def geometry(n: int, axis: int, chunk: int = CHUNK,
             max_chunks: Optional[int] = None) -> Geometry:
    """The kernel's cut of a pass over lines of ``n``. Along H (axis 1) a
    tile is 32, 16 or 8 adjacent columns, so each row of it is one 32-128
    byte read; along W (axis 2) it is whole rows. A line of more than
    ``max_chunks`` chunks (64 along H, 512 along W: ``THREADS`` over the
    fewest lines a tile holds) is cut into segments of ``max_chunks``
    chunks. Each of the 2 x lines scans (a line and a direction) gets the
    most lanes that the tile's threads allow."""
    gmin = 8 if axis == 1 else 1
    if max_chunks is None:
        max_chunks = THREADS // gmin
    k = -(-n // chunk)
    if k <= max_chunks:
        seg, nseg = n, 1
    else:
        k, seg = max_chunks, max_chunks * chunk
        nseg = -(-n // seg)
    if axis == 1:
        lines = next(g for g in (32, 16, 8) if g * k <= THREADS or g == 8)
    else:
        lines = max(1, THREADS // k)
    threads = -(-lines * k // 32) * 32
    lanes = 1
    while lanes < 32 and 4 * lines * lanes <= threads:
        lanes *= 2
    return Geometry(seg, nseg, k, lines, lanes, -(-k // lanes))


def companion_power(sigma: float, length: int) -> List[float]:
    """``A**length`` for the recurrences' companion matrix ``A = [[-b1,
    -b2], [1, 0]]`` (fp32 b1, b2) in double, each entry rounded to fp32
    once: it carries a state ``(y[i-1], y[i-2])`` across ``length``
    steps without input. Row-major (m00, m01, m10, m11)."""
    c = coeffs(sigma)
    a = np.array([[-c["b1"], -c["b2"]], [1.0, 0.0]], np.float64)
    m = np.linalg.matrix_power(a, length)
    return [float(np.float32(v)) for v in m.reshape(-1)]


def scan_powers(sigma: float, chunk: int, g: Geometry) -> List[List[float]]:
    """The chunk scan's matrices: ``A**chunk`` for a lane's fold, then
    ``A**(chunk * per_lane * d)`` for the lane scan's steps d = 1, 2, 4,
    ... below ``lanes``."""
    out = [companion_power(sigma, chunk)]
    d = 1
    while d < g.lanes:
        out.append(companion_power(sigma, chunk * g.per_lane * d))
        d *= 2
    return out


def feedback_l1(sigma: float) -> float:
    """sum |g| of the feedback's impulse response, in double (the same
    for the causal and the anticausal recurrence)."""
    c = coeffs(sigma)
    b1, b2 = c["b1"], c["b2"]
    g1, g2, total, i = 1.0, 0.0, 1.0, 1
    while True:
        g = -b1 * g1 - b2 * g2
        total += abs(g)
        g1, g2, i = g, g1, i + 1
        if abs(g1) + abs(g2) < 1e-18 * total and i > 4:
            return total


def error_bound(sigma: float, xmax: float, c: float = BOUND_C) -> float:
    """The bound on |y - y64| of one pass: ``c * 2**-24 * (sum|g_causal|
    + sum|g_anti|) * max|x|``."""
    return c * 2.0 ** -24 * 2.0 * feedback_l1(sigma) * float(xmax)


def _advance(m: List[float], t1, t2, e1, e2):
    """``M @ (t1, t2) + (e1, e2)``, each product and sum rounded in the
    kernel's order."""
    return (m[0] * t1 + m[1] * t2) + e1, (m[2] * t1 + m[3] * t2) + e2


def _chunk_scan(e1, e2, mats: List[List[float]], g: Geometry, reverse: bool):
    """The scan over a segment's chunks (dim 0) as the kernel's lanes run
    it. ``e``: each chunk's end state from a zero start (the first chunk's,
    in the scan's direction, from its true start). Each of ``g.lanes``
    lanes folds ``g.per_lane`` consecutive chunks (zeros past the last),
    the lanes scan their folds in log2(lanes) steps, and each lane walks
    its chunks again from the state before it. Returns (the true start
    state of each chunk, zeros for the first; the last chunk's true end
    state)."""
    kk, r = e1.shape
    pl, ln = g.per_lane, g.lanes
    pad = lambda e: torch.cat([e.flip(0) if reverse else e,
                               e.new_zeros(ln * pl - kk, r)]).view(ln, pl, r)
    e1, e2 = pad(e1), pad(e2)
    m = mats[0]
    f1, f2 = e1[:, 0], e2[:, 0]
    for i in range(1, pl):
        f1, f2 = _advance(m, f1, f2, e1[:, i], e2[:, i])
    d, step = 1, 1
    while d < ln:
        o1, o2 = _advance(mats[step], f1[:-d], f2[:-d], f1[d:], f2[d:])
        f1, f2 = torch.cat([f1[:d], o1]), torch.cat([f2[:d], o2])
        d, step = 2 * d, step + 1
    s1 = torch.cat([f1.new_zeros(1, r), f1[:-1]])
    s2 = torch.cat([f2.new_zeros(1, r), f2[:-1]])
    in1, in2 = torch.empty_like(e1), torch.empty_like(e2)
    ends1, ends2 = torch.empty_like(e1), torch.empty_like(e2)
    for i in range(pl):
        in1[:, i], in2[:, i] = s1, s2
        s1, s2 = _advance(m, s1, s2, e1[:, i], e2[:, i])
        ends1[:, i], ends2[:, i] = s1, s2
    in1[0, 0], in2[0, 0] = 0.0, 0.0
    last = divmod(kk - 1, pl)
    unpad = lambda t: t.reshape(ln * pl, r)[:kk].flip(0) if reverse else \
        t.reshape(ln * pl, r)[:kk]
    return unpad(in1), unpad(in2), ends1[last], ends2[last]


def _segment(xm, start: int, seff: int, chunk: int, c, g: Geometry, mats, pw,
             init_c, init_a, final: bool):
    """One segment of the chunked order on lines ``xm`` (n, R): the zero-
    state runs (the first chunk causal and the last anticausal from
    ``init_c`` / ``init_a``) summed, the chunk scans, then, if ``final``,
    each chunk's sum plus the two start states carried in by ``pw``.
    Returns (output (seff, R) or None, causal end state, anticausal end
    state)."""
    n = xm.shape[0]
    kk = -(-seff // chunk)
    ar = torch.arange(kk * chunk, device=xm.device)
    pos = start + ar
    valid = (ar < seff).view(kk, chunk, 1)
    at = lambda d: xm[(pos + d).clamp(0, n - 1)].view(kk, chunk, -1)
    x, xm1, xp1, xp2 = at(0), at(-1), at(1), at(2)
    a0, a1, a2, a3, b1, b2 = (c[k] for k in KEYS[:6])

    def starts(first, init):
        s1, s2 = torch.zeros_like(x[:, 0]), torch.zeros_like(x[:, 0])
        s1[first], s2[first] = init
        return s1, s2

    zc = torch.empty_like(x)
    y1, y2 = starts(0, init_c)
    for j in range(chunk):
        yc = ((a0 * x[:, j] + a1 * xm1[:, j]) - b1 * y1) - b2 * y2
        v = valid[:, j]
        y2, y1 = torch.where(v, y1, y2), torch.where(v, yc, y1)
        zc[:, j] = yc
    w = torch.empty_like(x)
    z1, z2 = starts(kk - 1, init_a)
    for j in range(chunk - 1, -1, -1):
        yc = ((a2 * xp1[:, j] + a3 * xp2[:, j]) - b1 * z1) - b2 * z2
        v = valid[:, j]
        z2, z1 = torch.where(v, z1, z2), torch.where(v, yc, z1)
        w[:, j] = zc[:, j] + yc
    ic1, ic2, end_c1, end_c2 = _chunk_scan(y1, y2, mats, g, reverse=False)
    ia1, ia2, end_a1, end_a2 = _chunk_scan(z1, z2, mats, g, reverse=True)
    if not final:
        return None, (end_c1, end_c2), (end_a1, end_a2)
    ia1[kk - 1], ia2[kk - 1] = 0.0, 0.0
    p0, p1 = pw[:, 0].view(1, chunk, 1), pw[:, 1].view(1, chunk, 1)
    q0, q1 = pw.flip(0)[:, 0].view(1, chunk, 1), pw.flip(0)[:, 1].view(1, chunk, 1)
    hc = p0 * ic1.unsqueeze(1) + p1 * ic2.unsqueeze(1)
    ha = q0 * ia1.unsqueeze(1) + q1 * ia2.unsqueeze(1)
    out = ((w + hc) + ha).reshape(kk * chunk, -1)[:seff]
    return out, (end_c1, end_c2), (end_a1, end_a2)


def response_table(sigma: float, chunk: int) -> torch.Tensor:
    """(chunk, 2) fp32: row j is row 0 of ``A**(j+1)``: output j of a
    chunk from the start state it is given."""
    return torch.tensor([companion_power(sigma, d)[:2] for d in range(1, chunk + 1)],
                        dtype=torch.float32)


def deriche_axis_chunked(x: torch.Tensor, sigma: float, axis: int, chunk: int = CHUNK,
                         max_chunks: Optional[int] = None) -> torch.Tensor:
    """The kernel's order in plain torch (fp32, no contraction): per
    segment of ``geometry``, each chunk of ``chunk`` elements run in both
    directions from a zero state (the line's first chunk causal and last
    chunk anticausal from their true starts) and summed; the chunks' end
    states scanned as the kernel's lanes scan them; then each element plus
    what its chunk's two true start states add (``response_table``). Over
    several segments a carry pass first, whose segment end states are
    composed with ``A**segment``. Not on any product path: the tests and
    chip_smoke hold the kernel and the float64 loop against it."""
    c = coeffs(sigma)
    xm = x.movedim(axis, 0)
    shape = xm.shape
    xm = xm.reshape(shape[0], -1)
    n = shape[0]
    g = geometry(n, axis, chunk, max_chunks)
    seg, nseg = g.segment, g.segments
    mats = scan_powers(sigma, chunk, g)
    pw = response_table(sigma, chunk).to(xm.device)
    zero = (torch.zeros_like(xm[0]), torch.zeros_like(xm[0]))
    first = c["coefp"] * xm[0]
    last = c["coefn"] * xm[n - 1]
    bounds = [(s * seg, min(seg, n - s * seg)) for s in range(nseg)]
    into_c = [(first, first)] + [zero] * (nseg - 1)
    into_a = [zero] * (nseg - 1) + [(last, last)]
    run = lambda s, final: _segment(xm, *bounds[s], chunk, c, g, mats, pw, into_c[s],
                                    into_a[s], final)
    if nseg > 1:  # the carry pass, then each segment's true start state
        ms = companion_power(sigma, seg)
        ends = [run(s, False)[1:] for s in range(nseg)]
        for s in range(1, nseg):
            t = ends[0][0]
            for u in range(1, s):
                t = _advance(ms, *t, *ends[u][0])
            into_c[s] = t
        for s in range(nseg - 2, -1, -1):
            t = ends[nseg - 1][1]
            for u in range(nseg - 2, s, -1):
                t = _advance(ms, *t, *ends[u][1])
            into_a[s] = t
    outs = [run(s, True)[0] for s in range(nseg)]
    return torch.cat(outs).reshape(shape).movedim(0, axis)


@functools.lru_cache(maxsize=256)
def launch_plan(n: int, axis: int, sigma: float, chunk: int = CHUNK):
    """(``geometry``, the kernel's floats) of a pass over lines of ``n``:
    the coefficients, ``A**segment`` (zeros for one segment), the five
    scan matrices (``scan_powers``, zeros past the last) and
    ``response_table``. Host math, cached."""
    g = geometry(n, axis, chunk)
    floats = [coeffs(sigma)[key] for key in KEYS]
    floats += companion_power(sigma, g.segment) if g.segments > 1 else [0.0] * 4
    mats = scan_powers(sigma, chunk, g)
    floats += sum(mats, []) + [0.0] * 4 * (6 - len(mats))
    floats += response_table(sigma, chunk).reshape(-1).tolist()
    return g, (ctypes.c_float * len(floats))(*floats)


def launch(lib, x: torch.Tensor, out: torch.Tensor, axis: int, plan) -> int:
    """Launch ``lib``'s ``deriche_launch`` for ``plan`` (``launch_plan``):
    the carry pass first where a line has several segments. Returns the
    launches made."""
    p, h, w = x.shape
    g, floats = plan
    carry = None
    if g.segments > 1:  # each (line, segment)'s causal and anticausal end states
        carry = torch.empty((p * (w if axis == 1 else h), g.segments, 4), device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    modes = (CARRY, MAIN) if g.segments > 1 else (MAIN,)
    for mode in modes:
        with _build.on_device(x):
            err = lib.deriche_launch(x.data_ptr(), out.data_ptr(),
                                     None if carry is None else carry.data_ptr(), p, h, w,
                                     axis, *g, mode, floats, len(floats), stream)
        _build.check(err, "deriche")
    return len(modes)


def deriche_axis(x: torch.Tensor, sigma: float, axis: int,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The Deriche blur of (P, H, W) fp32 along ``axis`` (1: H, 2: W).
    ``out`` (CUDA only): buffer for the result, distinct from x."""
    if axis not in (1, 2):
        raise ValueError(f"deriche_axis: axis must be 1 (H) or 2 (W), got {axis}")
    if x.device.type == "cpu":
        return deriche_axis_reference(x, sigma, axis)
    if x.device.type != "cuda":
        raise ValueError(f"deriche_axis: unsupported device {x.device}")
    if x.dim() != 3 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"deriche_axis: need contiguous fp32 (P, H, W), got "
                         f"{x.dtype} {tuple(x.shape)}")
    if out is None:
        out = torch.empty_like(x)
    elif (out.shape != x.shape or out.dtype != torch.float32
          or not out.is_contiguous() or out.device != x.device):
        raise ValueError("deriche_axis: out must match x")
    if out.data_ptr() == x.data_ptr():
        raise ValueError("deriche_axis: out must not alias x")
    plan = launch_plan(x.shape[axis], axis, float(sigma))
    n = launch(_build.library("deriche", _SIG), x, out, axis, plan)
    global launches
    with _build.COUNT_LOCK:
        launches += n
    return out


def deriche_blur(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """G'MIC's fast-approximation blur of (P, H, W): along H, then W."""
    return deriche_axis(deriche_axis(x, sigma, 1), sigma, 2)
