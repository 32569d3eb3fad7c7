"""The benchmark's arithmetic: the chip's peaks, operation counts and
bounds, percentiles and leaf gaps.

Peaks: NVIDIA's H100 SXM data sheet, dense rates without sparsity, at the
card's full 700 W power limit; a run reports the card's own limit beside
them (``device.power_limit_w``).

Operation counts come from ``torch.utils.flop_counter.FlopCounterMode``
over the benchmark's own plain reference (``reference/``) on the meta
device: no data and no card. A bound is the larger of the bytes over the
memory bandwidth and the operations over the type's peak, each input byte
read once and each output byte written once.
"""

from __future__ import annotations

import functools
import statistics
from typing import Dict, Iterable, Sequence, Tuple

PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12, "int8": 1979e12}
PEAK_BYTES = 3.35e12  # HBM3, bytes/s


def bound_s(nbytes: float, flops: float, dtype: str) -> Tuple[float, str]:
    """(least seconds, 'bytes' or 'operations')."""
    b, o = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dtype]
    return max(b, o), ("bytes" if b >= o else "operations")


def _count(fn) -> int:
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def _meta_weights(network: str, funit):
    import torch

    from .reference import nets

    return {name: torch.empty(shape, device="meta")
            for name, shape, _ in nets.param_shapes(network, funit)}


@functools.lru_cache(maxsize=None)
def forward_flops(network: str, funit, batch: int, cs: int) -> int:
    """Operations of one forward of ``batch`` tiles of cs x cs."""
    import torch

    from .reference import nets

    p = _meta_weights(network, funit)
    if network == "UNet":
        p.update({k: v.to("meta") for k, v in nets.unet_buffers().items()})
    x = torch.empty((batch, 3, cs, cs), device="meta")
    with torch.no_grad():
        return _count(lambda: nets.forward(network, p, x))


@functools.lru_cache(maxsize=None)
def train_step_flops(network: str, funit, batch: int, cs: int, loss_weights: tuple,
                     loss_cs: int) -> int:
    """Operations of one training step's forward, loss and backward
    (AMSGrad's elementwise update is not counted)."""
    import torch

    from .reference import nets
    from .reference import train as rt

    p = {k: v.requires_grad_() for k, v in _meta_weights(network, funit).items()}
    clean = torch.empty((batch, 3, cs, cs), device="meta")
    noisy = torch.empty((batch, 3, cs, cs), device="meta")

    def step():
        out = nets.forward(network, p, noisy, train=True)
        rt.loss(out, clean, dict(loss_weights), loss_cs).backward()

    return _count(step)


def enc1_level1(batch: int, h: int, w: int, funit: int = 64) -> Tuple[float, float]:
    """(operations, bytes) of UtNet's fused level 1 (kernel K2) on a
    (batch, 3, h + 4, w + 4) bf16 input: c0 (3 -> funit, 3x3) over
    (h + 2) x (w + 2), c1 (funit -> funit, 3x3) over h x w, two operations
    a multiply-add; bytes of the input, l1, the pooled l1 and the weights."""
    flops = 2.0 * batch * h * w * funit * funit * 9 + 2.0 * batch * (h + 2) * (w + 2) * funit * 27
    nbytes = 2.0 * (batch * 3 * (h + 4) * (w + 4) + batch * funit * h * w
                    + batch * funit * (h // 2) * (w // 2) + funit * 27 + funit * funit * 9)
    return flops, nbytes


def rl_iteration(planes: int, h: int, w: int, radius: int) -> Tuple[float, float]:
    """(operations, bytes) of one fused Richardson-Lucy iteration (kernel
    K1) on float32 planes: u and d read, the new u written (12 bytes a
    pixel); two blurs of 2R+1 taps a direction and the ratio and product
    (8(2R+1) + 3 operations a pixel)."""
    n = float(planes) * h * w
    return n * (8 * (2 * radius + 1) + 3), 12.0 * n


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0-100), linear between order statistics."""
    v = sorted(values)
    if not v:
        raise ValueError("percentile of nothing")
    k = (len(v) - 1) * q / 100.0
    lo = int(k)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (k - lo)


def leaf_gaps(got: Dict[str, float], ref: Dict[str, float],
              keep: Iterable[str] = None) -> Dict[str, float]:
    """Each leaf's |got - ref| / max(ref, the median leaf's ref), where
    got and ref are the leaves' norms."""
    names = list(keep) if keep is not None else list(ref)
    med = statistics.median(ref[k] for k in names)
    return {k: abs(got[k] - ref[k]) / max(ref[k], med, 1e-30) for k in names}


def worst_leaf_gap(got: Dict[str, float], ref: Dict[str, float],
                   keep: Iterable[str] = None) -> Tuple[float, str]:
    """The largest of ``leaf_gaps``: (gap, leaf)."""
    gaps = leaf_gaps(got, ref, keep)
    at = max(gaps, key=gaps.get)
    return gaps[at], at

