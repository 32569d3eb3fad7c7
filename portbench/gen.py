"""Seeded weights and inputs, made on the device in a few large calls.

Everything a run feeds the program and the reference is drawn here from
``--seed``: one ``torch.Generator`` on the run's device a stream. The same
seed on the same device gives the same values, so a run regenerates what
it needs for its check after the window instead of holding a copy.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from .reference import nets

STREAM_WEIGHTS, STREAM_PHOTOS, STREAM_PAIRS, STREAM_ORDER = 1, 2, 3, 4


def generator(device, seed: int, stream: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % (2 ** 63 - 1))
    return g


def host_rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % 2 ** 63, stream])


# How each kind of leaf is drawn: uniform in centre +- half_width, where
# half_width = gain * sqrt(3 / fan_in) for convolutions (He's uniform init,
# gain sqrt(2 / (1 + a^2)) for PReLU's a = 0.25, sqrt(2) for ReLU) so the
# signal keeps its scale through the depth. The last 1x1 convolution is
# linear and centres the image at 0.5; its gain keeps the seeded image's
# spread near 0.15 (UtNet's features reach it four times wider than
# UNet's, whose sigmoid bounds it anyway).
PRELU_GAIN = math.sqrt(2.0 / (1.0 + 0.25 ** 2))
RELU_GAIN = math.sqrt(2.0)
LAST_GAIN = {"UtNet": 0.15, "UNet": 1.0}


def _fan_in(shape, kind: str) -> int:
    if kind == "conv":
        return shape[1] * shape[2] * shape[3]
    # transposed: a 2x2 stride-2 up-conv gives each output one input pixel
    # a channel; a stride-1 3x3 one, nine
    k = shape[2] * shape[3]
    return shape[0] * (1 if k == 4 else k)


def _leaf_law(network: str, name: str, shape, kind: str, last: str):
    """(centre, half width) of a leaf's uniform law."""
    if kind in ("conv", "conv_t"):
        gain = (LAST_GAIN[network] if name == last
                else PRELU_GAIN if network == "UtNet" else RELU_GAIN)
        return 0.0, gain * math.sqrt(3.0 / _fan_in(shape, kind))
    if kind == "bias":
        return (0.5, 0.02) if name == last.replace(".weight", ".bias") else (0.0, 0.02)
    if kind == "prelu":
        return 0.25, 0.05
    if kind == "bn_weight":
        return 1.0, 0.1
    if kind == "bn_bias":
        return 0.0, 0.05
    raise ValueError(kind)


def weights(network: str, funit, dtype: torch.dtype, device, seed: int
            ) -> Dict[str, torch.Tensor]:
    """Every parameter of ``network`` (the reference's state-dict names),
    in ``dtype`` on ``device``, from one uniform draw; a UNet also gets its
    BatchNorm buffers (running mean 0, variance 1)."""
    shapes = nets.param_shapes(network, funit)
    last = [n for n, _, k in shapes if k in ("conv", "conv_t")][-1]
    sizes = [math.prod(s) for _, s, _ in shapes]
    laws = torch.tensor([_leaf_law(network, n, s, k, last) for n, s, k in shapes],
                        dtype=torch.float32, device=device)
    counts = torch.tensor(sizes, device=device)
    centre = torch.repeat_interleave(laws[:, 0], counts)
    half = torch.repeat_interleave(laws[:, 1], counts)
    u = torch.rand(sum(sizes), generator=generator(device, seed, STREAM_WEIGHTS),
                   device=device, dtype=torch.float32)
    flat = ((u * 2 - 1) * half + centre).to(dtype)
    out, at = {}, 0
    for (name, shape, _), n in zip(shapes, sizes):
        out[name] = flat[at:at + n].view(shape)
        at += n
    if network == "UNet":
        out.update(nets.unet_buffers(device))
    return out


def _field(n: int, h: int, w: int, cells: int, g, device) -> torch.Tensor:
    """(n, 3, h, w) smooth random field in [0, 1]: ``cells`` control points
    along the longer side, bicubic in between."""
    ch, cw = max(2, round(cells * h / max(h, w))), max(2, round(cells * w / max(h, w)))
    coarse = torch.rand((n, 3, ch, cw), generator=g, device=device)
    return F.interpolate(coarse, size=(h, w), mode="bicubic", align_corners=False).clamp_(0, 1)


def photos(traffic: dict, device, seed: int) -> List[np.ndarray]:
    """The traffic's pool of images: 16-bit HWC arrays in host memory, as a
    decoder hands them over. Image i is (h, w) of ``shape``, turned to
    portrait when i % ``portrait_every`` == ``portrait_every`` - 1; a
    smooth scene (``scene_cells`` control points), finer texture
    (``texture_cells``) and Gaussian noise of ``noise_sigmas[i % len]``."""
    g = generator(device, seed, STREAM_PHOTOS)
    h0, w0 = traffic["shape"]
    every = traffic.get("portrait_every", 0)
    sigmas = traffic["noise_sigmas"]
    out = []
    for i in range(traffic["pool"]):
        h, w = (w0, h0) if every and i % every == every - 1 else (h0, w0)
        scene = _field(1, h, w, traffic["scene_cells"], g, device)
        texture = _field(1, h, w, traffic["texture_cells"], g, device)
        noise = torch.randn((1, 3, h, w), generator=g, device=device)
        img = (0.1 + 0.75 * scene + 0.15 * (texture - 0.5) + sigmas[i % len(sigmas)] * noise)
        # C-contiguous HWC, as a decoder hands pixels over
        q = torch.round(img.clamp_(0, 1) * 65535).to(torch.int32)[0].permute(1, 2, 0).contiguous()
        out.append(q.cpu().numpy().astype(np.uint16))
    return out


def pairs(traffic: dict, cs: int, device, seed: int, chunk: int = 512):
    """(clean, noisy): ``traffic['pool']`` crops of cs x cs, float16 NHWC
    on the device; clean a smooth scene with texture, noisy it plus
    Gaussian noise of a sigma drawn per pair in ``noise_sigma_range``."""
    g = generator(device, seed, STREAM_PAIRS)
    n = traffic["pool"]
    lo, hi = traffic["noise_sigma_range"]
    clean = torch.empty((n, cs, cs, 3), dtype=torch.float16, device=device)
    noisy = torch.empty_like(clean)
    for a in range(0, n, chunk):
        b = min(n, a + chunk)
        scene = _field(b - a, cs, cs, traffic["scene_cells"], g, device)
        texture = _field(b - a, cs, cs, traffic["texture_cells"], g, device)
        c = (0.1 + 0.75 * scene + 0.15 * (texture - 0.5)).clamp_(0, 1)
        sigma = lo + (hi - lo) * torch.rand((b - a, 1, 1, 1), generator=g, device=device)
        nz = (c + sigma * torch.randn(c.shape, generator=g, device=device)).clamp_(0, 1)
        clean[a:b] = c.permute(0, 2, 3, 1)
        noisy[a:b] = nz.permute(0, 2, 3, 1)
    return clean, noisy


def order(n_pool: int, batch: int, steps: int, device, seed: int) -> torch.Tensor:
    """(steps, batch) pool rows: consecutive slices of seeded permutations
    of the pool, a new permutation each time one runs out, so rows within
    a pass never repeat."""
    g = generator(device, seed, STREAM_ORDER)
    need = steps * batch
    perms = [torch.randperm(n_pool, generator=g, device=device)
             for _ in range(-(-need // n_pool))]
    return torch.cat(perms)[:need].view(steps, batch)
