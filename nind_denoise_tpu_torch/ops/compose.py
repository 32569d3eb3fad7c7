"""Composed up-convolutions of the int8 UtNet decoder.

Counterpart of ``nind_denoise_tpu/ops/fastconv.py`` ``compose_up3`` and
``up_bias_map``: a decoder level's ``conv3x3_FULL(concat(tconv2x2s2(t),
skip))`` is linear in both branches, so it equals

    lhs_dilated_conv4x4(t, K) + conv3x3_FULL(skip, W_skip) + biasmap

with ``K[a, b] = sum_{u,v} Wup[u, v] @ W3[u-a+2, v-b+2]`` (flipped to
conv form) and ``biasmap`` the field the up-conv bias makes through the
FULL conv's zero padding. The int8 forward (``models/utnet_int8``)
quantizes K and runs the dilated conv through P1. The width folding of
the same module (``fold_w``, ``fold_kernel``) is a TPU layout rewrite and
is not ported.
"""

from __future__ import annotations

import torch


def compose_up3(w_up: torch.Tensor, w3a: torch.Tensor) -> torch.Tensor:
    """``w_up``: the up-conv as the JAX package's matmul matrix (cin,
    4*cmid), column (u*2+v)*cmid + m; ``w3a``: (3, 3, cmid, cout), the
    slice of the 3x3 kernel that reads the up branch. Returns the
    conv-form (flipped) kernel (4, 4, cin, cout) in fp32 for the conv with
    ``lhs_dilation=(2, 2)`` and padding 3. The terms are summed in the JAX
    package's order, u then v."""
    cin = w_up.shape[0]
    cmid = w_up.shape[1] // 4
    cout = w3a.shape[3]
    wu = w_up.to(torch.float32).reshape(cin, 2, 2, cmid)
    w3 = w3a.to(torch.float32)
    k = torch.zeros((4, 4, cin, cout), dtype=torch.float32, device=w_up.device)
    for a in range(4):
        for b in range(4):
            acc = None
            for u in (0, 1):
                for v in (0, 1):
                    i3, j3 = u - a + 2, v - b + 2
                    if 0 <= i3 <= 2 and 0 <= j3 <= 2:
                        term = wu[:, u, v] @ w3[i3, j3]
                        acc = term if acc is None else acc + term
            if acc is not None:
                k[a, b] = acc
    return k.flip(0, 1).contiguous()


def bias_taps(b_up: torch.Tensor, w3a: torch.Tensor) -> torch.Tensor:
    """(3, 3, cout) float64: what the up-conv bias adds through each tap
    of the 3x3 kernel."""
    return torch.einsum("c,ijco->ijo", b_up.to(torch.float64), w3a.to(torch.float64))


def up_bias_map(h2: int, w2: int, taps: torch.Tensor) -> torch.Tensor:
    """The (1, h2+2, w2+2, cout) fp32 field of the up-conv bias through
    the 3x3 FULL conv's zero padding, from ``bias_taps``: at each output
    pixel the sum of the taps whose input lies inside the h2 x w2 plane,
    in float64, rounded once."""
    dev = taps.device

    def inside(n):  # (3, n + 2): tap i of output p reads input p + i - 2
        p = torch.arange(n + 2, device=dev)[None] + torch.arange(3, device=dev)[:, None] - 2
        return ((p >= 0) & (p < n)).to(torch.float64)

    field = torch.einsum("ih,jw,ijo->hwo", inside(h2), inside(w2), taps)
    return field.to(torch.float32)[None]
