"""The legacy denoisers DnCNN and RedCNN as ``nn.Module``s: the
counterparts of ``nind_denoise_tpu/models/legacy.py``.

* ``DnCNN(depth=22, n_channels=64)``: a 3x3 conv (bias) and ReLU, then
  ``depth - 2`` times a 3x3 conv without bias, BatchNorm (eps 1e-4,
  momentum 0.95) and ReLU, then a 3x3 conv without bias; ``find_noise``
  returns ``x - out`` (residual learning). One ``nn.Sequential`` under
  ``dncnn``, so the state_dict names are ``dncnn.<index>.<param>``.
* ``RedCNN(n_channels=128, depth=30)``: an encoder of VALID 5x5 convs and a
  decoder of 5x5 transposed convs with additive skips from the encoder.
  ``conv`` and ``deconv`` are single modules applied at every depth step:
  the weights are tied across the steps, as in the reference.

Both are registry / inference networks: the trainer and the front ends
refuse them as the JAX package's do.
"""

from __future__ import annotations

import torch
from torch import nn


class DnCNN(nn.Module):
    def __init__(self, depth: int = 22, n_channels: int = 64, image_channels: int = 3,
                 find_noise: bool = True):
        super().__init__()
        self.find_noise = find_noise
        layers = [nn.Conv2d(image_channels, n_channels, 3, padding=1), nn.ReLU()]
        for _ in range(depth - 2):
            layers += [nn.Conv2d(n_channels, n_channels, 3, padding=1, bias=False),
                       nn.BatchNorm2d(n_channels, eps=1e-4, momentum=0.95), nn.ReLU()]
        layers.append(nn.Conv2d(n_channels, image_channels, 3, padding=1, bias=False))
        self.dncnn = nn.Sequential(*layers)

    @staticmethod
    def config_of(sd) -> dict:
        """Constructor arguments of a state_dict."""
        w = sd["dncnn.0.weight"]
        convs = sum(k.startswith("dncnn.") and k.endswith(".weight") and len(sd[k].shape) == 4
                    for k in sd)
        return {"depth": convs, "n_channels": int(w.shape[0]), "image_channels": int(w.shape[1])}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.dncnn(x)
        return x - out if self.find_noise else out


class RedCNN(nn.Module):
    def __init__(self, n_channels: int = 128, image_channels: int = 3, kernel_size: int = 5,
                 depth: int = 30):
        super().__init__()
        self.depth = depth
        k = kernel_size
        self.conv_first = nn.Conv2d(image_channels, n_channels, k)
        self.conv = nn.Conv2d(n_channels, n_channels, k)
        self.deconv = nn.ConvTranspose2d(n_channels, n_channels, k)
        self.deconv_last = nn.ConvTranspose2d(n_channels, image_channels, k)

    @staticmethod
    def config_of(sd, depth: int = 30) -> dict:
        """Constructor arguments of a state_dict (the depth is not in it)."""
        w = sd["conv_first.weight"]
        return {"n_channels": int(w.shape[0]), "image_channels": int(w.shape[1]),
                "kernel_size": int(w.shape[-1]), "depth": depth}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        relu = torch.relu
        steps = (self.depth - 6) // 2
        t = relu(self.conv_first(x))
        t = relu(self.conv(t))
        residuals = [t]
        for _ in range(steps):
            t = relu(self.conv(relu(self.conv(t))))
            residuals.append(t)
        t = relu(self.deconv(relu(self.conv(t))))
        t = relu(t + residuals.pop())
        for _ in range(steps):
            t = relu(self.deconv(relu(self.deconv(t))))
            t = relu(t + residuals.pop())
        t = relu(self.deconv(t))
        return relu(self.deconv_last(t))
