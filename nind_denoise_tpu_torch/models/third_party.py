"""The torchvision segmentation experiments: the counterpart of
``nind_denoise_tpu/models/third_party.py`` (the reference's
ThirdPartyNets.py:171-187).

``MobileNetV3`` is torchvision's ``lraspp_mobilenet_v3_large`` with both
LR-ASPP classifiers 3-channel 1x1 convs (low 40 -> 3, high 128 -> 3), in
plain torch with torchvision's module names, so its state_dict is
torchvision's (``backbone.<i>.block.<j>.<k>``, ``classifier.cbr``,
``classifier.scale.1``, ``classifier.{low,high}_classifier``), and the
reference wrapper's ``.pt`` (the same under ``net.``) maps through
``params_io``. Neither torchvision nor its weights are needed.

* stem Conv2d(3, 16, 3, s2, p1, no bias) + BN (eps 1e-3) + Hardswish;
* 15 inverted-residual blocks of the MobileNetV3-Large table, the last
  stage dilated (dilation 2 forces stride 1), each an expand 1x1 (where
  the width grows), a depthwise kxk, squeeze-and-excitation (avgpool ->
  1x1 to ``make_divisible(exp // 4)`` -> ReLU -> 1x1 -> Hardsigmoid,
  multiplicative) where the table says, and a project 1x1 without
  activation; a residual add at stride 1 where the width stays;
* ``backbone.16``: a 1x1 160 -> 960 + BN + Hardswish; the low tap is the
  output of ``backbone.4`` (40 channels, stride 8);
* the LR-ASPP head: ``cbr`` 1x1 960 -> 128 + BN (eps 1e-5) + ReLU times
  ``scale`` (global average pool, 1x1 960 -> 128, sigmoid), resized
  bilinearly to the low tap, ``low_classifier(low) + high_classifier(x)``,
  resized to the input (``align_corners=False`` both times).

It runs in eval mode only (running stats), at upstream's support level
(pretrained inference): a train-mode forward raises NotImplementedError,
as the JAX package's does. ``deeplabv3_resnet101`` raises
NotImplementedError when built, as upstream's forward and the JAX
package's ``init`` do.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def make_divisible(v: float, divisor: int = 8) -> int:
    """torchvision.models._utils._make_divisible."""
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


# MobileNetV3-Large inverted-residual table, segmentation (dilated) variant:
# (kernel, expanded, out, use_se, activation, stride, dilation)
LARGE_DILATED: List[Tuple[int, int, int, bool, str, int, int]] = [
    (3, 16, 16, False, "RE", 1, 1),    # backbone.1
    (3, 64, 24, False, "RE", 2, 1),    # backbone.2, C1
    (3, 72, 24, False, "RE", 1, 1),
    (5, 72, 40, True, "RE", 2, 1),     # backbone.4, C2 -> LR-ASPP "low" tap
    (5, 120, 40, True, "RE", 1, 1),
    (5, 120, 40, True, "RE", 1, 1),
    (3, 240, 80, False, "HS", 2, 1),   # C3
    (3, 200, 80, False, "HS", 1, 1),
    (3, 184, 80, False, "HS", 1, 1),
    (3, 184, 80, False, "HS", 1, 1),
    (3, 480, 112, True, "HS", 1, 1),
    (3, 672, 112, True, "HS", 1, 1),
    (5, 672, 160, True, "HS", 2, 2),   # C4; dilation > 1 forces stride 1
    (5, 960, 160, True, "HS", 1, 2),
    (5, 960, 160, True, "HS", 1, 2),
]
LOW_TAP = 4          # the backbone index whose output is the LR-ASPP low input
BN_EPS_BACKBONE = 1e-3   # torchvision's norm_layer eps=0.001
BN_EPS_HEAD = 1e-5       # LRASPPHead's default BatchNorm2d


def _act(name: str) -> nn.Module:
    return nn.ReLU() if name == "RE" else nn.Hardswish()


def conv_bn(cin: int, cout: int, k: int = 1, stride: int = 1, dilation: int = 1,
            groups: int = 1, act=None, eps: float = BN_EPS_BACKBONE) -> nn.Sequential:
    """torchvision's Conv2dNormActivation: conv (padding (k - 1) // 2 *
    dilation, no bias), BatchNorm, the activation module if any."""
    layers = [nn.Conv2d(cin, cout, k, stride, (k - 1) // 2 * dilation, dilation, groups,
                        bias=False),
              nn.BatchNorm2d(cout, eps=eps)]
    if act is not None:
        layers.append(act)
    return nn.Sequential(*layers)


class SqueezeExcitation(nn.Module):
    def __init__(self, channels: int, squeeze: int):
        super().__init__()
        self.fc1 = nn.Conv2d(channels, squeeze, 1)
        self.fc2 = nn.Conv2d(squeeze, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = F.adaptive_avg_pool2d(x, 1)
        return x * F.hardsigmoid(self.fc2(F.relu(self.fc1(s))))


class InvertedResidual(nn.Module):
    def __init__(self, cin: int, k: int, exp: int, cout: int, use_se: bool, act: str,
                 stride: int, dilation: int):
        super().__init__()
        stride = 1 if dilation > 1 else stride
        layers = []
        if exp != cin:
            layers.append(conv_bn(cin, exp, act=_act(act)))
        layers.append(conv_bn(exp, exp, k, stride, dilation, exp, _act(act)))
        if use_se:
            layers.append(SqueezeExcitation(exp, make_divisible(exp // 4, 8)))
        layers.append(conv_bn(exp, cout))
        self.block = nn.Sequential(*layers)
        self.residual = stride == 1 and cin == cout

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.block(x)
        return y + x if self.residual else y


class LRASPPHead(nn.Module):
    def __init__(self, low: int = 40, high: int = 960, n_classes: int = 3, inter: int = 128):
        super().__init__()
        self.cbr = conv_bn(high, inter, act=nn.ReLU(), eps=BN_EPS_HEAD)
        self.scale = nn.Sequential(nn.AdaptiveAvgPool2d(1), nn.Conv2d(high, inter, 1, bias=False),
                                   nn.Sigmoid())
        self.low_classifier = nn.Conv2d(low, n_classes, 1)
        self.high_classifier = nn.Conv2d(inter, n_classes, 1)

    def forward(self, low: torch.Tensor, high: torch.Tensor) -> torch.Tensor:
        x = self.cbr(high) * self.scale(high)
        x = F.interpolate(x, size=low.shape[-2:], mode="bilinear", align_corners=False)
        return self.low_classifier(low) + self.high_classifier(x)


class MobileNetV3(nn.Module):
    """LR-ASPP MobileNetV3-Large with 3-channel classifier heads
    (ThirdPartyNets.py:171-179); NCHW in, NCHW out at the input's size."""

    def __init__(self, n_classes: int = 3):
        super().__init__()
        layers = [conv_bn(3, 16, 3, stride=2, act=nn.Hardswish())]
        cin = 16
        for k, exp, cout, use_se, act, s, d in LARGE_DILATED:
            layers.append(InvertedResidual(cin, k, exp, cout, use_se, act, s, d))
            cin = cout
        layers.append(conv_bn(cin, 6 * cin, act=nn.Hardswish()))
        self.backbone = nn.Sequential(*layers)
        self.classifier = LRASPPHead(LARGE_DILATED[LOW_TAP - 1][2], 6 * cin, n_classes)

    @staticmethod
    def config_of(sd) -> dict:
        return {"n_classes": int(sd["classifier.low_classifier.weight"].shape[0])}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(
                "MobileNetV3 is ported at upstream's support level: "
                "pretrained-inference only (eval-mode BatchNorm)")
        t, low = x, None
        for i, layer in enumerate(self.backbone):
            t = layer(t)
            if i == LOW_TAP:
                low = t
        out = self.classifier(low, t)
        return F.interpolate(out, size=x.shape[-2:], mode="bilinear", align_corners=False)


class deeplabv3_resnet101(nn.Module):  # noqa: N801 (the registry's name)
    """ThirdPartyNets.py:181-187 — DeepLabV3-ResNet101 with
    aux_classifier[4] replaced by Conv2d(256,3,1). Upstream's forward
    raises NotImplementedError, and so does this constructor, as the JAX
    package's ``init`` does."""

    def __init__(self, **_ignored):
        raise NotImplementedError(
            "deeplabv3_resnet101 is unimplemented upstream too "
            "(ThirdPartyNets.py:186-187 raises NotImplementedError)")
