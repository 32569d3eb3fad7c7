"""Tensor (model) parallelism: each conv's output channels split over
devices.

Counterpart of ``nind_denoise_tpu/parallel/tensor_parallel.py``. JAX
shards every weight whose output dimension divides the mesh and lets GSPMD
insert the collectives; here:

* ``shard_params_tp`` copies the model to the first device (its home) and
  puts, in place of each conv whose output channels divide the device
  count, a ``TPConv`` that holds one slice of the weight and bias a device
  (JAX's ``_leaf_spec`` rule; the other convs, such as UtNet's final
  3-channel one, stay whole on the home device, which is replication with
  one copy that computes). Activations live on the home device;
* a ``TPConv`` sends its (full) input to every device, each computes its
  slice of the output channels, and the slices come back to the home
  device in order: the next conv gathers its input there.
* UtNet's level 1 (``convs1``) stays whole, so it stays one K2 launch with
  its weights replicated: K2 fuses both level-1 convs, and c1 needs all 64
  channels of c0.

As in JAX this is the weight-memory tool (wide variants); for whole-image
activations ``parallel/spatial`` divides the memory instead.
"""

from __future__ import annotations

import copy
from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from . import mesh

# UtNet's fused level 1 (kernel K2) keeps its weights whole
KEEP_WHOLE = ("convs1",)


def make_model_devices(n=None, device=None):
    """The device list of ``n`` (``parallel/mesh.make_devices``)."""
    return mesh.make_devices(n, device)


def splits(out_channels: int, n_shards: int) -> bool:
    """Output-channel sharding where the count divides the shards, else the
    conv stays whole."""
    return out_channels % n_shards == 0


class TPConv(nn.Module):
    """A ``Conv2d`` / ``ConvTranspose2d`` with its output channels split
    over ``devices``."""

    def __init__(self, conv: nn.Module, devices: Sequence[torch.device]):
        super().__init__()
        self.transposed = isinstance(conv, nn.ConvTranspose2d)
        self.devices = list(devices)
        n = len(self.devices)
        dim = 1 if self.transposed else 0  # ConvTranspose2d is (in, out, kh, kw)
        ws = conv.weight.detach().chunk(n, dim)
        bs = conv.bias.detach().chunk(n) if conv.bias is not None else [None] * n
        self.kw = dict(stride=conv.stride, padding=conv.padding, dilation=conv.dilation,
                       groups=conv.groups)
        if self.transposed:
            self.kw["output_padding"] = conv.output_padding
        for k, (w, b, d) in enumerate(zip(ws, bs, self.devices)):
            self.register_buffer(f"w{k}", w.to(d).contiguous())
            self.register_buffer(f"b{k}", None if b is None else b.to(d).contiguous())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        op = F.conv_transpose2d if self.transposed else F.conv2d
        outs = [op(x.to(d), getattr(self, f"w{k}"), getattr(self, f"b{k}"), **self.kw)
                for k, d in enumerate(self.devices)]
        return torch.cat([o.to(x.device) for o in outs], 1)


def shard_params_tp(model: nn.Module, devices: Sequence) -> nn.Module:
    """A copy of ``model`` on ``devices[0]`` with every conv whose output
    channels divide ``len(devices)`` (outside ``KEEP_WHOLE``) split by
    output channel over ``devices``; eval mode, no gradients."""
    devices = [torch.device(d) for d in devices]
    m = copy.deepcopy(model).to(devices[0]).eval().requires_grad_(False)
    n = len(devices)
    for name, mod in list(m.named_modules()):
        if (isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d))
                and not name.startswith(KEEP_WHOLE) and splits(mod.out_channels, n)):
            parent, _, leaf = name.rpartition(".")
            setattr(m.get_submodule(parent) if parent else m, leaf, TPConv(mod, devices))
    return m


def tp_forward(model_tp: nn.Module) -> Callable[[torch.Tensor], torch.Tensor]:
    """The forward of a ``shard_params_tp`` model: NCHW in (moved to the
    home device), NCHW out on the home device, under inference mode."""
    home = next(model_tp.parameters()).device

    def fn(x: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return model_tp(x.to(home))

    return fn
