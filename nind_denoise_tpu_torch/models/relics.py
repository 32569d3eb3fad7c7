"""The relic network zoo as ``nn.Module``s: the counterpart of
``nind_denoise_tpu/models/relics.py`` (the reference's networks/relics.py).

Nine networks from one block grammar:

* HunNet, HuNet and Hul160Net (alias ``HulNet``): the 160 px dual-branch U
  (standard and dilated conv branches, concatenated skips, two stride-3
  convs and a stride-2 conv down to 1 px, the mirrored transposed-conv
  decoder); HuDisc is its encoder under a sigmoid 1-channel head;
* Hul128Net: the 128 px dense-concat U; Hul144Disc: its 144 px encoder
  with both heads (``decide``, or ``enc4to2pool`` and a global max-pool
  when ``finalpool``), as JAX's tree holds both;
* HunkyDisc: a 256 px conv / BatchNorm / ReLU ladder with max-pools and
  absolute widths; HunkyNet: its residual U, 224 + 16n px, which adds its
  skips and runs pre-activated decoder blocks;
* RedishCNN: a pre-activation residual CNN whose one ``conv``, one
  ``deconv`` and one BatchNorm serve every depth, under a leaky ReLU at
  RReLU's eval slope.

A layer spec is ``(op, cin, cout, bias, post)``. ``op``: ``c3``/``c2``/
``c5`` VALID convs, ``c3d2``/``c3d5`` dilated, ``c3s3``/``c2s2`` strided,
``t3``/``t5`` transposed convs, ``t3d2``/``t3s3`` dilated / strided ones,
``t2s2`` the 2x2 stride-2 up-conv, ``pre`` no conv. Channels are funit
multiples, ``"in"`` the input's and ``("A", n)`` absolute. ``post`` orders
the layer's tail in its ``nn.Sequential``: ``a`` the activation, ``ab`` the
activation then BatchNorm, ``ba`` BatchNorm then the activation,
``sig``/``relu`` the head, ``""`` nothing. Every block is an
``nn.Sequential`` named after it, so the state_dict names are
``<block>.<index>.<param>``. BatchNorm is torch's default (eps 1e-5,
momentum 0.1), as the JAX package's ``norm.apply``. The JAX package
lowers its transposed convs to plain convs over flipped kernels (and the
up-conv to a matmul and a pixel shuffle); here they are
``nn.ConvTranspose2d``, and ``params_io``'s weight maps make the two
compute the same function.

RReLU is the fixed slope 55/240 in train and eval mode, as in the JAX
package (torch's ``nn.RReLU`` draws random slopes in train mode). The
upstream file cannot run (it NameErrors on ``torch.cat`` and ``floor``);
the port follows the JAX package. The discriminators take
``forward(x, frozen=False)``: ``frozen`` is ``models/norm.layer``'s frozen
forward, the cGAN's fooling term.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from . import norm

Chan = Union[int, str, Tuple[str, int]]
Spec = Tuple[str, Chan, Chan, bool, str]

_K = {"c3": 3, "c2": 2, "c5": 5, "c3d2": 3, "c3d5": 3, "c3s3": 3, "c2s2": 2,
      "t3": 3, "t5": 5, "t3d2": 3, "t3s3": 3, "t2s2": 2, "pre": 0}

# torch nn.RReLU() eval-mode slope = (lower + upper) / 2 = (1/8 + 1/3) / 2
RRELU_EVAL_SLOPE = (1.0 / 8 + 1.0 / 3) / 2

# the Sequential slots a layer's post code gives after its conv
_TAIL = {"a": ("act",), "ab": ("act", "bn"), "ba": ("bn", "act"), "sig": ("sigmoid",),
         "relu": ("relu",), "": ()}


def _resolve(c: Chan, funit: int, cin_raw: int) -> int:
    if c == "in":
        return cin_raw
    if isinstance(c, tuple):
        return int(c[1])
    return int(c) * funit


def _dual(c: str, tail: str, cin1, mid) -> List[Spec]:
    """std double-conv block: two convs cin1->mid->mid."""
    return [(c, cin1, mid, False, tail), (c, mid, mid, False, tail)]


def roles(spec: Spec) -> Tuple[str, ...]:
    """The modules of one layer in Sequential order: ``conv`` unless the op
    is ``pre``, then its post code's tail."""
    op, _, _, _, post = spec
    return (() if op == "pre" else ("conv",)) + _TAIL[post]


def layer_slots(plan: Dict[str, List[Spec]]):
    """For every layer of ``plan``: (block, index in the plan, its spec,
    {role: Sequential index}) — the walk the state_dict names follow."""
    for bname, specs in plan.items():
        idx = 0
        for li, spec in enumerate(specs):
            rs = roles(spec)
            yield bname, li, spec, {r: idx + j for j, r in enumerate(rs)}
            idx += len(rs)


def conv_module(op: str, cin: int, cout: int, bias: bool) -> nn.Module:
    """The module of a conv op: ``c``/``t`` (conv / transposed conv), the
    kernel, then ``d<n>`` (dilation) or ``s<n>`` (stride)."""
    kind, k, mod, n = re.fullmatch(r"([ct])(\d)(?:([ds])(\d))?", op).groups()
    kw = {"dilation": int(n)} if mod == "d" else {"stride": int(n)} if mod == "s" else {}
    cls = nn.Conv2d if kind == "c" else nn.ConvTranspose2d
    return cls(cin, cout, int(k), bias=bias, **kw)


def _cat(*ts: torch.Tensor) -> torch.Tensor:
    return torch.cat(ts, dim=1)


class RelicNet(nn.Module):
    """The block-grammar networks. Subclasses set ``plan``, ``act`` and
    ``prelu_init`` and wire the blocks in ``graph(B, x)``, ``B(name, t)``
    running one block."""

    plan: Dict[str, List[Spec]] = {}
    act = "ReLU"
    prelu_init = 0.25
    default_in = 3
    funit = 32

    def __init__(self, funit: Optional[int] = None, input_channels: Optional[int] = None):
        super().__init__()
        funit = type(self).funit if funit is None else int(funit)
        cin_raw = self.default_in if input_channels is None else int(input_channels)
        blocks: Dict[str, list] = {b: [] for b in self.plan}
        for bname, _, spec, slots in layer_slots(self.plan):
            op, cin_c, cout_c, bias, _ = spec
            cin, cout = _resolve(cin_c, funit, cin_raw), _resolve(cout_c, funit, cin_raw)
            for role in slots:
                if role == "conv":
                    blocks[bname].append(conv_module(op, cin, cout, bias))
                elif role == "bn":
                    blocks[bname].append(nn.BatchNorm2d(cout))
                elif role == "act":
                    blocks[bname].append(nn.PReLU(init=self.prelu_init) if self.act == "PReLU"
                                         else nn.ReLU())
                else:
                    blocks[bname].append(nn.Sigmoid() if role == "sigmoid" else nn.ReLU())
        for bname, seq in blocks.items():
            self.add_module(bname, nn.Sequential(*seq))

    @classmethod
    def config_of(cls, sd) -> dict:
        """Constructor arguments of a state_dict, from its first conv (the
        class default funit where the first conv's width is absolute)."""
        first = next(iter(cls.plan))
        w = sd[f"{first}.0.weight"]
        cout = cls.plan[first][0][2]
        funit = int(w.shape[0]) // int(cout) if isinstance(cout, int) else cls.funit
        return {"funit": funit, "input_channels": int(w.shape[1])}

    def graph(self, B, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, x: torch.Tensor, frozen: bool = False) -> torch.Tensor:
        return self.graph(lambda name, t: norm.sequential(getattr(self, name), t, frozen), x)


# ---------------------------------------------------------------------------
# HunNet / HuNet / Hul160Net / HuDisc: the 160 px dual-branch family, one
# graph; they differ in channel plan, activation and BatchNorm placement.
# ---------------------------------------------------------------------------

def _hu_encode(B, x):
    l158 = B("enc160to158std", x)
    l154 = _cat(B("enc158to154std", l158), B("enc158to154dil", l158))
    l150 = _cat(B("enc154to150std", l154), B("enc154to150dil", l154), B("enc160to150dil", x))
    l50 = B("enc150to50str", l150)
    l46 = _cat(B("enc50to46std", l50), B("enc50to46dil", l50))
    l42 = _cat(B("enc46to42std", l46), B("enc46to42dil", l46))
    l14 = B("enc42to14str", l42)
    l10 = _cat(B("enc14to10std", l14), B("enc14to10dil", l14))
    l6 = _cat(B("enc10to6std", l10), B("enc10to6dil", l10))
    l3 = B("enc6to3str", l6)
    return {"l158": l158, "l154": l154, "l150": l150, "l50": l50, "l46": l46, "l42": l42,
            "l14": l14, "l10": l10, "l6": l6, "l3": l3}


def _hu_graph(B, x):
    lv = _hu_encode(B, x)
    l1 = B("enc3to1std", lv["l3"])
    l3 = _cat(lv["l3"], B("dec1to3std", l1))
    l6 = _cat(lv["l6"], B("dec3to6str", l3))
    l10 = _cat(lv["l10"], B("dec6to10std", l6), B("dec6to10dil", l6))
    l14 = _cat(lv["l14"], B("dec10to14std", l10), B("dec10to14dil", l10))
    l42 = _cat(lv["l42"], B("dec14to42str", l14))
    l46 = _cat(lv["l46"], B("dec42to46std", l42), B("dec42to46dil", l42))
    l50 = _cat(lv["l50"], B("dec46to50std", l46), B("dec46to50dil", l46))
    l150 = _cat(lv["l150"], B("dec50to150str", l50))
    l154 = _cat(lv["l154"], B("dec150to154std", l150), B("dec150to154dil", l150))
    l158 = _cat(lv["l158"], B("dec154to158std", l154), B("dec154to158dil", l154))
    return B("dec158to160std", l158)


class HunNet(RelicNet):
    """relics.py:98-429 — ReLU + Conv->BN->ReLU blocks, Sigmoid head."""

    act = "ReLU"
    plan: Dict[str, List[Spec]] = {
        "enc160to158std": [("c3", "in", 4, True, "a")],
        "enc158to154std": _dual("c3", "ba", 4, 3),
        "enc154to150std": _dual("c3", "ba", 6, 4),
        "enc158to154dil": [("c3d2", 4, 3, False, "ba")],
        "enc154to150dil": [("c3d2", 6, 4, False, "ba")],
        "enc160to150dil": [("c3d5", "in", 2, False, "ba")],
        "enc150to50str": [("c3s3", 10, 10, False, "ba")],
        "enc50to46std": _dual("c3", "ba", 10, 5),
        "enc46to42std": _dual("c3", "ba", 10, 8),
        "enc50to46dil": [("c3d2", 10, 5, False, "ba")],
        "enc46to42dil": [("c3d2", 10, 8, False, "ba")],
        "enc42to14str": [("c3s3", 16, 16, False, "ba")],
        "enc14to10std": _dual("c3", "ba", 16, 8),
        "enc10to6std": _dual("c3", "ba", 16, 16),
        "enc14to10dil": [("c3d2", 16, 8, False, "ba")],
        "enc10to6dil": [("c3d2", 16, 16, False, "ba")],
        "enc6to3str": [("c2s2", 32, 32, False, "ba")],
        "enc3to1std": [("c3", 32, 32, False, "ba")],
        "dec1to3std": [("t3", 32, 32, False, "ba")],
        "dec3to6str": [("t2s2", 64, 32, False, "ba")],
        "dec6to10std": [("t3", 64, 8, False, "ba"), ("t3", 8, 8, False, "ba")],
        "dec6to10dil": [("t3d2", 64, 8, False, "ba")],
        "dec10to14std": [("t3", 32, 8, False, "ba"), ("t3", 8, 8, False, "ba")],
        "dec10to14dil": [("t3d2", 32, 8, False, "ba")],
        "dec14to42str": [("t3s3", 32, 16, False, "ba")],
        "dec42to46std": [("t3", 32, 5, False, "ba"), ("t3", 5, 5, False, "ba")],
        "dec42to46dil": [("t3d2", 32, 5, False, "ba")],
        "dec46to50std": [("t3", 20, 5, False, "ba"), ("t3", 5, 5, False, "ba")],
        "dec46to50dil": [("t3d2", 20, 5, False, "ba")],
        "dec50to150str": [("t3s3", 20, 10, False, "ba")],
        "dec150to154std": [("t3", 20, 3, False, "ba"), ("t3", 3, 3, False, "ba")],
        "dec150to154dil": [("t3d2", 20, 3, False, "ba")],
        "dec154to158std": [("t3", 12, 2, False, "ba"), ("t3", 2, 2, False, "ba")],
        "dec154to158dil": [("t3d2", 12, 2, False, "ba")],
        "dec158to160std": [("t3", 8, ("A", 3), True, "sig")],
    }

    def graph(self, B, x):
        return _hu_graph(B, x)


class HuNet(RelicNet):
    """relics.py:432-763 — PReLU (torch default init 0.25), all BN commented
    out upstream, ReLU head."""

    act = "PReLU"
    prelu_init = 0.25
    plan: Dict[str, List[Spec]] = {
        "enc160to158std": [("c3", "in", 2, True, "a")],
        "enc158to154std": _dual("c3", "a", 2, 2),
        "enc154to150std": _dual("c3", "a", 4, 3),
        "enc158to154dil": [("c3d2", 2, 2, False, "a")],
        "enc154to150dil": [("c3d2", 4, 3, False, "a")],
        "enc160to150dil": [("c3d5", "in", 2, False, "a")],
        "enc150to50str": [("c3s3", 8, 2, False, "a")],
        "enc50to46std": _dual("c3", "a", 2, 2),
        "enc46to42std": _dual("c3", "a", 4, 2),
        "enc50to46dil": [("c3d2", 2, 2, False, "a")],
        "enc46to42dil": [("c3d2", 4, 2, False, "a")],
        "enc42to14str": [("c3s3", 4, 2, False, "a")],
        "enc14to10std": _dual("c3", "a", 2, 2),
        "enc10to6std": _dual("c3", "a", 4, 2),
        "enc14to10dil": [("c3d2", 2, 2, False, "a")],
        "enc10to6dil": [("c3d2", 4, 2, False, "a")],
        "enc6to3str": [("c2s2", 4, 2, False, "a")],
        "enc3to1std": [("c3", 2, 2, False, "a")],
        "dec1to3std": [("t3", 2, 2, False, "a")],
        "dec3to6str": [("t2s2", 4, 2, False, "a")],
        "dec6to10std": [("t3", 6, 2, False, "a"), ("t3", 2, 2, False, "a")],
        "dec6to10dil": [("t3d2", 6, 2, False, "a")],
        "dec10to14std": [("t3", 8, 2, False, "a"), ("t3", 2, 2, False, "a")],
        "dec10to14dil": [("t3d2", 8, 2, False, "a")],
        "dec14to42str": [("t3s3", 6, 2, False, "a")],
        "dec42to46std": [("t3", 6, 2, False, "a"), ("t3", 2, 2, False, "a")],
        "dec42to46dil": [("t3d2", 6, 2, False, "a")],
        "dec46to50std": [("t3", 8, 2, False, "a"), ("t3", 2, 2, False, "a")],
        "dec46to50dil": [("t3d2", 8, 2, False, "a")],
        "dec50to150str": [("t3s3", 6, 4, False, "a")],
        "dec150to154std": [("t3", 12, 3, False, "a"), ("t3", 3, 3, False, "a")],
        "dec150to154dil": [("t3d2", 12, 3, False, "a")],
        "dec154to158std": [("t3", 10, 2, False, "a"), ("t3", 2, 2, False, "a")],
        "dec154to158dil": [("t3d2", 10, 2, False, "a")],
        "dec158to160std": [("t3", 6, ("A", 3), True, "relu")],
    }

    def graph(self, B, x):
        return _hu_graph(B, x)


class Hul160Net(RelicNet):
    """relics.py:1338-1606 (alias ``HulNet`` :1608) — PReLU(0.01) + BN
    (Conv->PReLU->BN), BN-free stem/tail, ReLU head."""

    act = "PReLU"
    prelu_init = 0.01
    plan: Dict[str, List[Spec]] = {
        "enc160to158std": [("c3", "in", 2, True, "a")],
        "enc158to154std": _dual("c3", "a", 2, 2),
        "enc154to150std": _dual("c3", "ab", 4, 3),
        "enc158to154dil": [("c3d2", 2, 2, False, "ab")],
        "enc154to150dil": [("c3d2", 4, 3, False, "ab")],
        "enc160to150dil": [("c3d5", "in", 2, False, "a")],
        "enc150to50str": [("c3s3", 8, 2, False, "ab")],
        "enc50to46std": _dual("c3", "ab", 2, 2),
        "enc46to42std": _dual("c3", "ab", 4, 2),
        "enc50to46dil": [("c3d2", 2, 2, False, "ab")],
        "enc46to42dil": [("c3d2", 4, 2, False, "ab")],
        "enc42to14str": [("c3s3", 4, 2, False, "ab")],
        "enc14to10std": _dual("c3", "ab", 2, 2),
        "enc10to6std": _dual("c3", "ab", 4, 2),
        "enc14to10dil": [("c3d2", 2, 2, False, "ab")],
        "enc10to6dil": [("c3d2", 4, 2, False, "ab")],
        "enc6to3str": [("c2s2", 4, 2, False, "ab")],
        "enc3to1std": [("c3", 2, 2, False, "ab")],
        "dec1to3std": [("t3", 2, 2, False, "ab")],
        "dec3to6str": [("t2s2", 4, 2, False, "ab")],
        "dec6to10std": [("t3", 6, 2, False, "ab"), ("t3", 2, 2, False, "ab")],
        "dec6to10dil": [("t3d2", 6, 2, False, "ab")],
        "dec10to14std": [("t3", 8, 2, False, "ab"), ("t3", 2, 2, False, "ab")],
        "dec10to14dil": [("t3d2", 8, 2, False, "ab")],
        "dec14to42str": [("t3s3", 6, 2, False, "ab")],
        "dec42to46std": [("t3", 6, 2, False, "ab"), ("t3", 2, 2, False, "ab")],
        "dec42to46dil": [("t3d2", 6, 2, False, "ab")],
        "dec46to50std": [("t3", 8, 2, False, "ab"), ("t3", 2, 2, False, "ab")],
        "dec46to50dil": [("t3d2", 8, 2, False, "ab")],
        "dec50to150str": [("t3s3", 6, 4, False, "ab")],
        "dec150to154std": [("t3", 12, 3, False, "ab"), ("t3", 3, 3, False, "ab")],
        "dec150to154dil": [("t3d2", 12, 3, False, "ab")],
        "dec154to158std": [("t3", 10, 2, False, "a"), ("t3", 2, 2, False, "a")],
        "dec154to158dil": [("t3d2", 10, 2, False, "a")],
        "dec158to160std": [("t3", 6, ("A", 3), True, "relu")],
    }

    def graph(self, B, x):
        return _hu_graph(B, x)


class HuDisc(RelicNet):
    """relics.py:765-928 — ReLU + BN discriminator: the 160-px encoder alone
    with a Sigmoid 1-channel head."""

    act = "ReLU"
    plan: Dict[str, List[Spec]] = {
        "enc160to158std": [("c3", "in", 2, True, "a")],
        "enc158to154std": _dual("c3", "ba", 2, 2),
        "enc154to150std": _dual("c3", "ba", 4, 3),
        "enc158to154dil": [("c3d2", 2, 2, False, "ba")],
        "enc154to150dil": [("c3d2", 4, 3, False, "ba")],
        "enc160to150dil": [("c3d5", "in", 2, False, "ba")],
        "enc150to50str": [("c3s3", 8, 2, False, "ba")],
        "enc50to46std": _dual("c3", "ba", 2, 2),
        "enc46to42std": _dual("c3", "ba", 4, 2),
        "enc50to46dil": [("c3d2", 2, 2, False, "ba")],
        "enc46to42dil": [("c3d2", 4, 2, False, "ba")],
        "enc42to14str": [("c3s3", 4, 2, False, "ba")],
        "enc14to10std": _dual("c3", "ba", 2, 2),
        "enc10to6std": _dual("c3", "ba", 4, 2),
        "enc14to10dil": [("c3d2", 2, 2, False, "ba")],
        "enc10to6dil": [("c3d2", 4, 2, False, "ba")],
        "enc6to3str": [("c2s2", 4, 2, False, "ba")],
        "enc3to1std": [("c3", 2, ("A", 1), True, "sig")],
    }

    def graph(self, B, x):
        return B("enc3to1std", _hu_encode(B, x)["l3"])


class Hul128Net(RelicNet):
    """relics.py:1070-1334 — 128-px PReLU(0.01)+BN dense-concat generator
    (the BN-ful precursor of Hul.py's Hulb128Net), ReLU head."""

    act = "PReLU"
    prelu_init = 0.01
    plan: Dict[str, List[Spec]] = {
        "enc128to126std": [("c3", "in", 2, True, "a")],
        "enc126to122std": _dual("c3", "a", 2, 2),
        "enc122to118std": _dual("c3", "ab", 4, 2),
        "enc126to122dil": [("c3d2", 2, 2, False, "ab")],
        "enc122to118dil": [("c3d2", 4, 2, False, "ab")],
        "enc128to118dil": [("c3d5", "in", 2, False, "a")],
        "enc118to114std": _dual("c3", "ab", 6, 2),
        "enc118to114dil": [("c3d2", 6, 2, False, "ab")],
        "enc114to38str": [("c3s3", 4, 4, False, "ab")],
        "enc38to34std": _dual("c3", "ab", 4, 2),
        "enc34to30std": _dual("c3", "ab", 4, 2),
        "enc38to34dil": [("c3d2", 4, 2, False, "ab")],
        "enc34to30dil": [("c3d2", 4, 2, False, "ab")],
        "enc30to10str": [("c3s3", 4, 4, False, "ab")],
        "enc10to6std": [("c3", 4, 3, False, "ab"), ("c3", 3, 3, False, "ab")],
        "enc6to2std": _dual("c3", "ab", 6, 6),
        "enc10to6dil": [("c3d2", 4, 3, False, "ab")],
        "enc6to2dil": [("c3d2", 6, 6, False, "ab")],
        "dec2to6std": [("t3", 12, 3, False, "ab"), ("t3", 3, 3, False, "ab")],
        "dec6to10std": [("t3", 12, 3, False, "ab"), ("t3", 3, 3, False, "ab")],
        "dec2to6dil": [("t3d2", 12, 3, False, "ab")],
        "dec6to10dil": [("t3d2", 12, 3, False, "ab")],
        "dec10to30str": [("t3s3", 10, 5, False, "ab")],
        "dec30to34std": [("t3", 9, 3, False, "ab"), ("t3", 3, 3, False, "ab")],
        "dec30to34dil": [("t3d2", 9, 3, False, "ab")],
        "dec34to38std": [("t3", 10, 3, False, "ab"), ("t3", 3, 3, False, "ab")],
        "dec34to38dil": [("t3d2", 10, 3, False, "ab")],
        "dec38to114str": [("t3s3", 10, 4, False, "ab")],
        "dec114to118std": [("t3", 8, 3, False, "ab"), ("t3", 3, 3, False, "ab")],
        "dec114to118dil": [("t3d2", 8, 3, False, "ab")],
        "dec118to122std": [("t3", 12, 3, False, "ab"), ("t3", 3, 3, False, "ab")],
        "dec118to122dil": [("t3d2", 12, 3, False, "ab")],
        "dec122to126std": [("t3", 10, 3, False, "a"), ("t3", 3, 3, False, "a")],
        "dec122to126dil": [("t3d2", 10, 3, False, "a")],
        "dec126to128std": [("t3", 8, ("A", 3), True, "relu")],
    }

    def graph(self, B, x):
        l126 = B("enc128to126std", x)
        l122 = _cat(B("enc126to122std", l126), B("enc126to122dil", l126))
        l118 = _cat(B("enc122to118std", l122), B("enc122to118dil", l122),
                    B("enc128to118dil", x))
        l114 = _cat(B("enc118to114std", l118), B("enc118to114dil", l118))
        l38 = B("enc114to38str", l114)
        l34 = _cat(B("enc38to34std", l38), B("enc38to34dil", l38))
        l30 = _cat(B("enc34to30std", l34), B("enc34to30dil", l34))
        l10 = B("enc30to10str", l30)
        l6 = _cat(B("enc10to6std", l10), B("enc10to6dil", l10))
        l2 = _cat(B("enc6to2std", l6), B("enc6to2dil", l6))
        l6 = _cat(l6, B("dec2to6std", l2), B("dec2to6dil", l2))
        l10 = _cat(l10, B("dec6to10std", l6), B("dec6to10dil", l6))
        l30 = _cat(l30, B("dec10to30str", l10))
        l34 = _cat(l34, B("dec30to34std", l30), B("dec30to34dil", l30))
        l38 = _cat(l38, B("dec34to38std", l34), B("dec34to38dil", l34))
        l114 = _cat(l114, B("dec38to114str", l38))
        l118 = _cat(l118, B("dec114to118std", l114), B("dec114to118dil", l114))
        l122 = _cat(l122, B("dec118to122std", l118), B("dec118to122dil", l118))
        l126 = _cat(l126, B("dec122to126std", l122), B("dec122to126dil", l122))
        return B("dec126to128std", l126)


class Hul144Disc(RelicNet):
    """relics.py:931-1066 — 144-px PReLU(0.01)+BN discriminator; ``decide``
    head is a k2 conv + Sigmoid, or (``finalpool=True``) Sigmoid k3 conv +
    global max-pool. Both heads are built, as JAX's tree holds both; the
    unused one takes no part in the forward (a zero gradient)."""

    act = "PReLU"
    prelu_init = 0.01
    plan: Dict[str, List[Spec]] = {
        "enc144to142std": [("c3", "in", 2, True, "a")],
        "enc142to138std": _dual("c3", "a", 2, 2),
        "enc138to134std": _dual("c3", "ab", 4, 2),
        "enc142to138dil": [("c3d2", 2, 2, False, "a")],
        "enc138to134dil": [("c3d2", 4, 2, False, "ab")],
        "enc144to134dil": [("c3d5", "in", 2, False, "a")],
        "enc134to132std": [("c3", 6, 6, False, "ab")],
        "enc132to44str": [("c3s3", 6, 6, False, "ab")],
        "enc44to40std": _dual("c3", "ab", 6, 3),
        "enc40to36std": _dual("c3", "ab", 6, 3),
        "enc44to40dil": [("c3d2", 6, 3, False, "ab")],
        "enc40to36dil": [("c3d2", 6, 3, False, "ab")],
        "enc36to12str": [("c3s3", 6, 6, False, "ab")],
        "enc12to8std": _dual("c3", "ab", 6, 6),
        "enc8to4std": _dual("c3", "ab", 12, 6),
        "enc12to8dil": [("c3d2", 6, 6, False, "ab")],
        "enc8to4dil": [("c3d2", 12, 6, False, "ab")],
        # finalpool=False
        "enc4to2std": [("c3", 12, 4, True, "a")],
        "decide": [("c2", 4, ("A", 1), True, "sig")],
        # finalpool=True
        "enc4to2pool": [("c3", 12, ("A", 1), True, "sig")],
    }

    def __init__(self, funit: Optional[int] = None, input_channels: Optional[int] = None,
                 finalpool: bool = False):
        super().__init__(funit, input_channels)
        self.finalpool = finalpool

    def graph(self, B, x):
        layer = B("enc144to142std", x)
        layer = _cat(B("enc142to138std", layer), B("enc142to138dil", layer))
        layer = _cat(B("enc138to134std", layer), B("enc138to134dil", layer),
                     B("enc144to134dil", x))
        layer = B("enc132to44str", B("enc134to132std", layer))
        layer = _cat(B("enc44to40std", layer), B("enc44to40dil", layer))
        layer = _cat(B("enc40to36std", layer), B("enc40to36dil", layer))
        layer = B("enc36to12str", layer)
        layer = _cat(B("enc12to8std", layer), B("enc12to8dil", layer))
        layer = _cat(B("enc8to4std", layer), B("enc8to4dil", layer))
        if self.finalpool:
            return torch.amax(B("enc4to2pool", layer), dim=(2, 3), keepdim=True)
        return B("decide", B("enc4to2std", layer))


_HUNKY_ENC = {
    "enc1": [("c5", "in", ("A", 64), True, "ba"), ("c5", ("A", 64), ("A", 64), True, "ba")],
    "enc2": [("c3", ("A", 64), ("A", 96), True, "ba"), ("c3", ("A", 96), ("A", 96), True, "ba")],
    "enc3": [("c3", ("A", 96), ("A", 128), True, "ba"),
             ("c3", ("A", 128), ("A", 128), True, "ba")],
    "enc4": [("c3", ("A", 128), ("A", 256), True, "ba"),
             ("c3", ("A", 256), ("A", 256), True, "ba")],
    "enc5": [("c3", ("A", 256), ("A", 512), True, "ba"),
             ("c3", ("A", 512), ("A", 512), True, "ba")],
}


class HunkyDisc(RelicNet):
    """relics.py:43-96 — plain 256-px Conv->BN->ReLU + MaxPool ladder with a
    Sigmoid head; absolute channel plan (no funit). Below ``MIN_SIZE`` px
    its prediction map is empty (5x5 convs and four 3x3 pairs before five
    pools, a 3x3 and a 2x2 conv after them: 256 -> 1 px)."""

    MIN_SIZE = 256
    act = "ReLU"
    plan: Dict[str, List[Spec]] = {
        **_HUNKY_ENC,
        "encdec": [("c3", ("A", 512), ("A", 1024), True, "ba"),
                   ("c2", ("A", 1024), ("A", 1), True, "sig")],
    }

    def graph(self, B, x):
        for bname in _HUNKY_ENC:
            x = F.max_pool2d(B(bname, x), 2)
        return B("encdec", x)


class HunkyNet(RelicNet):
    """relics.py:1610-1759 — 224+16n-px residual U-Net: Conv->BN->ReLU
    encoder with MaxPool downs, k2s2 up-tconvs, residual ADDS (not concats),
    pre-activation (BN->ReLU first) decoder blocks, Sigmoid head."""

    act = "ReLU"
    plan: Dict[str, List[Spec]] = {
        **_HUNKY_ENC,
        "encdec": [("c3", ("A", 512), ("A", 1024), True, "ba"),
                   ("t3", ("A", 1024), ("A", 1024), True, "ba")],
        "up1": [("t2s2", ("A", 1024), ("A", 512), True, "")],
        "dec2": [("pre", ("A", 512), ("A", 512), False, "ba"),
                 ("t3", ("A", 512), ("A", 512), True, "ba"),
                 ("t3", ("A", 512), ("A", 512), True, "ba")],
        "up2": [("t2s2", ("A", 512), ("A", 256), True, "")],
        "dec3": [("pre", ("A", 256), ("A", 256), False, "ba"),
                 ("t3", ("A", 256), ("A", 256), True, "ba"),
                 ("t3", ("A", 256), ("A", 256), True, "ba")],
        "up3": [("t2s2", ("A", 256), ("A", 128), True, "")],
        "dec4": [("pre", ("A", 128), ("A", 128), False, "ba"),
                 ("t3", ("A", 128), ("A", 128), True, "ba"),
                 ("t3", ("A", 128), ("A", 128), True, "ba")],
        "up4": [("t2s2", ("A", 128), ("A", 96), True, "")],
        "dec5": [("pre", ("A", 96), ("A", 96), False, "ba"),
                 ("t3", ("A", 96), ("A", 96), True, "ba"),
                 ("t3", ("A", 96), ("A", 96), True, "ba")],
        "up5": [("t2s2", ("A", 96), ("A", 64), True, "")],
        "dec6": [("pre", ("A", 64), ("A", 64), False, "ba"),
                 ("t5", ("A", 64), ("A", 64), True, "ba"),
                 ("t5", ("A", 64), ("A", 3), True, "sig")],
    }

    def graph(self, B, x):
        residuals = []
        for bname in _HUNKY_ENC:
            x = B(bname, x)
            residuals.append(x)
            x = F.max_pool2d(x, 2)
        x = B("encdec", x)
        for i in range(1, 6):
            x = B(f"dec{i + 1}", B(f"up{i}", x) + residuals.pop())
        return x


class RedishCNN(nn.Module):
    """relics.py:4-39 — pre-activation residual CNN with *shared* modules
    (one conv, one deconv, one BN reused at every depth) and RReLU at its
    eval slope. ``depth`` sets ``(depth - 6) // 2`` down and up levels; in
    train mode the BatchNorm's running stats update at each of its
    ``2 * (depth - 6)`` uses in turn (the module called again), as the JAX
    package threads them. ``find_noise`` returns ``x - out``."""

    def __init__(self, n_channels: int = 128, image_channels: int = 3, kernel_size: int = 5,
                 depth: int = 30, find_noise: bool = False):
        super().__init__()
        self.depth, self.find_noise = depth, find_noise
        k = kernel_size
        self.conv_first = nn.Conv2d(image_channels, n_channels, k)
        self.conv = nn.Conv2d(n_channels, n_channels, k)
        self.deconv = nn.ConvTranspose2d(n_channels, n_channels, k)
        self.deconv_last = nn.ConvTranspose2d(n_channels, image_channels, k)
        self.bn = nn.BatchNorm2d(n_channels)

    @staticmethod
    def config_of(sd, depth: int = 30, find_noise: bool = False) -> dict:
        """Constructor arguments of a state_dict (depth and find_noise are
        not in it)."""
        w = sd["conv_first.weight"]
        return {"n_channels": int(w.shape[0]), "image_channels": int(w.shape[1]),
                "kernel_size": int(w.shape[-1]), "depth": depth, "find_noise": find_noise}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        def rr(t):
            return F.leaky_relu(t, RRELU_EVAL_SLOPE)

        steps = (self.depth - 6) // 2
        layer = rr(self.conv_first(x))
        residuals = [layer]
        for _ in range(steps):
            for _ in range(2):
                layer = self.conv(rr(self.bn(layer)))
            residuals.append(layer)
        layer = rr(self.deconv(rr(self.conv(layer))))
        layer = rr(layer + residuals.pop())
        for _ in range(steps):
            for _ in range(2):
                layer = self.deconv(rr(self.bn(layer)))
            layer = rr(layer + residuals.pop())
        layer = rr(self.deconv_last(layer))
        return x - layer if self.find_noise else layer


HulNet = Hul160Net  # relics.py:1608 compatibility alias

# the block-grammar networks by registry name (HulNet is Hul160Net)
NETS = {"HunkyDisc": HunkyDisc, "HunkyNet": HunkyNet, "HunNet": HunNet, "HuNet": HuNet,
        "HuDisc": HuDisc, "Hul144Disc": Hul144Disc, "Hul128Net": Hul128Net,
        "Hul160Net": Hul160Net, "HulNet": Hul160Net}
DISCS = ("HuDisc", "Hul144Disc", "HunkyDisc")
