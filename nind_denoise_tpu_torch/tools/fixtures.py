"""Seeded checkpoints and stand-ins for darktable-cli and gmic, for the
tests and chip_smoke.py.

``write_jax_checkpoint`` writes a UtNet of any width in the JAX package's
``.npz`` format from a seed, with numpy alone, and
``write_torch_checkpoint`` the same weights as a torch state_dict;
``write_unet_checkpoint`` a UNet with its BatchNorm state and
``write_hul_gen_checkpoint`` a Hul generator, likewise (``unet_tree`` and
``hul_gen_params`` give their trees); ``seed_zoo_module`` draws the
weights (BatchNorm stats and PReLU slopes included) of a port module of
the legacy, pix2pix or relic zoo, or of MobileNetV3, from a seed.
``plugin_command`` is the darktable plugin's command line, built from the
template in its Lua source, and ``SIDECAR`` a darktable XMP sidecar with a
history of first-stage, second-stage and unknown operations.

Neither binary is needed to drive the RAW path: ``write_darktable`` and
``write_gmic`` write small Python scripts that take the same command lines
(``pipeline/external.py``), append each argv to a JSON-lines log, and write
what the real tool would:

- darktable stage 1 (``bpp=32``): a seeded float32 TIFF of the given size,
  values in [0, 1.2) (highlights above 1 survive, as darktable's do), at
  the output name in its working directory;
- darktable stage 2 (``bpp=16``): the denoised TIFF it is given, clipped
  to [0, 1] and written at the output name, 8-bit for ``.jpg`` and 16-bit
  otherwise;
- gmic: ``-/ 256 cut 0,255 round`` of its input (no deblur) as the JPEG
  ``-o`` names.

Every 8-bit image a stand-in writes also goes, lossless, to
``<output>.png``, so that callers can compare pixels without the JPEG
codec in between. The device path these files feed is the real one.
"""

from __future__ import annotations

import json
import math
import os
import re
import shlex
import stat
import sys
from typing import List

import numpy as np

SIDECAR = """<?xpacket begin="\ufeff" id="W5M0MpCehiHzreSzNTczkc9d"?>
<x:xmpmeta xmlns:x="adobe:ns:meta/">
 <rdf:RDF xmlns:rdf="http://www.w3.org/1999/02/22-rdf-syntax-ns#">
  <rdf:Description rdf:about=""
    xmlns:darktable="http://darktable.sf.net/"
    darktable:iop_order_version="3"
    darktable:iop_order_list="rawprepare,0,temperature,0,demosaic,0,colorin,0,exposure,0,sharpen,0,colorout,0">
   <darktable:history>
    <rdf:Seq>
     <rdf:li darktable:num="2" darktable:operation="sharpen" darktable:enabled="1" darktable:params="aa"/>
     <rdf:li darktable:num="0" darktable:operation="demosaic" darktable:enabled="1" darktable:params="bb"/>
     <rdf:li darktable:num="1" darktable:operation="exposure" darktable:enabled="1" darktable:params="cc"/>
     <rdf:li darktable:num="3" darktable:operation="flip" darktable:enabled="1" darktable:params="dd"/>
     <rdf:li darktable:num="4" darktable:operation="mystery_op" darktable:enabled="1" darktable:params="ee"/>
     <rdf:li darktable:num="5" darktable:operation="colorin" darktable:enabled="1" darktable:params="ff"/>
    </rdf:Seq>
   </darktable:history>
  </rdf:Description>
 </rdf:RDF>
</x:xmpmeta>
<?xpacket end="w"?>
"""

_COMMON = '''#!{python}
import json, os, sys
import cv2
import numpy as np

argv = sys.argv[1:]
with open({log!r}, "a") as f:
    f.write(json.dumps({{"tool": {tool!r}, "cwd": os.getcwd(), "argv": argv}}) + "\\n")


def write8(path, u8):
    ok = cv2.imwrite(path, u8) and cv2.imwrite(path + ".png", u8)
    sys.exit(0 if ok else 1)
'''

_DARKTABLE = '''
src, out = argv[0], argv[2]
if "plugins/imageio/format/tiff/bpp=32" in argv:
    rng = np.random.default_rng({seed})
    img = rng.random(({height}, {width}, 3), dtype=np.float32) * np.float32(1.2)
    sys.exit(0 if cv2.imwrite(out, img) else 1)
x = np.clip(cv2.imread(src, cv2.IMREAD_COLOR + cv2.IMREAD_ANYDEPTH), 0, 1)
if out.lower().endswith((".jpg", ".jpeg")):
    write8(out, np.round(x * 255).astype(np.uint8))
sys.exit(0 if cv2.imwrite(out, np.round(x * 65535).astype(np.uint16)) else 1)
'''

_GMIC = '''
src = argv[0]
out = argv[argv.index("-o") + 1].split(",")[0]
x = cv2.imread(src, cv2.IMREAD_COLOR + cv2.IMREAD_ANYDEPTH).astype(np.float32)
write8(out, np.round(np.clip(x / 256, 0, 255)).astype(np.uint8))
'''


def _write(path: str, body: str) -> str:
    with open(path, "w") as f:
        f.write(body)
    os.chmod(path, os.stat(path).st_mode | stat.S_IXUSR | stat.S_IXGRP | stat.S_IXOTH)
    return path


def write_darktable(path: str, log: str, height: int, width: int, seed: int = 0) -> str:
    """A darktable-cli stand-in at ``path`` whose stage 1 develops a seeded
    ``height`` x ``width`` float32 image; returns ``path``."""
    head = _COMMON.format(python=sys.executable, log=log, tool="darktable-cli")
    return _write(path, head + _DARKTABLE.format(seed=seed, height=height, width=width))


def write_gmic(path: str, log: str) -> str:
    """A gmic stand-in at ``path``; returns ``path``."""
    head = _COMMON.format(python=sys.executable, log=log, tool="gmic")
    return _write(path, head + _GMIC)


def read_log(log: str) -> List[dict]:
    """The calls a stand-in logged, in order ([] when none)."""
    if not os.path.isfile(log):
        return []
    with open(log) as f:
        return [json.loads(line) for line in f]


def write_jax_checkpoint(path: str, funit: int, seed: int) -> None:
    """A funit-``funit`` UtNet in the JAX package's .npz params format
    (HWIO kernels, (I, 4*O) up-conv matrices, scalar PReLU ``a``), with
    torch-default-style uniform(+-1/sqrt(fan_in)) weights from a seed."""
    rng = np.random.default_rng(seed)
    arrays = {}

    def layer(key, shape, fan_in, cout, act=True):
        bound = 1.0 / math.sqrt(fan_in)
        arrays[f"{key}/w"] = rng.uniform(-bound, bound, shape).astype(np.float32)
        arrays[f"{key}/b"] = rng.uniform(-bound, bound, (cout,)).astype(np.float32)
        if act:
            arrays[f"{key}/a"] = np.asarray(0.25, np.float32)

    def conv(key, cin, cout, k=3, act=True):
        layer(key, (k, k, cin, cout), cin * k * k, cout, act)

    def tconv(key, cin, cout):
        layer(key, (3, 3, cin, cout), cout * 9, cout)

    f = funit
    for i, (cin, c) in enumerate([(3, f), (f, 2 * f), (2 * f, 4 * f), (4 * f, 8 * f)], 1):
        conv(f"convs{i}/c0", cin, c)
        conv(f"convs{i}/c1", c, c)
    conv("bottom/c0", 8 * f, 16 * f)
    tconv("bottom/c1", 16 * f, 16 * f)
    for i, (cin, c) in enumerate([(16 * f, 8 * f), (8 * f, 4 * f), (4 * f, 2 * f)], 1):
        layer(f"up{i}", (cin, 4 * c), c * 4, c, act=False)
        tconv(f"tconvs{i}/c0", cin, c)
        tconv(f"tconvs{i}/c1", c, c)
    layer("up4", (2 * f, 4 * f), f * 4, f, act=False)
    tconv("tconvs4/c0", 2 * f, f)
    tconv("tconvs4/c1", f, f)
    conv("tconvs4/c2", f, 3, k=1, act=False)
    meta = np.frombuffer(json.dumps({}).encode(), dtype=np.uint8)
    np.savez(path, __pytree_meta__=meta, **arrays)


def write_torch_checkpoint(path: str, funit: int, seed: int) -> None:
    """The weights of ``write_jax_checkpoint(..., funit, seed)`` as the
    port's UtNet state_dict, saved with ``torch.save``."""
    import torch

    from ..models.params_io import load_npz, state_dict_from_jax

    tmp = path + ".npz"
    write_jax_checkpoint(tmp, funit, seed)
    try:
        sd = state_dict_from_jax(load_npz(tmp))
    finally:
        os.unlink(tmp)
    torch.save(sd, path)


def unet_tree(seed: int, n_channels: int = 3, n_classes: int = 3):
    """A seeded UNet (params, BN state) in the JAX package's layout, numpy
    only: He-uniform (+-sqrt(6/fan_in)) conv kernels, so that activations
    keep their scale through the 18 ReLU layers, uniform(+-1/sqrt(fan_in))
    biases, BN scale in [0.5, 1.5), bias in [-0.1, 0.1), running mean in
    [-0.1, 0.1) and running var in [0.5, 1.5)."""
    from ..models.unet import CHANNELS

    rng = np.random.default_rng(seed)

    def conv(k, cin, cout):
        fan_in = cin * k * k
        w = rng.uniform(-1, 1, (k, k, cin, cout)) * math.sqrt(6 / fan_in)
        b = rng.uniform(-1, 1, (cout,)) / math.sqrt(fan_in)
        return {"w": w.astype(np.float32), "b": b.astype(np.float32)}

    def double(cin, cout):
        p, st = {}, {}
        for j, ci in enumerate((cin, cout)):
            p[f"c{j}"] = conv(3, ci, cout)
            p[f"bn{j}"] = {"scale": rng.uniform(0.5, 1.5, cout).astype(np.float32),
                           "bias": rng.uniform(-0.1, 0.1, cout).astype(np.float32)}
            st[f"bn{j}"] = {"mean": rng.uniform(-0.1, 0.1, cout).astype(np.float32),
                            "var": rng.uniform(0.5, 1.5, cout).astype(np.float32)}
        return p, st

    ch = CHANNELS
    params, state = {}, {}
    params["inc"], state["inc"] = double(n_channels, ch[0])
    for i in range(4):
        params[f"down{i + 1}"], state[f"down{i + 1}"] = double(ch[i], ch[i + 1])
    for i, (cin, cout) in enumerate(zip((1024, 512, 256, 128), (256, 128, 64, 64)), 1):
        half = cin // 2
        fan_in = half * 4
        params[f"up{i}_t"] = {
            "w": (rng.uniform(-1, 1, (half, 4 * half)) * math.sqrt(6 / fan_in)).astype(np.float32),
            "b": (rng.uniform(-1, 1, (half,)) / math.sqrt(fan_in)).astype(np.float32)}
        params[f"up{i}"], state[f"up{i}"] = double(cin, cout)
    params["outc"] = conv(1, ch[0], n_classes)
    return params, state


def write_unet_checkpoint(path: str, seed: int) -> None:
    """``unet_tree(seed)`` as the JAX package's ``{"params", "state"}``
    ``.npz``."""
    from ..models.params_io import save

    params, state = unet_tree(seed)
    save({"params": params, "state": state}, path)


def hul_gen_params(network: str, funit: int, seed: int, activation: str = "PReLU"):
    """Seeded Hulb128Net / Hulbs128Net params in the JAX package's layout,
    numpy only, drawn as JAX's init draws them (uniform(+-1/sqrt(fan_in)),
    PReLU ``a`` 0.01, ``_final_a`` for a PReLU output), without the unused
    ``a`` of the head's last conv."""
    from ..models.hul_gen import _PLAN, HEAD, VARIANTS

    rng = np.random.default_rng(seed)
    params = {}
    for bname, specs in _PLAN.items():
        layers = []
        for li, (cin_m, cout_m, ltype, bias) in enumerate(specs):
            cin = 3 if cin_m is None else cin_m * funit
            cout = max(1, cout_m * funit) if cout_m else 3
            k = 1 if ltype == "t1" else 3
            bound = 1.0 / math.sqrt(cin * k * k)
            lay = {"w": rng.uniform(-bound, bound, (k, k, cin, cout)).astype(np.float32)}
            if bias:
                lay["b"] = rng.uniform(-bound, bound, (cout,)).astype(np.float32)
            if VARIANTS[network] == "PReLU" and not (bname == HEAD and li == len(specs) - 1):
                lay["a"] = np.asarray(0.01, np.float32)
            layers.append(lay)
        params[bname] = layers
    if activation == "PReLU":
        params["_final_a"] = np.asarray(0.01, np.float32)
    return params


def write_hul_gen_checkpoint(path: str, network: str, funit: int, seed: int,
                             activation: str = "PReLU") -> None:
    """``hul_gen_params(...)`` as a JAX package ``.npz``."""
    from ..models.params_io import save

    save(hul_gen_params(network, funit, seed, activation), path)


PLUGIN_LUA = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "lua-scripts", "nind_denoise_tpu_rl.lua")


def _redraw_bn(rng, c: int):
    """BatchNorm scale, bias, mean and var of ``c`` channels from ``rng``: a
    fresh init's ones and zeros would hide a swapped mapping."""
    return tuple(rng.uniform(lo, hi, c).astype(np.float32)
                 for lo, hi in ((0.5, 1.5), (-0.3, 0.3), (-0.2, 0.2), (0.5, 1.5)))


def seed_zoo_module(model, seed: int):
    """Redraw ``model``'s weights from ``seed``, in place, with numpy: conv
    kernels He-normal (std sqrt(2 / fan_in), so ReLU stacks keep their
    scale), biases uniform(+-0.1), every PReLU's slope in [0, 0.3], every
    BatchNorm's scale in [0.5, 1.5], bias in [-0.3, 0.3], mean in
    [-0.2, 0.2] and var in [0.5, 1.5]. The same seed gives the same weights
    on any device."""
    import torch
    from torch import nn

    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                w = m.weight
                fan_in = w[0].numel() if isinstance(m, nn.Conv2d) else \
                    w.shape[0] * w.shape[2] * w.shape[3] // (m.stride[0] * m.stride[1])
                w.copy_(torch.from_numpy(rng.normal(0, math.sqrt(2.0 / fan_in), w.shape)))
                if m.bias is not None:
                    m.bias.copy_(torch.from_numpy(rng.uniform(-0.1, 0.1, m.bias.shape)))
            elif isinstance(m, nn.PReLU):
                m.weight.copy_(torch.from_numpy(rng.uniform(0, 0.3, m.weight.shape)))
            elif isinstance(m, nn.BatchNorm2d):
                for t, a in zip((m.weight, m.bias, m.running_mean, m.running_var),
                                _redraw_bn(rng, m.num_features)):
                    t.copy_(torch.from_numpy(a))
    return model


def plugin_template(lua_path: str = PLUGIN_LUA) -> str:
    """The ``string.format`` template of the plugin's CLI call."""
    with open(lua_path) as f:
        m = re.search(r"string\.format\(\s*'([^']*)'", f.read())
    if m is None:
        raise ValueError(f"no CLI command template in {lua_path}")
    return m.group(1)


def plugin_command(cli: str, temp_name: str, work_dir: str, ext: str = "jpg",
                   quality: int = 97, sigma: int = 1, iterations: int = 10,
                   no_deblur: bool = False, lua_path: str = PLUGIN_LUA) -> List[str]:
    """The argv the plugin runs for one export (its template filled as
    Lua's ``string.format`` fills it; ``work_dir`` ends in a separator, as
    the plugin's does)."""
    cmd = plugin_template(lua_path) % (cli, shlex.quote(temp_name), shlex.quote(work_dir),
                                       ext, quality, sigma, iterations,
                                       " --no_deblur" if no_deblur else "")
    return shlex.split(cmd)
