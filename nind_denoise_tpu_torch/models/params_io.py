"""Generator checkpoints: the reference ``.pt`` state_dicts and the JAX
package's ``.npz`` params files, loaded into the port's ``UtNet``.

``state_dict_from_jax`` carries weights across frameworks: it maps a JAX
UtNet params pytree (numpy arrays) to the port's state_dict — the port's
own copy of the mapping in ``nind_denoise_tpu/models/torch_export.py``:

* HWIO conv kernel               -> ``nn.Conv2d`` (O, I, kh, kw)
* flipped-HWIO plain-conv kernel -> ``nn.ConvTranspose2d`` k=3 s=1 (I, O, 3, 3)
* (I, 4*O) up-conv matmul matrix -> ``nn.ConvTranspose2d`` k=2 s=2 (I, O, 2, 2)
  (column (u*2+v)*O + o for sub-pixel (u, v))
* scalar ``a``                   -> ``nn.PReLU`` weight (1,)

The ``.npz`` reader reads the flat-key format of the JAX package's
``params_io.save``: leaves under "/"-joined key paths, non-array leaves in
a JSON entry. No pickle.
"""

from __future__ import annotations

import json
from typing import Any, Dict

import numpy as np
import torch

from .utnet import UtNet

_META_KEY = "__pytree_meta__"


def _insert(root: dict, path: str, value: Any) -> None:
    parts = path.split("/")
    node = root
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = value


def _listify(node: Any) -> Any:
    if not isinstance(node, dict):
        return node
    t = node.pop("__type__", None)
    out = {k: _listify(v) for k, v in node.items()}
    if t in ("list", "tuple"):
        seq = [out[k] for k in sorted(out, key=int)]
        return seq if t == "list" else tuple(seq)
    return out


def load_npz(fpath: str) -> Any:
    """Params pytree of a ``.npz`` checkpoint, with numpy leaves."""
    with np.load(fpath, allow_pickle=False) as z:
        meta = json.loads(bytes(z[_META_KEY]).decode()) if _META_KEY in z else {}
        root: dict = {}
        for key in z.files:
            if key != _META_KEY:
                _insert(root, key, z[key])
        for key, val in meta.items():
            _insert(root, key, val)
    return _listify(root)


def _f32(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float32)


def _conv_w(w) -> np.ndarray:
    return _f32(w).transpose(3, 2, 0, 1)


def _tconv3_w(w) -> np.ndarray:
    return _f32(w).transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]


def _upconv_w(w) -> np.ndarray:
    w = _f32(w)
    i, o4 = w.shape
    return w.reshape(i, 2, 2, o4 // 4).transpose(0, 3, 1, 2)


_WMAP = {"conv": _conv_w, "tconv3": _tconv3_w, "up": _upconv_w}


def state_dict_from_jax(params: Dict) -> Dict[str, torch.Tensor]:
    """JAX UtNet params pytree -> the port's UtNet state_dict."""
    sd: Dict[str, np.ndarray] = {}

    def layer(prefix, lay, kind, act_key=None):
        sd[prefix + ".weight"] = _WMAP[kind](lay["w"])
        if "b" in lay:
            sd[prefix + ".bias"] = _f32(lay["b"])
        if act_key is not None and "a" in lay:
            sd[act_key + ".weight"] = _f32(lay["a"]).reshape(1)

    def double(prefix, tree, kind):
        layer(f"{prefix}.0", tree["c0"], kind, f"{prefix}.1")
        layer(f"{prefix}.2", tree["c1"], kind, f"{prefix}.3")

    for i in range(1, 5):
        double(f"convs{i}", params[f"convs{i}"], "conv")
    layer("bottom.0", params["bottom"]["c0"], "conv", "bottom.1")
    layer("bottom.2", params["bottom"]["c1"], "tconv3", "bottom.3")
    for i in range(1, 5):
        layer(f"up{i}", params[f"up{i}"], "up")
    for i in range(1, 4):
        double(f"tconvs{i}", params[f"tconvs{i}"], "tconv3")
    t4 = params["tconvs4"]
    layer("tconvs4.0", t4["c0"], "tconv3", "tconvs4.1")
    layer("tconvs4.2", t4["c1"], "tconv3", "tconvs4.3")
    layer("tconvs4.4", t4["c2"], "conv")
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def load_generator(path: str, activation: str = "PReLU") -> UtNet:
    """UtNet with the weights of ``path`` (``.pt`` state_dict or ``.npz``
    JAX params), loaded strictly, on the CPU in float32."""
    if path.endswith(".npz"):
        tree = load_npz(path)
        # native checkpoints may bundle {'params': ..., 'state': ...}
        if isinstance(tree, dict) and "params" in tree:
            tree = tree["params"]
        sd = state_dict_from_jax(tree)
    elif path.endswith((".pt", ".pth")):
        sd = torch.load(path, map_location="cpu", weights_only=True)
    else:
        raise ValueError(f"unsupported checkpoint format: {path}")
    model = UtNet(UtNet.funit_of(sd), activation)
    model.load_state_dict(sd, strict=True)
    return model
