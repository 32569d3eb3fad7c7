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

``jax_from_state_dict`` is its inverse, and ``save`` writes the flat-key
format of the JAX package's ``params_io.save`` that ``load_npz`` reads:
leaves under "/"-joined key paths, non-array leaves in a JSON entry. No
pickle. ``opt_leaves`` / ``opt_from_leaves`` carry the trainer's optimizer
state across in the order the JAX trainer stores it, so that a checkpoint
of either trainer resumes in the other.

``complete_path`` resolves a checkpoint directory to its best-validation
epoch (``trainres.json``) or its highest epoch, as the JAX package's
``params_io`` does. ``load_generator`` builds the model on the ``meta``
device and assigns the checkpoint's tensors to it, so no random init runs.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, List, Optional

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


def _conv_w_inv(w) -> np.ndarray:
    return _f32(w).transpose(2, 3, 1, 0)


def _tconv3_w_inv(w) -> np.ndarray:
    return _f32(w)[:, :, ::-1, ::-1].transpose(2, 3, 0, 1)


def _upconv_w_inv(w) -> np.ndarray:
    w = _f32(w)
    return w.transpose(0, 2, 3, 1).reshape(w.shape[0], -1)


_WMAP = {"conv": _conv_w, "tconv3": _tconv3_w, "up": _upconv_w}
_WMAP_INV = {"conv": _conv_w_inv, "tconv3": _tconv3_w_inv, "up": _upconv_w_inv}


def _get(tree: Any, path: tuple) -> Any:
    for k in path:
        tree = tree[k]
    return tree


def _set(tree: dict, path: tuple, value: Any) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _layers():
    """(JAX path, torch module prefix, kernel kind, PReLU module or None)
    for every UtNet layer."""
    for i in range(1, 5):
        yield (f"convs{i}", "c0"), f"convs{i}.0", "conv", f"convs{i}.1"
        yield (f"convs{i}", "c1"), f"convs{i}.2", "conv", f"convs{i}.3"
    yield ("bottom", "c0"), "bottom.0", "conv", "bottom.1"
    yield ("bottom", "c1"), "bottom.2", "tconv3", "bottom.3"
    for i in range(1, 5):
        yield (f"up{i}",), f"up{i}", "up", None
    for i in range(1, 5):
        yield (f"tconvs{i}", "c0"), f"tconvs{i}.0", "tconv3", f"tconvs{i}.1"
        yield (f"tconvs{i}", "c1"), f"tconvs{i}.2", "tconv3", f"tconvs{i}.3"
    yield ("tconvs4", "c2"), "tconvs4.4", "conv", None


def state_dict_from_jax(params: Dict) -> Dict[str, torch.Tensor]:
    """JAX UtNet params pytree -> the port's UtNet state_dict."""
    sd: Dict[str, np.ndarray] = {}
    for path, prefix, kind, act in _layers():
        lay = _get(params, path)
        sd[prefix + ".weight"] = _WMAP[kind](lay["w"])
        if "b" in lay:
            sd[prefix + ".bias"] = _f32(lay["b"])
        if act is not None and "a" in lay:
            sd[act + ".weight"] = _f32(lay["a"]).reshape(1)
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def jax_from_state_dict(sd: Dict[str, Any]) -> Dict:
    """The port's UtNet state_dict (tensors or arrays) -> the JAX UtNet
    params pytree of float32 numpy arrays: the inverse of
    ``state_dict_from_jax`` (HWIO kernels, flipped stride-1 transposed
    convs, (I, 4*O) up-conv matrices, scalar PReLU ``a``). Any tensor laid
    out as a parameter, such as an optimizer moment, maps the same way."""
    def arr(v):
        return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)

    tree: Dict = {}
    for path, prefix, kind, act in _layers():
        lay: Dict = {"w": np.ascontiguousarray(_WMAP_INV[kind](arr(sd[prefix + ".weight"])))}
        if prefix + ".bias" in sd:
            lay["b"] = _f32(arr(sd[prefix + ".bias"]))
        if act is not None and act + ".weight" in sd:
            lay["a"] = _f32(arr(sd[act + ".weight"])).reshape(())
        _set(tree, path, lay)
    return tree


def leaf_paths(tree: Any, prefix=()) -> List[tuple]:
    """Key paths of a nested dict's leaves in ``jax.tree_util.tree_leaves``
    order (dict keys sorted)."""
    if not isinstance(tree, dict):
        return [prefix]
    return [p for k in sorted(tree) for p in leaf_paths(tree[k], prefix + (k,))]


# optax.inject_hyperparams(optax.amsgrad) state, flattened as
# jax.tree_util.tree_leaves gives it: the outer count, the hyperparameters
# by sorted name, amsgrad's count, then mu, nu and nu_max as params trees
OPT_HYPERPARAMS = ("b1", "b2", "eps", "eps_root", "learning_rate")
OPT_MOMENTS = ("mu", "nu", "nu_max")


def opt_leaves(count: int, hyper: Dict[str, float], inner_count: int,
               moments: Dict[str, Dict[str, Any]]) -> List[np.ndarray]:
    """The JAX trainer's ``opt`` checkpoint entry from the port's
    optimizer state: ``moments[name]`` is a state_dict-keyed dict of each
    of ``OPT_MOMENTS``, permuted here as its weight is."""
    leaves = [np.asarray(count, np.int32)]
    leaves += [np.asarray(hyper[k], np.float32) for k in OPT_HYPERPARAMS]
    leaves.append(np.asarray(inner_count, np.int32))
    for name in OPT_MOMENTS:
        tree = jax_from_state_dict(moments[name])
        leaves += [_get(tree, p) for p in leaf_paths(tree)]
    return leaves


def opt_from_leaves(leaves: List[Any], params: Dict):
    """Inverse of ``opt_leaves`` for a checkpoint whose params tree is
    ``params``: (count, hyper, inner_count, {moment: state_dict})."""
    paths = leaf_paths(params)
    n = len(paths)
    head = 2 + len(OPT_HYPERPARAMS)
    if len(leaves) != head + len(OPT_MOMENTS) * n:
        raise ValueError(
            f"optimizer state mismatch: {head + len(OPT_MOMENTS) * n} leaves "
            f"expected, {len(leaves)} saved")
    hyper = {k: float(np.asarray(v)) for k, v in zip(OPT_HYPERPARAMS, leaves[1:head - 1])}
    moments = {}
    for j, name in enumerate(OPT_MOMENTS):
        tree: dict = {}
        for p, v in zip(paths, leaves[head + j * n: head + (j + 1) * n]):
            _set(tree, p, v)
        moments[name] = state_dict_from_jax(tree)
    return int(np.asarray(leaves[0])), hyper, int(np.asarray(leaves[head - 1])), moments


def _flatten(tree: Any, prefix: str = ""):
    arrays: Dict[str, np.ndarray] = {}
    meta: Dict[str, Any] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            a, m = _flatten(v, f"{prefix}{k}/")
            arrays.update(a)
            meta.update(m)
    elif isinstance(tree, (list, tuple)):
        meta[prefix + "__type__"] = "list" if isinstance(tree, list) else "tuple"
        for i, v in enumerate(tree):
            a, m = _flatten(v, f"{prefix}{i}/")
            arrays.update(a)
            meta.update(m)
    elif tree is None:
        meta[prefix[:-1]] = None
    elif hasattr(tree, "shape"):
        arrays[prefix[:-1]] = np.asarray(tree)
    else:
        meta[prefix[:-1]] = tree  # bool/int/float/str leaf
    return arrays, meta


def save(tree: Any, fpath: str) -> None:
    """Write a pytree of numpy arrays in the JAX package's ``.npz`` format
    (``nind_denoise_tpu.models.params_io.save``): array leaves under
    "/"-joined key paths, everything else in the JSON meta entry."""
    arrays, meta = _flatten(tree)
    os.makedirs(os.path.dirname(os.path.abspath(fpath)), exist_ok=True)
    np.savez(fpath, **{_META_KEY: np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8)}, **arrays)


def find_highest(dpath: str, keyword: str) -> Optional[str]:
    """Highest-epoch checkpoint ``<keyword>_<epoch>.(npz|pt|pth)`` in dpath.
    The keyword must be followed directly by ``_<epoch>``, so that
    ``discriminator`` does not match ``discriminator2_*`` files."""
    best, best_epoch = None, -1
    for fn in os.listdir(dpath):
        m = re.match(rf"{re.escape(keyword)}_(\d+)\.(npz|pt|pth)$", fn)
        if m and int(m.group(1)) > best_epoch:
            best, best_epoch = fn, int(m.group(1))
    return os.path.join(dpath, best) if best else None


def find_best(dpath: str, keyword: str) -> Optional[str]:
    """Best-validation-loss epoch from trainres.json (generators only)."""
    if keyword != "generator":
        return None
    resfpath = os.path.join(dpath, "trainres.json")
    if not os.path.isfile(resfpath):
        return None
    with open(resfpath, "r") as fp:
        res = json.load(fp)
    try:
        best_epoch = res["best_epoch"]["validation_loss"]
    except KeyError:
        return None
    for ext in (".npz", ".pt"):
        cand = os.path.join(dpath, f"generator_{best_epoch}{ext}")
        if os.path.isfile(cand):
            return cand
    return None


def complete_path(path: str, models_dpath: Optional[str] = None,
                  keyword: str = "generator") -> str:
    """A checkpoint file, a training directory (best, else highest epoch),
    or a directory under ``models_dpath``; raises FileNotFoundError."""
    if os.path.isfile(path):
        return path
    if os.path.isdir(path):
        best = find_best(path, keyword)
        if best is not None:
            return best
        highest = find_highest(path, keyword)
        if highest is not None:
            return highest
        raise FileNotFoundError(f"no {keyword} checkpoints in {path}")
    if models_dpath and os.path.isdir(os.path.join(models_dpath, path)):
        return complete_path(os.path.join(models_dpath, path), None, keyword)
    raise FileNotFoundError(f"model path not found: {path}")


def load_generator(path: str, activation: str = "PReLU",
                   models_dpath: Optional[str] = None) -> UtNet:
    """UtNet with the weights of ``path`` (``.pt`` state_dict or ``.npz``
    JAX params, resolved by ``complete_path``), loaded strictly, on the CPU
    in float32. The model is built on the ``meta`` device and the
    checkpoint's tensors are assigned to it: no random init runs, and a
    missing, extra or misshapen key raises as in an ordinary load."""
    if os.path.splitext(path)[1] not in ("", ".npz", ".pt", ".pth") \
            and not os.path.isdir(path):
        raise ValueError(f"unsupported checkpoint format: {path}")
    path = complete_path(path, models_dpath, "generator")
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
    return generator_from_state_dict(sd, activation)


def generator_from_state_dict(sd: Dict[str, torch.Tensor],
                              activation: str = "PReLU") -> UtNet:
    """UtNet built on the ``meta`` device with ``sd``'s tensors assigned to
    it (strictly), on the CPU in float32."""
    sd = {k: v.to("cpu", torch.float32).contiguous() for k, v in sd.items()}
    with torch.device("meta"):
        model = UtNet(UtNet.funit_of(sd), activation)
    model.load_state_dict(sd, strict=True, assign=True)
    return model
