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

The Hul discriminators cross the same way: ``hul_state_dict_from_jax``
(the mapping of ``torch_export.export_hul_disc``), its inverse
``hul_jax_from_state_dict`` (``torch_import.import_hul_disc``, which
rejects finalpool heads) and ``load_discriminator``; their Adam state
is ``opt_leaves`` with ``ADAM_MOMENTS``.

The relic zoo crosses by its plan tables (``relic_state_dict_from_jax`` /
``relic_jax_from_state_dict``: per-block lists with None in the state for
layers without BatchNorm; RedishCNN's flat tree), and MobileNetV3 between
JAX's tree and torchvision's state_dict (``mobilenet_state_dict_from_jax``
/ ``mobilenet_jax_from_state_dict``, the port's copy of
``torch_import.import_mobilenetv3``).

UNet crosses with its BatchNorm state (``unet_state_dict_from_jax``,
``torch_export.export_unet``'s mapping, and its inverse
``unet_jax_from_state_dict``), and so do the Hul generators
(``hul_gen_state_dict_from_jax`` / ``hul_gen_jax_from_state_dict``,
``export_hul_gen`` / ``import_hul_gen``); ``generator_state_dict_from_jax``
and ``generator_jax_from_state_dict`` pick the mapping by network name.

``complete_path`` resolves a checkpoint directory to its best-validation
epoch (``trainres.json``) or its highest epoch, as the JAX package's
``params_io`` does. ``load_generator(path, network, activation)`` builds
the model on the ``meta`` device and assigns the checkpoint's tensors to
it, so no random init runs.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from . import RELICS, ZOO
from .unet import UNet
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
    """Key paths of a nested dict's (or list's) leaves in
    ``jax.tree_util.tree_leaves`` order (dict keys sorted, lists in order)."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in leaf_paths(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in leaf_paths(v, prefix + (i,))]
    return [prefix]


def _unflatten_like(template: Any, leaves) -> Any:
    """A tree of ``template``'s structure holding ``leaves`` (an iterator),
    taken in ``leaf_paths`` order."""
    if isinstance(template, dict):
        return {k: _unflatten_like(template[k], leaves) for k in sorted(template)}
    if isinstance(template, (list, tuple)):
        return [_unflatten_like(v, leaves) for v in template]
    return next(leaves)


# optax.inject_hyperparams(optax.amsgrad | optax.adam) state, flattened as
# jax.tree_util.tree_leaves gives it: the outer count, the hyperparameters
# by sorted name, the inner transform's count, then its moments as params
# trees (amsgrad: mu, nu and nu_max; adam: mu and nu)
OPT_HYPERPARAMS = ("b1", "b2", "eps", "eps_root", "learning_rate")
OPT_MOMENTS = ("mu", "nu", "nu_max")
ADAM_MOMENTS = ("mu", "nu")


def opt_leaves(count: int, hyper: Dict[str, float], inner_count: int,
               moments: Dict[str, Dict[str, Any]], names=OPT_MOMENTS,
               to_jax=None) -> List[np.ndarray]:
    """The JAX trainer's ``opt`` checkpoint entry from the port's
    optimizer state: ``moments[name]`` is a state_dict-keyed dict of each
    of ``names``, mapped to the JAX params tree by ``to_jax`` (default:
    UtNet's ``jax_from_state_dict``), so permuted as its weight is."""
    to_jax = to_jax or jax_from_state_dict
    leaves = [np.asarray(count, np.int32)]
    leaves += [np.asarray(hyper[k], np.float32) for k in OPT_HYPERPARAMS]
    leaves.append(np.asarray(inner_count, np.int32))
    for name in names:
        tree = to_jax(moments[name])
        leaves += [_get(tree, p) for p in leaf_paths(tree)]
    return leaves


def opt_from_leaves(leaves: List[Any], params: Any, names=OPT_MOMENTS, from_jax=None):
    """Inverse of ``opt_leaves`` for a checkpoint whose params tree is
    ``params``: (count, hyper, inner_count, {moment: state_dict}), each
    moment mapped by ``from_jax`` (default: UtNet's ``state_dict_from_jax``)."""
    from_jax = from_jax or state_dict_from_jax
    n = len(leaf_paths(params))
    head = 2 + len(OPT_HYPERPARAMS)
    if len(leaves) != head + len(names) * n:
        raise ValueError(
            f"optimizer state mismatch: {head + len(names) * n} leaves "
            f"expected, {len(leaves)} saved")
    hyper = {k: float(np.asarray(v)) for k, v in zip(OPT_HYPERPARAMS, leaves[1:head - 1])}
    moments = {name: from_jax(_unflatten_like(
        params, iter(leaves[head + j * n: head + (j + 1) * n])))
        for j, name in enumerate(names)}
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


def load_generator(path: str, network: str = "UtNet", activation: str = "PReLU",
                   models_dpath: Optional[str] = None) -> nn.Module:
    """The generator ``network`` with the weights of ``path`` (``.pt``
    state_dict or ``.npz`` JAX params, resolved by ``complete_path``),
    loaded strictly, on the CPU in float32. The model is built on the
    ``meta`` device and the checkpoint's tensors are assigned to it: no
    random init runs, and a missing, extra or misshapen key raises as in an
    ordinary load. A UNet ``.npz`` must bundle its BatchNorm state
    (``{"params", "state"}``), as the JAX engine requires."""
    if os.path.splitext(path)[1] not in ("", ".npz", ".pt", ".pth") \
            and not os.path.isdir(path):
        raise ValueError(f"unsupported checkpoint format: {path}")
    path = complete_path(path, models_dpath, "generator")
    if path.endswith(".npz"):
        tree = load_npz(path)
        # native checkpoints may bundle {'params': ..., 'state': ...}
        state = None
        if isinstance(tree, dict) and "params" in tree:
            tree, state = tree["params"], tree.get("state")
        if network == "UNet" and state is None:
            raise ValueError(f"{path}: a UNet checkpoint needs its BatchNorm "
                             "state ({'params': ..., 'state': ...})")
        sd = generator_state_dict_from_jax(network, tree, state)
    elif path.endswith((".pt", ".pth")):
        sd = torch.load(path, map_location="cpu", weights_only=True)
    else:
        raise ValueError(f"unsupported checkpoint format: {path}")
    return generator_from_state_dict(sd, activation, network)


def generator_from_state_dict(sd: Dict[str, torch.Tensor], activation: str = "PReLU",
                              network: str = "UtNet") -> nn.Module:
    """The generator ``network`` built on the ``meta`` device with ``sd``'s
    tensors assigned to it (strictly), on the CPU, floating tensors in
    float32."""
    from . import GENERATORS, THIRD_PARTY, ZOO_GENERATORS, get_network, is_discriminator

    cls = get_network(network)  # an unknown name raises KeyError
    if is_discriminator(network):
        raise ValueError(f"{network} is not a generator")
    sd = {k: v.to("cpu", torch.float32).contiguous() if v.is_floating_point()
          else v.to("cpu") for k, v in sd.items()}
    with torch.device("meta"):
        if network == "UtNet":
            model = UtNet(UtNet.funit_of(sd), activation)
        elif network == "UNet":
            model = UNet(int(sd["inc.conv.conv.0.weight"].shape[1]),
                         int(sd["outc.conv.weight"].shape[0]))
        elif network in ZOO_GENERATORS or network in RELICS or network in THIRD_PARTY:
            model = cls(**cls.config_of(sd))
        else:
            w = sd["enc128to126std.0.weight"]
            model = GENERATORS[network](int(w.shape[0]) // 2, activation, int(w.shape[1]))
    model.load_state_dict(sd, strict=True, assign=True)
    return model


def generator_state_dict_from_jax(network: str, params: Dict,
                                  state: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
    """A JAX generator's params (and UNet's BN state) -> the port's
    state_dict of ``network``. ``state`` None maps the parameters alone."""
    if network == "UNet":
        return unet_state_dict_from_jax(params, state)
    if network in ("Hulb128Net", "Hulbs128Net"):
        return hul_gen_state_dict_from_jax(params, network)
    if network in ZOO:
        return zoo_state_dict_from_jax(network, params, state)
    if network in RELICS:
        return relic_state_dict_from_jax(network, params, state)
    if network == "MobileNetV3":
        return mobilenet_state_dict_from_jax(params, state)
    return state_dict_from_jax(params)


def generator_jax_from_state_dict(network: str, sd: Dict[str, Any]):
    """Inverse of ``generator_state_dict_from_jax``: (params, state), the
    state None for a stateless network or a dict without running stats."""
    if network == "UNet":
        return unet_jax_from_state_dict(sd)
    if network in ("Hulb128Net", "Hulbs128Net"):
        return hul_gen_jax_from_state_dict(sd, network), None
    if network in ZOO:
        return zoo_jax_from_state_dict(network, sd)
    if network in RELICS:
        return relic_jax_from_state_dict(network, sd)
    if network == "MobileNetV3":
        return mobilenet_jax_from_state_dict(sd)
    return jax_from_state_dict(sd), None


# -- UNet ---------------------------------------------------------------------

def _unet_doubles():
    """(JAX key, torch prefix) of every UNet double block."""
    yield "inc", "inc.conv.conv"
    for i in range(1, 5):
        yield f"down{i}", f"down{i}.mpconv.1.conv"
    for i in range(1, 5):
        yield f"up{i}", f"up{i}.conv.conv"


def unet_state_dict_from_jax(params: Dict, state: Optional[Dict]) -> Dict[str, torch.Tensor]:
    """JAX UNet (params, BN state) -> the port's ``UNet`` state_dict, the
    mapping of ``torch_export.export_unet``: BN ``scale/bias/mean/var`` ->
    ``weight/bias/running_mean/running_var`` (``num_batches_tracked`` 0).
    ``state`` None maps the parameters alone (an optimizer moment)."""
    sd: Dict[str, np.ndarray] = {}
    for key, prefix in _unet_doubles():
        for j in (0, 1):
            conv, bn = params[key][f"c{j}"], params[key][f"bn{j}"]
            sd[f"{prefix}.{3 * j}.weight"] = _conv_w(conv["w"])
            sd[f"{prefix}.{3 * j}.bias"] = _f32(conv["b"])
            sd[f"{prefix}.{3 * j + 1}.weight"] = _f32(bn["scale"])
            sd[f"{prefix}.{3 * j + 1}.bias"] = _f32(bn["bias"])
            if state is not None:
                st = state[key][f"bn{j}"]
                sd[f"{prefix}.{3 * j + 1}.running_mean"] = _f32(st["mean"])
                sd[f"{prefix}.{3 * j + 1}.running_var"] = _f32(st["var"])
                sd[f"{prefix}.{3 * j + 1}.num_batches_tracked"] = np.zeros((), np.int64)
    for i in range(1, 5):
        sd[f"up{i}.up.weight"] = _upconv_w(params[f"up{i}_t"]["w"])
        sd[f"up{i}.up.bias"] = _f32(params[f"up{i}_t"]["b"])
    sd["outc.conv.weight"] = _conv_w(params["outc"]["w"])
    sd["outc.conv.bias"] = _f32(params["outc"]["b"])
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def _arr(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def unet_jax_from_state_dict(sd: Dict[str, Any]):
    """A UNet state_dict (the port's or the reference's ``.pt``) -> JAX
    (params, state), as ``torch_import.import_unet``; the state is None
    where the dict holds no running stats."""
    def lay(prefix, kind="conv"):
        return {"w": np.ascontiguousarray(_WMAP_INV[kind](_arr(sd[prefix + ".weight"]))),
                "b": _f32(_arr(sd[prefix + ".bias"]))}

    params: Dict = {}
    state: Optional[Dict] = {} if "inc.conv.conv.1.running_mean" in sd else None
    for key, prefix in _unet_doubles():
        params[key] = {}
        if state is not None:
            state[key] = {}
        for j in (0, 1):
            bn = f"{prefix}.{3 * j + 1}"
            params[key][f"c{j}"] = lay(f"{prefix}.{3 * j}")
            params[key][f"bn{j}"] = {"scale": _f32(_arr(sd[bn + ".weight"])),
                                     "bias": _f32(_arr(sd[bn + ".bias"]))}
            if state is not None:
                state[key][f"bn{j}"] = {"mean": _f32(_arr(sd[bn + ".running_mean"])),
                                        "var": _f32(_arr(sd[bn + ".running_var"]))}
    for i in range(1, 5):
        params[f"up{i}_t"] = lay(f"up{i}.up", "up")
    params["outc"] = lay("outc.conv")
    return params, state


# -- the Hul generators -------------------------------------------------------

def hul_gen_state_dict_from_jax(params: Dict, network: str) -> Dict[str, torch.Tensor]:
    """JAX Hulb128Net / Hulbs128Net params -> the port's state_dict, the
    mapping of ``torch_export.export_hul_gen``: convs as ``nn.Conv2d``,
    the transposed convs (plain convs over flipped kernels in JAX) as
    ``nn.ConvTranspose2d``, the per-layer PReLU ``a`` and the output
    PReLU ``_final_a`` as ``activation.weight``. The unused ``a`` that
    JAX's init gives the head's last conv is dropped, as JAX's own
    ``.pt`` export drops it."""
    from .hul_gen import CONV_TYPES, VARIANTS, layer_slots

    prelu = VARIANTS[network] == "PReLU"
    sd: Dict[str, np.ndarray] = {}
    for bname, li, ltype, idx, act in layer_slots():
        lay = params[bname][li]
        sd[f"{bname}.{idx}.weight"] = (_conv_w if ltype in CONV_TYPES else _tconv3_w)(lay["w"])
        if "b" in lay:
            sd[f"{bname}.{idx}.bias"] = _f32(lay["b"])
        if act is not None and prelu:
            sd[f"{bname}.{act}.weight"] = _f32(lay["a"]).reshape(1)
    if "_final_a" in params:
        sd["activation.weight"] = _f32(params["_final_a"]).reshape(1)
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def hul_gen_jax_from_state_dict(sd: Dict[str, Any], network: str) -> Dict:
    """A Hul generator state_dict (the port's or the reference's ``.pt``)
    -> JAX params: the inverse of ``hul_gen_state_dict_from_jax``, as
    ``torch_import.import_hul_gen``."""
    from .hul_gen import _PLAN, CONV_TYPES, VARIANTS, layer_slots

    prelu = VARIANTS[network] == "PReLU"
    params: Dict = {b: [] for b in _PLAN}
    for bname, _li, ltype, idx, act in layer_slots():
        inv = _conv_w_inv if ltype in CONV_TYPES else _tconv3_w_inv
        lay = {"w": np.ascontiguousarray(inv(_arr(sd[f"{bname}.{idx}.weight"])))}
        if f"{bname}.{idx}.bias" in sd:
            lay["b"] = _f32(_arr(sd[f"{bname}.{idx}.bias"]))
        if act is not None and prelu:
            lay["a"] = _f32(_arr(sd[f"{bname}.{act}.weight"])).reshape(())
        params[bname].append(lay)
    if "activation.weight" in sd:
        params["_final_a"] = _f32(_arr(sd["activation.weight"])).reshape(())
    return params


# -- the Hul discriminators ---------------------------------------------------

def hul_state_dict_from_jax(params: Dict, state: Optional[Dict],
                            network: str) -> Dict[str, torch.Tensor]:
    """JAX Hul discriminator (params, BN state) -> the port's ``HulDisc``
    state_dict, as ``torch_export.export_hul_disc`` writes the reference's
    layout. ``state`` None maps the parameters alone (an optimizer moment
    is laid out as the parameters)."""
    from .hul import layer_slots

    sd: Dict[str, np.ndarray] = {}
    for bname, li, spec, conv, act, bn in layer_slots(network):
        lay = params[bname][li]
        sd[f"{bname}.{conv}.weight"] = _conv_w(lay["w"])
        if spec[5]:
            sd[f"{bname}.{conv}.bias"] = _f32(lay["b"])
        if act is not None and "a" in lay:
            sd[f"{bname}.{act}.weight"] = _f32(lay["a"]).reshape(1)
        if bn is not None:
            sd[f"{bname}.{bn}.weight"] = _f32(lay["bn"]["scale"])
            sd[f"{bname}.{bn}.bias"] = _f32(lay["bn"]["bias"])
            if state is not None:
                st = state[bname][li]
                sd[f"{bname}.{bn}.running_mean"] = _f32(st["mean"])
                sd[f"{bname}.{bn}.running_var"] = _f32(st["var"])
                sd[f"{bname}.{bn}.num_batches_tracked"] = np.zeros((), np.int64)
    if "_out_a" in params:
        sd["out_activation.weight"] = _f32(params["_out_a"]).reshape(1)
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def hul_jax_from_state_dict(sd: Dict[str, Any], network: str):
    """A Hul discriminator state_dict (the port's or the reference's
    ``.pt``) -> JAX (params, BN state): the inverse of
    ``hul_state_dict_from_jax``, as ``torch_import.import_hul_disc``. Only
    the ``finalpool=False`` wiring exists in either package: a finalpool
    checkpoint (a 1x1 first decide conv) raises ValueError. A layer's state
    is None where the dict holds no running stats."""
    from .hul import VARIANTS, layer_slots

    def arr(v):
        return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)

    plan = VARIANTS[network][0]
    dk = "decide.0.weight"
    if arr(sd[dk]).shape[-1] != plan["decide"][0][2]:
        raise ValueError(
            f"{network}: decide head kernel {tuple(arr(sd[dk]).shape)} does not "
            "match the finalpool=False wiring (finalpool checkpoints are "
            "not supported)")
    params: Dict = {b: [] for b in plan}
    state: Dict = {b: [] for b in plan}
    for bname, _li, spec, conv, act, bn in layer_slots(network):
        key = f"{bname}.{conv}.weight"
        w = arr(sd[key])
        if w.shape[-1] != spec[2]:
            raise ValueError(f"{network}: {key} kernel {tuple(w.shape)} != plan k={spec[2]}")
        lay = {"w": np.ascontiguousarray(_conv_w_inv(w))}
        if spec[5]:
            lay["b"] = _f32(arr(sd[f"{bname}.{conv}.bias"]))
        if act is not None and f"{bname}.{act}.weight" in sd:
            lay["a"] = _f32(arr(sd[f"{bname}.{act}.weight"])).reshape(())
        st = None
        if bn is not None:
            lay["bn"] = {"scale": _f32(arr(sd[f"{bname}.{bn}.weight"])),
                         "bias": _f32(arr(sd[f"{bname}.{bn}.bias"]))}
            if f"{bname}.{bn}.running_mean" in sd:
                st = {"mean": _f32(arr(sd[f"{bname}.{bn}.running_mean"])),
                      "var": _f32(arr(sd[f"{bname}.{bn}.running_var"]))}
        params[bname].append(lay)
        state[bname].append(st)
    if "out_activation.weight" in sd:
        params["_out_a"] = _f32(arr(sd["out_activation.weight"])).reshape(())
    return params, state


def load_discriminator(model_path: str, network: str,
                       models_dpath: Optional[str] = None,
                       keyword: str = "discriminator") -> Dict[str, Any]:
    """Resolve and load a discriminator checkpoint, as the JAX package's
    ``params_io.load_discriminator``: ``{"params", "state", "opt",
    "sched"}`` in the JAX layout. ``opt`` and ``sched`` are None unless the
    file is an ``.npz`` that bundled them; a reference ``.pt`` carries
    neither, so a resume from one restarts Adam and the plateau window."""
    fpath = complete_path(model_path, models_dpath, keyword)
    if fpath.endswith(".npz"):
        tree = load_npz(fpath)
        if isinstance(tree, dict) and "params" in tree:
            return {"params": tree["params"], "state": tree.get("state"),
                    "opt": tree.get("opt"), "sched": tree.get("sched")}
        return {"params": tree, "state": None, "opt": None, "sched": None}
    if fpath.endswith((".pt", ".pth")):
        from .hul import VARIANTS

        if network not in VARIANTS:
            # the JAX package's torch_import has no mapping for the zoo or
            # the relics
            raise NotImplementedError(f"torch import for {network}: only a .npz of "
                                      "either trainer resumes it")
        params, state = hul_jax_from_state_dict(
            torch.load(fpath, map_location="cpu", weights_only=True), network)
        return {"params": params, "state": state, "opt": None, "sched": None}
    raise ValueError(f"unsupported checkpoint format: {fpath}")


def disc_state_dict_from_jax(network: str, params: Dict,
                             state: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
    """Any discriminator's JAX (params, BN state) -> the port's state_dict;
    ``state`` None maps the parameters alone (an optimizer moment)."""
    from .hul import VARIANTS

    if network in VARIANTS:
        return hul_state_dict_from_jax(params, state, network)
    if network in RELICS:
        return relic_state_dict_from_jax(network, params, state)
    return zoo_state_dict_from_jax(network, params, state)


def disc_jax_from_state_dict(network: str, sd: Dict[str, Any]):
    """Inverse of ``disc_state_dict_from_jax``: (params, state)."""
    from .hul import VARIANTS

    if network in VARIANTS:
        return hul_jax_from_state_dict(sd, network)
    if network in RELICS:
        return relic_jax_from_state_dict(network, sd)
    return zoo_jax_from_state_dict(network, sd)


# -- the legacy and pix2pix zoo -------------------------------------------------

def _nlayer_slots(cfg: Dict, ppre=(), tpre=""):
    n, bn = cfg["n_layers"], cfg["norm_type"] == "batch"
    yield "conv", ppre + ("layers", 0, "c"), None, f"{tpre}model.0"
    for i in range(1, n + 1):
        yield "conv", ppre + ("layers", i, "c"), None, f"{tpre}model.{2 + 3 * (i - 1)}"
        if bn:
            yield "bn", ppre + ("layers", i, "n"), ppre + (f"n{i}",), f"{tpre}model.{3 + 3 * (i - 1)}"
    yield "conv", ppre + ("out",), None, f"{tpre}model.{2 + 3 * n}"


def zoo_slots(network: str, cfg: Dict):
    """For every conv and BatchNorm of a zoo network of constructor
    arguments ``cfg``: (kind, JAX params path, JAX state path or None,
    torch module prefix); kind is ``conv``, ``tconv3`` (a transposed conv,
    a plain conv over the flipped kernel in JAX, any k and stride) or
    ``bn``."""
    if network == "DnCNN":
        depth = cfg["depth"]
        yield "conv", ("first",), None, "dncnn.0"
        for i in range(depth - 2):
            yield "conv", ("mid", i, "c"), None, f"dncnn.{2 + 3 * i}"
            yield "bn", ("mid", i, "bn"), (f"bn{i}",), f"dncnn.{3 + 3 * i}"
        yield "conv", ("last",), None, f"dncnn.{2 + 3 * (depth - 2)}"
    elif network == "RedCNN":
        for name, kind in (("conv_first", "conv"), ("conv", "conv"), ("deconv", "tconv3"),
                           ("deconv_last", "tconv3")):
            yield kind, (name,), None, name
    elif network == "ResnetGenerator":
        bn, nb = cfg["norm_type"] == "batch", cfg["n_blocks"]
        up = 10 + nb  # the Sequential's index of the first up conv
        for tag, kind, at in (("inc", "conv", 1), ("down1", "conv", 4), ("down2", "conv", 7),
                              ("up1", "tconv3", up), ("up2", "tconv3", up + 3)):
            yield kind, (tag,), None, f"model.{at}"
            if bn:
                yield "bn", (tag + "_n",), (tag + "_n",), f"model.{at + 1}"
        for i in range(nb):
            for j, at in ((0, 1), (1, 5)):
                yield "conv", ("blocks", i, f"c{j}"), None, f"model.{10 + i}.conv_block.{at}"
                if bn:
                    yield ("bn", ("blocks", i, f"n{j}"), (f"res{i}_n{j}",),
                           f"model.{10 + i}.conv_block.{at + 1}")
        yield "conv", ("outc",), None, f"model.{up + 7}"
    elif network in ("NLayerDiscriminator", "PatchGAN"):
        yield from _nlayer_slots(cfg)
    elif network == "PixelDiscriminator":
        yield "conv", ("c0",), None, "net.0"
        yield "conv", ("c1",), None, "net.2"
        if cfg["norm_type"] == "batch":
            yield "bn", ("n1",), ("n1",), "net.3"
        yield "conv", ("c2",), None, "net.5"
    elif network == "MultiscaleDiscriminator":
        for d in range(cfg["num_D"]):
            yield from _nlayer_slots(cfg, (f"d{d}",), f"d{d}.")
    else:
        raise ValueError(f"{network} is not a network of the legacy or pix2pix zoo")


def zoo_config_of_jax(network: str, params: Dict) -> Dict:
    """The constructor arguments ``zoo_slots`` needs, from a JAX params
    tree (a tree without norm parameters reads as instance norm)."""
    if network == "DnCNN":
        return {"depth": len(params["mid"]) + 2}
    if network == "ResnetGenerator":
        return {"n_blocks": len(params["blocks"]),
                "norm_type": "batch" if "inc_n" in params else "instance"}
    if network in ("NLayerDiscriminator", "PatchGAN"):
        return {"n_layers": len(params["layers"]) - 1,
                "norm_type": "batch" if "n" in params["layers"][1] else "instance"}
    if network == "PixelDiscriminator":
        return {"norm_type": "batch" if "n1" in params else "instance"}
    if network == "MultiscaleDiscriminator":
        return {**zoo_config_of_jax("PatchGAN", params["d0"]), "num_D": len(params)}
    return {}


def _bn_to_sd(sd: Dict, prefix: str, bn: Dict, st: Optional[Dict]) -> None:
    sd[prefix + ".weight"] = _f32(bn["scale"])
    sd[prefix + ".bias"] = _f32(bn["bias"])
    if st is not None:
        sd[prefix + ".running_mean"] = _f32(st["mean"])
        sd[prefix + ".running_var"] = _f32(st["var"])
        sd[prefix + ".num_batches_tracked"] = np.zeros((), np.int64)


def _bn_from_sd(sd: Dict, prefix: str):
    """(BN params, BN state or None where the dict holds no running stats)."""
    bn = {"scale": _f32(_arr(sd[prefix + ".weight"])), "bias": _f32(_arr(sd[prefix + ".bias"]))}
    if prefix + ".running_mean" not in sd:
        return bn, None
    return bn, {"mean": _f32(_arr(sd[prefix + ".running_mean"])),
                "var": _f32(_arr(sd[prefix + ".running_var"]))}


def _state_dict_of(slots, params: Dict, state: Optional[Dict]) -> Dict[str, torch.Tensor]:
    """The state_dict of the JAX (params, state) that ``slots`` (kind, params
    path, state path, module prefix) lay out; ``state`` None maps the
    parameters alone."""
    sd: Dict[str, np.ndarray] = {}
    for kind, ppath, spath, prefix in slots:
        lay = _get(params, ppath)
        if kind == "bn":
            _bn_to_sd(sd, prefix, lay, None if state is None else _get(state, spath))
            continue
        sd[prefix + ".weight"] = _WMAP[kind](lay["w"])
        if "b" in lay:
            sd[prefix + ".bias"] = _f32(lay["b"])
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def _tree_of(slots, sd: Dict[str, Any]):
    """Inverse of ``_state_dict_of``: JAX (params, state), the state None
    where the dict holds no running stats and ``slots`` has BatchNorm sites
    (``{}`` where it has none)."""
    slots = list(slots)
    stats = any(k.endswith(".running_mean") for k in sd)
    bn_sites = any(kind == "bn" for kind, *_ in slots)
    params: Dict = {}
    state: Optional[Dict] = None if bn_sites and not stats else {}
    for kind, ppath, spath, prefix in slots:
        if kind == "bn":
            bn, st = _bn_from_sd(sd, prefix)
            _set(params, ppath, bn)
            if state is not None:
                _set(state, spath, st)
            continue
        lay = {"w": np.ascontiguousarray(_WMAP_INV[kind](_arr(sd[prefix + ".weight"])))}
        if prefix + ".bias" in sd:
            lay["b"] = _f32(_arr(sd[prefix + ".bias"]))
        _set(params, ppath, lay)
    return _as_lists(params), None if state is None else _as_lists(state)


def zoo_state_dict_from_jax(network: str, params: Dict,
                            state: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
    """A zoo network's JAX (params, BN state) -> the port's state_dict:
    HWIO kernels as ``nn.Conv2d``, the transposed convs (flipped plain-conv
    kernels in JAX) as ``nn.ConvTranspose2d``, BN ``scale/bias/mean/var`` as
    ``weight/bias/running_mean/running_var`` (``num_batches_tracked`` 0).
    ``state`` None maps the parameters alone (an optimizer moment)."""
    return _state_dict_of(zoo_slots(network, zoo_config_of_jax(network, params)), params, state)


def _as_lists(tree: Any) -> Any:
    """Dicts keyed by list indices (``_set`` with int keys) as lists."""
    if not isinstance(tree, dict):
        return tree
    out = {k: _as_lists(v) for k, v in tree.items()}
    if out and all(isinstance(k, int) for k in out):
        return [out[i] for i in range(len(out))]
    return out


def zoo_jax_from_state_dict(network: str, sd: Dict[str, Any]):
    """A zoo state_dict -> JAX (params, state): the inverse of
    ``zoo_state_dict_from_jax``. The state is None where the dict holds no
    running stats, and for RedCNN, which has none in JAX either; a net
    without BatchNorm sites has the JAX package's empty state ``{}``."""
    params, state = _tree_of(zoo_slots(network, ZOO[network].config_of(sd)), sd)
    return params, None if network == "RedCNN" else state


# -- the relic zoo ----------------------------------------------------------------

_REDISH = (("conv_first", "conv"), ("conv", "conv"), ("deconv", "tconv3"),
           ("deconv_last", "tconv3"))


def _relic_kind(op: str) -> str:
    """The weight map of a relic op: a conv, the up-conv, or another
    transposed conv (a plain conv over the flipped kernel in JAX)."""
    return "conv" if op.startswith("c") else "up" if op == "t2s2" else "tconv3"


def relic_state_dict_from_jax(network: str, params: Dict,
                              state: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
    """A relic network's JAX (params, BN state) -> the port's state_dict,
    walking the plan table: HWIO kernels as ``nn.Conv2d``, flipped plain-conv
    kernels as ``nn.ConvTranspose2d`` (any k, dilation or stride), (I, 4*O)
    up-conv matrices as the k2 s2 ``nn.ConvTranspose2d``, the scalar PReLU
    ``a``, BN ``scale/bias/mean/var`` as ``weight/bias/running_mean/
    running_var`` (``num_batches_tracked`` 0). ``state`` None maps the
    parameters alone (an optimizer moment)."""
    from .relics import layer_slots

    sd: Dict[str, np.ndarray] = {}
    if network == "RedishCNN":
        for name, kind in _REDISH:
            sd[name + ".weight"] = _WMAP[kind](params[name]["w"])
            sd[name + ".bias"] = _f32(params[name]["b"])
        _bn_to_sd(sd, "bn", params["bn"], None if state is None else state["bn"])
    else:
        for bname, li, spec, slots in layer_slots(RELICS[network].plan):
            lay = params[bname][li]
            if "conv" in slots:
                prefix = f"{bname}.{slots['conv']}"
                sd[prefix + ".weight"] = _WMAP[_relic_kind(spec[0])](lay["w"])
                if "b" in lay:
                    sd[prefix + ".bias"] = _f32(lay["b"])
            if "a" in lay:
                sd[f"{bname}.{slots['act']}.weight"] = _f32(lay["a"]).reshape(1)
            if "bn" in slots:
                _bn_to_sd(sd, f"{bname}.{slots['bn']}", lay["bn"],
                          None if state is None else state[bname][li])
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def relic_jax_from_state_dict(network: str, sd: Dict[str, Any]):
    """A relic state_dict -> JAX (params, state): the inverse of
    ``relic_state_dict_from_jax``. The state is JAX's per-block lists, None
    for a layer without BatchNorm (RedishCNN: ``{"bn": ...}``); it is None
    where the dict holds no running stats and the network has BatchNorm
    sites."""
    from .relics import layer_slots

    stats = any(k.endswith(".running_mean") for k in sd)
    if network == "RedishCNN":
        params: Dict = {name: {"w": np.ascontiguousarray(_WMAP_INV[kind](_arr(sd[name + ".weight"]))),
                               "b": _f32(_arr(sd[name + ".bias"]))} for name, kind in _REDISH}
        params["bn"], st = _bn_from_sd(sd, "bn")
        return params, ({"bn": st} if stats else None)
    plan = RELICS[network].plan
    bn_sites = any("bn" in slots for *_, slots in layer_slots(plan))
    params = {b: [] for b in plan}
    state: Optional[Dict] = {b: [] for b in plan} if stats or not bn_sites else None
    for bname, _li, spec, slots in layer_slots(plan):
        lay: Dict = {}
        st = None
        if "conv" in slots:
            prefix = f"{bname}.{slots['conv']}"
            lay["w"] = np.ascontiguousarray(_WMAP_INV[_relic_kind(spec[0])](
                _arr(sd[prefix + ".weight"])))
            if prefix + ".bias" in sd:
                lay["b"] = _f32(_arr(sd[prefix + ".bias"]))
        if "act" in slots and f"{bname}.{slots['act']}.weight" in sd:
            lay["a"] = _f32(_arr(sd[f"{bname}.{slots['act']}.weight"])).reshape(())
        if "bn" in slots:
            lay["bn"], st = _bn_from_sd(sd, f"{bname}.{slots['bn']}")
        params[bname].append(lay)
        if state is not None:
            state[bname].append(st)
    return params, state


# -- MobileNetV3 ------------------------------------------------------------------

def mobilenet_slots():
    """For every conv and BatchNorm of MobileNetV3: (kind, JAX params path,
    JAX state path or None, torchvision module prefix), as ``zoo_slots``;
    JAX keeps a stem's or the last layer's stats under ``bn``, a block's
    under its layer's name, the head's under ``cbr``."""
    from .third_party import LARGE_DILATED

    def cbn(path, prefix, spath=None):
        yield "conv", path, None, prefix + ".0"
        yield "bn", path + ("bn",), spath or path, prefix + ".1"

    yield from cbn(("backbone", 0), "backbone.0", ("backbone", 0, "bn"))
    cin = 16
    for i, (_k, exp, cout, use_se, _a, _s, _d) in enumerate(LARGE_DILATED):
        p, j = f"backbone.{i + 1}.block", 0
        blk = ("backbone", i + 1)
        if exp != cin:
            yield from cbn(blk + ("expand",), f"{p}.{j}")
            j += 1
        yield from cbn(blk + ("dw",), f"{p}.{j}")
        j += 1
        if use_se:
            for fc in ("fc1", "fc2"):
                yield "conv", blk + ("se", fc), None, f"{p}.{j}.{fc}"
            j += 1
        yield from cbn(blk + ("project",), f"{p}.{j}")
        cin = cout
    last = len(LARGE_DILATED) + 1
    yield from cbn(("backbone", last), f"backbone.{last}", ("backbone", last, "bn"))
    yield from cbn(("classifier", "cbr"), "classifier.cbr")
    yield "conv", ("classifier", "scale"), None, "classifier.scale.1"
    for head in ("low_classifier", "high_classifier"):
        yield "conv", ("classifier", head), None, f"classifier.{head}"


def mobilenet_state_dict_from_jax(params: Dict,
                                  state: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
    """JAX MobileNetV3 (params, BN state) -> torchvision's state_dict
    (``state`` None: the parameters alone)."""
    return _state_dict_of(mobilenet_slots(), params, state)


def mobilenet_jax_from_state_dict(sd: Dict[str, Any]):
    """torchvision's ``lraspp_mobilenet_v3_large`` state_dict (or the
    reference wrapper's, under ``net.``) -> JAX (params, state), as
    ``torch_import.import_mobilenetv3`` builds them; the state None where the
    dict holds no running stats."""
    if any(k.startswith("net.") for k in sd):
        sd = {k[4:]: v for k, v in sd.items() if k.startswith("net.")}
    return _tree_of(mobilenet_slots(), sd)
