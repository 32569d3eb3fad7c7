"""darktable XMP sidecar history splitting.

A port of ``read_config`` and ``split_history`` from
``nind_denoise_tpu/pipeline/xmp.py`` (the reference's
``parse_darktable_history_stack``, src/denoise.py:126-220) onto the
standard library's ``xml.etree.ElementTree``: the JAX package parses with
BeautifulSoup and lxml, which the GPU hosts need not have. The split
sidecars equal the JAX package's element for element, tag, attributes and
order (tests/test_torch_xmp.py); the namespace prefixes of the input are
kept, and its processing instructions (darktable's ``xpacket``) are copied
around the root element.

A darktable sidecar carries the full edit-history stack; the split gives:

* ``.s1.xmp``: first-stage ops only (RAW development that must happen
  before denoising); ``flip`` is kept but disabled so the tile geometry
  stays upright.
* ``.s2.xmp``: second-stage ops; first-stage-only ops are removed, unknown
  ops kept (the K/K/R/K rule), the config's per-op attribute overrides
  applied (the ``colorin`` params blob), ``iop_order_version`` forced to 5
  and ``colorin`` moved next to ``demosaic`` in the iop order list.

``--nightmode`` moves ``exposure``/``toneequal`` into the first stage so
that brightness is normalized before denoising (``read_config``).
"""

from __future__ import annotations

import copy
import io
import os
import pathlib
import re
import xml.etree.ElementTree as ET
from typing import Dict, Optional

import yaml

DEFAULT_OPERATIONS_FPATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                        "operations.yaml")
NIGHTMODE_OPS = ("exposure", "toneequal")
# the processing instructions (and comments) around the root element
_PROLOG = re.compile(r"\s*(?:<\?xml[^>]*\?>\s*)?((?:<\?[^>]*\?>\s*|<!--.*?-->\s*)*)", re.S)
_EPILOG = re.compile(r"((?:\s*<\?[^>]*\?>)*)\s*$")


def read_config(config_path: Optional[str] = None, nightmode: bool = False,
                verbose: bool = False) -> Dict:
    """Load the pipeline operations config; nightmode rewrites the op split."""
    config_path = config_path or DEFAULT_OPERATIONS_FPATH
    with io.open(config_path, "r", encoding="utf-8") as fp:
        cfg = yaml.safe_load(fp)
    if nightmode:
        if verbose:
            print("Updating ops for nightmode ...")
        for op in NIGHTMODE_OPS:
            if op not in cfg["operations"]["first_stage"]:
                cfg["operations"]["first_stage"].append(op)
            if op in cfg["operations"]["second_stage"]:
                cfg["operations"]["second_stage"].remove(op)
    return cfg


def _namespaces(text: str) -> Dict[str, str]:
    """prefix -> URI of every namespace the document declares, registered
    with ElementTree so that its output keeps the prefixes."""
    ns: Dict[str, str] = {}
    for _, (prefix, uri) in ET.iterparse(io.BytesIO(text.encode("utf-8")),
                                         events=("start-ns",)):
        ns.setdefault(prefix, uri)
    for prefix, uri in ns.items():
        if prefix and not re.fullmatch(r"ns\d+", prefix):
            ET.register_namespace(prefix, uri)
    return ns


def _serialize(prolog: str, root: ET.Element, epilog: str) -> str:
    return ('<?xml version="1.0" encoding="utf-8"?>\n' + prolog
            + ET.tostring(root, encoding="unicode") + epilog + "\n")


def split_history(input_xmp: pathlib.Path, config: Dict, verbose: bool = False) -> None:
    """Write <stem>.s1.xmp and <stem>.s2.xmp next to the sidecar."""
    operations = config["operations"]
    first = set(operations["first_stage"])
    second = set(operations["second_stage"])
    overrides = operations.get("overrides", {})

    input_xmp = pathlib.Path(input_xmp)
    text = input_xmp.read_text()
    ns = _namespaces(text)

    def q(name: str) -> str:
        prefix, local = name.split(":")
        return f"{{{ns[prefix]}}}{local}"

    prolog = _PROLOG.match(text).group(1)
    epilog = _EPILOG.search(text).group(1)
    root = ET.fromstring(text)
    history = next(root.iter(q("darktable:history")), None)
    if history is None:
        raise ValueError(f"no darktable:history in {input_xmp}")
    history_org = copy.deepcopy(history)
    parents = {c: p for p in root.iter() for c in p}

    ops = list(history.iter(q("rdf:li")))
    ops.sort(key=lambda tag: int(tag.attrib[q("darktable:num")]))

    # ---- stage 1: keep only first-stage ops; disable flip ----
    for op in reversed(ops):
        name = op.attrib[q("darktable:operation")]
        if name not in first:
            parents[op].remove(op)
            if verbose:
                print("s1 removed:", name)
        elif name == "flip":
            op.set(q("darktable:enabled"), "0")

    s1_path = input_xmp.with_suffix(".s1.xmp")
    s1_path.unlink(missing_ok=True)
    s1_path.write_text(_serialize(prolog, root, epilog))

    # ---- stage 2: restore, then apply the keep/keep/remove/keep rule ----
    holder = parents[history]
    holder.insert(list(holder).index(history), history_org)
    holder.remove(history)
    parents = {c: p for p in history_org.iter() for c in p}
    for op in reversed(list(history_org.iter(q("rdf:li")))):
        name = op.attrib[q("darktable:operation")]
        if name not in second and name in first:
            parents[op].remove(op)  # first-stage-only op: already applied in stage 1
            if verbose:
                print("s2 removed:", name)
        elif name in overrides:
            for key, val in overrides[name].items():
                op.set(q(key), str(val))

    desc = next(root.iter(q("rdf:Description")))
    desc.set(q("darktable:iop_order_version"), "5")
    order_key = q("darktable:iop_order_list")
    if order_key in desc.attrib:
        desc.set(order_key, desc.attrib[order_key]
                 .replace("colorin,0,", "")
                 .replace("demosaic,0", "demosaic,0,colorin,0"))

    s2_path = input_xmp.with_suffix(".s2.xmp")
    s2_path.unlink(missing_ok=True)
    s2_path.write_text(_serialize(prolog, root, epilog))
