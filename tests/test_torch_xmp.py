"""The port's XMP split (xml.etree) against the JAX package's (bs4 + lxml):
``read_config`` plain and with nightmode, and ``split_history`` on the
sidecar of tests/test_pipeline.py and on the hypothesis-drawn histories of
tests/test_xmp_property.py. The split sidecars must be equal element for
element: tag, attributes, non-blank text, children in order."""

import shutil
import xml.etree.ElementTree as ET

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from nind_denoise_tpu.pipeline import xmp as jax_xmp
from nind_denoise_tpu_torch.pipeline import xmp as port_xmp
from nind_denoise_tpu_torch.tools import fixtures
from test_pipeline import SIDECAR
from test_xmp_property import HEADER, VOCAB


@pytest.mark.parametrize("nightmode", [False, True])
def test_read_config_matches_jax(nightmode):
    assert port_xmp.read_config(nightmode=nightmode) == \
        jax_xmp.read_config(nightmode=nightmode)


def _assert_same_tree(got, ref, where="/"):
    assert got.tag == ref.tag, where
    assert got.attrib == ref.attrib, where + got.tag
    assert (got.text or "").strip() == (ref.text or "").strip(), where + got.tag
    kids_got, kids_ref = list(got), list(ref)
    assert len(kids_got) == len(kids_ref), where + got.tag
    for i, (g, r) in enumerate(zip(kids_got, kids_ref)):
        _assert_same_tree(g, r, f"{where}{got.tag}[{i}]/")


def _split_both(tmp_path, text, nightmode=False):
    outs = {}
    for name, mod in (("jax", jax_xmp), ("port", port_xmp)):
        d = tmp_path / name
        d.mkdir()
        sidecar = d / "img.nef.xmp"
        sidecar.write_text(text)
        mod.split_history(sidecar, mod.read_config(nightmode=nightmode))
        outs[name] = [(d / f"img.nef.s{k}.xmp").read_text() for k in (1, 2)]
    return outs


@pytest.mark.parametrize("sidecar", ["test_pipeline", "fixtures"])
@pytest.mark.parametrize("nightmode", [False, True])
def test_split_history_matches_jax(tmp_path, nightmode, sidecar):
    text = SIDECAR if sidecar == "test_pipeline" else fixtures.SIDECAR
    outs = _split_both(tmp_path, text, nightmode)
    for got, ref in zip(outs["port"], outs["jax"]):
        _assert_same_tree(ET.fromstring(got.encode()), ET.fromstring(ref.encode()))
        # the input's prefixes and its xpacket instructions survive
        assert "<darktable:history>" in got and "<rdf:li " in got and "ns0:" not in got
        assert got.count("<?xpacket") == ref.count("<?xpacket") == text.count("<?xpacket")


def test_split_history_without_history_raises_like_jax(tmp_path):
    text = SIDECAR.replace("darktable:history", "darktable:other")
    for mod in (jax_xmp, port_xmp):
        p = tmp_path / f"{mod.__name__}.xmp"
        p.write_text(text)
        with pytest.raises(ValueError):
            mod.split_history(p, mod.read_config())


@st.composite
def history(draw):
    names = draw(st.lists(st.sampled_from(VOCAB), min_size=1, max_size=12))
    order = draw(st.permutations(list(range(len(names)))))
    return [(names[i], order[i]) for i in range(len(names))]


@settings(max_examples=30, deadline=None)
@given(history(), st.booleans())
def test_split_history_matches_jax_on_drawn_histories(tmp_path_factory, ops, nightmode):
    tmp_path = tmp_path_factory.mktemp("xmp")
    items = "\n".join(
        f'     <rdf:li darktable:num="{num}" darktable:operation="{name}" '
        f'darktable:enabled="1" darktable:params="p{num}"/>'
        for name, num in ops)
    outs = _split_both(tmp_path, HEADER.format(items=items), nightmode)
    for got, ref in zip(outs["port"], outs["jax"]):
        _assert_same_tree(ET.fromstring(got.encode()), ET.fromstring(ref.encode()))
    shutil.rmtree(tmp_path)
