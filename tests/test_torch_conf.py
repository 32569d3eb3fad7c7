"""The port's LayeredArgumentParser against the JAX package's: the same
argv over the same YAML layers gives equal namespaces, in every precedence
case of tests/test_utils.py (CLI > --config2 > --config > defaults files),
for abbreviated long flags, list coercion and parse_known_args_layered."""

import pytest

from nind_denoise_tpu.utils import conf as jax_conf
from nind_denoise_tpu_torch.utils import conf as port_conf


@pytest.fixture
def layers(tmp_path):
    files = {"defaults": "a: 1\nb: 2\nc: 3\nitems: single\nalpha: 9\n",
             "c1": "b: 20\nc: 30\n", "c2": "c: 300\n"}
    paths = {}
    for name, text in files.items():
        paths[name] = tmp_path / f"{name}.yaml"
        paths[name].write_text(text)
    return {k: str(v) for k, v in paths.items()}


def _parser(conf, defaults):
    p = conf.LayeredArgumentParser(default_config_files=[defaults])
    p.add_argument("--a", type=int)
    p.add_argument("--b", type=int)
    p.add_argument("--c", type=int)
    p.add_argument("--items", nargs="*")
    p.add_argument("--alpha", type=int)
    return p


CASES = {  # argv (config names for paths) -> (a, b, c, items, alpha)
    "defaults": ([], (1, 2, 3, ["single"], 9)),
    "config": (["--config", "c1"], (1, 20, 30, ["single"], 9)),
    "config2_over_config": (["--config", "c1", "--config2", "c2"], (1, 20, 300, ["single"], 9)),
    "cli_over_all": (["--config", "c1", "--config2", "c2", "--c", "999"],
                     (1, 20, 999, ["single"], 9)),
    "cli_over_defaults": (["--b", "7", "--items", "x", "y"], (1, 7, 3, ["x", "y"], 9)),
    "abbreviated_flag": (["--alp", "5", "--config", "c1"], (1, 20, 30, ["single"], 5)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_layered_parsers_agree(layers, case):
    argv, expect = CASES[case]
    argv = [layers.get(t, t) for t in argv]
    ref = _parser(jax_conf, layers["defaults"]).parse_args(argv)
    got = _parser(port_conf, layers["defaults"]).parse_args(argv)
    assert vars(got) == vars(ref)
    assert (got.a, got.b, got.c, got.items, got.alpha) == expect


def test_parse_known_args_layered_agrees(layers):
    argv = ["--config", layers["c1"], "--unknown", "u", "--a", "4"]
    ref, ref_rest = _parser(jax_conf, layers["defaults"]).parse_known_args_layered(argv)
    got, got_rest = _parser(port_conf, layers["defaults"]).parse_known_args_layered(argv)
    assert vars(got) == vars(ref) and got_rest == ref_rest == ["--unknown", "u"]
    assert (got.a, got.b) == (4, 20)


def test_common_config_is_a_copy():
    with open(jax_conf.common_config_fpath()) as f, \
            open(port_conf.common_config_fpath()) as g:
        assert f.read() == g.read()
    assert port_conf.common_config_fpath() != jax_conf.common_config_fpath()
