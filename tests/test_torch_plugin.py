"""The darktable plugin drives the port: a twin of tests/test_lua_plugin.py's
flag check against the port's ``denoise`` parser, and the plugin's own
command line (its Lua template filled, no model flag) running the port with
the checkpoint at the model table's default path under the working
directory, within 1 LSB of a ``--model_path`` run on the same weights."""

import os

import cv2
import numpy as np
import pytest

from nind_denoise_tpu_torch.pipeline import denoise_cli as port_cli
from nind_denoise_tpu_torch.tools import fixtures


def test_cli_flags_emitted_by_plugin_exist_on_the_port():
    import re

    known = set(port_cli.build_parser()._option_string_actions)
    template = fixtures.plugin_template()
    flags = re.findall(r"(--[a-z0-9_-]+|\s-[a-z]\b)", template)
    assert flags, "no flags parsed from the template"
    for fl in flags:
        assert fl.strip() in known, f"plugin emits unknown CLI flag {fl!r}"
    with open(fixtures.PLUGIN_LUA) as f:
        assert "--no_deblur" in f.read() and "--no_deblur" in known


@pytest.mark.parametrize("sigma,no_deblur", [(1, False), (3, True)])
def test_plugin_command_line_parses_without_a_model_flag(sigma, no_deblur):
    argv = fixtures.plugin_command("nind-denoise", "/tmp/x y.tif", "/tmp/ndtpu_out/",
                                   sigma=sigma, no_deblur=no_deblur)
    assert argv[0] == "nind-denoise" and "--model_path" not in argv
    args = port_cli.build_parser().parse_args(argv[1:])
    assert args.model_path is None and args.model == "nind_generator_650.pt"
    assert (args.raw_image, args.output_path) == ("/tmp/x y.tif", "/tmp/ndtpu_out/")
    assert args.tiff_input and args.sigma == str(sigma) and args.no_deblur == no_deblur


def test_plugin_command_line_runs_the_port(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    ckpt = os.path.join("models", "nind", "generator_650.pt")
    os.makedirs(os.path.dirname(ckpt))
    fixtures.write_torch_checkpoint(ckpt, 8, seed=31)
    tmp = tmp_path / "darktable_export.tif"
    img = (np.random.default_rng(3).random((150, 170, 3)) * 65535).astype(np.uint16)
    assert cv2.imwrite(str(tmp), img)
    seen = []
    encode = port_cli._encode_u8
    monkeypatch.setattr(port_cli, "_encode_u8",
                        lambda u8, path, q: seen.append(np.array(u8)) or encode(u8, path, q))
    work = str(tmp_path / "ndtpu_out") + os.sep
    os.makedirs(work)
    argv = fixtures.plugin_command("nind-denoise", str(tmp), work, quality=95, sigma=1)
    out = port_cli.main(argv[1:] + ["--device", "cpu"])
    assert out == tmp_path / "ndtpu_out" / "darktable_export.jpg" and out.is_file()
    assert cv2.imread(str(out)).shape == (150, 170, 3)
    port_cli.main([str(tmp), "--tiff-input", "-o", str(tmp_path), "-q", "95",
                   "--model_path", os.path.abspath(ckpt), "--device", "cpu"])
    assert len(seen) == 2 and np.abs(seen[0].astype(int) - seen[1].astype(int)).max() <= 1
