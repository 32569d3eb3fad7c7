"""Layered YAML + argparse configuration.

A copy of ``nind_denoise_tpu/utils/conf.py``. The reference's scripts use
configargparse with a YAMLConfigFileParser and layered default config
files (precedence: CLI > --config2 > --config > defaults files; the
reference's src/nind_denoise/nn_train.py:121-125). This module gives the
same layering on stock argparse: YAML files supply defaults, later layers
override earlier ones, and explicit CLI flags override everything.
``common_config_fpath`` is the port's own copy of
``configs/common_conf_default.yaml``.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional, Sequence

import yaml


def _load_yaml(fpath: str) -> dict:
    with open(fpath, "r") as fp:
        data = yaml.safe_load(fp)
    return data or {}


class LayeredArgumentParser(argparse.ArgumentParser):
    """argparse with configargparse-like layered YAML defaults.

    Usage matches the reference scripts: construct with
    ``default_config_files=[...]``, declare arguments normally, and the parser
    accepts ``-c/--config`` and ``-c2/--config2`` YAML paths whose values act
    as defaults (CLI flags still win).
    """

    def __init__(self, *args, default_config_files: Optional[Sequence[str]] = None,
                 add_config_args: bool = True, **kwargs):
        super().__init__(*args, **kwargs)
        self._default_config_files = list(default_config_files or [])
        if add_config_args:
            self.add_argument("-c", "--config", help="(yaml) config file path")
            self.add_argument("-c2", "--config2", help="extra (yaml) config file path")

    def _config_layers(self, namespace) -> List[dict]:
        layers = []
        for fpath in self._default_config_files:
            if fpath and os.path.isfile(fpath):
                layers.append(_load_yaml(fpath))
        for attr in ("config", "config2"):
            fpath = getattr(namespace, attr, None)
            if fpath:
                layers.append(_load_yaml(fpath))  # missing explicit config = error
        return layers

    def _apply_layers(self, namespace, explicit: set):
        merged: dict = {}
        for layer in self._config_layers(namespace):
            merged.update(layer)
        known = {a.dest for a in self._actions}
        for key, val in merged.items():
            if key in explicit or key not in known:
                continue
            action = next((a for a in self._actions if a.dest == key), None)
            if action is not None and action.type is not None and val is not None \
                    and not isinstance(val, (list, dict)):
                try:
                    val = action.type(val)
                except (TypeError, ValueError):
                    pass
            if action is not None and isinstance(action.nargs, str) \
                    and action.nargs in ("*", "+") and isinstance(val, str):
                val = [val]
            setattr(namespace, key, val)
        return namespace

    def _explicit_dests(self, argv: Sequence[str]) -> set:
        """Which dests were explicitly given on the CLI."""
        explicit = set()
        opt_map = {}
        for action in self._actions:
            for opt in action.option_strings:
                opt_map[opt] = action.dest
        for tok in argv:
            if not tok.startswith("-"):
                continue
            opt = tok.split("=", 1)[0]
            if opt in opt_map:
                explicit.add(opt_map[opt])
            elif opt.startswith("--") and len(opt) > 2:
                # argparse accepts unambiguous long-option ABBREVIATIONS
                # (--whole for --whole_image); an abbreviation the exact
                # map misses would let a config layer silently override a
                # value the user explicitly typed
                hits = {opt_map[o] for o in opt_map
                        if o.startswith("--") and o.startswith(opt)}
                if len(hits) == 1:
                    explicit.add(hits.pop())
        return explicit

    def parse_args(self, args=None, namespace=None):  # type: ignore[override]
        import sys

        argv = list(sys.argv[1:] if args is None else args)
        namespace = super().parse_args(argv, namespace)
        return self._apply_layers(namespace, self._explicit_dests(argv))

    def parse_known_args_layered(self, args=None, namespace=None):
        import sys

        argv = list(sys.argv[1:] if args is None else args)
        namespace, rest = super().parse_known_args(argv, namespace)
        return self._apply_layers(namespace, self._explicit_dests(argv)), rest


def package_dir() -> str:
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def default_configs_dir() -> str:
    return os.path.join(package_dir(), "configs")


def common_config_fpath() -> str:
    return os.path.join(default_configs_dir(), "common_conf_default.yaml")
