"""Epoch/step-keyed JSON metric store with running best tracking: a copy
of ``nind_denoise_tpu/utils/json_saver.py``.

Produces ``trainres.json``/``testres.json`` files compatible with the
reference's format (the reference's src/nind_denoise/common/libs/
json_saver.py:9-68): top-level integer step keys plus ``best_val`` and
``best_<step_type>`` dicts mapping metric name -> best value / step. The
checkpoint-retention policy and the directory->best-epoch model resolution
both consume this format.
"""

from __future__ import annotations

from typing import Dict, Optional, Set

from . import utilities


class JSONSaver:
    def __init__(self, jsonfpath: str, step_type: str = "step",
                 default: Optional[dict] = None):
        if default is None:
            default = {"best_val": {}}
        self.best_key_str = f"best_{step_type}"
        self.jsonfpath = jsonfpath
        self.results = utilities.jsonfpath_load(jsonfpath, default=default)
        if self.best_key_str not in self.results:
            self.results[self.best_key_str] = {}
        if "best_val" not in self.results:
            self.results["best_val"] = {}

    def add_res(self, step: Optional[int], res: Dict[str, float], minimize: bool = True,
                write: bool = True, val_type=float, epoch: Optional[int] = None,
                rm_none: bool = False, key_prefix: str = "") -> None:
        """Record metrics for a step; update running best (min or max)."""
        if step is None:
            step = epoch
        if step is None:
            raise ValueError("JSONSaver.add_res: must specify step or epoch")
        if step not in self.results:
            self.results[step] = {}
        if key_prefix:
            res = {key_prefix + k: v for k, v in res.items()}
        for key, val in res.items():
            if val_type is not None and not isinstance(val, (list, dict)):
                val = val_type(val)
            self.results[step][key] = val
            if isinstance(val, (list, dict)):
                continue
            if rm_none and val == 0:
                continue
            # repair best_val if only best_step survived a manual edit
            if key not in self.results["best_val"] and key in self.results[self.best_key_str]:
                prev_step = self.results[self.best_key_str][key]
                if prev_step in self.results and key in self.results[prev_step]:
                    self.results["best_val"][key] = self.results[prev_step][key]
            is_new_best = (
                key not in self.results[self.best_key_str]
                or key not in self.results["best_val"]
                or (minimize and self.results["best_val"][key] > val)
                or (not minimize and self.results["best_val"][key] < val)
            )
            if is_new_best:
                self.results[self.best_key_str][key] = step
                self.results["best_val"][key] = val
        if write:
            self.write()

    def write(self) -> None:
        utilities.dict_to_json(self.results, self.jsonfpath)

    def get_best_steps(self) -> Set[int]:
        """Steps that are best for at least one metric (checkpoint keepers)."""
        return set(self.results[self.best_key_str].values())

    def get_best(self, key: str):
        """(best_step, best_value) for a metric, or (None, None)."""
        step = self.results[self.best_key_str].get(key)
        val = self.results["best_val"].get(key)
        return step, val
