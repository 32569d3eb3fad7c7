"""The generator's training step, closed loop, from a pool on the device.

Set-up builds one training state (the program's model, loaded with the
benchmark's seeded weights, and its AMSGrad) and one step
(``train.steps.make_generator_train_step`` with ``plain_apply``), warms
them with ``warm_steps`` steps on rows the window never reaches, and then
rewinds that same state to the seeded weights: parameters and buffers
copied back, the moments zeroed, the step counts reset. The window goes
on stepping that object; its first ``checked_steps`` steps are the ones
the check compares, read as they pass.

The feed gathers each batch's rows from the seeded pool of crops held on
the device in float16 NHWC (as ``--device_cache`` holds them) into
float32 NCHW. The window runs steps until ``seconds`` have passed (and at
least the checked steps) and then waits for the device.

``correct``: the plain reference (``reference/train.py``) runs the same
first steps from the same weights on the same rows, in float32 and (the
first step) in float64. Read: the first step's loss, the first gradient as
AMSGrad holds it (mu / (1 - b1)) by the worst leaf's norm, against the
float32 reference and, as a multiple of that reference's own distance,
against float64 (``grad_f64_ratio``), and the parameters' change over the
checked steps by the worst leaf's norm, read before the next step runs.
Leaves whose reference gradient is under a thousandth of the median
leaf's (rounding alone moves them under AMSGrad) are left out of the
change. The cell's limits file names the readings compared.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict

import torch

from .. import gen, yardstick
from ..reference import train as rtrain
from ..profiling import Profile, Spans
from .photos import _no_tf32, _sync

MOVED_SHARE = 1e-3  # a leaf moves by its gradient if that is over this share of the median's


class TrainLoop:
    kind = "train"

    def __init__(self, config: dict, traffic: dict, device, seed: int):
        self.cfg, self.traffic, self.device, self.seed = config, traffic, device, seed
        self.tcfg = dict(config["training"])
        self.batch, self.cs = self.tcfg["batch_size"], self.tcfg["cs"]
        self.n_checked = traffic["checked_steps"]
        self.taken = {}  # the checked steps' readings, as the window takes them

    def prepare(self) -> None:
        self.clean, self.noisy = gen.pairs(self.traffic, self.cs, self.device, self.seed)
        self.weights = gen.weights(self.cfg["network"], self.cfg.get("funit"), torch.float32,
                                   self.device, self.seed)
        self.rows = gen.order(self.traffic["pool"], self.batch, self.traffic["order_steps"],
                              self.device, self.seed)

    def feed(self, k: int):
        rows = self.rows[k % self.rows.shape[0]]
        clean = self.clean.index_select(0, rows).permute(0, 3, 1, 2).float().contiguous()
        noisy = self.noisy.index_select(0, rows).permute(0, 3, 1, 2).float().contiguous()
        return clean, noisy

    def build(self) -> None:
        from nind_denoise_tpu_torch.models import build
        from nind_denoise_tpu_torch.train import steps

        with torch.device("meta"):
            model = build(self.cfg["network"], **self.cfg.get("kwargs", {}))
        model = model.to_empty(device=self.device)
        model.load_state_dict(self.weights)
        model.train()
        self.state = steps.TrainState(model, steps.make_optimizer(
            model, self.tcfg["lr"], self.tcfg["beta1"]))
        self.step = steps.make_generator_train_step(
            steps.plain_apply, self.tcfg["loss_weights"], self.tcfg["loss_cs"])
        self.names = [n for n, _ in model.named_parameters()]
        self.weights = None  # the program holds them now; the check draws them again

    def warm(self) -> None:
        """``warm_steps`` steps on the order's last rows, which the window
        never reaches; then the state goes back to the seeded weights."""
        opt, model = self.state.opt, self.state.model
        self.p0 = [p.detach().clone() for p in opt.params]
        b0 = [b.detach().clone() for b in model.buffers()]
        for j in range(self.traffic["warm_steps"]):
            self.step(self.state, *self.feed(-1 - j))
        with torch.no_grad():
            for p, a in zip(opt.params, self.p0):
                p.copy_(a)
            for b, a in zip(model.buffers(), b0):
                b.copy_(a)
            for name in opt.MOMENTS:
                for m in opt.moments(name):
                    m.zero_()
        opt.count = opt.inner_count = 0
        del b0
        _sync(self.device)
        self.k = 0

    def _take(self, k: int, metrics: dict) -> None:
        """The readings of checked step ``k`` on the device, without waiting."""
        opt = self.state.opt
        if k == 0:
            self.taken["loss1"] = torch.as_tensor(metrics["weighted"]).detach().clone()
            self.taken["grad1"] = _norms(opt.moments("mu")) / (1.0 - opt.hyper["b1"])
        if k == self.n_checked - 1:
            self.taken["change"] = _norms([p.detach() - a for p, a in zip(opt.params, self.p0)])
            self.p0 = None

    def window(self, seconds: float, trace: bool) -> dict:
        spans = Spans() if trace else None
        prof = Profile(spans) if trace else None
        p_from = self.traffic["trace_after"]
        p_to = p_from + self.traffic["trace_items"]
        n = 0
        profiled = 0
        t0 = time.perf_counter()
        while (time.perf_counter() - t0 < seconds or n < self.n_checked
               or (prof is not None and n < p_to)):
            if prof is not None and n == p_from:
                _sync(self.device)
                prof.start()
            with spans.span("feed") if spans else contextlib.nullcontext():
                batch = self.feed(self.k)
            with spans.span("step") if spans else contextlib.nullcontext():
                m = self.step(self.state, *batch)
            if self.k < self.n_checked:
                self._take(self.k, m)
            self.k += 1
            n += 1
            if prof is not None and n == p_to:
                _sync(self.device)
                prof.stop()
                profiled = p_to - p_from
        _sync(self.device)
        t1 = time.perf_counter()
        if prof is not None and prof.prof is not None and not prof.stopped:
            prof.stop()
            profiled = n - p_from
        return {"attempted": n, "failed": 0, "steps": n, "window_s": t1 - t0,
                "spans": spans, "profile": prof, "profiled_steps": profiled}

    def end_to_end(self, rec: dict) -> Dict[str, float]:
        return {"crops_per_s": rec["steps"] * self.batch / rec["window_s"]}

    def work(self, rec: dict) -> dict:
        prof = rec["profile"]
        return {"steps": rec["steps"], "batch": self.batch, "cs": self.cs,
                "window_s": rec["window_s"] - (prof.overhead_s if prof else 0.0),
                "profiled_steps": rec["profiled_steps"]}

    def free(self) -> None:
        self.state = self.step = None

    def reference(self, dtype: torch.dtype, steps: int = None):
        """The plain reference's steps from the seeded weights on the
        checked steps' rows: (losses, the first gradient, the parameters
        after the last step, the seeded weights)."""
        w0 = gen.weights(self.cfg["network"], self.cfg.get("funit"), torch.float32,
                         self.device, self.seed)
        batches = [self.feed(k) for k in range(steps or self.n_checked)]
        t = self.tcfg
        return rtrain.train_steps(self.cfg["network"], w0, batches, t, t["loss_weights"],
                                  t["loss_cs"], dtype=dtype) + (w0,)

    def check(self) -> Dict[str, float]:
        if set(self.taken) != {"loss1", "grad1", "change"}:
            raise RuntimeError(f"the window took {sorted(self.taken)} of the checked steps")
        loss1 = float(self.taken["loss1"])
        grad1 = dict(zip(self.names, self.taken["grad1"].tolist()))
        change = dict(zip(self.names, self.taken["change"].tolist()))
        with _no_tf32():
            losses, g1, p3, w0 = self.reference(torch.float32)
            _, g64, _, _ = self.reference(torch.float64, steps=1)
        ref_g = _named_norms(g1)
        ref_g64 = _named_norms(g64)
        ref_c = _named_norms({k: p3[k] - w0[k] for k in p3})
        del g64, p3, w0
        med = sorted(ref_g.values())[len(ref_g) // 2]
        moved = [k for k in ref_g if ref_g[k] >= MOVED_SHARE * med]
        change_gap, change_leaf = yardstick.worst_leaf_gap(change, ref_c, moved)
        # PReLU's one-element slopes each sum their layer's rounding over every
        # pixel: left out of the gradient's worst leaf (kept in the change)
        multi = [k for k in ref_g if g1[k].numel() > 1]
        grad_multi, grad_multi_leaf = yardstick.worst_leaf_gap(grad1, ref_g, multi)
        # the first gradient's distance from float64 in units of the float32
        # reference's own distance from it: steady where the loss amplifies
        # rounding (a crop's MS-SSIM factor near 0 at the seeded weights)
        floor, _ = yardstick.worst_leaf_gap(ref_g, ref_g64, multi)
        prog64, _ = yardstick.worst_leaf_gap(grad1, ref_g64, multi)
        self.detail = {"loss1": loss1, "ref_losses": losses, "change_leaf": change_leaf,
                       "grad_multi_leaf": grad_multi_leaf,
                       "grad_f64_floor": floor, "left_out": sorted(set(ref_g) - set(moved))}
        return {"loss1_gap": abs(loss1 - losses[0]) / abs(losses[0]),
                "grad_multi_gap": grad_multi, "change_gap": change_gap,
                "grad_f64_ratio": prog64 / max(floor, 1e-12)}


def _norms(tensors) -> torch.Tensor:
    """Each tensor's norm in float64, on the device (no wait)."""
    return torch.stack([t.detach().double().norm() for t in tensors])


def _named_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return dict(zip(tensors, _norms(list(tensors.values())).tolist()))
