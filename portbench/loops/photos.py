"""Photos through the program's engine and Richardson-Lucy, one in flight.

A closed loop with one client: each image of the seeded pool, cycled, is
handed to ``AdaptiveEngine.denoise_raw(raw, scale, out_dtype='device')``
as the CLI's decoder hands it over (storage pixels in host memory), the
canvas goes through ``rl_deblur.rl_to_u8_device`` and ``.cpu()``; the
next image goes in when the previous one's uint8 pixels are on the host.

``correct`` compares a seeded reservoir sample of the window's images:
their canvases and uint8 images, held as the program returned them,
against the plain reference (``reference/``) recomputing each from the
same pixels and weights in float32.
"""

from __future__ import annotations

import contextlib
import math
import time
from typing import Dict, List

import numpy as np
import torch

from .. import gen, yardstick
from ..reference import nets, rl, tiling
from ..profiling import Profile, Spans


class PhotoLoop:
    kind = "photos"

    def __init__(self, config: dict, traffic: dict, device, seed: int):
        self.cfg, self.traffic, self.device, self.seed = config, traffic, device, seed
        self.eng_cfg = dict(config["inference"])
        self.rl = traffic["rl"]
        self.sample_k = traffic["check_sample"]

    # -- set-up ---------------------------------------------------------------

    def _dtype(self) -> torch.dtype:
        return {"bfloat16": torch.bfloat16, "float32": torch.float32}[
            self.eng_cfg["compute_dtype"]]

    def prepare(self) -> None:
        self.pool = gen.photos(self.traffic, self.device, self.seed)
        self.weights = gen.weights(self.cfg["network"], self.cfg.get("funit"), self._dtype(),
                                   self.device, self.seed)

    def build(self, compute_dtype: str = None) -> None:
        """The program's engine over the seeded weights, in the
        configuration's compute type or in ``compute_dtype``."""
        from nind_denoise_tpu_torch.engine import tile_engine
        from nind_denoise_tpu_torch.models import build

        with torch.device("meta"):
            model = build(self.cfg["network"], **self.cfg.get("kwargs", {}))
        model = model.to_empty(device=self.device)
        model.load_state_dict(self.weights)
        dtype = compute_dtype or self.eng_cfg["compute_dtype"]
        self.engine = tile_engine.AdaptiveEngine(
            self.cfg["network"], model, cs=self.eng_cfg["cs"], ucs=self.eng_cfg["ucs"],
            batch_size=self.eng_cfg["batch_size"], compute_dtype=dtype, device=self.device)
        del model

    def one(self, raw: np.ndarray, spans: Spans = None, sync: bool = False):
        """One image through the timed path: (canvas on the device, uint8
        image on the host)."""
        from nind_denoise_tpu_torch.ops import rl_deblur

        with spans.span("denoise") if spans else contextlib.nullcontext():
            canvas = self.engine.denoise_raw(raw, 65535.0, out_dtype="device")
            if sync:
                _sync(self.device)
        with spans.span("rl_post") if spans else contextlib.nullcontext():
            u8 = rl_deblur.rl_to_u8_device(canvas, self.rl["sigma"], self.rl["iterations"],
                                           psf=self.rl["psf"]).cpu().numpy()
        return canvas, u8

    def warm(self) -> None:
        """One image of each shape in the pool."""
        seen = set()
        for raw in self.pool:
            if raw.shape not in seen:
                seen.add(raw.shape)
                self.one(raw)
        _sync(self.device)
        self.checked = []

    # -- the window -------------------------------------------------------------

    def window(self, seconds: float, trace: bool) -> dict:
        """Images until ``seconds`` have passed; the last one finishes.
        With ``trace``, the benchmark's spans (closed by a synchronize)
        and a profile over ``trace_items`` images after ``trace_after``."""
        rng = gen.host_rng(self.seed, 7)
        spans = Spans() if trace else None
        prof = Profile(spans) if trace else None
        p_from = self.traffic["trace_after"]
        p_to = p_from + self.traffic["trace_items"]
        latencies, sizes, profiled = [], [], []
        reservoir: List[tuple] = []
        failed = 0
        i = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds or (prof is not None and i < p_to):
            if prof is not None and i == p_from:
                _sync(self.device)
                prof.start()
            raw = self.pool[i % len(self.pool)]
            t = time.perf_counter()
            try:
                canvas, u8 = self.one(raw, spans, sync=trace)
            except RuntimeError as e:  # a request that fails counts as failed
                print(f"image {i}: {e}", flush=True)
                failed += 1
                i += 1
                continue
            latencies.append(time.perf_counter() - t)
            sizes.append(raw.shape)
            if prof is not None and p_from <= i < p_to:
                profiled.append(raw.shape)
            if prof is not None and i == p_to - 1:
                _sync(self.device)
                prof.stop()
            # a uniform sample of the window's images, drawn from the seed
            if len(reservoir) < self.sample_k:
                reservoir.append((i, canvas, u8))
            else:
                j = int(rng.integers(0, i + 1))
                if j < self.sample_k:
                    reservoir[j] = (i, canvas, u8)
            del canvas, u8
            i += 1
        t1 = time.perf_counter()
        if prof is not None and prof.prof is not None and not prof.stopped:
            _sync(self.device)  # the window ended first
            prof.stop()
        self.checked = reservoir
        return {"attempted": i, "failed": failed, "latencies": latencies, "sizes": sizes,
                "window_s": t1 - t0, "spans": spans, "profile": prof, "profiled_sizes": profiled}

    def end_to_end(self, rec: dict) -> Dict[str, float]:
        mp = sum(h * w for h, w, _ in rec["sizes"]) / 1e6
        out = {"mp_per_s": mp / rec["window_s"]}
        if rec["latencies"]:
            out["image_s_p90"] = yardstick.percentile(rec["latencies"], 90)
        return out

    def work(self, rec: dict) -> dict:
        """What the window did, for the per-layer readers."""
        prof = rec["profile"]
        return {"images": len(rec["sizes"]), "sizes": rec["sizes"],
                "window_s": rec["window_s"] - (prof.overhead_s if prof else 0.0),
                "profiled_sizes": rec["profiled_sizes"]}

    def free(self) -> None:
        self.engine = None

    # -- the check ---------------------------------------------------------------

    def _ref_forward(self, fp8: bool = False):
        p = {k: v.float() for k, v in self.weights.items()}
        ops = nets.Ops(nets.fp8_rounding if fp8 else None)
        net = self.cfg["network"]
        return lambda x: nets.forward(net, p, x, train=False, ops=ops)

    def _reference(self, raw: np.ndarray, fp8: bool = False):
        """(canvas, uint8) of the plain reference, float32, TF32 off."""
        e = self.eng_cfg
        with _no_tf32(), torch.no_grad():
            x = torch.from_numpy(raw.astype(np.float32)).to(self.device) / 65535.0
            canvas = tiling.denoise(self._ref_forward(fp8), x, e["cs"], e["ucs"],
                                    e["overlap"], e["batch_size"])
            return canvas, rl.to_u8(canvas, self.rl["sigma"], self.rl["iterations"])

    def check(self) -> Dict[str, float]:
        """The readings over the sample, each its worst image: the canvas's
        RMS error relative to the reference's RMS; the uint8 image's RMS
        difference in levels and the share of its values more than one
        level off; and, local, the largest share of values more than two
        levels off in any block of the uint8 image, the image split evenly
        into blocks of at most the engine's tile (``ucs``) a side, so that
        a few wrong tiles or a bad seam show. The cell's limits file says
        which are compared."""
        out = dict.fromkeys(("canvas_rel_rms", "u8_rms_lsb", "u8_over1_share",
                             "u8_over2_block"), 0.0)
        block = self.eng_cfg["ucs"]
        for i, canvas, u8 in self.checked:
            raw = self.pool[i % len(self.pool)]
            ref_canvas, ref_u8 = self._reference(raw)
            d = canvas.float() - ref_canvas
            du = (torch.from_numpy(u8).to(self.device).float() - ref_u8.float()).abs()
            got = {"canvas_rel_rms": float(d.square().mean().sqrt()
                                           / ref_canvas.square().mean().sqrt()),
                   "u8_rms_lsb": float(du.square().mean().sqrt()),
                   "u8_over1_share": float((du > 1).float().mean()),
                   "u8_over2_block": float(block_means((du > 2).float(), block).max())}
            out = {k: max(out[k], got[k]) for k in out}
            del ref_canvas, ref_u8, d, du
        return out


def block_means(x: torch.Tensor, block: int) -> torch.Tensor:
    """Means of an (H, W, C) map over blocks of at most ``block`` a side,
    the rows and columns split as evenly as they go."""
    rows = torch.tensor_split(x, math.ceil(x.shape[0] / block), dim=0)
    return torch.stack([c.mean() for r in rows
                        for c in torch.tensor_split(r, math.ceil(x.shape[1] / block), dim=1)])


def tiles_of(shape, eng_cfg: dict) -> int:
    """Tiles the engine runs over an (H, W, C) image at the cell's cs/ucs."""
    ny, nx, _ = tiling.grid(shape[0], shape[1], eng_cfg["ucs"], eng_cfg["overlap"])
    return ny * nx


def batches_of(shape, eng_cfg: dict) -> List[int]:
    """The engine's batch sizes over one image: each tile row in batches
    of ``batch_size``."""
    ny, nx, _ = tiling.grid(shape[0], shape[1], eng_cfg["ucs"], eng_cfg["overlap"])
    b = eng_cfg["batch_size"]
    row = [b] * (nx // b) + ([nx % b] if nx % b else [])
    return row * ny


def rl_radius(sigma: float) -> int:
    return max(1, int(math.ceil(3.0 * sigma)))


class _no_tf32:
    def __enter__(self):
        self.saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    def __exit__(self, *a):
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = self.saved
        return False


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
