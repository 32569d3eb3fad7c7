"""mfu.denoise: the forward operations of every tile the traced window
ran (counted on the meta device over the plain reference, one tile at
cs x cs, times the tiles of each image), over the window's seconds, as a
share of the chip's peak in the cell's compute dtype."""

from portbench import yardstick
from portbench.loops.photos import tiles_of


def read(ctx):
    w, cfg = ctx.work, ctx.config
    if not w.get("sizes") or w["window_s"] <= 0:
        return None
    e = cfg["inference"]
    per_tile = yardstick.forward_flops(cfg["network"], cfg.get("funit"), 1, e["cs"])
    flops = per_tile * sum(tiles_of(s, e) for s in w["sizes"])
    return 100.0 * flops / w["window_s"] / yardstick.PEAK_FLOPS[e["compute_dtype"]]
