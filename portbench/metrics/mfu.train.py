"""mfu.train: the operations of a training step's forward, loss and
backward (counted on the meta device over the plain reference at the
cell's batch and crop), times the traced window's steps, over its
seconds, as a share of the chip's float32 peak (TF32 is off)."""

from portbench import yardstick


def read(ctx):
    w, cfg = ctx.work, ctx.config
    if not w.get("steps") or w["window_s"] <= 0:
        return None
    t = cfg["training"]
    per_step = yardstick.train_step_flops(cfg["network"], cfg.get("funit"), t["batch_size"],
                                          t["cs"], tuple(sorted(t["loss_weights"].items())),
                                          t["loss_cs"])
    return 100.0 * per_step * w["steps"] / w["window_s"] / yardstick.PEAK_FLOPS[t["compute_dtype"]]
