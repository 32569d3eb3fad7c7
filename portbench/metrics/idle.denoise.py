"""idle.denoise: the share of the profiled images' window in which no
kernel, copy or memset ran on the device, in percent."""


def read(ctx):
    p = ctx.profile
    if p is None or not p.window_s:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)
