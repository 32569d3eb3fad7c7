"""k1_roofline: one fused Richardson-Lucy iteration (kernel K1,
csrc/rl_iter.cu) in the profiled images: the least time its launches
could take (``yardstick.rl_iteration``: 12 bytes a pixel over the
bandwidth, or 8(2R+1)+3 operations a pixel over the fp32 peak, the
larger) over the device time of its kernels, in percent."""

from portbench import yardstick
from portbench.loops.photos import rl_radius


def read(ctx):
    p = ctx.profile
    if p is None:
        return None
    seconds, launches = p.kernel_time("rl_iter_kernel")
    rl = ctx.traffic["rl"]
    sizes = ctx.work["profiled_sizes"]
    if launches == 0 or seconds <= 0 or launches != rl["iterations"] * len(sizes):
        return None
    r = rl_radius(rl["sigma"])
    bound = sum(rl["iterations"] * yardstick.bound_s(nb, fl, "float32")[0]
                for fl, nb in (yardstick.rl_iteration(c, h, w, r) for h, w, c in sizes))
    return 100.0 * bound / seconds
