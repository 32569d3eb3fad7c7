"""k2_roofline: UtNet's fused level 1 (kernel K2, csrc/enc1.cu) in the
profiled images: the least time its launches could take (the larger of
operations over the type's peak and bytes over the bandwidth,
``yardstick.enc1_level1`` at each tile batch the engine ran) over the
device time of its kernels, in percent. Nothing to read where K2 did not
run or its launches do not match the profiled tile batches."""

from portbench import yardstick
from portbench.loops.photos import batches_of


def read(ctx):
    p = ctx.profile
    if p is None:
        return None
    seconds, launches = p.kernel_time("enc1_bf16_kernel", "enc1_f32_kernel")
    e = ctx.config["inference"]
    batches = [b for s in ctx.work["profiled_sizes"] for b in batches_of(s, e)]
    if launches == 0 or seconds <= 0 or launches != len(batches):
        return None
    funit = ctx.config.get("funit") or 64
    bound = sum(yardstick.bound_s(nb, fl, e["compute_dtype"])[0]
                for fl, nb in (yardstick.enc1_level1(b, e["cs"], e["cs"], funit)
                               for b in batches))
    return 100.0 * bound / seconds
