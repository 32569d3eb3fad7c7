"""rl.post_ms: the mean host time of the benchmark's span around
``rl_deblur.rl_to_u8_device(canvas, ...).cpu()`` (Richardson-Lucy, the
gmic quantize and the copy to the host), over every image of the traced
window."""


def read(ctx):
    spans = ctx.spans.get("rl_post")
    return 1e3 * sum(spans) / len(spans) if spans else None
