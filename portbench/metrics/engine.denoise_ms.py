"""engine.denoise_ms: the mean host time of the benchmark's span around
``AdaptiveEngine.denoise_raw(raw, scale, out_dtype='device')``, closed by
``torch.cuda.synchronize()``, over every image of the traced window."""


def read(ctx):
    spans = ctx.spans.get("denoise")
    return 1e3 * sum(spans) / len(spans) if spans else None
