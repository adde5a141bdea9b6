"""Device-busy milliseconds of the traced value_and_grad call."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.device or not ctx.traced:
        return None
    return 1e3 * ctx.trace.busy_s / len(ctx.traced)
