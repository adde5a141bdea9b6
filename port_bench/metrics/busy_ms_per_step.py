"""Device-busy milliseconds of the traced simulation over its steps."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.device or not ctx.traced:
        return None
    return 1e3 * ctx.trace.busy_s / (len(ctx.traced) * ctx.steps_per_unit)
