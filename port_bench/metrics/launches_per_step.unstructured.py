"""Device records (kernels, copies, fills) of the traced simulation over
its steps."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.device or not ctx.traced:
        return None
    return len(ctx.trace.device) / (len(ctx.traced) * ctx.steps_per_unit)
