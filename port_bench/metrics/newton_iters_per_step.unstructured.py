"""Newton iterations a step, over every simulation of the run."""


def read(ctx):
    steps = [k for r in ctx.traced + ctx.records for k in getattr(r, "newton", [])]
    return sum(steps) / len(steps) if steps else None
