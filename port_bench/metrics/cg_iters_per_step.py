"""CG iterations a step: the rd solves (one a Newton iteration), the
elasticity solve and the refinement's correction solve, over every
simulation of the run."""


def read(ctx):
    units = ctx.traced + ctx.records
    if not units:
        return None
    its = sum(sum(ctx.iters(r, ("rd_cg_iters", "el_cg_iters", "el_refine_cg_iters")))
              for r in units)
    return its / (len(units) * ctx.steps_per_unit)
