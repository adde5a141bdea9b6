"""Adjoint CG iterations a value_and_grad call: the two adjoint solves of
each step (rd_adj_cg_iters + el_adj_cg_iters of the model's
``solver_info``), summed over the call, averaged over the run's calls."""


def read(ctx):
    units = ctx.traced + ctx.records
    if not units:
        return None
    return sum(sum(ctx.iters(r, ("rd_adj_cg_iters", "el_adj_cg_iters")))
               for r in units) / len(units)
