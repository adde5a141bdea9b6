"""The whole traced unit's share of the card's float32 peak: the
operations of its linear algebra that the benchmark counts from shapes
(the lattice's whole-solve PCGs at the iterations they report, 15
stencil offsets; the block matvecs by (B, M, K) from the port's launch
counter) over the unit's whole wall time at 67 TFLOP/s.  The residuals'
quadrature and the solvers' vector work outside those kernels are not
counted, so this is a floor of the step's share; it reads the same work
whatever kernel does it."""

from port_bench import roofline

N_OFFSETS = 15


def read(ctx):
    if ctx.trace is None or not ctx.trace.device or ctx.trace.window_s <= 0:
        return None
    flops = sum(f for _, f in roofline.lattice_solves(ctx, N_OFFSETS)) if ctx.lattice else 0
    flops += sum(count * f for (_, f), count in roofline.block_matvecs(ctx))
    if flops <= 0:
        return None
    return 100.0 * flops / (ctx.trace.window_s * roofline.F32_FLOPS)
