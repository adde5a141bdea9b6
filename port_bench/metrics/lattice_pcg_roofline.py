"""Share of the roofline of the lattice's whole linear solves in the
traced simulation: the least time their work needs on the published
peaks (``roofline.pcg_work`` of each solve: the stencil planes,
preconditioner and vectors read once, the operations of the iterations
the solve reports) over the device time of the kernels that did them.
The Kuhn lattice's stencil has 15 offsets."""

import re

from port_bench import roofline

# the kernels that do this operation, by name
KERNELS = re.compile(r"stencil_pcg_kernel")
N_OFFSETS = 15


def read(ctx):
    if ctx.trace is None:
        return None
    device_s, n = roofline.kernel_seconds(ctx.trace.device, KERNELS)
    if n == 0 or device_s <= 0:
        return None
    bound = sum(roofline.bound_s(*w)[0] for w in roofline.lattice_solves(ctx, N_OFFSETS))
    return 100.0 * bound / device_s
