"""Share of the roofline of the block matvecs y_b = A_b x_b in the traced
unit: the least time of their work on the published peaks
(``roofline.bmv_work`` of each launch's (B, M, K), from the port's
launch counter by shape) over the device time of the kernels that did
them."""

import re

from port_bench import roofline

# the kernels that do this operation, by name
KERNELS = re.compile(r"bell_bmv_kernel")


def read(ctx):
    if ctx.trace is None:
        return None
    device_s, n = roofline.kernel_seconds(ctx.trace.device, KERNELS)
    launches = list(roofline.block_matvecs(ctx))
    if n == 0 or device_s <= 0 or not launches:
        return None
    bound = sum(count * roofline.bound_s(*work)[0] for work, count in launches)
    return 100.0 * bound / device_s
