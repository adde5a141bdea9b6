"""The 95th percentile of the wall seconds of the window's whole
simulations (each ended by a device synchronisation), leaving out the
traced one; numpy's linear interpolation between order statistics."""

import numpy as np


def read(ctx):
    walls = [r.wall_s for r in ctx.records]
    return float(np.percentile(walls, 95)) if len(walls) >= 2 else None
