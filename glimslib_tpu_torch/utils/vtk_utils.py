# Copy of glimslib_tpu/utils/vtk_utils.py (numpy only): threshold_cells and
# cell_to_point_data only.  The code is kept byte for byte apart from
# imports, which point into glimslib_tpu_torch so that the port never
# imports the JAX package.
"""Grid processing on (points, cells, data) arrays: the two operations the
reduced-domain 2D atlas problem needs (counterpart of
``glimslib_tpu/utils/vtk_utils.py``).
"""

from __future__ import annotations

import numpy as np


def threshold_cells(points, cells, cell_values, lower, upper,
                    point_data=None, cell_data=None):
    """Keep cells with lower <= value <= upper; drop orphaned points
    (reference getVtuThreshold, vtk_utils.py:16-34 + subdomain removal
    data_io.py:581-599)."""
    keep = (cell_values >= lower) & (cell_values <= upper)
    new_cells = cells[keep]
    used = np.unique(new_cells.ravel())
    remap = -np.ones(len(points), dtype=np.int64)
    remap[used] = np.arange(len(used))
    out_pd = {k: np.asarray(v)[used] for k, v in (point_data or {}).items()}
    out_cd = {k: np.asarray(v)[keep] for k, v in (cell_data or {}).items()}
    return points[used], remap[new_cells], out_pd, out_cd


def cell_to_point_data(n_points, cells, cell_values):
    """Average adjacent-cell data to points (reference l.255-262)."""
    cell_values = np.asarray(cell_values, dtype=np.float64)
    acc = np.zeros(n_points)
    cnt = np.zeros(n_points)
    for j in range(cells.shape[1]):
        np.add.at(acc, cells[:, j], cell_values)
        np.add.at(cnt, cells[:, j], 1.0)
    return acc / np.maximum(cnt, 1.0)
