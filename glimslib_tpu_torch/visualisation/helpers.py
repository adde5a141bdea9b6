# Counterpart of glimslib_tpu/visualisation/helpers.py. The code is the
# JAX package's apart from imports: matplotlib is imported inside the
# functions that draw (show_plot also selects the backend first, through
# config.require_matplotlib), and MidpointNormalize, a subclass of
# matplotlib's Normalize, is defined at its first use (module __getattr__),
# so that this module imports where matplotlib is absent.
"""Plotting helpers (rebuild of reference ``visualisation/helpers.py``).

- backend-aware save-or-show (reference helpers.py:19-38),
- mesh -> matplotlib triangulation (l.54-57),
- grid interpolation of nodal fields (l.60-89),
- colormap/range utilities incl. MidpointNormalize (l.92-202).
"""

from __future__ import annotations

import os

import numpy as np

from glimslib_tpu_torch.visualisation import config


def show_plot(path=None, fig=None, dpi=120):
    """Save to ``path`` if given (or no display), else show
    (reference helpers.py:19-38)."""
    matplotlib = config.require_matplotlib()
    import matplotlib.pyplot as plt
    fig = fig or plt.gcf()
    if path:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        fig.savefig(path, dpi=dpi, bbox_inches="tight")
        plt.close(fig)
        return path
    if matplotlib.get_backend().lower() == "agg":
        plt.close(fig)
        return None
    plt.show()
    return None


def mesh_to_triangulation(mesh):
    """2D Mesh -> matplotlib Triangulation (reference helpers.py:54-57)."""
    from matplotlib.tri import Triangulation

    if mesh.dim != 2:
        raise ValueError("triangulation requires a 2D mesh")
    return Triangulation(mesh.points[:, 0], mesh.points[:, 1], mesh.cells)


def interpolate_to_grid(mesh, values, nx=100, ny=100):
    """Nodal field -> regular grid (reference helpers.py:60-89)."""
    from scipy.interpolate import griddata

    pts = mesh.points
    xi = np.linspace(pts[:, 0].min(), pts[:, 0].max(), nx)
    yi = np.linspace(pts[:, 1].min(), pts[:, 1].max(), ny)
    X, Y = np.meshgrid(xi, yi)
    vals = np.asarray(values)
    if vals.ndim == 1:
        Z = griddata(pts, vals, (X, Y), method="linear")
        return X, Y, Z
    comps = [griddata(pts, vals[:, k], (X, Y), method="linear")
             for k in range(vals.shape[1])]
    return X, Y, comps


def __getattr__(name):
    if name != "MidpointNormalize":
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    config.require_matplotlib()
    import matplotlib.colors as mcolors

    class MidpointNormalize(mcolors.Normalize):
        """Colormap normalization centred on a midpoint (reference helpers.py:178-202)."""

        def __init__(self, vmin=None, vmax=None, midpoint=0.0, clip=False):
            self.midpoint = midpoint
            super().__init__(vmin, vmax, clip)

        def __call__(self, value, clip=None):
            x = [self.vmin, self.midpoint, self.vmax]
            y = [0, 0.5, 1]
            return np.ma.masked_array(np.interp(value, x, y))

    globals()[name] = MidpointNormalize
    return MidpointNormalize


def get_value_range(values, percentile=None):
    """(vmin, vmax) of a field, optionally robust (reference helpers.py:92-120)."""
    v = np.asarray(values)
    if percentile:
        return (np.percentile(v, percentile), np.percentile(v, 100 - percentile))
    return float(v.min()), float(v.max())
