# Copy of glimslib_tpu/visualisation/plotting.py (numpy; matplotlib imported
# inside the functions that draw). The code is kept byte for byte apart
# from imports, which point into glimslib_tpu_torch so that the port
# never imports the JAX package.
"""Composable overlay plotting of fields, images and segmentations.

Rebuild of reference ``visualisation/plotting.py`` (541 LoC):
- scalar fields on triangulations with colorbars (reference plotting.py:121-160),
- vector fields as quiver/streamlines on an interpolation grid (l.44-117),
- background image + segmentation contours (l.198-239),
- the generic ``plot(plot_object_list)`` overlay engine (l.241-337),
- the ``show_img_seg_f`` convenience wrapper (l.340-389),
- the in-loop ``Plotting`` class (helper_classes.py:1456-1517) producing a
  PNG per subspace per recorded step.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional

import numpy as np

from glimslib_tpu_torch.visualisation import helpers

logger = logging.getLogger(__name__)


def plot_scalar_field(mesh, values, path=None, title=None, cmap="viridis",
                      ax=None, levels=None, colorbar=True, alpha=1.0,
                      range_f=None, exclude_below=None, exclude_around=None,
                      cmap_ref=None):
    """Filled-contour plot of a nodal scalar on a 2D mesh
    (reference plot_scalar_field, plotting.py:121-160).

    ``range_f``: (lo, hi) color range; ``exclude_below``/``exclude_around``
    mask values out of the plot (reference exclude_* kwargs, l.340-389);
    ``cmap_ref`` centers a diverging colormap at that value."""
    import matplotlib.pyplot as plt

    tri = helpers.mesh_to_triangulation(mesh)
    own_fig = ax is None
    if own_fig:
        fig, ax = plt.subplots(figsize=(6, 5))
    vals = np.asarray(values, dtype=np.float64).copy()
    excluded = np.zeros(vals.shape, dtype=bool)
    if exclude_below is not None:
        excluded |= vals < exclude_below
    if exclude_around is not None:
        center, tol = exclude_around
        excluded |= np.abs(vals - center) <= tol
    kw = {}
    if range_f is not None:
        lo, hi = range_f
        vals = np.clip(vals, lo, hi)
        if isinstance(levels, int) or levels is None:
            levels = np.linspace(lo, hi, (levels or 32) + 1)
    if cmap_ref is not None:
        kw["norm"] = helpers.MidpointNormalize(midpoint=cmap_ref)
    # excluded regions are masked OUT of the triangulation (reference
    # exclude_* semantics leave them unplotted), never rendered at value 0
    if excluded.any():
        tri.set_mask(excluded[tri.triangles].any(axis=1))
    vals = np.where(excluded, 0.0, vals)  # masked tris ignore these values
    # all-NaN/all-masked guard: tricontourf fails on empty data
    if not np.isfinite(vals).any() or (
        excluded.any() and tri.mask is not None and tri.mask.all()
    ):
        tri.set_mask(None)
        vals = np.zeros_like(vals)
    tpc = ax.tricontourf(tri, np.nan_to_num(vals), levels=levels
                         if levels is not None else 32, cmap=cmap,
                         alpha=alpha, **kw)
    if colorbar:
        ax.figure.colorbar(tpc, ax=ax, shrink=0.8)
    if title:
        ax.set_title(title)
    ax.set_aspect("equal")
    if own_fig:
        return helpers.show_plot(path, ax.figure)
    return ax


def plot_vector_field(mesh, values, path=None, title=None, mode="quiver",
                      ax=None, n_grid=30, color="k", alpha=1.0):
    """Quiver/streamline plot of a nodal vector field
    (reference plotting.py:44-117)."""
    import matplotlib.pyplot as plt

    own_fig = ax is None
    if own_fig:
        fig, ax = plt.subplots(figsize=(6, 5))
    vals = np.asarray(values)
    if mode == "quiver":
        pts = mesh.points
        stride = max(1, len(pts) // (n_grid * n_grid))
        if np.abs(vals).max() > 0:
            ax.quiver(
                pts[::stride, 0], pts[::stride, 1],
                vals[::stride, 0], vals[::stride, 1],
                color=color, alpha=alpha,
            )
        else:  # all-zero field: quiver autoscale divides by zero
            ax.plot(pts[::stride, 0], pts[::stride, 1], ".", ms=1,
                    color=color, alpha=alpha * 0.5)
    else:  # streamlines on an interpolation grid
        X, Y, (U, V) = helpers.interpolate_to_grid(mesh, vals, n_grid, n_grid)
        ax.streamplot(X, Y, np.nan_to_num(U), np.nan_to_num(V), color=color)
    if title:
        ax.set_title(title)
    ax.set_aspect("equal")
    if own_fig:
        return helpers.show_plot(path, ax.figure)
    return ax


def plot_image(image, origin=(0, 0), spacing=(1, 1), path=None, ax=None,
               cmap="gray", alpha=1.0, colorbar=False):
    """Background 2D image (reference sitk-image plotting, plotting.py:198-219)."""
    import matplotlib.pyplot as plt

    own_fig = ax is None
    if own_fig:
        fig, ax = plt.subplots(figsize=(6, 5))
    img = np.asarray(image)
    ny, nx = img.shape
    extent = (
        origin[0], origin[0] + nx * spacing[0],
        origin[1], origin[1] + ny * spacing[1],
    )
    im = ax.imshow(img, origin="lower", extent=extent, cmap=cmap, alpha=alpha)
    if colorbar:
        ax.figure.colorbar(im, ax=ax, shrink=0.8)
    if own_fig:
        return helpers.show_plot(path, ax.figure)
    return ax


def plot_segmentation_contours(image, origin=(0, 0), spacing=(1, 1), ax=None,
                               path=None, colors="r"):
    """Label-map contour overlay (reference plotting.py:220-239)."""
    import matplotlib.pyplot as plt

    own_fig = ax is None
    if own_fig:
        fig, ax = plt.subplots(figsize=(6, 5))
    img = np.asarray(image, dtype=np.float64)
    ny, nx = img.shape
    xs = origin[0] + spacing[0] * (np.arange(nx) + 0.5)
    ys = origin[1] + spacing[1] * (np.arange(ny) + 0.5)
    levels = np.unique(img)
    levels = (levels[:-1] + levels[1:]) / 2.0 if len(levels) > 1 else levels
    if len(levels):
        ax.contour(xs, ys, img, levels=levels, colors=colors, linewidths=1.0)
    if own_fig:
        return helpers.show_plot(path, ax.figure)
    return ax


def plot(plot_object_list: List[Dict], path=None, title=None, figsize=(7, 6)):
    """Generic overlay engine (reference plotting.py:241-337): each entry is
    ``{'object': array-or-(mesh,field), 'type': 'image'|'labels'|'scalar'|
    'vector', ...kwargs}`` drawn in order on one axis."""
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=figsize)
    for entry in plot_object_list:
        kind = entry.get("type")
        kwargs = {k: v for k, v in entry.items() if k not in ("object", "type")}
        obj = entry.get("object")
        if kind == "image":
            plot_image(obj, ax=ax, **kwargs)
        elif kind == "labels":
            plot_segmentation_contours(obj, ax=ax, **kwargs)
        elif kind == "scalar":
            mesh, vals = obj
            plot_scalar_field(mesh, vals, ax=ax, **kwargs)
        elif kind == "vector":
            mesh, vals = obj
            plot_vector_field(mesh, vals, ax=ax, **kwargs)
        else:
            raise ValueError(f"unknown plot object type {kind!r}")
    if title:
        ax.set_title(title)
    return helpers.show_plot(path, fig)


def show_img_seg_f(image=None, segmentation=None, function=None, mesh=None,
                   path=None, title=None, showmesh=False, alpha_f=0.8,
                   origin=(0, 0), spacing=(1, 1), range_f=None,
                   colormap="viridis", n_cmap_levels=None, exclude_below=None,
                   exclude_around=None, cmap_ref=None, **_ignored):
    """Convenience overlay: image + segmentation contours + field
    (reference show_img_seg_f, plotting.py:340-389).  Unknown reference
    kwargs are accepted and ignored for drop-in compatibility."""
    objs = []
    if image is not None:
        objs.append({"object": image, "type": "image", "origin": origin,
                     "spacing": spacing})
    if segmentation is not None:
        objs.append({"object": segmentation, "type": "labels", "origin": origin,
                     "spacing": spacing})
    if function is not None and mesh is not None:
        vals = np.asarray(function)
        kind = "vector" if vals.ndim == 2 else "scalar"
        entry = {"object": (mesh, vals), "type": kind, "alpha": alpha_f}
        if kind == "scalar":
            entry.update(cmap=colormap, range_f=range_f,
                         levels=n_cmap_levels, exclude_below=exclude_below,
                         exclude_around=exclude_around, cmap_ref=cmap_ref)
        objs.append(entry)
    return plot(objs, path=path, title=title)


# -- domain-specific presets (reference plotting.py:390-428) -----------------


def plot_concentration(image, label, fun, title, mesh=None, path=None,
                       show=False, plot_range=None):
    """Concentration preset (reference plot_concentration, plotting.py:390-398)."""
    return show_img_seg_f(image, label, fun, mesh=mesh, range_f=[0.001, 1.01],
                          colormap="viridis", n_cmap_levels=20, title=title,
                          path=path)


def plot_growth(image, label, fun, title, mesh=None, path=None, show=False):
    """Growth-field preset (reference plot_growth, plotting.py:401-408)."""
    return show_img_seg_f(image, label, fun, mesh=mesh, range_f=[0.0, 0.2],
                          colormap="viridis", n_cmap_levels=20, title=title,
                          path=path)


def plot_proliferation(image, label, fun, title, mesh=None, path=None,
                       show=False):
    """Proliferation preset with diverging colormap centered at 0
    (reference plot_proliferation, plotting.py:411-419)."""
    return show_img_seg_f(image, label, fun, mesh=mesh,
                          exclude_around=(0, 0.0001), range_f=[-0.02, 0.1],
                          colormap="RdBu_r", n_cmap_levels=20, cmap_ref=0.0,
                          title=title, path=path)


def plot_displacement(image, label, fun, title, mesh=None, path=None,
                      show=False):
    """Displacement preset: |u| masked below 0.5
    (reference plot_displacement, plotting.py:422-428)."""
    vals = np.asarray(fun)
    if vals.ndim == 2:
        vals = np.linalg.norm(vals, axis=1)
    return show_img_seg_f(image, label, vals, mesh=mesh, range_f=[0.0, 20],
                          exclude_below=0.5, colormap="viridis",
                          n_cmap_levels=20, title=title, path=path)


class Plotting:
    """In-loop per-step plotting (reference helper_classes.py:1456-1517)."""

    def __init__(self, results, output_dir="plots"):
        self.results = results
        self.output_dir = output_dir

    def plot_all(self, recording_step):
        fields = self.results.get_result(recording_step)
        if fields is None or self.results.mesh.dim != 2:
            return
        names = self.results._functionspace.get_subspace_names()
        os.makedirs(self.output_dir, exist_ok=True)
        for sid, arr in fields.items():
            nm = names.get(sid, f"subspace_{sid}")
            path = os.path.join(self.output_dir, f"{nm}_{recording_step:04d}.png")
            arr = np.asarray(arr)
            try:
                if arr.ndim == 2:
                    plot_vector_field(self.results.mesh, arr, path=path,
                                      title=f"{nm} @ step {recording_step}")
                else:
                    plot_scalar_field(self.results.mesh, arr, path=path,
                                      title=f"{nm} @ step {recording_step}")
            except Exception as e:  # plotting must never kill a run
                logger.warning("plotting failed for %s: %s", nm, e)
