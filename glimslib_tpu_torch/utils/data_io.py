# Copy of glimslib_tpu/utils/data_io.py (numpy only): image2fct2D,
# get_labelfunction_from_image, identify_orphaned_vertices,
# remove_orphaned_vertices and remove_mesh_subdomain only.  The code is
# kept byte for byte apart from imports, which point into
# glimslib_tpu_torch so that the port never imports the JAX package.
"""Image -> mesh -> subdomain pipeline of the 2D atlas problems: an image
slice as a pixel-lattice mesh with its label function, orphaned-vertex
repair, and the removal of subdomains (counterpart of
``glimslib_tpu/utils/data_io.py``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from glimslib_tpu_torch.core.mesh import Mesh, rectangle_mesh
from glimslib_tpu_torch.utils.image_io import Image, read_image


def image2fct2D(image: Image) -> Tuple[Mesh, np.ndarray]:
    """2D image -> P1 function on a RectangleMesh whose vertices are exactly
    the pixel centres, dof order == pixel order (reference data_io.py:31-63).
    """
    assert image.ndim == 2
    data = np.asarray(image.data)
    ny, nx = data.shape
    ox, oy = image.origin
    sx, sy = image.spacing
    mesh = rectangle_mesh(
        (ox, oy), (ox + (nx - 1) * sx, oy + (ny - 1) * sy), nx - 1, ny - 1
    )
    values = data.astype(np.float64).ravel()  # node order: x fastest == C order
    return mesh, values


def get_labelfunction_from_image(path, z_slice=0) -> Tuple[Mesh, np.ndarray]:
    """Read a 3D labelmap, take an axial slice, return the pixel-lattice
    mesh + nodal label function (reference l.256-275)."""
    img = read_image(path)
    if img.ndim == 3:
        img = img.slice_z(z_slice)
    return image2fct2D(img)


def identify_orphaned_vertices(points, cells):
    used = np.zeros(len(points), dtype=bool)
    used[np.unique(np.asarray(cells).ravel())] = True
    return np.where(~used)[0]


def remove_orphaned_vertices(points, cells, point_data: Optional[Dict] = None):
    """Drop vertices not referenced by any cell, remapping connectivity
    (reference l.429-467, the PETSc 'error 76' guard)."""
    cells = np.asarray(cells)
    used = np.unique(cells.ravel())
    remap = -np.ones(len(points), dtype=np.int64)
    remap[used] = np.arange(len(used))
    out_pd = {k: np.asarray(v)[used] for k, v in (point_data or {}).items()}
    return points[used], remap[cells], out_pd


def remove_mesh_subdomain(mesh: Mesh, subdomains, lower_thr, upper_thr):
    """Keep only cells whose subdomain id is within [lower, upper]
    (reference l.581-599, VTK threshold round-trip)."""
    from glimslib_tpu_torch.utils.vtk_utils import threshold_cells

    pts, cells, _, cd = threshold_cells(
        mesh.points, mesh.cells, np.asarray(subdomains), lower_thr, upper_thr,
        cell_data={"subdomains": np.asarray(subdomains)},
    )
    return Mesh.from_arrays(pts, cells), cd["subdomains"]
