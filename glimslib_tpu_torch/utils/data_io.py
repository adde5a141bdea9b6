# Copy of glimslib_tpu/utils/data_io.py (numpy only) up to the mesh and
# function store: that code is kept byte for byte apart from imports, which
# point into glimslib_tpu_torch so that the port never imports the JAX
# package.  The store is the port's own (see the module docstring).
"""Image <-> mesh <-> field data pipeline (counterpart of
``glimslib_tpu/utils/data_io.py``): image slices as pixel-lattice meshes,
sampling between images and nodal functions, VTU ingest and merging, and
the mesh and function store of the workflow.

The store writes numpy ``.npz`` archives, not HDF5: the card's host has no
h5py, so the port's workflow path never imports it.  One format, no
fallback.  Each archive holds the reference's dataset keys (``mesh/points``,
``mesh/cells``, ``mesh/lattice_shape`` and ``mesh/lattice_strides`` for the
reference's lattice attributes, ``subdomains``, ``boundaries``,
``function``, ``labelfunction``, ``<name>/step_XXXXX``) at the reference's
path with the extension swapped to ``.npz`` (:func:`store_path`); the
functions keep the reference's names (``save_mesh_hdf5``,
``load_function_mesh``, ...) and return the path they wrote.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional, Tuple

import numpy as np

from glimslib_tpu_torch.core.mesh import Mesh, rectangle_mesh
from glimslib_tpu_torch.utils.image_io import Image, read_image

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# 2D image <-> function on pixel-lattice mesh
# ---------------------------------------------------------------------------


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


def fct2image2D(fct: Tuple[Mesh, np.ndarray], nx: int, ny: int) -> Image:
    """Function -> image by point evaluation over an (nx, ny) lattice
    spanning the mesh bbox (reference data_io.py:65-94)."""
    mesh, values = fct
    mins = mesh.points.min(axis=0)
    maxs = mesh.points.max(axis=0)
    spacing = (maxs - mins) / np.array([nx - 1, ny - 1])
    from glimslib_tpu_torch.utils.vtk_utils import resample_to_image

    out = resample_to_image(
        mesh.points, mesh.cells, {"f": values}, mins, spacing, (nx, ny)
    )["f"]
    # resample_to_image returns (nx, ny) index order; image arrays are [y][x]
    return Image(data=out.T.copy(), origin=tuple(mins), spacing=tuple(spacing))


def compute_spacing(number_list):
    """Spacing of a sorted coordinate list (reference data_io.py:124-130)."""
    arr = np.unique(np.asarray(number_list, dtype=np.float64))
    if len(arr) < 2:
        return 0.0
    return float(np.diff(arr).mean())


def get_measures_from_structured_mesh(mesh):
    """Origin/spacing/size of a structured (pixel-lattice) mesh
    (reference data_io.py:101-130)."""
    pts = mesh.points
    out = {}
    for a, name in enumerate("xyz"[: mesh.dim]):
        coords = np.unique(pts[:, a])
        out[f"origin_{name}"] = float(coords[0])
        out[f"spacing_{name}"] = compute_spacing(coords)
        out[f"size_{name}"] = int(len(coords))
    return out


def get_measures_from_image(image: Image):
    """(origin, spacing, size, extent) — reference data_io.py:153-174."""
    size = image.size
    origin = image.get_origin()
    spacing = image.get_spacing()
    extent = tuple(
        origin[a] + spacing[a] * (size[a] - 1) for a in range(len(size))
    )
    return {"origin": origin, "spacing": spacing, "size": size, "extent": extent}


def create_image_from_fenics_function(fct, size_new=None) -> Image:
    """Nodal function -> image over the mesh bbox (reference l.176-225)."""
    mesh, values = fct
    dim = mesh.dim
    mins = mesh.points.min(axis=0)
    maxs = mesh.points.max(axis=0)
    if size_new is None:
        size_new = (100,) * dim
    spacing = (maxs - mins) / (np.asarray(size_new) - 1)
    from glimslib_tpu_torch.utils.vtk_utils import resample_to_image

    vals = np.asarray(values)
    out = resample_to_image(
        mesh.points, mesh.cells, {"f": vals}, mins, spacing, tuple(size_new)
    )["f"]
    # (x, y[, z]) index order -> [z][y][x]
    axes = tuple(reversed(range(dim)))
    if vals.ndim == 2:
        out = np.transpose(out, axes + (dim,))
        return Image(out.copy(), tuple(mins), tuple(spacing), is_vector=True)
    return Image(np.transpose(out, axes).copy(), tuple(mins), tuple(spacing))


def create_fenics_function_from_image(image: Image, mesh: Mesh) -> np.ndarray:
    """Sample an image at mesh node coordinates (linear interpolation) —
    the general path of reference l.385-406 without the slow dof matching
    (node coords are explicit here)."""
    from scipy.ndimage import map_coordinates

    dim = mesh.dim
    origin = np.asarray(image.origin[:dim])
    spacing = np.asarray(image.spacing[:dim])
    # node -> voxel index (x,y[,z]) -> array index reversed
    idx = (mesh.points - origin) / spacing
    coords = [idx[:, a] for a in reversed(range(dim))]  # [z][y][x] order
    data = np.asarray(image.data, dtype=np.float64)
    if image.is_vector:
        comps = [
            map_coordinates(data[..., k], coords, order=1, mode="nearest")
            for k in range(data.shape[-1])
        ]
        return np.stack(comps, axis=1)
    return map_coordinates(data, coords, order=1, mode="nearest")


create_fenics_function_from_image_quick = create_fenics_function_from_image


def get_labelfunction_from_image(path, z_slice=0) -> Tuple[Mesh, np.ndarray]:
    """Read a 3D labelmap, take an axial slice, return the pixel-lattice
    mesh + nodal label function (reference l.256-275)."""
    img = read_image(path)
    if img.ndim == 3:
        img = img.slice_z(z_slice)
    return image2fct2D(img)


# ---------------------------------------------------------------------------
# mesh sanitation (reference l.413-467)
# ---------------------------------------------------------------------------


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


# ---------------------------------------------------------------------------
# VTU ingest (reference l.469-579)
# ---------------------------------------------------------------------------


def read_vtk_convert_to_fenics(path_to_vtk, domain_array_name="ElementBlockIds"):
    """VTU -> (Mesh, cell_subdomains or None) with orphaned-vertex repair
    (reference read_vtk_convert_to_fenics, l.575-579 + l.469-524)."""
    from glimslib_tpu_torch.utils.vtk_utils import read_vtu

    pts, cells, point_data, cell_data = read_vtu(path_to_vtk)
    # drop the padding z column for planar meshes
    dim = cells.shape[1] - 1
    pts = pts[:, :dim]
    pts, cells, point_data = remove_orphaned_vertices(pts, cells, point_data)
    mesh = Mesh.from_arrays(pts, cells)
    subdomains = None
    for key in (domain_array_name, "subdomains", "labels"):
        if key in cell_data:
            subdomains = np.asarray(cell_data[key]).astype(np.int32)
            break
    return mesh, subdomains


def convert_fenics_mesh_to_meshio(mesh: Mesh, subdomains=None):
    """Mesh -> meshio-style dict {points, cells, cell_data}
    (reference convert_fenics_mesh_to_meshio, l.527-547)."""
    out = {"points": mesh.points, "cells": mesh.cells}
    if subdomains is not None:
        out["cell_data"] = {"ElementBlockIds": np.asarray(subdomains)}
    return out


def convert_meshio_to_fenics_mesh(meshio_like, domain_array_name="ElementBlockIds"):
    """meshio-style dict/object -> (Mesh, subdomains) with orphan repair
    (reference convert_meshio_to_fenics_mesh, l.469-524)."""
    pts = np.asarray(meshio_like["points"] if isinstance(meshio_like, dict)
                     else meshio_like.points)
    cells = np.asarray(meshio_like["cells"] if isinstance(meshio_like, dict)
                       else meshio_like.cells)
    cd = (meshio_like.get("cell_data", {}) if isinstance(meshio_like, dict)
          else getattr(meshio_like, "cell_data", {}))
    dim = cells.shape[1] - 1
    pts = pts[:, :dim]
    pts, cells, _ = remove_orphaned_vertices(pts, cells)
    sd = None
    if domain_array_name in cd:
        sd = np.asarray(cd[domain_array_name]).astype(np.int32)
    return Mesh.from_arrays(pts, cells), sd


def remove_mesh_subdomain(mesh: Mesh, subdomains, lower_thr, upper_thr):
    """Keep only cells whose subdomain id is within [lower, upper]
    (reference l.581-599, VTK threshold round-trip)."""
    from glimslib_tpu_torch.utils.vtk_utils import threshold_cells

    pts, cells, _, cd = threshold_cells(
        mesh.points, mesh.cells, np.asarray(subdomains), lower_thr, upper_thr,
        cell_data={"subdomains": np.asarray(subdomains)},
    )
    return Mesh.from_arrays(pts, cells), cd["subdomains"]


# ---------------------------------------------------------------------------
# per-timestep VTU merging (reference l.606-654)
# ---------------------------------------------------------------------------


def create_file_name(name, step):
    return f"{name}_{step:06d}.vtu"


def merge_vtus_timestep(base_path, timestep, remove=False, reference_file_path=None):
    """Merge all single-field VTUs of one timestep into one file
    (reference l.606-641)."""
    from glimslib_tpu_torch.utils.vtk_utils import read_vtu, write_vtu

    import glob

    pattern = os.path.join(base_path, f"*_{timestep:06d}.vtu")
    files = sorted(glob.glob(pattern))
    merged_name = os.path.join(base_path, f"merged_{timestep:06d}.vtu")
    files = [f for f in files if not os.path.basename(f).startswith("merged_")]
    if not files:
        return None
    pts, cells, pd, cd = read_vtu(files[0])
    for f in files[1:]:
        _, _, pd2, cd2 = read_vtu(f)
        pd.update(pd2)
        cd.update(cd2)
    if reference_file_path:
        _, _, pdr, _ = read_vtu(reference_file_path)
        pd.update(pdr)
    dim = cells.shape[1] - 1
    write_vtu(merged_name, pts[:, :dim], cells, pd, cd)
    if remove:
        for f in files:
            os.remove(f)
    return merged_name


def merge_VTUs(base_path, delta_t, t_max, remove=False, reference=None):
    """Merge per-field VTUs across all timesteps (reference l.649-654)."""
    out = []
    n = int(round(t_max / delta_t))
    for step in range(n + 1):
        merged = merge_vtus_timestep(base_path, step, remove=remove,
                                     reference_file_path=reference)
        if merged:
            out.append(merged)
    return out



# ---------------------------------------------------------------------------
# mesh / function store: .npz with the reference's keys (reference l.663-800)
# ---------------------------------------------------------------------------


def store_path(path):
    """The archive a store function writes for a reference path: the same
    path with its extension swapped to ``.npz``."""
    return os.path.splitext(str(path))[0] + ".npz"


def _write_npz(path, arrays: Dict[str, np.ndarray]):
    path = store_path(path)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        np.savez(f, **{k: np.asarray(v) for k, v in arrays.items()})
    return path


def _read_npz(path) -> Dict[str, np.ndarray]:
    with np.load(store_path(path), allow_pickle=False) as f:
        return {k: f[k] for k in f.files}


def _mesh_arrays(mesh: Mesh) -> Dict[str, np.ndarray]:
    out = {"mesh/points": mesh.points, "mesh/cells": mesh.cells}
    if mesh.lattice_shape is not None:
        out["mesh/lattice_shape"] = np.asarray(mesh.lattice_shape)
        out["mesh/lattice_strides"] = np.asarray(mesh.lattice_strides)
    return out


def _mesh_from(store: Dict[str, np.ndarray]) -> Mesh:
    lat = store.get("mesh/lattice_shape")
    strides = store.get("mesh/lattice_strides")
    return Mesh.from_arrays(
        store["mesh/points"], store["mesh/cells"],
        lattice_shape=tuple(int(x) for x in lat) if lat is not None else None,
        lattice_strides=(tuple(int(x) for x in strides)
                         if strides is not None else None),
    )


def save_mesh_hdf5(mesh: Mesh, path_to_file, subdomains=None, boundaries=None):
    """Mesh (+cell subdomains, +facet boundaries) -> store
    (reference save_mesh_hdf5, l.663-679); returns the archive's path."""
    arrays = _mesh_arrays(mesh)
    if subdomains is not None:
        arrays["subdomains"] = subdomains
    if boundaries is not None:
        arrays["boundaries"] = boundaries
    return _write_npz(path_to_file, arrays)


def read_mesh_hdf5(path_to_file):
    """Store -> (Mesh, subdomains, boundaries) (reference l.681-713)."""
    store = _read_npz(path_to_file)
    return _mesh_from(store), store.get("subdomains"), store.get("boundaries")


def save_functions_hdf5(function_dict: Dict[str, np.ndarray], path_to_file,
                        time_step=None):
    """Named nodal functions -> store, added to what the archive holds
    (reference l.716-748); returns the archive's path."""
    path = store_path(path_to_file)
    arrays = _read_npz(path) if os.path.exists(path) else {}
    for name, arr in function_dict.items():
        key = name if time_step is None else f"{name}/step_{time_step:05d}"
        arrays[key] = np.asarray(arr)
        if time_step is not None:
            arrays[f"{key}/time_step"] = np.int64(time_step)
    return _write_npz(path, arrays)


def read_function_hdf5(name, path_to_file, time_step=None):
    """Read one named function back (reference l.751-760)."""
    key = name if time_step is None else f"{name}/step_{time_step:05d}"
    return _read_npz(path_to_file).get(key)


def save_function_mesh(function, path_to_hdf5_function, labelfunction=None,
                       mesh: Optional[Mesh] = None, subdomains=None):
    """Function + mesh (+labels) in one archive (reference l.763-783);
    returns the archive's path."""
    arrays = {"function": function}
    if mesh is not None:
        arrays["mesh/points"] = mesh.points
        arrays["mesh/cells"] = mesh.cells
    if labelfunction is not None:
        arrays["labelfunction"] = labelfunction
    if subdomains is not None:
        arrays["subdomains"] = subdomains
    return _write_npz(path_to_hdf5_function, arrays)


def load_function_mesh(path_to_hdf5_function):
    """(function, mesh, labelfunction, subdomains) (reference l.785-800)."""
    store = _read_npz(path_to_hdf5_function)
    mesh = None
    if "mesh/points" in store:
        mesh = Mesh.from_arrays(store["mesh/points"], store["mesh/cells"])
    return (store["function"], mesh, store.get("labelfunction"),
            store.get("subdomains"))


# ---------------------------------------------------------------------------
# tabular results: dicts of numpy columns (the reference's DataFrames)
# ---------------------------------------------------------------------------


def save_columns(columns: Dict[str, np.ndarray], path_pkl=None, path_csv=None):
    """A table as a dict of equal-length numpy columns under the
    reference's column names: pickled to ``path_pkl`` and written as CSV
    (a header row, then every value as numpy prints it, which reads back
    exactly) to ``path_csv``.  The reference writes DataFrames (pickle and
    xls or csv); the port's workflow path does not import pandas."""
    if path_pkl:
        import pickle

        os.makedirs(os.path.dirname(os.path.abspath(path_pkl)), exist_ok=True)
        with open(path_pkl, "wb") as f:
            pickle.dump(columns, f, protocol=pickle.HIGHEST_PROTOCOL)
    if path_csv:
        os.makedirs(os.path.dirname(os.path.abspath(path_csv)), exist_ok=True)
        table = np.column_stack([np.asarray(c).astype(str) for c in columns.values()])
        np.savetxt(path_csv, table, fmt="%s", delimiter=",",
                   header=",".join(columns), comments="")
    return columns
