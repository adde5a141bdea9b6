# Copy of glimslib_tpu/utils/meshing.py (numpy only). The code is kept
# byte for byte apart from imports, which point into glimslib_tpu_torch so
# that the port never imports the JAX package.
"""3D labeled-image -> tetrahedral mesh.

Rebuild of reference ``glimslib/utils/meshing.py``: the reference writes a
MeshTool XML config (per-tissue cell sizing) and shells out to the
CGAL-based MeshTool binary (meshing.py:10-43).  That driver is kept
interface-compatible (:func:`create_mesh_xml`, :func:`mesh_image`), gated on
the binary being installed — and complemented by a first-party fallback
mesher (:func:`mesh_image_labels`) that builds a structured Kuhn-subdivided
tet mesh over the foreground voxels, so the full 3D pipeline runs in
environments without MeshTool (this one included).
"""

from __future__ import annotations

import logging
import os
import subprocess
from typing import Dict, Optional

import numpy as np

from glimslib_tpu_torch import config
from glimslib_tpu_torch.core.mesh import Mesh
from glimslib_tpu_torch.utils.image_io import Image

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# first-party fallback mesher
# ---------------------------------------------------------------------------


def mesh_image_labels(image: Image, downsample: int = 1, full_lattice=False):
    """Labeled 3D image -> (Mesh, cell_labels): each foreground voxel
    (label > 0) becomes 6 tets (Kuhn subdivision); vertices sit on voxel
    corners in physical coordinates; cell label = voxel label.

    ``full_lattice=False`` drops unused vertices (reference orphan repair,
    data_io.py:413-467).  ``full_lattice=True`` keeps every corner of the
    bounding lattice and tags the mesh with lattice strides — enabling the
    offset-stencil operator fast path (ops/stencil.py); nodes untouched by
    any cell are auto-masked by the solvers (Simulation handles them as
    zero-Dirichlet dofs).
    """
    data = np.asarray(image.data)
    assert data.ndim == 3, "mesh_image_labels needs a 3D labelmap"
    if downsample > 1:
        data = data[::downsample, ::downsample, ::downsample]
    nz, ny, nx = data.shape
    sx, sy, sz = (s * downsample for s in image.spacing)
    ox, oy, oz = image.origin

    # voxel corner lattice: (nx+1, ny+1, nz+1), index = ix*sx_ + iy*sy_ + iz
    sy_ = nz + 1
    sx_ = (ny + 1) * (nz + 1)
    fg = np.argwhere(data > 0)  # (n_fg, 3) as (iz, iy, ix)
    if len(fg) == 0:
        raise ValueError("labelmap has no foreground voxels")
    iz, iy, ix = fg[:, 0], fg[:, 1], fg[:, 2]
    v000 = ix * sx_ + iy * sy_ + iz
    # anchor-sorted voxels (argwhere yields z-major order; the stencil
    # lattice meta requires anchors ascending in node-index order)
    order = np.argsort(v000, kind="stable")
    iz, iy, ix, v000 = iz[order], iy[order], ix[order], v000[order]
    v100 = v000 + sx_
    v010 = v000 + sy_
    v001 = v000 + 1
    v110 = v000 + sx_ + sy_
    v101 = v000 + sx_ + 1
    v011 = v000 + sy_ + 1
    v111 = v000 + sx_ + sy_ + 1
    # voxel-major (6 tets per voxel adjacent) — see core/mesh.py box_mesh
    tets = np.stack(
        [
            np.stack([v000, v100, v110, v111], axis=1),
            np.stack([v000, v110, v010, v111], axis=1),
            np.stack([v000, v010, v011, v111], axis=1),
            np.stack([v000, v011, v001, v111], axis=1),
            np.stack([v000, v001, v101, v111], axis=1),
            np.stack([v000, v101, v100, v111], axis=1),
        ],
        axis=1,
    ).reshape(-1, 4)
    labels = np.repeat(data[iz, iy, ix], 6).astype(np.int32)

    if full_lattice:
        # all lattice corner coordinates, index = ix*sx_ + iy*sy_ + iz
        gx, gy, gz = np.meshgrid(
            np.arange(nx + 1), np.arange(ny + 1), np.arange(nz + 1),
            indexing="ij",
        )
        coords = np.stack(
            [ox + gx.ravel() * sx, oy + gy.ravel() * sy, oz + gz.ravel() * sz],
            axis=1,
        ).astype(np.float64)
        mesh = Mesh.from_arrays(
            coords, tets,
            lattice_shape=(nx + 1, ny + 1, nz + 1),
            lattice_strides=(sx_, sy_, 1),
        )
        return mesh, labels

    used = np.unique(tets.ravel())
    gx = used // sx_
    rem = used % sx_
    gy = rem // sy_
    gz = rem % sy_
    coords_used = np.stack(
        [ox + gx * sx, oy + gy * sy, oz + gz * sz], axis=1
    ).astype(np.float64)
    remap = -np.ones(int(used.max()) + 1, dtype=np.int64)
    remap[used] = np.arange(len(used))
    cells = remap[tets]
    mesh = Mesh.from_arrays(coords_used, cells)
    return mesh, labels


# ---------------------------------------------------------------------------
# MeshTool driver (reference meshing.py:10-43) — gated on the binary
# ---------------------------------------------------------------------------


def create_mesh_xml(path_to_image_in, path_to_mesh_out, tissues_dict: Dict,
                    path_to_xml_file):
    """Write the MeshTool XML configuration (reference create_mesh_xml,
    meshing.py:19-43): global + per-tissue cell-size settings."""
    lines = ['<?xml version="1.0"?>', "<input>"]
    lines.append(f"    <image_in>{path_to_image_in}</image_in>")
    lines.append(f"    <mesh_out>{path_to_mesh_out}</mesh_out>")
    g = tissues_dict.get("global", {})
    lines.append("    <global>")
    for key in ("cell_radius_edge_ratio", "cell_size", "facet_angle",
                "facet_size", "facet_distance"):
        if key in g:
            lines.append(f"        <{key}>{g[key]}</{key}>")
    lines.append("    </global>")
    for name, t in tissues_dict.items():
        if name == "global":
            continue
        lines.append(f'    <tissue id="{t.get("domain_id", 0)}" name="{name}">')
        for key in ("cell_size",):
            if key in t:
                lines.append(f"        <{key}>{t[key]}</{key}>")
        lines.append("    </tissue>")
    lines.append("</input>")
    os.makedirs(os.path.dirname(os.path.abspath(path_to_xml_file)), exist_ok=True)
    with open(path_to_xml_file, "w") as f:
        f.write("\n".join(lines))
    return path_to_xml_file


def meshtool_available(path_to_meshtool_bin=None) -> bool:
    import shutil as _shutil

    binpath = path_to_meshtool_bin or config.path_to_meshtool_bin
    return _shutil.which(binpath) is not None or os.path.isfile(binpath)


def mesh_image(path_to_meshtool_bin=None, path_to_meshtool_xsd=None,
               path_to_config_file=None):
    """Run MeshTool in image mode (reference mesh_image, meshing.py:10-16).

    Raises ``RuntimeError`` when the binary is absent — callers fall back to
    :func:`mesh_image_labels`."""
    binpath = path_to_meshtool_bin or config.path_to_meshtool_bin
    if not meshtool_available(binpath):
        raise RuntimeError(
            f"MeshTool binary not found at {binpath!r}; use "
            "meshing.mesh_image_labels for the first-party fallback mesher"
        )
    cmd = [binpath, "-m", "image", "-c", path_to_config_file]
    if path_to_meshtool_xsd:
        cmd += ["-x", path_to_meshtool_xsd]
    logger.info("running: %s", " ".join(cmd))
    subprocess.run(cmd, check=True)
