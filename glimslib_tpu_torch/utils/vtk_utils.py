# Copy of glimslib_tpu/utils/vtk_utils.py (numpy only). The code is kept
# byte for byte apart from imports, which point into glimslib_tpu_torch so
# that the port never imports the JAX package.  The XDMF pair keeps its
# lazy h5py import: save_method="xdmf" needs h5py, the VTU path does not.
"""Unstructured-grid file I/O and processing — pure Python/numpy.

Rebuild of reference ``glimslib/utils/vtk_utils.py`` (315 LoC of VTK
pipelines).  The VTK C++ library is not a dependency here: the operations
the framework needs are implemented directly on (points, cells, data)
arrays, and the file formats (VTU XML, PVD series, XDMF+HDF5, legacy VTK)
are written/parsed with the standard library.

Covered reference operations:
- read/write VTU (reference vtk_utils.py:53-130) — ascii + base64 binary
- threshold cells by data value (l.16-34)  -> :func:`threshold_cells`
- tet/tri measure (l.36-51)                -> :func:`total_measure`
- warp by displacement vector (l.264-282)  -> :func:`warp_by_vector`
- resample unstructured -> image (l.284-292) -> :func:`resample_to_image`
- point<->cell data (l.246-262)            -> :func:`point_to_cell_data`,
                                              :func:`cell_to_point_data`
- surface/boundary node extraction (l.162-220) via Mesh.boundary_nodes
"""

from __future__ import annotations

import base64
import os
import struct
import xml.etree.ElementTree as ET
import zlib
from typing import Dict, Optional

import numpy as np

# VTK cell type ids
VTK_TRIANGLE = 5
VTK_TETRA = 10
_CELL_TYPE_BY_NPE = {2: 3, 3: VTK_TRIANGLE, 4: VTK_TETRA}  # line/tri/tet


# ---------------------------------------------------------------------------
# VTU writing
# ---------------------------------------------------------------------------


def _data_array_ascii(name, data, n_components):
    dtype = "Float64" if np.issubdtype(data.dtype, np.floating) else "Int32"
    body = " ".join(map(repr, np.asarray(data, dtype=np.float64 if dtype == "Float64" else np.int32).ravel().tolist()))
    return (
        f'<DataArray type="{dtype}" Name="{name}" '
        f'NumberOfComponents="{n_components}" format="ascii">{body}</DataArray>'
    )


def write_vtu(path, points, cells, point_data: Optional[Dict] = None,
              cell_data: Optional[Dict] = None):
    """Write an unstructured grid as VTU XML (ascii).

    ``points`` (n, dim) is padded to 3D as VTK requires; vector point data is
    padded to 3 components likewise."""
    points = np.asarray(points, dtype=np.float64)
    cells = np.asarray(cells, dtype=np.int64)
    n_points, dim = points.shape
    n_cells, npe = cells.shape
    pts3 = np.zeros((n_points, 3))
    pts3[:, :dim] = points
    ctype = _CELL_TYPE_BY_NPE[npe]

    parts = []
    parts.append('<?xml version="1.0"?>')
    parts.append(
        '<VTKFile type="UnstructuredGrid" version="0.1" byte_order="LittleEndian">'
    )
    parts.append("<UnstructuredGrid>")
    parts.append(f'<Piece NumberOfPoints="{n_points}" NumberOfCells="{n_cells}">')
    parts.append("<Points>")
    parts.append(_data_array_ascii("Points", pts3, 3))
    parts.append("</Points>")
    parts.append("<Cells>")
    parts.append(_data_array_ascii("connectivity", cells.ravel(), 1))
    parts.append(
        _data_array_ascii("offsets", np.arange(1, n_cells + 1) * npe, 1)
    )
    parts.append(
        _data_array_ascii("types", np.full(n_cells, ctype, dtype=np.int32), 1)
    )
    parts.append("</Cells>")
    if point_data:
        parts.append("<PointData>")
        for name, arr in point_data.items():
            arr = np.asarray(arr)
            if arr.ndim == 2 and arr.shape[1] == dim and dim < 3:
                arr3 = np.zeros((n_points, 3))
                arr3[:, :dim] = arr
                arr = arr3
            nc = 1 if arr.ndim == 1 else arr.shape[1]
            parts.append(_data_array_ascii(name, arr, nc))
        parts.append("</PointData>")
    if cell_data:
        parts.append("<CellData>")
        for name, arr in cell_data.items():
            arr = np.asarray(arr)
            nc = 1 if arr.ndim == 1 else arr.shape[1]
            parts.append(_data_array_ascii(name, arr, nc))
        parts.append("</CellData>")
    parts.append("</Piece></UnstructuredGrid></VTKFile>")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(parts))
    return path


def write_pvd(path, series):
    """ParaView series file; ``series`` = [(step, time, filename), ...]."""
    parts = ['<?xml version="1.0"?>', '<VTKFile type="Collection" version="0.1">',
             "<Collection>"]
    for step, time, fname in series:
        parts.append(f'<DataSet timestep="{time}" part="0" file="{fname}"/>')
    parts.append("</Collection></VTKFile>")
    with open(path, "w") as f:
        f.write("\n".join(parts))
    return path


# ---------------------------------------------------------------------------
# VTU reading (ascii, base64 appended/inline, optionally zlib-compressed)
# ---------------------------------------------------------------------------

_VTU_DTYPES = {
    "Float32": np.float32,
    "Float64": np.float64,
    "Int8": np.int8,
    "Int16": np.int16,
    "Int32": np.int32,
    "Int64": np.int64,
    "UInt8": np.uint8,
    "UInt16": np.uint16,
    "UInt32": np.uint32,
    "UInt64": np.uint64,
}


def _decode_data_array(da, appended: Optional[bytes], header_dtype, compressed):
    dtype = _VTU_DTYPES[da.get("type")]
    fmt = da.get("format", "ascii")
    if fmt == "ascii":
        text = da.text or ""
        return np.fromstring(text, sep=" ").astype(dtype) if False else np.array(
            text.split(), dtype=dtype
        )
    if fmt == "binary":
        raw = base64.b64decode((da.text or "").strip())
        return _decode_b64_block(raw, dtype, header_dtype, compressed)
    if fmt == "appended":
        offset = int(da.get("offset", "0"))
        return _decode_b64_block(appended[offset:], dtype, header_dtype, compressed,
                                 raw_binary=True)
    raise ValueError(f"unsupported VTU format {fmt}")


def _decode_b64_block(buf, dtype, header_dtype, compressed, raw_binary=False):
    hsize = np.dtype(header_dtype).itemsize
    if not compressed:
        n = int(np.frombuffer(buf[:hsize], dtype=header_dtype)[0])
        data = buf[hsize : hsize + n]
        return np.frombuffer(data, dtype=dtype)
    # compressed header: [nblocks, blocksize, lastsize, sizes...]
    head = np.frombuffer(buf[: 3 * hsize], dtype=header_dtype)
    nblocks = int(head[0])
    sizes = np.frombuffer(
        buf[3 * hsize : (3 + nblocks) * hsize], dtype=header_dtype
    ).astype(int)
    ofs = (3 + nblocks) * hsize
    out = b""
    for s in sizes:
        out += zlib.decompress(buf[ofs : ofs + s])
        ofs += s
    return np.frombuffer(out, dtype=dtype)


def read_vtu(path):
    """Read a VTU file -> (points (n,3), cells, point_data, cell_data).

    Supports ascii, inline-base64 and appended-base64 data, raw or
    zlib-compressed (the formats VTK/meshio write by default)."""
    tree = ET.parse(path)
    root = tree.getroot()
    compressed = root.get("compressor") is not None
    header_dtype = (
        np.uint64 if root.get("header_type", "UInt32") == "UInt64" else np.uint32
    )
    appended = None
    app = root.find("AppendedData")
    if app is not None:
        txt = (app.text or "").strip()
        if txt.startswith("_"):
            txt = txt[1:]
        appended = base64.b64decode(txt) if app.get("encoding", "base64") == "base64" else txt.encode()

    piece = root.find(".//Piece")
    n_points = int(piece.get("NumberOfPoints"))
    n_cells = int(piece.get("NumberOfCells"))

    def grab(parent_tag):
        node = piece.find(parent_tag)
        out = {}
        if node is None:
            return out
        for da in node.findall("DataArray"):
            arr = _decode_data_array(da, appended, header_dtype, compressed)
            nc = int(da.get("NumberOfComponents", "1"))
            if nc > 1:
                arr = arr.reshape(-1, nc)
            out[da.get("Name")] = arr
        return out

    pts = grab("Points")["Points"].reshape(n_points, 3)
    cd = grab("Cells")
    conn = cd["connectivity"].astype(np.int64)
    offsets = cd["offsets"].astype(np.int64)
    sizes = np.diff(np.concatenate([[0], offsets]))
    if len(np.unique(sizes)) != 1:
        raise ValueError("mixed cell types not supported")
    cells = conn.reshape(n_cells, int(sizes[0]))
    return pts, cells, grab("PointData"), grab("CellData")


# ---------------------------------------------------------------------------
# XDMF (+HDF5 heavy data) time-series writing
# ---------------------------------------------------------------------------


def append_xdmf_step(xdmf_path, h5_path, mesh, point_data, step, time):
    """Append one time step to an XDMF+HDF5 series (reference Results
    ``save_solution`` with method='xdmf', helper_classes.py:1360-1375)."""
    import h5py

    os.makedirs(os.path.dirname(os.path.abspath(h5_path)), exist_ok=True)
    mode = "a" if os.path.exists(h5_path) else "w"
    with h5py.File(h5_path, mode) as f:
        if "mesh" not in f:
            f.create_dataset("mesh/points", data=mesh.points)
            f.create_dataset("mesh/cells", data=mesh.cells)
        g = f.require_group(f"step_{step:05d}")
        g.attrs["time"] = time
        for name, arr in point_data.items():
            if name in g:
                del g[name]
            g.create_dataset(name, data=np.asarray(arr))
    _rewrite_xdmf_index(xdmf_path, h5_path, mesh)


def _rewrite_xdmf_index(xdmf_path, h5_path, mesh):
    import h5py

    topo = {3: "Triangle", 4: "Tetrahedron"}[mesh.cells.shape[1]]
    h5 = os.path.basename(h5_path)
    with h5py.File(h5_path, "r") as f:
        steps = sorted(k for k in f.keys() if k.startswith("step_"))
        lines = [
            '<?xml version="1.0"?>',
            '<Xdmf Version="3.0"><Domain>',
            '<Grid Name="series" GridType="Collection" CollectionType="Temporal">',
        ]
        npts, dim = mesh.points.shape
        ncells, npe = mesh.cells.shape
        for s in steps:
            t = float(f[s].attrs["time"])
            lines.append(f'<Grid Name="{s}"><Time Value="{t}"/>')
            lines.append(
                f'<Topology TopologyType="{topo}" NumberOfElements="{ncells}">'
                f'<DataItem Dimensions="{ncells} {npe}" Format="HDF">{h5}:/mesh/cells</DataItem>'
                "</Topology>"
            )
            geom = "XY" if dim == 2 else "XYZ"
            lines.append(
                f'<Geometry GeometryType="{geom}">'
                f'<DataItem Dimensions="{npts} {dim}" Format="HDF">{h5}:/mesh/points</DataItem>'
                "</Geometry>"
            )
            for name, dset in f[s].items():
                arr = np.asarray(dset)
                if arr.ndim == 1:
                    atype, dims = "Scalar", f"{len(arr)}"
                else:
                    atype, dims = "Vector", f"{arr.shape[0]} {arr.shape[1]}"
                lines.append(
                    f'<Attribute Name="{name}" AttributeType="{atype}" Center="Node">'
                    f'<DataItem Dimensions="{dims}" Format="HDF">{h5}:/{s}/{name}</DataItem>'
                    "</Attribute>"
                )
            lines.append("</Grid>")
        lines += ["</Grid></Domain></Xdmf>"]
    with open(xdmf_path, "w") as fx:
        fx.write("\n".join(lines))


# ---------------------------------------------------------------------------
# Grid processing (reference vtk pipelines, numpy re-implementations)
# ---------------------------------------------------------------------------


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


def total_measure(points, cells):
    """Total volume (tet) / area (tri) — reference getVolume (l.36-51)."""
    X = points[:, : cells.shape[1] - 1][cells] if False else points[cells]
    d = cells.shape[1] - 1
    J = X[:, 1:, : ] - X[:, :1, :]
    import math

    if J.shape[1] == J.shape[2]:
        return float(np.abs(np.linalg.det(J)).sum() / math.factorial(d))
    raise ValueError("embedded meshes not supported")


def warp_by_vector(points, displacement, scale=1.0):
    """Reference warpVTU (vtk_utils.py:264-282)."""
    disp = np.asarray(displacement)
    return points + scale * disp[:, : points.shape[1]]


def point_to_cell_data(cells, point_values):
    """Average point data to cells (reference l.246-253)."""
    return np.asarray(point_values)[cells].mean(axis=1)


def cell_to_point_data(n_points, cells, cell_values):
    """Average adjacent-cell data to points (reference l.255-262)."""
    cell_values = np.asarray(cell_values, dtype=np.float64)
    acc = np.zeros(n_points)
    cnt = np.zeros(n_points)
    for j in range(cells.shape[1]):
        np.add.at(acc, cells[:, j], cell_values)
        np.add.at(cnt, cells[:, j], 1.0)
    return acc / np.maximum(cnt, 1.0)


def resample_to_image(points, cells, point_data, origin, spacing, shape):
    """Sample P1 fields of a tri/tet mesh on a regular lattice — reference
    resample_to_image (vtk_utils.py:284-292, vtkResampleToImage).

    ``shape``: grid dims per axis (nx, ny[, nz]); returns dict of arrays
    shaped ``shape`` (+ component axis for vectors); points outside the mesh
    get 0 (as vtkResampleToImage's masked default).
    """
    from glimslib_tpu_torch.utils.interpolation import build_locator, sample_fields

    dim = points.shape[1]
    axes = [origin[a] + spacing[a] * np.arange(shape[a]) for a in range(dim)]
    grids = np.meshgrid(*axes, indexing="ij")
    q = np.stack([g.ravel() for g in grids], axis=1)
    loc = build_locator(points, cells)
    out = {}
    for name, arr in point_data.items():
        vals, inside = sample_fields(loc, points, cells, np.asarray(arr), q)
        vals[~inside] = 0.0
        out[name] = vals.reshape(
            tuple(shape) + (() if vals.ndim == 1 else (vals.shape[1],))
        )
    return out
