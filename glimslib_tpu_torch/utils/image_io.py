# Copy of glimslib_tpu/utils/image_io.py (numpy only). The code is kept
# byte for byte apart from imports, which point into glimslib_tpu_torch so
# that the port never imports the JAX package.
"""Medical-image I/O without ITK: MetaImage (.mha/.mhd) + NIfTI-1 (.nii).

Replaces the reference's SimpleITK dependency (SURVEY.md §2.2) for the
formats its data pipeline uses (.mha/.nii reads/writes at data_io.py:38-63,
image_based_optimization.py:201-227).  A light :class:`Image` carries the
voxel array plus the sitk-style geometry (origin/spacing in x,y,z order;
array stored numpy-style [z][y][x]).
"""

from __future__ import annotations

import dataclasses
import gzip
import os
import struct
import zlib
from typing import Optional, Tuple

import numpy as np

_MET_TYPES = {
    "MET_CHAR": np.int8,
    "MET_UCHAR": np.uint8,
    "MET_SHORT": np.int16,
    "MET_USHORT": np.uint16,
    "MET_INT": np.int32,
    "MET_UINT": np.uint32,
    "MET_LONG": np.int64,
    "MET_ULONG": np.uint64,
    "MET_FLOAT": np.float32,
    "MET_DOUBLE": np.float64,
}
_MET_NAMES = {np.dtype(v): k for k, v in _MET_TYPES.items()}


@dataclasses.dataclass
class Image:
    """Voxel image with sitk-like geometry.

    data: numpy array, axis order [z][y][x] (3D) or [y][x] (2D), with an
          optional trailing component axis for vector images.
    origin/spacing: x,y,z ordered tuples (sitk convention).
    """

    data: np.ndarray
    origin: Tuple[float, ...]
    spacing: Tuple[float, ...]
    is_vector: bool = False

    @property
    def ndim(self):
        return self.data.ndim - (1 if self.is_vector else 0)

    @property
    def size(self):  # (x, y[, z]) like sitk GetSize()
        shp = self.data.shape[: self.ndim]
        return tuple(reversed(shp))

    def get_spacing(self):
        return tuple(self.spacing)

    def get_origin(self):
        return tuple(self.origin)

    def slice_z(self, z_index: int) -> "Image":
        """Extract a 2D axial slice from a 3D image (reference 2D-slice
        extraction, image_based_optimization.py:201-227)."""
        assert self.ndim == 3
        return Image(
            data=self.data[z_index],
            origin=self.origin[:2],
            spacing=self.spacing[:2],
            is_vector=self.is_vector,
        )

    def astype(self, dtype) -> "Image":
        return Image(self.data.astype(dtype), self.origin, self.spacing,
                     self.is_vector)


# ---------------------------------------------------------------------------
# MetaImage
# ---------------------------------------------------------------------------


def _check_lfs_pointer(raw: bytes, path):
    if raw.startswith(b"version https://git-lfs"):
        raise ValueError(
            f"{path} is a git-LFS pointer stub, not image data (the "
            "reference repo's bundled data is stored in LFS and was not "
            "fetched); generate synthetic stand-ins with "
            "glimslib_tpu.utils.synthetic instead"
        )


def read_mha(path) -> Image:
    with open(path, "rb") as f:
        raw = f.read()
    _check_lfs_pointer(raw, path)
    # header = text lines until 'ElementDataFile'
    header = {}
    pos = 0
    while True:
        eol = raw.index(b"\n", pos)
        line = raw[pos:eol].decode("ascii", errors="replace").strip()
        pos = eol + 1
        if "=" in line:
            k, v = line.split("=", 1)
            header[k.strip()] = v.strip()
            if k.strip() == "ElementDataFile":
                break
        if pos >= len(raw):
            break
    ndims = int(header.get("NDims", 3))
    dims = tuple(int(x) for x in header["DimSize"].split())  # x y z
    dtype = _MET_TYPES[header.get("ElementType", "MET_FLOAT")]
    n_comp = int(header.get("ElementNumberOfChannels", 1))
    spacing = tuple(
        float(x)
        for x in header.get(
            "ElementSpacing", header.get("ElementSize", "1 " * ndims)
        ).split()
    )
    origin = tuple(
        float(x) for x in header.get("Offset", header.get("Position", "0 " * ndims)).split()
    )
    datafile = header.get("ElementDataFile", "LOCAL")
    if datafile != "LOCAL":
        with open(os.path.join(os.path.dirname(path), datafile), "rb") as f:
            buf = f.read()
    else:
        buf = raw[pos:]
    if header.get("CompressedData", "False").lower() == "true":
        buf = zlib.decompress(buf)
    count = int(np.prod(dims)) * n_comp
    arr = np.frombuffer(buf[: count * np.dtype(dtype).itemsize], dtype=dtype)
    shape = tuple(reversed(dims)) + ((n_comp,) if n_comp > 1 else ())
    arr = arr.reshape(shape)
    if header.get("BinaryDataByteOrderMSB", "False").lower() == "true":
        arr = arr.byteswap()
    return Image(
        data=np.array(arr),
        origin=origin,
        spacing=spacing,
        is_vector=n_comp > 1,
    )


def write_mha(path, image: Image, compressed=False):
    data = np.ascontiguousarray(image.data)
    ndims = image.ndim
    n_comp = data.shape[-1] if image.is_vector else 1
    dims = " ".join(str(s) for s in image.size)
    lines = [
        "ObjectType = Image",
        f"NDims = {ndims}",
        "BinaryData = True",
        "BinaryDataByteOrderMSB = False",
        f"CompressedData = {'True' if compressed else 'False'}",
        f"TransformMatrix = {' '.join(str(int(i == j)) for i in range(ndims) for j in range(ndims))}",
        f"Offset = {' '.join(repr(float(o)) for o in image.origin)}",
        f"CenterOfRotation = {' '.join('0' for _ in range(ndims))}",
        f"ElementSpacing = {' '.join(repr(float(s)) for s in image.spacing)}",
        f"DimSize = {dims}",
    ]
    if n_comp > 1:
        lines.append(f"ElementNumberOfChannels = {n_comp}")
    lines.append(f"ElementType = {_MET_NAMES[data.dtype]}")
    lines.append("ElementDataFile = LOCAL")
    payload = data.tobytes()
    if compressed:
        payload = zlib.compress(payload)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(("\n".join(lines) + "\n").encode("ascii"))
        f.write(payload)
    return path


# ---------------------------------------------------------------------------
# NIfTI-1 (minimal: uncompressed or .nii.gz, single file)
# ---------------------------------------------------------------------------

_NIFTI_DTYPES = {
    2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32, 64: np.float64,
    256: np.int8, 512: np.uint16, 768: np.uint32,
}
_NIFTI_CODES = {np.dtype(v): k for k, v in _NIFTI_DTYPES.items()}


def read_nii(path) -> Image:
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rb") as f:
        hdr = f.read(352)
        sizeof_hdr = struct.unpack("<i", hdr[:4])[0]
        assert sizeof_hdr == 348, "not a NIfTI-1 file"
        dim = struct.unpack("<8h", hdr[40:56])
        ndim = dim[0]
        shape = dim[1 : 1 + ndim]
        datatype = struct.unpack("<h", hdr[70:72])[0]
        pixdim = struct.unpack("<8f", hdr[76:108])
        vox_offset = int(struct.unpack("<f", hdr[108:112])[0])
        qoffset = struct.unpack("<3f", hdr[268:280])
        f.seek(vox_offset)
        dtype = _NIFTI_DTYPES[datatype]
        count = int(np.prod(shape))
        arr = np.frombuffer(f.read(count * np.dtype(dtype).itemsize), dtype=dtype)
    # nifti data is x-fastest: reshape fortran then transpose to [z][y][x]
    arr = arr.reshape(tuple(shape), order="F")
    arr = np.transpose(arr, tuple(reversed(range(ndim))))
    return Image(
        data=np.array(arr),
        origin=tuple(qoffset[:ndim]),
        spacing=tuple(pixdim[1 : 1 + ndim]),
    )


def write_nii(path, image: Image):
    data = np.ascontiguousarray(image.data)
    ndim = image.ndim
    # to x-fastest fortran layout
    arr = np.transpose(data, tuple(reversed(range(ndim))))
    hdr = bytearray(348)
    struct.pack_into("<i", hdr, 0, 348)
    dims = [ndim] + list(arr.shape) + [1] * (7 - ndim)
    struct.pack_into("<8h", hdr, 40, *dims)
    struct.pack_into("<h", hdr, 70, _NIFTI_CODES[arr.dtype])
    struct.pack_into("<h", hdr, 72, arr.dtype.itemsize * 8)
    pixdims = [1.0] + list(image.spacing) + [1.0] * (7 - ndim)
    struct.pack_into("<8f", hdr, 76, *pixdims)
    struct.pack_into("<f", hdr, 108, 352.0)
    # sform with spacing on the diagonal
    struct.pack_into("<h", hdr, 254, 1)  # sform_code
    srow = np.zeros((3, 4), dtype=np.float32)
    for a in range(min(3, ndim)):
        srow[a, a] = image.spacing[a]
        srow[a, 3] = image.origin[a] if a < len(image.origin) else 0.0
    struct.pack_into("<4f", hdr, 280, *srow[0])
    struct.pack_into("<4f", hdr, 296, *srow[1])
    struct.pack_into("<4f", hdr, 312, *srow[2])
    hdr[344:348] = b"n+1\x00"
    opener = gzip.open if str(path).endswith(".gz") else open
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with opener(path, "wb") as f:
        f.write(bytes(hdr))
        f.write(b"\x00" * 4)  # extension flag
        f.write(arr.tobytes(order="F"))
    return path


def read_image(path) -> Image:
    p = str(path)
    if p.endswith((".mha", ".mhd")):
        return read_mha(p)
    if p.endswith((".nii", ".nii.gz")):
        return read_nii(p)
    raise ValueError(f"unsupported image format: {p}")


def write_image(path, image: Image, **kw):
    p = str(path)
    if p.endswith((".mha", ".mhd")):
        return write_mha(p, image, **kw)
    if p.endswith((".nii", ".nii.gz")):
        return write_nii(p, image)
    raise ValueError(f"unsupported image format: {p}")
