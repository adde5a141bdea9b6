# Copy of glimslib_tpu/utils/synthetic.py (numpy only). The code is kept
# byte for byte apart from imports, which point into glimslib_tpu_torch so
# that the port never imports the JAX package.
"""Synthetic brain-atlas data generator.

The reference ships a real SRI24-derived 3D brain atlas labelmap
(test_cases/data/brain_atlas_image_3d.mha) which is stored in git-LFS and is
not available in this environment (the files are LFS pointer stubs).  This
module generates deterministic synthetic stand-ins with the same semantics:
a labelmap over {0: outside, 1: CSF, 2: GM, 3: WM, 4: Ventricles}
(image_based_optimization.py:391-394) shaped as concentric ellipsoids, plus
a matching pseudo-T1 intensity image — enough to exercise every pipeline
stage (slicing, meshing, subdomains, forward/inverse sims, registration
drivers) end to end.
"""

from __future__ import annotations

import numpy as np

LABELS = {0: "outside", 1: "CSF", 2: "GM", 3: "WM", 4: "Ventricles"}


def brain_labelmap_2d(nx=64, ny=64, spacing=(1.0, 1.0), origin=(0.0, 0.0)):
    """Concentric-ellipse 2D labelmap (ny, nx) int16."""
    xs = origin[0] + spacing[0] * np.arange(nx)
    ys = origin[1] + spacing[1] * np.arange(ny)
    X, Y = np.meshgrid(xs, ys)  # (ny, nx)
    cx = origin[0] + spacing[0] * (nx - 1) / 2
    cy = origin[1] + spacing[1] * (ny - 1) / 2
    ex = spacing[0] * nx / 2
    ey = spacing[1] * ny / 2
    r = np.sqrt(((X - cx) / ex) ** 2 + ((Y - cy) / ey) ** 2)
    lab = np.zeros((ny, nx), dtype=np.int16)
    lab[r < 0.90] = 1  # CSF
    lab[r < 0.78] = 2  # GM
    lab[r < 0.62] = 3  # WM
    lab[r < 0.15] = 4  # Ventricles
    return lab


def brain_labelmap_3d(nx=48, ny=56, nz=48, spacing=(1.0, 1.0, 1.0),
                      origin=(0.0, 0.0, 0.0)):
    """Concentric-ellipsoid 3D labelmap (nz, ny, nx) int16 (z-major layout,
    like SimpleITK's GetArrayFromImage)."""
    xs = origin[0] + spacing[0] * np.arange(nx)
    ys = origin[1] + spacing[1] * np.arange(ny)
    zs = origin[2] + spacing[2] * np.arange(nz)
    Z, Y, X = np.meshgrid(zs, ys, xs, indexing="ij")
    cx = origin[0] + spacing[0] * (nx - 1) / 2
    cy = origin[1] + spacing[1] * (ny - 1) / 2
    cz = origin[2] + spacing[2] * (nz - 1) / 2
    r = np.sqrt(
        ((X - cx) / (spacing[0] * nx / 2)) ** 2
        + ((Y - cy) / (spacing[1] * ny / 2)) ** 2
        + ((Z - cz) / (spacing[2] * nz / 2)) ** 2
    )
    lab = np.zeros((nz, ny, nx), dtype=np.int16)
    lab[r < 0.90] = 1
    lab[r < 0.78] = 2
    lab[r < 0.62] = 3
    lab[r < 0.15] = 4
    return lab


def t1_from_labels(labels, seed=0):
    """Pseudo-T1 intensities per tissue + smooth noise."""
    rng = np.random.default_rng(seed)
    intensity = {0: 0.0, 1: 0.25, 2: 0.55, 3: 0.85, 4: 0.15}
    img = np.zeros_like(labels, dtype=np.float32)
    for lab, val in intensity.items():
        img[labels == lab] = val
    img += 0.02 * rng.standard_normal(labels.shape).astype(np.float32)
    img[labels == 0] = 0.0
    return img
