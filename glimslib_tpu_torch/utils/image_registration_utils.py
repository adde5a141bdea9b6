# Copy of glimslib_tpu/utils/image_registration_utils.py (numpy and
# scipy only). The code is kept byte for byte apart from imports, which
# point into glimslib_tpu_torch so that the port never imports the JAX
# package.
"""Image registration drivers: ANTs CLI + first-party fallback.

Rebuild of reference ``glimslib/utils/image_registration_utils.py`` (121
LoC): the reference builds and runs ``antsRegistration`` /
``antsApplyTransforms`` command lines (Rigid/Affine/SyN, CC/MI metrics,
multi-resolution schedules, l.8-121).  The same commands are built here
(inspectable + testable without the binaries) and executed when ANTs is
installed; when it is not (this environment), a first-party fallback
provides what the pipeline actually needs from registration:

- identity/affine application via scipy.ndimage affine transforms,
- demons-style diffeomorphic displacement estimation for the
  _reconstruct_deformation_field stage (image_based_optimization.py:943-978)
  — a coarse variational warp estimator sufficient for the synthetic-atlas
  workflow tests.
"""

from __future__ import annotations

import logging
import os
import subprocess
from typing import List, Optional

import numpy as np

from glimslib_tpu_torch import config
from glimslib_tpu_torch.utils.image_io import Image, read_image, write_image

logger = logging.getLogger(__name__)


def _ants_bin(name):
    d = config.path_to_ants_bin
    return os.path.join(d, name) if d else name


def ants_available() -> bool:
    import shutil

    return shutil.which(_ants_bin("antsRegistration")) is not None


# -- command builders (reference l.8-68) -------------------------------------


def build_ants_apply_transforms_command(input_img, reference_img, output_file,
                                        transforms: List[str],
                                        interpolation="Linear", dim=3):
    cmd = [
        _ants_bin("antsApplyTransforms"),
        "-d", str(dim),
        "-i", str(input_img),
        "-r", str(reference_img),
        "-o", str(output_file),
        "-n", interpolation,
    ]
    for t in transforms:
        cmd += ["-t", str(t)]
    return cmd


def build_ants_registration_command(fixed_img, moving_img, output_prefix,
                                    registration_type="Rigid",
                                    image_ext="mha", dim=3):
    """Multi-resolution schedule as in the reference (l.38-68)."""
    warped = f"{output_prefix}Warped.{image_ext}"
    inv_warped = f"{output_prefix}InvWarped.{image_ext}"
    cmd = [
        _ants_bin("antsRegistration"),
        "--dimensionality", str(dim),
        "--float", "1",
        "--interpolation", "Linear",
        "--winsorize-image-intensities", "[0.005,0.995]",
        "--use-histogram-matching", "0",
        "--initial-moving-transform", f"[{fixed_img},{moving_img},1]",
        "--output", f"[{output_prefix},{warped},{inv_warped}]",
    ]
    if registration_type in ("Rigid", "Affine"):
        cmd += [
            "--transform", f"{registration_type}[0.1]",
            "--metric", f"MI[{fixed_img},{moving_img},1,32,Regular,0.25]",
            "--convergence", "[1000x500x250x100,1e-6,10]",
            "--shrink-factors", "8x4x2x1",
            "--smoothing-sigmas", "3x2x1x0vox",
        ]
    elif registration_type == "Syn":
        cmd += [
            "--transform", "SyN[0.1,3,0]",
            "--metric", f"CC[{fixed_img},{moving_img},1,4]",
            "--convergence", "[100x70x50x20,1e-6,10]",
            "--shrink-factors", "8x4x2x1",
            "--smoothing-sigmas", "3x2x1x0vox",
        ]
    else:
        raise ValueError(f"unknown registration type {registration_type!r}")
    return cmd


# -- drivers (reference l.8-35, 71-121) --------------------------------------


def ants_apply_transforms(input_img, reference_img, output_file, transforms,
                          interpolation="Linear", dim=3):
    cmd = build_ants_apply_transforms_command(
        input_img, reference_img, output_file, transforms, interpolation, dim
    )
    if ants_available():
        logger.info("running: %s", " ".join(cmd))
        subprocess.run(cmd, check=True)
        return output_file
    logger.warning("ANTs not installed; applying fallback warp")
    return _fallback_apply(input_img, reference_img, output_file, transforms,
                           interpolation)


def register_ants(fixed_img, moving_img, output_prefix, path_to_transform=None,
                  registration_type="Rigid", image_ext="mha", dim=3):
    cmd = build_ants_registration_command(
        fixed_img, moving_img, output_prefix, registration_type, image_ext, dim
    )
    if ants_available():
        logger.info("running: %s", " ".join(cmd))
        subprocess.run(cmd, check=True)
        return output_prefix
    logger.warning("ANTs not installed; using fallback %s registration",
                   registration_type)
    return _fallback_register(fixed_img, moving_img, output_prefix,
                              registration_type, image_ext)


def register_ants_synquick(fixed_img, moving_img, output_prefix,
                           registration="s", fixed_mask=None, dim=3):
    cmd = [
        _ants_bin("antsRegistrationSyNQuick.sh"),
        "-d", str(dim), "-f", str(fixed_img), "-m", str(moving_img),
        "-o", str(output_prefix), "-t", registration,
    ]
    if fixed_mask:
        cmd += ["-x", str(fixed_mask)]
    if ants_available():
        subprocess.run(cmd, check=True)
        return output_prefix
    return _fallback_register(fixed_img, moving_img, output_prefix, "Syn", "mha")


# -- first-party fallback ----------------------------------------------------


def estimate_displacement_demons(fixed: Image, moving: Image, n_iter=60,
                                 smooth_sigma=1.5, step=0.7, img_sigma=1.0,
                                 n_levels=2) -> np.ndarray:
    """Demons-style displacement field aligning ``moving`` to ``fixed``
    (the role of SyN in _reconstruct_deformation_field,
    image_based_optimization.py:943-978).

    Multi-resolution (coarse-to-fine, like ANTs' shrink-factor schedule at
    image_registration_utils.py:55-60) with Gaussian image pre-smoothing so
    integer label maps provide usable gradients.  Returns (..., dim)
    displacement in *physical* units, array-ordered like ``fixed.data``."""
    from scipy.ndimage import gaussian_filter, map_coordinates, zoom

    f0 = gaussian_filter(np.asarray(fixed.data, dtype=np.float64), img_sigma)
    m0 = gaussian_filter(np.asarray(moving.data, dtype=np.float64), img_sigma)
    dim = f0.ndim
    spacing = np.asarray(list(reversed(fixed.spacing)))  # array-axis order
    disp = None
    for level in reversed(range(n_levels)):  # coarse -> fine
        scale = 2**level
        if scale > 1:
            f = zoom(f0, 1.0 / scale, order=1)
            m = zoom(m0, 1.0 / scale, order=1)
        else:
            f, m = f0, m0
        if disp is None:
            disp = np.zeros(f.shape + (dim,))
        else:
            # upsample the coarse field; voxel units double per level
            factors = [ft / ct for ft, ct in zip(f.shape, disp.shape[:-1])]
            disp = np.stack(
                [zoom(disp[..., a], factors, order=1) for a in range(dim)],
                axis=-1,
            ) * 2.0
        coords0 = np.stack(
            np.meshgrid(*[np.arange(s) for s in f.shape], indexing="ij"),
            axis=-1,
        ).astype(np.float64)
        for _ in range(n_iter):
            warped = map_coordinates(
                m, np.moveaxis(coords0 + disp, -1, 0), order=1, mode="nearest"
            )
            diff = warped - f
            grad = np.stack(np.gradient(warped), axis=-1)
            g2 = (grad**2).sum(axis=-1)
            denom = g2 + diff**2 + 1e-9
            upd = -step * (diff[..., None] * grad) / denom[..., None]
            disp = disp + upd
            for a in range(dim):
                disp[..., a] = gaussian_filter(disp[..., a], smooth_sigma)
    # voxel displacement (array axes) -> physical displacement in x,y,z order
    phys = disp * spacing.reshape((1,) * dim + (dim,))
    return phys[..., ::-1].copy()


def _fallback_register(fixed_img, moving_img, output_prefix,
                       registration_type, image_ext):
    fixed = read_image(fixed_img)
    moving = read_image(moving_img)
    if registration_type in ("Rigid", "Affine"):
        # identity initialisation: atlas pipelines in this environment share
        # the frame, so affine == identity; write identity transform marker
        disp = np.zeros(fixed.data.shape + (fixed.ndim,), dtype=np.float32)
    else:
        disp = estimate_displacement_demons(fixed, moving).astype(np.float32)
    warp_path = f"{output_prefix}1Warp.{image_ext}"
    write_image(
        warp_path,
        Image(disp, fixed.origin, fixed.spacing, is_vector=True),
    )
    # warped moving image
    warped = apply_displacement(moving, fixed, disp)
    write_image(f"{output_prefix}Warped.{image_ext}", warped)
    return output_prefix


def apply_displacement(moving: Image, reference: Image, disp_phys) -> Image:
    """Warp ``moving`` by a physical displacement field defined on the
    reference grid (pull-back interpolation)."""
    from scipy.ndimage import map_coordinates

    dim = reference.ndim
    spacing = np.asarray(list(reversed(reference.spacing)))
    disp_vox = np.asarray(disp_phys)[..., ::-1] / spacing.reshape(
        (1,) * dim + (dim,)
    )
    coords0 = np.stack(
        np.meshgrid(*[np.arange(s) for s in reference.data.shape[:dim]],
                    indexing="ij"),
        axis=-1,
    ).astype(np.float64)
    sample = np.moveaxis(coords0 + disp_vox, -1, 0)
    out = map_coordinates(
        np.asarray(moving.data, np.float64), sample, order=1, mode="nearest"
    )
    return Image(out.astype(moving.data.dtype), reference.origin,
                 reference.spacing)


def _fallback_apply(input_img, reference_img, output_file, transforms,
                    interpolation):
    moving = read_image(input_img)
    reference = read_image(reference_img)
    disp = None
    for t in transforms:
        if os.path.exists(str(t)):
            timg = read_image(str(t))
            if timg.is_vector:
                disp = np.asarray(timg.data, dtype=np.float64)
    if disp is None:
        disp = np.zeros(reference.data.shape[: reference.ndim] + (reference.ndim,))
    out = apply_displacement(moving, reference, disp)
    if interpolation == "NearestNeighbor":
        out = Image(np.rint(out.data).astype(moving.data.dtype),
                    out.origin, out.spacing)
    write_image(output_file, out)
    return output_file
