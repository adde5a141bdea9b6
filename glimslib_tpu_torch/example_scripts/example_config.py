"""Shared configuration for the example scripts (counterpart of
``examples/example_config.py``, without jax: each script's ``main`` takes
the device and dtype, by default the card and float32).

Examples write to ``<out_dir>/<name>`` (default ``output/examples``) and
generate the synthetic brain atlas on first use.  Every script takes
``--device``, ``--dtype`` and ``--no-plot`` besides its own arguments:

    python -m glimslib_tpu_torch.example_scripts.<name> [--device cpu --dtype float64]

Run as a script, this module writes the synthetic atlas and prints the
shared settings.
"""

import argparse
import os
import sys

import numpy as np
import torch

from glimslib_tpu_torch import config

output_path = os.path.join(config.output_dir, "examples")

TISSUE_MAP = {0: "outside", 1: "CSF", 2: "GM", 3: "WM", 4: "Ventricles"}

BRAIN_PARAMS_FIXED = dict(
    E_GM=3e3, E_WM=3e3, E_CSF=1e3, E_VENT=1e3,
    nu_GM=0.45, nu_WM=0.45, nu_CSF=0.45, nu_VENT=0.3,
)
BRAIN_PARAMS_VARYING = dict(
    D_WM=0.1, D_GM=0.02, rho_WM=0.1, rho_GM=0.02, coupling=0.15
)

# Where a script asserts on fields: at float64 the reference script's
# limit, unchanged; at float32, the card's dtype, the repo's f32 field
# limit, relative (chip_smoke.py [9], [10]).
F32_FIELD_RTOL = 1e-4

DTYPES = {"float32": torch.float32, "float64": torch.float64}


class BoundaryAll:
    def inside(self, x, on_boundary):
        return on_boundary


def parser(doc):
    """The scripts' argument parser: ``--device`` (default: the card),
    ``--dtype`` (default: float32) and ``--no-plot``."""
    p = argparse.ArgumentParser(description=doc.splitlines()[0])
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' for the CPU)")
    p.add_argument("--dtype", choices=sorted(DTYPES), default=None,
                   help="working dtype (default: float32)")
    p.add_argument("--no-plot", action="store_true", help="draw no figure")
    return p


def resolve(args, device, dtype, plot):
    """(device, dtype, plot) of a run: ``main``'s own arguments win over
    the command line's."""
    device = config.resolve_device(args.device if device is None else device)
    dtype = config.resolve_dtype(DTYPES.get(args.dtype) if dtype is None else dtype)
    return device, dtype, plot and not args.no_plot


def example_out(name, out_dir=None):
    path = os.path.join(out_dir or output_path, name)
    os.makedirs(path, exist_ok=True)
    return path


def synthetic_atlas_path(tmp_dir=None, nx=64, ny=64, nz=24):
    """Write (once) and return the synthetic 3D brain labelmap path."""
    from glimslib_tpu_torch.utils.image_io import Image, write_mha
    from glimslib_tpu_torch.utils.synthetic import brain_labelmap_3d

    d = tmp_dir or example_out("data")
    p = os.path.join(d, f"synthetic_brain_atlas_{nx}x{ny}x{nz}.mha")
    if not os.path.exists(p):
        lab = brain_labelmap_3d(nx, ny, nz)
        write_mha(p, Image(lab, origin=(0, 0, 0), spacing=(1, 1, 1)))
    return p


def labelled_slice_vtu(path, atlas, z_slice):
    """A VTU of the atlas slice ``z_slice`` meshed pixel by pixel, its
    tissue ids as cell data ``subdomains``: the input
    ``convert_vtu_mesh_to_hdf5`` converts.  Returns ``path``."""
    from glimslib_tpu_torch.core.subdomains import SubDomains
    from glimslib_tpu_torch.utils import data_io as dio
    from glimslib_tpu_torch.utils.vtk_utils import write_vtu

    mesh, labels = dio.get_labelfunction_from_image(atlas, z_slice=z_slice)
    sd = SubDomains(mesh)
    sd.setup_subdomains(label_function=labels)
    write_vtu(path, mesh.points, mesh.cells, {"label": labels},
              cell_data={"subdomains": np.asarray(sd.cell_labels)})
    return path


def gaussian_iv(center, width=1.0):
    c = np.asarray(center, dtype=np.float64)

    def f(x):
        return np.exp(-((x - c) ** 2).sum(axis=1) / (2 * width**2))

    return f


def main(argv=None, device=None, dtype=None, plot=True, out_dir=None):
    """Write the synthetic atlas the atlas scripts read (64 x 64 x 24) and
    print the shared settings; returns them with the atlas's path and
    tissue ids.  ``device``, ``dtype`` and ``plot`` are unused: the
    settings are the same on every device."""
    p = parser(__doc__)
    p.add_argument("--atlas", type=int, nargs=3, default=(64, 64, 24),
                   metavar=("NX", "NY", "NZ"))
    args = p.parse_args([] if argv is None else argv)
    from glimslib_tpu_torch.utils.image_io import read_image

    path = synthetic_atlas_path(example_out("data", out_dir), *args.atlas)
    tissues = sorted(int(v) for v in np.unique(read_image(path).data))
    out = dict(output_path=out_dir or output_path, atlas=path, tissues=tissues,
               tissue_map=TISSUE_MAP, params_fixed=BRAIN_PARAMS_FIXED,
               params_varying=BRAIN_PARAMS_VARYING)
    for k, v in out.items():
        print(f"{k}: {v}")
    if tissues != sorted(TISSUE_MAP):
        raise AssertionError(f"atlas tissue ids {tissues}, expected {sorted(TISSUE_MAP)}")
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
