"""Convert a VTU mesh (+subdomain cell data) to the framework's mesh
store — the pre-conversion step the reference requires before parallel
runs (reference test_cases/test_simulation_tumor_growth/
convert_vtk_mesh_to_fenics_hdf5.py:13-61).  Counterpart of
``examples/convert_vtu_mesh_to_hdf5.py``; the port's store is ``.npz``
(``utils/data_io.save_mesh_hdf5``: the output's extension becomes .npz).

Usage: python -m glimslib_tpu_torch.example_scripts.convert_vtu_mesh_to_hdf5 input.vtu output.h5
"""

import sys

from glimslib_tpu_torch.example_scripts.example_config import parser
from glimslib_tpu_torch.utils import data_io as dio


def main(argv=None, device=None, dtype=None, plot=True, out_dir=None):
    """Convert ``argv``'s input VTU to the store at its output path;
    returns the mesh, the subdomains and the store's path.  ``device``,
    ``dtype``, ``plot`` and ``out_dir`` are unused: the conversion is
    numpy on the host."""
    p = parser(__doc__)
    p.add_argument("src", help="input .vtu")
    p.add_argument("dst", help="output mesh store (.h5 becomes .npz)")
    args = p.parse_args([] if argv is None else argv)
    src, dst = args.src, args.dst
    mesh, subdomains = dio.read_vtk_convert_to_fenics(src)
    path = dio.save_mesh_hdf5(mesh, dst, subdomains=subdomains)
    print(f"{src}: {mesh.n_nodes} nodes, {mesh.n_cells} cells -> {path}")
    return dict(mesh=mesh, subdomains=subdomains, path=path)


if __name__ == "__main__":
    main(sys.argv[1:])
