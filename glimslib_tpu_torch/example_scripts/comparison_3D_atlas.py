"""3D cross-model parity: TumorGrowth (per-tissue dicts) vs TumorGrowthBrain
on the same image-derived tet mesh.

Counterpart of ``examples/comparison_3D_atlas.py`` (reference
``test_case_comparison_3D_atlas.py``): both formulations solve the
identical problem; Comparison errornorms must be at machine precision (at
float32: relative to the field's norm, 1e-4).

Run: ``python -m glimslib_tpu_torch.example_scripts.comparison_3D_atlas``
(``--atlas NX NY NZ`` sets the synthetic atlas).
"""

import sys

import numpy as np

from glimslib_tpu_torch.example_scripts._comparison import compare, run_both
from glimslib_tpu_torch.example_scripts.example_config import (
    example_out, parser, resolve, synthetic_atlas_path,
)
from glimslib_tpu_torch.utils.image_io import read_image
from glimslib_tpu_torch.utils.meshing import mesh_image_labels
from glimslib_tpu_torch.utils.profiling import Tracer
from glimslib_tpu_torch.utils.vtk_utils import cell_to_point_data


def main(argv=None, device=None, dtype=None, plot=True, out_dir=None, plain=False):
    """Run the script; returns what ``comparison_2D_atlas`` returns.
    ``plain=True`` runs the models' plain torch path; ``plot`` is unused
    (the reference plots nothing in 3D)."""
    p = parser(__doc__)
    p.add_argument("--atlas", type=int, nargs=3, default=(24, 24, 16),
                   metavar=("NX", "NY", "NZ"))
    args = p.parse_args([] if argv is None else argv)
    device, dtype, plot = resolve(args, device, dtype, plot)
    tracer = Tracer()

    out = example_out("comparison_3D_atlas", out_dir)
    with tracer.scope("domain"):
        atlas = synthetic_atlas_path(example_out("data", out_dir), *args.atlas)
        mesh, cell_labels = mesh_image_labels(read_image(atlas))
        labels = np.rint(cell_to_point_data(mesh.n_nodes, mesh.cells, cell_labels))
    print(f"mesh: {mesh.n_nodes} nodes, {mesh.n_cells} tets")
    brain, uni = run_both(mesh, labels, out, tracer, device, dtype, plain)
    cols, rtol = compare(brain, uni, out, tracer, dtype,
                         ["concentration", "displacement"])
    print("3D parity confirmed ->", out)
    return dict(columns=cols, rtol=rtol, u=brain.solution[0], c=brain.solution[1],
                u_uniform=uni.solution[0], c_uniform=uni.solution[1],
                brain=brain, uniform=uni, stages=tracer.summary())


if __name__ == "__main__":
    main(sys.argv[1:])
