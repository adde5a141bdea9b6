"""Forward simulation with 2 tissue subdomains and heterogeneous parameters.

Counterpart of ``examples/tumor_growth_2D_subdomains.py`` (reference
``test_case_simulation_tumor_growth_2D_subdomains.py``, l.35-107): a
circular inclusion ('in') inside a background tissue ('out'), per-tissue
dict parameters (the DiscontinuousScalar mechanism), no-flux behavior
imposed through zero diffusivity/proliferation in the isolated tissue
(reference's recommended approach, helper_classes.py von-Neumann notes).

Run: ``python -m glimslib_tpu_torch.example_scripts.tumor_growth_2D_subdomains``
(``--n`` sets the mesh resolution; plots need matplotlib).
"""

import os
import sys

import numpy as np

from glimslib_tpu_torch.core.mesh import rectangle_mesh
from glimslib_tpu_torch.example_scripts.example_config import (
    BoundaryAll, example_out, gaussian_iv, parser, resolve,
)
from glimslib_tpu_torch.models.tumor_growth import TumorGrowth
from glimslib_tpu_torch.utils.profiling import Tracer, run_stats


def main(argv=None, device=None, dtype=None, plot=True, out_dir=None, plain=False):
    """Run the script; returns the final fields ``u`` and ``c``, the
    Newton statistics, the output path, the model and the seconds by stage.
    ``plain=True`` runs the model's plain torch path (a reference run)."""
    p = parser(__doc__)
    p.add_argument("--n", type=int, default=50, help="mesh resolution")
    args = p.parse_args([] if argv is None else argv)
    device, dtype, plot = resolve(args, device, dtype, plot)
    tracer = Tracer()

    with tracer.scope("setup"):
        mesh = rectangle_mesh((-5, -5), (5, 5), args.n, args.n)
        # nodal label function: 1 = outside tissue, 2 = inclusion (r < 2)
        r = np.linalg.norm(mesh.points, axis=1)
        labels = np.where(r < 2.0, 2.0, 1.0)

        sim = TumorGrowth(mesh, dtype=dtype, device=device, plain=plain)
        sim.setup_global_parameters(
            label_function=labels,
            domain_names={1: "out", 2: "in"},
            boundaries={"boundary_all": BoundaryAll()},
            dirichlet_bcs={
                "clamped_boundary": {
                    "bc_value": np.zeros(2),
                    "named_boundary": "boundary_all",
                    "subspace_id": 0,
                }
            },
        )
        sim.setup_model_parameters(
            iv_expression={0: np.zeros(2), 1: gaussian_iv((0.0, 0.0))},
            diffusion={"in": 0.2, "out": 0.05},
            proliferation={"in": 0.2, "out": 0.05},
            coupling={"in": 0.2, "out": 0.05},
            E={"in": 0.002, "out": 0.001},
            poisson={"in": 0.4, "out": 0.45},
            sim_time=10,
            sim_time_step=1,
        )
    out = example_out("tumor_growth_2D_subdomains", out_dir)
    with tracer.scope("run"):
        sim.run(save_method="vtk", plot=plot, output_dir=out, clear_all=True)
    with tracer.scope("postprocess"):
        sim.init_postprocess(os.path.join(out, "postprocess", "plots"))
        if plot:
            sim.postprocess.plot_all()
    print("outputs in", out)
    return dict(u=sim.solution[0], c=sim.solution[1], stats=run_stats(sim),
                output_path=out, sim=sim, stages=tracer.summary())


if __name__ == "__main__":
    main(sys.argv[1:])
