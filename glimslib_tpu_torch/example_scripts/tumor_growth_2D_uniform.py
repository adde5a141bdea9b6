"""Forward simulation, 2D uniform parameters.

Counterpart of ``examples/tumor_growth_2D_uniform.py`` (reference
``test_cases/test_simulation_tumor_growth/test_case_simulation_tumor_growth_2D_uniform.py``):
50x50 rectangle domain on [-5,5]^2, Gaussian concentration seed, clamped
displacement boundary, sim_time 5 / dt 1, VTK outputs + postprocess plots.

Run: ``python -m glimslib_tpu_torch.example_scripts.tumor_growth_2D_uniform``
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

    # == problem settings (reference l.33-79) ================================
    nx = ny = args.n
    mesh = rectangle_mesh((-5, -5), (5, 5), nx, ny)

    dirichlet_bcs = {
        "clamped_boundary": {
            "bc_value": np.array([0.0, 0.0]),
            "named_boundary": "boundary_all",
            "subspace_id": 0,
        }
    }
    von_neumann_bcs = {}

    u_0_conc_expr = gaussian_iv((0.0, 0.0), width=1.0 / np.sqrt(2))  # exp(-r^2)
    u_0_disp_expr = np.array([0.0, 0.0])

    sim_time = 5
    sim_time_step = 1

    # == setup & run ==========================================================
    with tracer.scope("setup"):
        sim = TumorGrowth(mesh, dtype=dtype, device=device, plain=plain)
        sim.setup_global_parameters(
            boundaries={"boundary_all": BoundaryAll()},
            dirichlet_bcs=dirichlet_bcs,
            von_neumann_bcs=von_neumann_bcs,
        )
        sim.setup_model_parameters(
            iv_expression={0: u_0_disp_expr, 1: u_0_conc_expr},
            diffusion=0.1,
            coupling=1.0,
            proliferation=0.1,
            E=0.001,
            poisson=0.45,
            sim_time=sim_time,
            sim_time_step=sim_time_step,
        )

    output_path = example_out("tumor_growth_2D_uniform", out_dir)
    with tracer.scope("run"):
        sim.run(save_method="vtk", plot=plot, output_dir=output_path, clear_all=True)

    # == postprocess (reference l.88-96) =====================================
    with tracer.scope("postprocess"):
        sim.init_postprocess(os.path.join(output_path, "postprocess", "plots"))
        if plot:
            sim.postprocess.plot_all(deformed=False)
            sim.postprocess.plot_all(deformed=True)
        sim.postprocess.save_all(output_dir=os.path.join(output_path, "postprocess"))
    print("outputs in", output_path)
    return dict(u=sim.solution[0], c=sim.solution[1], stats=run_stats(sim),
                output_path=output_path, sim=sim, stages=tracer.summary())


if __name__ == "__main__":
    main(sys.argv[1:])
