"""Run, checkpoint, reload, postprocess — in a fresh simulation object.

Counterpart of ``examples/tumor_growth_2D_uniform_reload.py`` (reference
``test_case_simulation_tumor_growth_2D_uniform_reload.py``): the
whole-series checkpoint written at the end of ``run()`` (the port's
``.npz`` series store) is loaded into a new simulation instance
(``reload_from_hdf5``), which then postprocesses without re-solving — the
workflow used to postprocess MPI runs serially (reference SURVEY §3.5).

Run: ``python -m glimslib_tpu_torch.example_scripts.tumor_growth_2D_uniform_reload``
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
from glimslib_tpu_torch.utils.data_io import store_path
from glimslib_tpu_torch.utils.profiling import Tracer


def main(argv=None, device=None, dtype=None, plot=True, out_dir=None, plain=False):
    """Run the script; returns the final fields ``u`` and ``c``, the
    reloaded recording steps, the checkpoint's path, the reloaded model
    and the seconds by stage.  ``plain=True`` runs the model's plain torch path."""
    p = parser(__doc__)
    p.add_argument("--n", type=int, default=25, help="mesh resolution")
    args = p.parse_args([] if argv is None else argv)
    device, dtype, plot = resolve(args, device, dtype, plot)
    tracer = Tracer()

    out = example_out("tumor_growth_2D_uniform_reload", out_dir)
    mesh = rectangle_mesh((-5, -5), (5, 5), args.n, args.n)

    def build():
        sim = TumorGrowth(mesh, dtype=dtype, device=device, plain=plain)
        sim.setup_global_parameters(
            boundaries={"boundary_all": BoundaryAll()},
            dirichlet_bcs={
                "clamped_boundary": {"bc_value": np.zeros(2),
                                     "named_boundary": "boundary_all",
                                     "subspace_id": 0}
            },
        )
        sim.setup_model_parameters(
            iv_expression={0: np.zeros(2), 1: gaussian_iv((0, 0))},
            diffusion=0.1, coupling=1.0, proliferation=0.1, E=0.001, poisson=0.45,
            sim_time=5, sim_time_step=1,
        )
        return sim

    # 1. run + checkpoint
    with tracer.scope("run"):
        sim = build()
        sim.run(keep_nth=1, save_method=None, plot=False, output_dir=out)
    ckpt = store_path(os.path.join(out, "solution_timeseries.h5"))
    if not os.path.exists(ckpt):
        raise AssertionError(f"no checkpoint at {ckpt}")
    print("checkpoint:", ckpt)

    # 2. fresh instance, reload, postprocess without solving
    with tracer.scope("reload"):
        sim2 = build()
        sim2.reload_from_hdf5(ckpt, output_dir=out)
    steps = sim2.results.get_recording_steps()
    print("reloaded steps:", steps)
    for rs in steps:
        a = sim.results.get_result(rs)[1]
        b = sim2.results.get_result(rs)[1]
        if not np.array_equal(a, b):
            raise AssertionError(f"reloaded step {rs} differs from the run's")
    with tracer.scope("postprocess"):
        sim2.init_postprocess(os.path.join(out, "postprocess"))
        sim2.postprocess.save_all()
        if plot:
            sim2.postprocess.plot_all()
    print("postprocess from reload ->", out)
    return dict(u=sim.solution[0], c=sim.solution[1], steps=steps,
                checkpoint=ckpt, sim=sim, stages=tracer.summary())


if __name__ == "__main__":
    main(sys.argv[1:])
