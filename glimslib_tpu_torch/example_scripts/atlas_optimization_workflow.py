"""Full image-based atlas optimization pipeline, end to end.

Counterpart of ``examples/atlas_optimization_workflow.py`` (the reference's
ordered workflow test,
``optimization_workflow/test_imageBasedOptimizationAtlas.py:61-136``):

  01 prepare domain (atlas slice -> mesh)      -> 01_domain_preparation/
  02 forward simulation (synthetic 'patient')  -> 02_forward_simulation/
  03 target fields (thresholded conc + disp)   -> 03_target_fields/
  04 inverse problem (adjoint L-BFGS-B)        -> 02_inverse_simulation/
  05 optimized re-simulation                   -> 02_optimized_simulation/
  06 comparison + analysis summary             -> comparison/, summary/

Every stage persists state; rerunning resumes from the pickle.  Tables
are dicts of numpy columns (the port's workflow imports no pandas).

Run: ``python -m glimslib_tpu_torch.example_scripts.atlas_optimization_workflow``
(``--atlas NX NY NZ --z`` set the synthetic atlas and its slice,
``--maxiter`` L-BFGS-B's iterations).
"""

import sys

import numpy as np

from glimslib_tpu_torch.example_scripts.example_config import (
    BRAIN_PARAMS_FIXED, BRAIN_PARAMS_VARYING, example_out, parser, resolve,
    synthetic_atlas_path,
)
from glimslib_tpu_torch.utils.profiling import Tracer
from glimslib_tpu_torch.workflow.image_based_optimization_atlas import (
    ImageBasedOptimizationAtlas,
)


def main(argv=None, device=None, dtype=None, plot=True, out_dir=None):
    """Run the script; returns the optimized parameters, their relative
    errors, the forward's maximum concentration, the volume table's
    columns, the summary's path, the inverse problem's model and the
    seconds by stage.  ``plot`` is
    unused (the reference runs the pipeline with ``plot=False``)."""
    p = parser(__doc__)
    p.add_argument("--atlas", type=int, nargs=3, default=(40, 40, 16),
                   metavar=("NX", "NY", "NZ"))
    p.add_argument("--z", type=int, default=8, help="the atlas slice")
    p.add_argument("--maxiter", type=int, default=50, help="L-BFGS-B iterations")
    args = p.parse_args([] if argv is None else argv)
    device, dtype, plot = resolve(args, device, dtype, plot)
    tracer = Tracer()

    base_dir = example_out("atlas_optimization_workflow", out_dir)
    atlas = synthetic_atlas_path(example_out("data", out_dir), *args.atlas)

    wf = ImageBasedOptimizationAtlas(
        base_dir=base_dir, path_to_labels_atlas=atlas, image_z_slice=args.z,
        device=device, dtype=dtype,
    )
    with tracer.scope("domain"):
        wf.prepare_domain()
    print("[01] domain:", wf.mesh.n_nodes, "nodes")

    seed = wf.mesh.points.mean(axis=0) + np.array([4.0, 0.0])
    sim_params = dict(sim_time=3, sim_time_step=1, seed_width=2.0)
    with tracer.scope("forward"):
        wf.init_forward_problem(seed, BRAIN_PARAMS_VARYING, BRAIN_PARAMS_FIXED,
                                sim_params)
        wf.run_forward_sim(plot=False)
    print("[02] forward max conc:", wf.measures["forward_final_max_conc"])

    with tracer.scope("targets"):
        wf.create_target_fields()
    print("[03] targets written")

    start = dict(BRAIN_PARAMS_VARYING, D_WM=0.05, rho_WM=0.05)
    with tracer.scope("inverse"):
        wf.init_inverse_problem(seed, start, sim_params, optimization_type=2)
        opt = wf.run_inverse_problem(opt_params={"tol": 1e-8, "gtol": 1e-8,
                                                 "maxiter": args.maxiter})
    print("[04] optimized params:", opt)

    with tracer.scope("optimized"):
        wf.init_optimized_problem()
        wf.run_optimized_sim(plot=False)
        wf.compare_original_optimized()
    print("[05] parameter relative errors:",
          wf.measures["param_relative_errors"])

    with tracer.scope("analysis"):
        frames = wf.post_process()  # per-step per-subdomain volume/COM tables
        print("[06] volume frame columns:", list(frames["volume"]))
        table = wf.compute_volume_com_per_step("forward")
        summary = wf.write_analysis_summary(
            {"volume_com": {k: v.tolist() for k, v in table.items()}})
    print("[06] summary ->", summary)
    return dict(params=dict(wf.model_params_optimized),
                rel_errors=dict(wf.measures["param_relative_errors"]),
                forward_final_max_conc=wf.measures["forward_final_max_conc"],
                volume_columns=list(frames["volume"]), summary=summary,
                nit=wf.measures["optimization_nit"], sim=wf.sims["inverse"],
                stages=tracer.summary())


if __name__ == "__main__":
    main(sys.argv[1:])
