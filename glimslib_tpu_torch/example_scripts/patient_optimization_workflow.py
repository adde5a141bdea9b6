"""Patient image-based optimization pipeline, end to end.

Counterpart of ``examples/patient_optimization_workflow.py`` (the
reference's patient workflow,
``optimization_workflow/image_based_optimization_patient.py:34-195`` and
``test_imageBasedOptimizationPatient``):

  01 atlas->patient domain preparation (affine registration driver with
     first-party fallback), mesh from the registered atlas labels
  02 target fields from the patient tumor segmentation (T1/T2 labels
     warped into the reference frame, smoothed concentration targets)
  03 inverse problem: estimate (D_WM, rho_WM) from the patient targets
  04 re-simulate with the optimized parameters

Runs on synthetic patient data (no external binaries needed; real ANTs
registration is used automatically when available, reference
image_registration_utils.py:38-68).

Run: ``python -m glimslib_tpu_torch.example_scripts.patient_optimization_workflow``
(``--maxiter`` sets L-BFGS-B's iterations).
"""

import os
import sys

import numpy as np

from glimslib_tpu_torch.example_scripts.example_config import example_out, parser, resolve
from glimslib_tpu_torch.utils.image_io import Image, write_mha
from glimslib_tpu_torch.utils.profiling import Tracer
from glimslib_tpu_torch.utils.synthetic import brain_labelmap_3d, t1_from_labels
from glimslib_tpu_torch.workflow.image_based_optimization_patient import (
    ImageBasedOptimizationPatient,
)


def main(argv=None, device=None, dtype=None, plot=True, out_dir=None):
    """Run the script; returns the optimized parameters, the targets'
    sums, the optimized run's maximum concentration, L-BFGS-B's
    iterations, the inverse problem's model and the seconds by stage.  ``plot`` is unused (the
    reference runs the pipeline with ``plot=False``)."""
    p = parser(__doc__)
    p.add_argument("--maxiter", type=int, default=15, help="L-BFGS-B iterations")
    args = p.parse_args([] if argv is None else argv)
    device, dtype, plot = resolve(args, device, dtype, plot)
    tracer = Tracer()

    base_dir = example_out("patient_optimization_workflow", out_dir)
    data_dir = os.path.join(base_dir, "input_data")
    os.makedirs(data_dir, exist_ok=True)

    # -- synthetic patient dataset: atlas + patient T1 + tumor segmentation ---
    lab = brain_labelmap_3d(24, 24, 10)
    t1 = t1_from_labels(lab)
    seg = np.zeros_like(lab)
    seg[4:7, 10:17, 10:17] = 6  # T2 (edema) label
    seg[5:6, 12:15, 12:15] = 5  # T1 (core) label
    paths = {}
    for name, arr in [("atlas_labels", lab), ("atlas_t1", t1),
                      ("patient_t1", t1), ("patient_seg", seg)]:
        path = os.path.join(data_dir, f"{name}.mha")
        write_mha(path, Image(np.ascontiguousarray(arr), origin=(0, 0, 0),
                              spacing=(1, 1, 1)))
        paths[name] = path

    wf = ImageBasedOptimizationPatient(
        base_dir=base_dir,
        path_to_labels_atlas=paths["atlas_labels"],
        path_to_image_atlas=paths["atlas_t1"],
        path_to_image_patient=paths["patient_t1"],
        path_to_labels_patient=paths["patient_seg"],
        image_z_slice=5,
        t1_label=5,
        t2_label=6,
        device=device,
        dtype=dtype,
    )

    # 01 -- domain preparation through the registration path
    with tracer.scope("domain"):
        wf.prepare_domain(use_registration=True)
    print("[01] patient domain:", wf.mesh.n_nodes, "nodes;",
          "registered labels ->", wf.path_to_labels_atlas_registered)

    # 02 -- targets from the patient segmentation
    with tracer.scope("targets"):
        cT2, cT1 = wf.create_target_fields()
    print(f"[02] targets: |T2|={float(cT2.sum()):.1f} |T1|={float(cT1.sum()):.1f}"
          f" -> {wf.path_conc_T2}")

    # 03 -- inverse problem seeded at the tumor core
    seed = wf.mesh.points[int(np.argmax(cT1))]
    start = dict(D_WM=0.08, D_GM=0.016, rho_WM=0.08, rho_GM=0.016, coupling=0.1)
    fixed = dict(E_GM=3e3, E_WM=3e3, E_CSF=1e3, E_VENT=1e3,
                 nu_GM=0.45, nu_WM=0.45, nu_CSF=0.45, nu_VENT=0.3)
    with tracer.scope("inverse"):
        wf.init_inverse_problem(seed, start, dict(sim_time=3, sim_time_step=1,
                                                  seed_width=1.5),
                                model_params_fixed=fixed, optimization_type=2)
        opt = wf.run_inverse_problem(opt_params={"maxiter": args.maxiter, "tol": 1e-6,
                                                 "gtol": 1e-6})
    print("[03] optimized patient parameters:", opt)

    # 04 -- re-simulate with the optimized parameters
    with tracer.scope("optimized"):
        wf.init_optimized_problem()
        wf.run_optimized_sim(plot=False)
    final_conc = np.asarray(wf.sims["optimized"].solution[1])
    print("[04] optimized final max conc:", float(final_conc.max()))
    print("outputs in", base_dir)
    return dict(params=dict(wf.model_params_optimized),
                T2_target_sum=float(cT2.sum()), T1_target_sum=float(cT1.sum()),
                optimized_final_max_conc=float(final_conc.max()),
                nit=wf.measures["optimization_nit"], sim=wf.sims["inverse"],
                stages=tracer.summary())


if __name__ == "__main__":
    main(sys.argv[1:])
