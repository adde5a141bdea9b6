"""What the two comparison scripts share: ``examples/comparison_{2D,3D}_atlas.py``
run the same problem through TumorGrowthBrain (per-tissue parameters) and
TumorGrowth (per-tissue dict coefficients) and compare them."""

import os
import pickle

import numpy as np
import torch

from glimslib_tpu_torch.example_scripts.example_config import (
    BRAIN_PARAMS_FIXED, BRAIN_PARAMS_VARYING, F32_FIELD_RTOL, TISSUE_MAP, BoundaryAll,
    gaussian_iv,
)
from glimslib_tpu_torch.models.tumor_growth import TumorGrowth
from glimslib_tpu_torch.models.tumor_growth_brain import E_OUT, NU_OUT, TumorGrowthBrain
from glimslib_tpu_torch.postprocess import Comparison

UNIFORM_PARAMS = dict(
    E={"outside": E_OUT, "CSF": 1e3, "GM": 3e3, "WM": 3e3, "Ventricles": 1e3},
    poisson={"outside": NU_OUT, "CSF": 0.45, "GM": 0.45, "WM": 0.45,
             "Ventricles": 0.3},
    diffusion={"outside": 0.0, "CSF": 0.0, "GM": 0.02, "WM": 0.1,
               "Ventricles": 0.0},
    proliferation={"outside": 0.0, "CSF": 0.0, "GM": 0.02, "WM": 0.1,
                   "Ventricles": 0.0},
    coupling=0.15,
)


def run_both(mesh, labels, out, tracer, device, dtype, plain):
    """Both models on ``mesh`` (2 steps of dt 1, clamped, a Gaussian seed
    of width 2 at 3 right of the mean point), run into ``out/brain`` and
    ``out/uniform``; returns them."""
    d = mesh.dim
    seed = mesh.points.mean(axis=0) + np.eye(d)[0] * 3.0

    def setup(sim, params):
        sim.setup_global_parameters(
            label_function=labels,
            domain_names=TISSUE_MAP,
            boundaries={"boundary_all": BoundaryAll()},
            dirichlet_bcs={
                "clamped_boundary": {
                    "bc_value": np.zeros(d),
                    "named_boundary": "boundary_all",
                    "subspace_id": 0,
                }
            },
        )
        sim.setup_model_parameters(
            iv_expression={0: np.zeros(d), 1: gaussian_iv(seed, width=2.0)},
            sim_time=2, sim_time_step=1, **params,
        )

    with tracer.scope("brain"):
        brain = TumorGrowthBrain(mesh, dtype=dtype, device=device, plain=plain)
        setup(brain, {**BRAIN_PARAMS_FIXED, **BRAIN_PARAMS_VARYING})
        brain.run(save_method=None, plot=False, output_dir=os.path.join(out, "brain"))
    with tracer.scope("uniform"):
        uni = TumorGrowth(mesh, dtype=dtype, device=device, plain=plain)
        setup(uni, UNIFORM_PARAMS)
        uni.run(save_method=None, plot=False, output_dir=os.path.join(out, "uniform"))
    return brain, uni


def compare(brain, uni, out, tracer, dtype, fields):
    """Comparison of the two runs (a dict of numpy columns, printed and
    pickled to ``out/comparison.pkl``) with each step's errornorm relative
    to the brain model's field norm; at float64 the errornorms of
    ``fields`` are held to the reference script's 1e-9, at float32 the
    relative ones to F32_FIELD_RTOL."""
    with tracer.scope("compare"):
        cmp = Comparison(brain, uni)
        cols = cmp.compare()
        for sid, nm in ((0, "displacement"), (1, "concentration")):
            norms = np.asarray([
                cmp.errornorm(f, np.zeros_like(f)) for f in
                (brain.results.get_result(rs)[sid] for rs in cols["recording_step"])])
            cols[f"relative_errornorm_{nm}"] = cols[f"errornorm_{nm}"] / np.maximum(
                norms, 1e-300)
    print("  ".join(cols))
    for row in zip(*cols.values()):
        print("  ".join(f"{v:.6g}" for v in row))
    with open(os.path.join(out, "comparison.pkl"), "wb") as f:
        pickle.dump(cols, f)
    if dtype == torch.float64:
        key, rtol = "errornorm_{}", 1e-9  # the reference script's limit
    else:
        key, rtol = "relative_errornorm_{}", F32_FIELD_RTOL
    for nm in fields:
        if not (cols[key.format(nm)] < rtol).all():
            raise AssertionError(f"{key.format(nm)} {cols[key.format(nm)]} (limit {rtol})")
    return cols, rtol
