"""The synthetic 3D brain box the benchmark runs (counterpart of
``__graft_entry__._brain_sim``, which imports jax and is not used here).

``brain_sim(n=32)`` is the main path's configuration: an n^3-voxel Kuhn
lattice of [0, 10]^3 (35,937 nodes and 196,608 tets at n=32) with
concentric-ellipsoid tissue labels, a clamped boundary and a Gaussian seed
off-centre in white matter; sim_time 5, dt 1.  ``unstructured=True``
strips the lattice structure and reorders the nodes along a Morton curve
(``bench.py run_unstructured``): the same tets through the unstructured
lane, which the benchmark times with :data:`UNSTRUCT_STEP_CONFIG`.

``adjoint_problem`` is the benchmark's adjoint cell (``bench.py
run_adjoint``): the 2-parameter inverse problem on that box.
"""

from __future__ import annotations

import numpy as np
import torch

from glimslib_tpu_torch.core.mesh import Mesh, box_mesh
from glimslib_tpu_torch.models.tumor_growth_brain import TumorGrowthBrain
from glimslib_tpu_torch.solvers.coupled import StepConfig

# the f32 operating point the benchmark times (bench.py build_problem)
BENCH_STEP_CONFIG = StepConfig(
    newton_rtol=1e-4, newton_atol=1e-5, cg_rtol=1e-7, cg_maxiter=800
)
# the f32 operating point of the unstructured lane (bench.py
# run_unstructured): inexact-Newton forcing on the c-block, chord method on
UNSTRUCT_STEP_CONFIG = StepConfig(
    newton_rtol=1e-4, newton_atol=1e-5, cg_rtol=1e-7, cg_maxiter=800,
    rd_cg_rtol=1e-3,
)


class _Boundary:
    def inside(self, x, on_boundary):
        return on_boundary


def brain_sim(n=10, dtype=None, device=None, plain=False, unstructured=False):
    """TumorGrowthBrain on the synthetic brain box, set up as the reference
    benchmark sets it up; on the card unless ``device`` says otherwise."""
    mesh = box_mesh((0, 0, 0), (10, 10, 10), n, n, n)
    if unstructured:
        mesh = Mesh.from_arrays(mesh.points, mesh.cells).reordered_morton()
    r = np.linalg.norm((mesh.points - 5.0) / 5.0, axis=1)
    labels = np.zeros(mesh.n_nodes)
    labels[r < 0.95] = 1
    labels[r < 0.80] = 2
    labels[r < 0.62] = 3
    labels[r < 0.20] = 4

    sim = TumorGrowthBrain(mesh, dtype=dtype, device=device, plain=plain)
    sim.setup_global_parameters(
        label_function=labels,
        domain_names={0: "outside", 1: "CSF", 2: "GM", 3: "WM", 4: "Ventricles"},
        boundaries={"boundary_all": _Boundary()},
        dirichlet_bcs={
            "clamped": {
                "bc_value": np.zeros(mesh.dim),
                "named_boundary": "boundary_all",
                "subspace_id": 0,
            }
        },
    )
    center = np.full(mesh.dim, 5.0)
    center[0] += 1.0  # seed off-centre inside WM
    sim.setup_model_parameters(
        iv_expression={
            0: np.zeros(mesh.dim),
            1: lambda x: np.exp(-((x - center) ** 2).sum(axis=1) / 0.5),
        },
        E_GM=3e3, E_WM=3e3, E_CSF=1e3, E_VENT=1e3,
        nu_GM=0.45, nu_WM=0.45, nu_CSF=0.45, nu_VENT=0.3,
        D_GM=0.02, D_WM=0.1, rho_GM=0.02, rho_WM=0.1, coupling=0.15,
        sim_time=5, sim_time_step=1,
    )
    return sim


# the adjoint cell's schedule (bench.py run_adjoint): 5 steps of dt = 1
ADJ_STEPS = 5


def adjoint_problem(n=16, unstructured=False, dtype=None, device=None, sim=None):
    """``(InverseProblem, v0)`` of the benchmark's adjoint cell, as
    ``bench.py run_adjoint`` sets it up: the brain box (``sim``, or a new
    :func:`brain_sim`), at f32 the benchmark's StepConfig of its lane,
    targets ``conc_T2 = thresh(c_T, 0.12)`` and ``disp = u_T`` from a
    forward run at the set-up parameters, parameter map type 2 (D_WM,
    rho_WM), 5 steps of dt = 1, and ``v0 = [0.05, 0.05]``."""
    from glimslib_tpu_torch.optimize.adjoint import (
        InverseProblem, param_map_for_type, thresh,
    )

    if sim is None:
        sim = brain_sim(n=n, dtype=dtype, device=device, unstructured=unstructured)
    if sim.dtype == torch.float32:
        sim.step_config = (UNSTRUCT_STEP_CONFIG if sim.mesh.lattice_strides is None
                           else BENCH_STEP_CONFIG)
    theta = sim.make_theta(sim.params.as_dict())
    u0, c0 = sim.initial_state()
    with torch.no_grad():
        u_tr, c_tr, ok, _ = sim.build_simulate_fn(ADJ_STEPS, 1.0)(theta, u0, c0)
    if not bool(ok.all()):
        raise RuntimeError("the forward run for the targets did not converge")
    targets = {"conc_T2": thresh(c_tr[-1], 0.12), "disp": u_tr[-1]}
    names, update = param_map_for_type(2)
    ip = InverseProblem(sim, names, targets, update_fn=update, n_steps=ADJ_STEPS,
                        dt=1.0)
    return ip, np.array([0.05, 0.05])
