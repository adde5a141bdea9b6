"""The synthetic 3D brain box the benchmark runs (counterpart of
``__graft_entry__._brain_sim``, which imports jax and is not used here).

``brain_sim(n=32)`` is the main path's configuration: an n^3-voxel Kuhn
lattice of [0, 10]^3 (35,937 nodes and 196,608 tets at n=32) with
concentric-ellipsoid tissue labels, a clamped boundary and a Gaussian seed
off-centre in white matter; sim_time 5, dt 1.
"""

from __future__ import annotations

import numpy as np

from glimslib_tpu_torch.core.mesh import box_mesh
from glimslib_tpu_torch.models.tumor_growth_brain import TumorGrowthBrain
from glimslib_tpu_torch.solvers.coupled import StepConfig

# the f32 operating point the benchmark times (bench.py build_problem)
BENCH_STEP_CONFIG = StepConfig(
    newton_rtol=1e-4, newton_atol=1e-5, cg_rtol=1e-7, cg_maxiter=800
)


class _Boundary:
    def inside(self, x, on_boundary):
        return on_boundary


def brain_sim(n=10, dtype=None, device=None, plain=False):
    """TumorGrowthBrain on the synthetic brain box, set up as the reference
    benchmark sets it up."""
    mesh = box_mesh((0, 0, 0), (10, 10, 10), n, n, n)
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
