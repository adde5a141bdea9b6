"""Port parity for the unstructured slice as a whole: the forward step of
TumorGrowthBrain on a Morton-ordered (non-lattice) brain box in
glimslib_tpu_torch against the JAX package and against the independent
scipy FEM (tests/reference_fem.py), at f64 on the CPU.

Both packages take their default path on such a mesh: supernode
halo-ELL operators, pcg preconditioned by supernode block-Jacobi plus the
two-level coarse level (``GLIMS_TWOLEVEL_MIN_NODES=100`` switches it on
at this size), the chord method, extrapolated warm starts with anchored
tolerances, the algebraic rd anchor and the factored frozen assembly.
The reference's frozen arrays are carried across
(``convert.aux_from_numpy``, its factored channel stacks included), so
both iterate with identical preconditioners: Newton counts are equal and
the states agree to rel-L2 1e-8.
"""

import os
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from __graft_entry__ import _brain_sim as jax_brain_sim  # noqa: E402
from glimslib_tpu.core.mesh import Mesh as JaxMesh  # noqa: E402
from glimslib_tpu.solvers.coupled import StepConfig as JaxStepConfig  # noqa: E402
from glimslib_tpu_torch import convert  # noqa: E402
from glimslib_tpu_torch.core.mesh import Mesh, box_mesh  # noqa: E402
from glimslib_tpu_torch.examples import brain_sim  # noqa: E402
from glimslib_tpu_torch.models.tumor_growth_brain import TumorGrowthBrain  # noqa: E402
from glimslib_tpu_torch.solvers.coupled import StepConfig  # noqa: E402

from reference_fem import ReferenceFEM  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

N_STEPS = 3


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


def _morton_jax(m):
    return JaxMesh.from_arrays(m.points, m.cells).reordered_morton()


class Boundary:
    def inside(self, x, on_boundary):
        return on_boundary


@pytest.fixture
def twolevel_env(monkeypatch):
    monkeypatch.setenv("GLIMS_TWOLEVEL_MIN_NODES", "100")


@pytest.mark.parametrize("chord", [True, False], ids=["chord", "exact_jacobian"])
def test_forward_matches_jax_f64(twolevel_env, chord):
    """n=6 Morton box, 3 steps, f64, the reference's aux carried across:
    converged flags and Newton counts equal, rel-L2 of c and u <= 1e-8.
    ``chord=False`` runs the exact per-iteration rd Jacobian
    (``build_bell_rd_wc``)."""
    sim_j = jax_brain_sim(n=6, dims=3, dtype=jnp.float64, mesh_transform=_morton_jax)
    sim_j.step_config = JaxStepConfig(rd_modified_newton=chord)
    theta_j = sim_j.make_theta(sim_j.params.as_dict())
    iv = sim_j.params.create_initial_value_function()
    aux_j = sim_j.runtime_aux()
    assert "_TLCfac" in aux_j
    u_j, c_j, ok_j, newton_j = jax.jit(sim_j.build_simulate_fn(N_STEPS, 1.0))(
        theta_j, jnp.asarray(iv[0]), jnp.asarray(iv[1]), aux_j)

    sim_t = brain_sim(n=6, dtype=torch.float64, device="cpu", unstructured=True)
    assert sim_t.mesh.lattice_strides is None
    sim_t.step_config = StepConfig(rd_modified_newton=chord)
    theta_t = convert.theta_from_numpy(
        {k: np.asarray(v) for k, v in theta_j.items()}, dtype=torch.float64)
    u0_t, c0_t = convert.state_from_numpy(iv[0], iv[1], dtype=torch.float64)
    aux_t = convert.aux_from_numpy({k: np.asarray(v) for k, v in aux_j.items()})
    u_t, c_t, ok_t, newton_t = sim_t.build_simulate_fn(N_STEPS, 1.0)(
        theta_t, u0_t, c0_t, aux_t)

    assert ok_t.tolist() == np.asarray(ok_j).tolist() == [True] * N_STEPS
    assert newton_t.tolist() == np.asarray(newton_j).tolist()
    assert len(sim_t.solver_info["el_cg_iters"]) == N_STEPS
    assert _rel(c_t[-1], c_j[-1]) <= 1e-8
    assert _rel(u_t[-1], u_j[-1]) <= 1e-8


def test_runtime_aux_equals_jax(twolevel_env):
    """The port's own frozen state equals the reference's: supernode
    inverses, mode matrices and factored channel stacks to 1e-10, their
    representative cells exactly, coarse factors as B Bᵀ."""
    sim_j = jax_brain_sim(n=6, dims=3, dtype=jnp.float64, mesh_transform=_morton_jax)
    aux_j = convert.aux_from_numpy(
        {k: np.asarray(v) for k, v in sim_j.runtime_aux().items()})
    sim_t = brain_sim(n=6, dtype=torch.float64, device="cpu", unstructured=True)
    aux_t = sim_t.runtime_aux()
    assert sorted(aux_t) == sorted(aux_j)
    for k in ("_BinvSN", "_McSN", "_TLMt", "_TLMtS", "_FWel", "_FCuc", "_FWrd",
              "_FMrd"):
        assert _rel(aux_t[k], aux_j[k]) <= 1e-10, k
    for k in ("_FReps", "_FWrdRhoReps", "_FWrdDReps"):
        assert torch.equal(aux_t[k], aux_j[k]), k
    for k in ("_TLCfac", "_TLCfacS"):
        assert _rel(aux_t[k] @ aux_t[k].T, aux_j[k] @ aux_j[k].T) <= 1e-10, k
    assert sim_t.runtime_aux() is aux_t  # built once per model


def test_streamed_residuals_match_matrix_free():
    """The halo-ELL streamed rd residual equals the per-cell evaluation,
    and the elasticity residual is linear in (u, c) with the assembled
    operator's action."""
    sim = brain_sim(n=5, dtype=torch.float64, device="cpu", unstructured=True)
    sim._build_step()
    theta = sim.make_theta(sim.params.as_dict())
    aug = sim._augment_theta_with_operators({**theta, **sim.runtime_aux()})
    rng = np.random.default_rng(7)
    n = sim.mesh.n_nodes
    c = torch.as_tensor(rng.random(n))
    c_prev = torch.as_tensor(rng.random(n))
    got = sim.rd_residual(c, c_prev, aug, 1.0)
    want = sim.kernels.rd_residual(c, c_prev, theta["D"], theta["rho"],
                                   theta["dt"], source=theta["source"])
    assert _rel(got, want) <= 1e-12


def test_forward_matches_reference_fem():
    """Unstructured 3D tet forward with 4 tissue subdomains vs the scipy
    FEM path (the configuration of test_torch_slice.py's lattice case,
    node order stripped of lattice structure and Morton-reordered)."""
    m = box_mesh((0, 0, 0), (8, 8, 8), 6, 6, 6)
    mesh = Mesh.from_arrays(m.points, m.cells).reordered_morton()
    r = np.linalg.norm((mesh.points - 4.0) / 4.0, axis=1)
    labels = np.zeros(mesh.n_nodes)
    labels[r < 0.95] = 1
    labels[r < 0.8] = 2
    labels[r < 0.6] = 3
    labels[r < 0.2] = 4
    sim = TumorGrowthBrain(mesh, dtype=torch.float64, device="cpu")
    sim.setup_global_parameters(
        label_function=labels,
        domain_names={0: "outside", 1: "CSF", 2: "GM", 3: "WM", 4: "Ventricles"},
        boundaries={"boundary_all": Boundary()},
        dirichlet_bcs={
            "clamped": {"bc_value": np.zeros(3),
                        "named_boundary": "boundary_all", "subspace_id": 0}
        },
    )
    center = np.array([4.5, 4.0, 4.0])
    sim.setup_model_parameters(
        iv_expression={0: np.zeros(3),
                       1: lambda x: np.exp(-((x - center) ** 2).sum(axis=1))},
        E_GM=3e3, E_WM=3e3, E_CSF=1e3, E_VENT=1e3,
        nu_GM=0.45, nu_WM=0.45, nu_CSF=0.45, nu_VENT=0.3,
        D_GM=0.02, D_WM=0.1, rho_GM=0.02, rho_WM=0.1, coupling=0.15,
        sim_time=2, sim_time_step=1,
    )
    sim.run(save_method=None)
    assert sim.results.get_recording_steps() == [0, 1, 2]  # every step converged

    theta = sim.make_theta(sim.params.as_dict())
    ref = ReferenceFEM(mesh)
    c = sim.params.create_initial_value_function()[1]
    u = np.zeros((mesh.n_nodes, 3))
    bn = mesh.boundary_nodes
    for _ in range(2):
        u, c = ref.solve_step(
            u.ravel(), c, D_cell=theta["D"].numpy(), rho_cell=theta["rho"].numpy(),
            mu_cell=theta["mu"].numpy(), lam_cell=theta["lam"].numpy(),
            coupling=0.15, dt=1.0, dirichlet_disp_nodes=bn,
            dirichlet_disp_values=np.zeros((len(bn), 3)),
        )
    assert _rel(sim.solution[1], c) <= 1e-6
    assert _rel(sim.solution[0], u) <= 1e-6
