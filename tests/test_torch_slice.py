"""Port parity for the slice as a whole: the lattice forward step of
TumorGrowthBrain in glimslib_tpu_torch against the JAX package and against
the independent scipy FEM (tests/reference_fem.py).

The JAX run takes its default path (pcg with extrapolated warm starts);
the port takes its plain whole-solve path.  Both converge the same
discrete system, so with tight tolerances (newton_rtol 1e-10, cg_rtol
1e-12) they agree to rel-L2 1e-8 at f64.
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
from glimslib_tpu.solvers.coupled import StepConfig as JaxStepConfig  # noqa: E402
from glimslib_tpu_torch import convert  # noqa: E402
from glimslib_tpu_torch.core.mesh import box_mesh, rectangle_mesh  # noqa: E402
from glimslib_tpu_torch.examples import brain_sim  # noqa: E402
from glimslib_tpu_torch.models.tumor_growth import TumorGrowth  # noqa: E402
from glimslib_tpu_torch.models.tumor_growth_brain import TumorGrowthBrain  # noqa: E402
from glimslib_tpu_torch.solvers.coupled import StepConfig  # noqa: E402

from reference_fem import ReferenceFEM  # noqa: E402

TIGHT = dict(newton_rtol=1e-10, newton_atol=1e-14, cg_rtol=1e-12)


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


class Boundary:
    def inside(self, x, on_boundary):
        return on_boundary


def test_theta_carried_across_equals_port_make_theta():
    sim_j = jax_brain_sim(n=4, dims=3, dtype=jnp.float64)
    sim_t = brain_sim(n=4, dtype=torch.float64, device="cpu")
    theta_j = sim_j.make_theta(sim_j.params.as_dict())
    carried = convert.theta_from_numpy(
        {k: np.asarray(v) for k, v in theta_j.items()}, dtype=torch.float64
    )
    own = sim_t.make_theta(sim_t.params.as_dict())
    assert carried.keys() == own.keys()
    for k in own:
        assert carried[k].shape == own[k].shape, k
        assert torch.allclose(carried[k], own[k], rtol=1e-15, atol=0.0), k


def test_projected_initial_values_match_jax():
    """The L2-projected initial state of both packages (f64)."""
    sim_j = jax_brain_sim(n=4, dims=3, dtype=jnp.float64)
    sim_t = brain_sim(n=4, dtype=torch.float64, device="cpu")
    iv_j = sim_j.params.create_initial_value_function()
    u0, c0 = sim_t.initial_state()
    assert _rel(c0, iv_j[1]) <= 1e-10
    assert np.abs(u0.numpy()).max() == 0.0


def test_forward_matches_jax_f64():
    """n=6 brain box, 3 steps, f64: converged flags equal, rel-L2 of c and
    u <= 1e-8."""
    n_steps = 3
    sim_j = jax_brain_sim(n=6, dims=3, dtype=jnp.float64)
    sim_j.step_config = JaxStepConfig(**TIGHT)
    theta_j = sim_j.make_theta(sim_j.params.as_dict())
    iv = sim_j.params.create_initial_value_function()
    u0_j = jnp.asarray(iv[0], jnp.float64)
    c0_j = jnp.asarray(iv[1], jnp.float64)
    u_j, c_j, ok_j, _ = jax.jit(sim_j.build_simulate_fn(n_steps, 1.0))(
        theta_j, u0_j, c0_j)

    sim_t = brain_sim(n=6, dtype=torch.float64, device="cpu")
    sim_t.step_config = StepConfig(**TIGHT)
    theta_t = convert.theta_from_numpy(
        {k: np.asarray(v) for k, v in theta_j.items()}, dtype=torch.float64)
    u0_t, c0_t = convert.state_from_numpy(iv[0], iv[1], dtype=torch.float64)
    u_t, c_t, ok_t, newton = sim_t.build_simulate_fn(n_steps, 1.0)(
        theta_t, u0_t, c0_t)

    assert ok_t.tolist() == np.asarray(ok_j).tolist() == [True] * n_steps
    assert (newton.numpy() > 0).all()
    assert _rel(c_t[-1], c_j[-1]) <= 1e-8
    assert _rel(u_t[-1], u_j[-1]) <= 1e-8


def test_forward_matches_reference_fem():
    """3D tet forward with 4 tissue subdomains vs the scipy FEM path, the
    configuration of test_northstar.py::test_3d_brain_forward_vs_reference."""
    mesh = box_mesh((0, 0, 0), (8, 8, 8), 6, 6, 6)
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
    _, _, ok, _ = sim.run()
    assert ok.all()

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


def _tumor_growth_2d(**kw):
    mesh = kw.pop("mesh", None) or rectangle_mesh((-5, -5), (5, 5), 6, 6)
    d = mesh.dim
    sim = TumorGrowth(mesh, dtype=torch.float64, device="cpu")
    sim.setup_global_parameters(
        boundaries={"boundary_all": Boundary()},
        dirichlet_bcs={"clamped": {"bc_value": np.zeros(d),
                                   "named_boundary": "boundary_all",
                                   "subspace_id": 0}},
        von_neumann_bcs=kw.pop("von_neumann_bcs", None),
    )
    params = dict(diffusion=0.1, coupling=1.0, proliferation=0.1, E=0.001,
                  poisson=0.45, sim_time=1, sim_time_step=1)
    params.update(kw)
    sim.setup_model_parameters(
        iv_expression={0: np.zeros(d), 1: lambda x: np.exp(-(x ** 2).sum(axis=1))},
        **params,
    )
    return sim


def _unstructured():
    """Von Neumann conditions on an unstructured mesh: still outside the
    port (the unstructured lane itself runs, tests/test_torch_unstructured.py)."""
    from glimslib_tpu_torch.core.mesh import Mesh

    m = box_mesh((0, 0, 0), (1, 1, 1), 2, 2, 2)
    _tumor_growth_2d(mesh=Mesh.from_arrays(m.points, m.cells), von_neumann_bcs={
        "flux": {"bc_value": 1.0, "named_boundary": "boundary_all",
                 "subspace_id": 1}})


def _von_neumann():
    _tumor_growth_2d(von_neumann_bcs={"flux": {
        "bc_value": 1.0, "named_boundary": "boundary_all", "subspace_id": 1}})


def _time_dependent_source():
    sim = _tumor_growth_2d(source_term=lambda x, t: 0.0 * x[:, 0] + t)
    sim.make_theta(sim.params.as_dict())


def _step_config(**kw):
    sim = _tumor_growth_2d()
    sim.step_config = StepConfig(**kw)
    sim.run()


def test_plain_2d_lattice_runs():
    """A 2D rectangle lattice runs through the same plain path on the CPU."""
    sim = _tumor_growth_2d()
    _, c, ok, _ = sim.run()
    assert ok.all() and torch.isfinite(c).all()


@pytest.mark.parametrize("case", [
    "unstructured", "von_neumann", "time_dependent_source", "refine_f64",
    "chebyshev", "sharding",
])
def test_outside_slice_raises(case):
    run = {
        "unstructured": _unstructured,
        "von_neumann": _von_neumann,
        "time_dependent_source": _time_dependent_source,
        "refine_f64": lambda: _step_config(refine_f64=True),
        "chebyshev": lambda: _step_config(precond_degree=3),
        "sharding": lambda: _tumor_growth_2d().use_sharding(None),
    }[case]
    with pytest.raises(NotImplementedError):
        run()
