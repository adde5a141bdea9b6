"""The matrix-free jvp lane of glimslib_tpu_torch (``operator_mode =
"matrix-free"``, ``solvers/newton.py``, the jvp branch of
``solvers/coupled.py make_step``, the quad models on lattice meshes)
against the JAX package and the scipy FEM, at f64 on the CPU.

- ``newton`` on tests/test_solvers.py's systems (and with a Jacobi
  diagonal) against the JAX package's: the same iterate to 1e-12, the
  same iterations and flags, the non-convergence flag included;
- forward-mode AD through the gather kernels under ``no_grad`` (the
  step's forward runs there) equals the assembled stencil operators;
- the matrix-free forward against the JAX package's matrix-free forward
  at rel-L2 1e-8 on the n=5 brain box, and on the 2D rectangle against
  the JAX package's default lane (its matrix-free lane on a 2D mesh
  runs ``P1Kernels.elasticity_diag_blocks``, which can abort the
  process there: ROADMAP §3); against
  the port's own assembled lanes (tests/test_stencil.py's rectangle on
  the stencil lane, tests/test_ell.py's unstructured brain box on the
  halo-ELL lane) at 1e-8;
- ``value_and_grad`` on the matrix-free lane against the JAX package's
  at 1e-8;
- the quad model on ``rectangle_mesh(9, 9)`` and ``box_mesh(4, 4, 4)``
  (the jvp lane, as in the reference) against the JAX package at 1e-8
  and against ``reference_fem.ReferenceFEMP2`` at 1e-6
  (tests/test_p2_parity.py): forward, Dirichlet c on the P2 edge dofs,
  and a von Neumann influx through the P2 trace element (also on the
  unstructured lane);
- a matrix-free model under ``use_sharding()`` takes the reference's
  ``cells`` mode, with its warning.
"""

import os
import sys

import numpy as np
import pytest
import jax.numpy as jnp
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from __graft_entry__ import _brain_sim as jax_brain_sim  # noqa: E402
from glimslib_tpu.core.mesh import box_mesh as jax_box_mesh  # noqa: E402
from glimslib_tpu.core.mesh import rectangle_mesh as jax_rectangle_mesh  # noqa: E402
from glimslib_tpu.models.tumor_growth import TumorGrowth as JaxTumorGrowth  # noqa: E402
from glimslib_tpu.models.tumor_growth_quad import TumorGrowth as JaxQuad  # noqa: E402
from glimslib_tpu.solvers.coupled import StepConfig as JaxStepConfig  # noqa: E402
from glimslib_tpu.solvers.newton import newton as jax_newton  # noqa: E402
from glimslib_tpu_torch.core.mesh import Mesh, box_mesh, rectangle_mesh  # noqa: E402
from glimslib_tpu_torch.examples import brain_sim  # noqa: E402
from glimslib_tpu_torch.models.tumor_growth import TumorGrowth  # noqa: E402
from glimslib_tpu_torch.models.tumor_growth_brain import TumorGrowthBrain  # noqa: E402
from glimslib_tpu_torch.models.tumor_growth_quad import TumorGrowth as Quad  # noqa: E402
from glimslib_tpu_torch.ops.assembly import P1Kernels  # noqa: E402
from glimslib_tpu_torch.ops.p2 import P2Kernels  # noqa: E402
from glimslib_tpu_torch.ops.stencil import StencilOperators  # noqa: E402
from glimslib_tpu_torch.parallel import DeviceMesh  # noqa: E402
from glimslib_tpu_torch.solvers.coupled import StepConfig  # noqa: E402
from glimslib_tpu_torch.solvers.newton import newton  # noqa: E402

from reference_fem import ReferenceFEMP2  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

TIGHT = dict(newton_rtol=1e-10, newton_atol=1e-14, cg_rtol=1e-12)
F64 = torch.float64


def _rel(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


class Boundary:
    def inside(self, x, on_boundary):
        return on_boundary


# -- newton ----------------------------------------------------------------------

B = np.linspace(0.5, 3.0, 17)
NEWTON_CASES = {
    # x^3 + x = b, from zeros (tests/test_solvers.py)
    "scalar": (lambda x, xp: x ** 3 + x - xp.asarray(B), np.zeros(17), None,
               dict(rtol=1e-12)),
    # the same from ones with the Jacobi diagonal of the Jacobian there
    "jacobi": (lambda x, xp: x ** 3 + x - xp.asarray(B), np.ones(17), np.full(17, 4.0),
               dict(rtol=1e-12)),
    # no root, exploding values: reported as not converged
    "nonconvergence": (lambda x, xp: xp.exp(x) + 1.0, np.zeros(4), None,
                       dict(maxiter=5)),
}


@pytest.mark.parametrize("case", list(NEWTON_CASES))
def test_newton_matches_jax(case):
    res, x0, diag, kw = NEWTON_CASES[case]
    x_j, conv_j, info_j = jax_newton(
        lambda x: res(x, jnp), jnp.asarray(x0),
        precond_diag=None if diag is None else jnp.asarray(diag), **kw)
    x, conv, info = newton(lambda x: res(x, torch), torch.as_tensor(x0),
                           precond_diag=None if diag is None else torch.as_tensor(diag),
                           **kw)
    assert conv == bool(conv_j) and info["iters"] == int(info_j["iters"])
    assert _rel(x, x_j) <= 1e-12, _rel(x, x_j)
    assert np.isclose(info["fnorm"], float(info_j["fnorm"]), rtol=1e-8, atol=1e-14)
    if case == "nonconvergence":
        assert not conv and np.isfinite(x.numpy()).all()
    else:
        assert conv and torch.allclose(res(x, torch), torch.zeros(17, dtype=F64), atol=1e-8)


# -- forward-mode AD under no_grad -----------------------------------------------


def test_jvp_under_no_grad_equals_the_assembled_operators():
    """The step's forward runs under no_grad; torch.func.jvp of the gather
    residuals there equals the stencil planes' actions (the reference's
    tests/test_stencil.py:21-58) and the P2 residual's central difference."""
    mesh = box_mesh((0, 0, 0), (1, 1, 1), 3, 4, 3)
    k, ops = P1Kernels(mesh), StencilOperators(mesh)
    rng = np.random.default_rng(0)
    t = lambda *s: torch.as_tensor(rng.standard_normal(s))  # noqa: E731
    c = torch.as_tensor(rng.uniform(0, 1, mesh.n_nodes))
    D = torch.as_tensor(rng.uniform(0.01, 0.3, mesh.n_cells))
    rho = torch.as_tensor(rng.uniform(0.01, 0.3, mesh.n_cells))
    mu = torch.as_tensor(rng.uniform(0.5, 2.0, mesh.n_cells))
    v, w = t(mesh.n_nodes), t(mesh.n_nodes, 3)
    p2 = P2Kernels(mesh)
    c2, v2 = torch.as_tensor(rng.uniform(0, 1, p2.n_dofs)), t(p2.n_dofs)
    with torch.no_grad():
        assert not torch.is_grad_enabled()
        _, jv = torch.func.jvp(lambda x: k.rd_residual(x, c, D, rho, 0.7), (c,), (v,))
        want = ops.apply_scalar(ops.build_rd_jacobian(c, D, rho, 0.7), v)
        assert torch.allclose(jv, want, atol=1e-11)
        _, jw = torch.func.jvp(lambda u: k.elasticity_residual(u, c, mu, 2 * mu, 0.0),
                               (torch.zeros_like(w),), (w,))
        assert torch.allclose(jw, ops.apply_vector(ops.build_elasticity(mu, 2 * mu), w),
                              atol=1e-11)
        f = lambda x: p2.rd_residual(x, c2, 0.1, 0.2, 0.7)  # noqa: E731
        _, j2 = torch.func.jvp(f, (c2,), (v2,))
        fd = (f(c2 + 1e-6 * v2) - f(c2 - 1e-6 * v2)) / 2e-6
        assert torch.allclose(j2, fd, atol=1e-8)


# -- the matrix-free forward -------------------------------------------------------


def _rect(pkg, mode):
    """tests/test_stencil.py's rectangle run (3 steps, coupling 0.5)."""
    if pkg == "jax":
        sim = JaxTumorGrowth(jax_rectangle_mesh((-5, -5), (5, 5), 10, 10))
        sim.step_config = JaxStepConfig(**TIGHT)
    else:
        sim = TumorGrowth(rectangle_mesh((-5, -5), (5, 5), 10, 10), dtype=F64,
                          device="cpu")
        sim.step_config = StepConfig(**TIGHT)
    sim.operator_mode = mode
    sim.setup_global_parameters(
        boundaries={"boundary_all": Boundary()},
        dirichlet_bcs={"clamped": {"bc_value": np.zeros(2),
                                   "named_boundary": "boundary_all", "subspace_id": 0}})
    sim.setup_model_parameters(
        iv_expression={0: np.zeros(2), 1: lambda x: np.exp(-(x ** 2).sum(axis=1))},
        diffusion=0.1, coupling=0.5, proliferation=0.1, E=0.001, poisson=0.45,
        sim_time=3, sim_time_step=1)
    return sim


def _trajectory(sim, n_steps, pkg="torch"):
    theta = sim.make_theta(sim.params.as_dict())
    if pkg == "jax":
        # the initial values clamped to the Dirichlet data, as its run() does
        iv = sim.params.create_initial_value_function()
        mask_u, mask_c, gu, gc = sim._bc_masks_and_values()
        u0 = jnp.where(mask_u, gu(0.0), jnp.asarray(iv[0]))
        c0 = jnp.where(mask_c, gc(0.0), jnp.asarray(iv[1]))
        u, c, ok, newton_j = sim.build_simulate_fn(n_steps, 1.0)(theta, u0, c0)
        return np.asarray(u), np.asarray(c), bool(np.asarray(ok).all()), \
            np.asarray(newton_j).tolist()
    u, c, ok, newton_t = sim.build_simulate_fn(n_steps, 1.0)(theta, *sim.initial_state())
    return u.numpy(), c.numpy(), bool(ok.all()), newton_t.tolist()


@pytest.fixture(scope="module")
def rect_mf():
    sim = _rect("torch", "matrix-free")
    return _trajectory(sim, 3), sim


def _brain5(pkg):
    if pkg == "jax":
        sim = jax_brain_sim(n=5, dims=3, dtype=jnp.float64)
        sim.step_config = JaxStepConfig(**TIGHT)
    else:
        sim = brain_sim(n=5, dtype=F64, device="cpu")
        sim.step_config = StepConfig(**TIGHT)
    sim.operator_mode = "matrix-free"
    return sim


@pytest.mark.parametrize("case", ["brain5", "rect"])
def test_matrix_free_forward_matches_jax(case, rect_mf):
    """The port's matrix-free trajectory within rel-L2 1e-8 of the JAX
    package's (matrix-free on the box, with the same Newton iterations;
    its default lane on the rectangle, module docstring); the lane builds
    no stencil plane and takes no warm start."""
    n_steps = 2 if case == "brain5" else 3
    if case == "brain5":
        sim = _brain5("torch")
        got = _trajectory(sim, n_steps)
    else:
        got, sim = rect_mf
    want = _trajectory(_brain5("jax") if case == "brain5" else _rect("jax", "auto"),
                       n_steps, "jax")
    # the same Newton iterations where both run the jvp lane (the JAX
    # package's default lane takes the chord method)
    assert got[2] and want[2] and (case == "rect" or got[3] == want[3])
    for k in range(n_steps):
        assert _rel(got[1][k], want[1][k]) <= 1e-8
        assert _rel(got[0][k], want[0][k]) <= 1e-8
    assert sim.matrix_free and sim._stencil_ops is None and sim.runtime_aux() == {}
    aug = sim._augment_theta_with_operators(sim.make_theta(sim.params.as_dict()))
    assert sorted(k for k in aug if k.startswith("_")) == ["_BinvG"]
    assert len(sim.solver_info["el_cg_iters"]) == n_steps


def test_matrix_free_matches_the_stencil_lane(rect_mf):
    """tests/test_stencil.py:60-91: the stencil lane (whole-solve branch,
    plain on the CPU) and the matrix-free lane give the same trajectory
    (rel-L2 1e-8)."""
    (u_mf, c_mf, ok_mf, _), _ = rect_mf
    sim = _rect("torch", "auto")
    u, c, ok, _ = _trajectory(sim, 3)
    assert ok and ok_mf and sim._stencil_ops is not None
    for k in range(3):
        assert _rel(c[k], c_mf[k]) <= 1e-8 and _rel(u[k], u_mf[k]) <= 1e-8


def _brain_unstructured(mode, n=6):
    """tests/test_ell.py's unstructured brain box (RCM order, 2 steps)."""
    m0 = box_mesh((0, 0, 0), (8, 8, 8), n, n, n)
    mesh = Mesh.from_arrays(m0.points, m0.cells).reordered_rcm()
    r = np.linalg.norm((mesh.points - 4.0) / 4.0, axis=1)
    labels = np.zeros(mesh.n_nodes)
    for lab, rad in ((1, 0.95), (2, 0.8), (3, 0.6), (4, 0.2)):
        labels[r < rad] = lab
    sim = TumorGrowthBrain(mesh, dtype=F64, device="cpu")
    sim.operator_mode = mode
    sim.step_config = StepConfig(**TIGHT)
    sim.setup_global_parameters(
        label_function=labels,
        domain_names={0: "outside", 1: "CSF", 2: "GM", 3: "WM", 4: "Ventricles"},
        boundaries={"boundary_all": Boundary()},
        dirichlet_bcs={"clamped": {"bc_value": np.zeros(3),
                                   "named_boundary": "boundary_all", "subspace_id": 0}})
    center = np.array([4.5, 4.0, 4.0])
    sim.setup_model_parameters(
        iv_expression={0: np.zeros(3),
                       1: lambda x: np.exp(-((x - center) ** 2).sum(axis=1))},
        E_GM=3e3, E_WM=3e3, E_CSF=1e3, E_VENT=1e3,
        nu_GM=0.45, nu_WM=0.45, nu_CSF=0.45, nu_VENT=0.3,
        D_GM=0.02, D_WM=0.1, rho_GM=0.02, rho_WM=0.1, coupling=0.15,
        sim_time=2, sim_time_step=1)
    return sim


def test_matrix_free_matches_the_bell_lane():
    """tests/test_ell.py:109-129: the halo-ELL lane (assembled operators,
    chord method, warm starts) and the matrix-free lane give the same
    trajectory (rel-L2 1e-8)."""
    auto, mf = _brain_unstructured("auto"), _brain_unstructured("matrix-free")
    u, c, ok, _ = _trajectory(auto, 2)
    u_mf, c_mf, ok_mf, _ = _trajectory(mf, 2)
    assert ok and ok_mf and not auto.matrix_free and mf.matrix_free
    assert _rel(c[-1], c_mf[-1]) <= 1e-8 and _rel(u[-1], u_mf[-1]) <= 1e-8


def test_matrix_free_value_and_grad_matches_jax():
    """J and the gradient on the matrix-free lane (the IFT backward's
    adjoint solves on the jvp operators) within 1e-8 of the JAX
    package's matrix-free value_and_grad: the benchmark's adjoint cell
    (type 2, v0 = 0.05) on the n=4 box, 2 steps, on the targets of the
    port's matrix-free forward at the set-up parameters."""
    from glimslib_tpu.optimize.adjoint import InverseProblem as JaxIP
    from glimslib_tpu.optimize.adjoint import param_map_for_type as jax_map
    from glimslib_tpu_torch.optimize.adjoint import (
        InverseProblem, param_map_for_type, thresh)

    sim = brain_sim(n=4, dtype=F64, device="cpu")
    sim.step_config = StepConfig(**TIGHT)
    sim.operator_mode = "matrix-free"
    # the targets of the port's forward at the set-up parameters
    u, c, ok, _ = _trajectory(sim, 2)
    assert ok
    targets = {"conc_T2": thresh(torch.as_tensor(c[-1]), 0.12).numpy(), "disp": u[-1]}
    v0 = np.array([0.05, 0.05])
    sim_j = jax_brain_sim(n=4, dims=3, dtype=jnp.float64)
    sim_j.step_config = JaxStepConfig(**TIGHT)
    sim_j.operator_mode = "matrix-free"
    names, update = jax_map(2)
    J_j, g_j = JaxIP(sim_j, names, targets, update_fn=update, n_steps=2,
                     dt=1.0).value_and_grad(v0)
    names, update = param_map_for_type(2)
    J, g = InverseProblem(sim, names, targets, update_fn=update, n_steps=2,
                          dt=1.0).value_and_grad(v0)
    assert abs(J - J_j) <= 1e-8 * abs(J_j) and _rel(g, g_j) <= 1e-8, (J, J_j, g, g_j)
    assert len(sim.solver_info["rd_adj_cg_iters"]) == 2
    assert all(int(i) > 0 for i in sim.solver_info["el_adj_cg_iters"][:1])


# -- the quad model on lattice meshes ------------------------------------------------


def _quad(pkg, mesh_kind, dirichlet_conc=False, vn_flux=None, unstructured=False):
    """tests/test_p2_parity.py's _build_quad_sim (3 steps) on the lattice
    mesh: the JAX package's quad model or the port's."""
    args = (((0, 0), (10, 10), 9, 9) if mesh_kind == "tri"
            else ((0, 0, 0), (10, 10, 10), 4, 4, 4))
    if pkg == "jax":
        mesh = (jax_rectangle_mesh if mesh_kind == "tri" else jax_box_mesh)(*args)
        sim = JaxQuad(mesh)
        sim.step_config = JaxStepConfig(**TIGHT)
    else:
        mesh = (rectangle_mesh if mesh_kind == "tri" else box_mesh)(*args)
        if unstructured:
            mesh = Mesh.from_arrays(mesh.points, mesh.cells)
        sim = Quad(mesh, dtype=F64, device="cpu")
        sim.step_config = StepConfig(**TIGHT)
    d = mesh.dim
    dirichlet_bcs = {"clamped": {"bc_value": np.zeros(d),
                                 "named_boundary": "boundary_all", "subspace_id": 0}}
    if dirichlet_conc:
        dirichlet_bcs["conc_wall"] = {"bc_value": 0.0, "named_boundary": "boundary_all",
                                      "subspace_id": 1}
    vn = None if vn_flux is None else {"influx": {
        "bc_value": vn_flux, "named_boundary": "boundary_all", "subspace_id": 1}}
    sim.setup_global_parameters(boundaries={"boundary_all": Boundary()},
                                dirichlet_bcs=dirichlet_bcs, von_neumann_bcs=vn)
    center = np.full(d, 5.0)
    sim.setup_model_parameters(
        iv_expression={0: np.zeros(d),
                       1: lambda x: np.exp(-0.5 * ((x - center) ** 2).sum(axis=1))},
        diffusion=0.2, coupling=0.15, proliferation=0.1, E=0.001, poisson=0.45,
        sim_time=3, sim_time_step=1)
    return sim


def _fem_p2(sim, n_steps=3, dirichlet_conc=False, vn_flux=None):
    """tests/test_p2_parity.py's scipy P2 run, in the model's dof order."""
    mesh = sim.mesh
    ref = ReferenceFEMP2(mesh)
    rank = np.asarray(sim.p2.dof_rank)
    c = np.asarray(sim.params.create_initial_value_function()[1], np.float64)[rank]
    d = mesh.dim
    u = np.zeros((mesh.n_nodes, d))
    bn = mesh.boundary_nodes
    E, nu = 0.001, 0.45
    mu, lam = E / (2 * (1 + nu)), E * nu / ((1 + nu) * (1 - 2 * nu))
    kw = {}
    if dirichlet_conc:
        fvs = mesh.boundary_facet_nodes
        pairs = fvs if d == 2 else np.concatenate(
            [fvs[:, [0, 1]], fvs[:, [0, 2]], fvs[:, [1, 2]]], axis=0)
        dofs = np.concatenate([bn, mesh.n_nodes + np.unique(mesh.edge_ids_for_pairs(pairs))])
        kw.update(dirichlet_conc_dofs=dofs, dirichlet_conc_values=np.zeros(len(dofs)))
        c[dofs] = 0.0
    if vn_flux is not None:
        kw.update(flux_facets=np.arange(len(mesh.boundary_facet_nodes)), flux_value=vn_flux)
    for _ in range(n_steps):
        u, c = ref.solve_step2(
            u.ravel(), c, D_cell=0.2, rho_cell=0.1, mu_cell=mu, lam_cell=lam,
            coupling=0.15, dt=1.0, dirichlet_disp_nodes=bn,
            dirichlet_disp_values=np.zeros((len(bn), d)), **kw)
    return u, c[np.argsort(rank)]


QUAD_CASES = {
    "tri": dict(mesh_kind="tri"),
    "tet": dict(mesh_kind="tet"),
    "tri_dirichlet_conc": dict(mesh_kind="tri", dirichlet_conc=True),
    "tri_von_neumann": dict(mesh_kind="tri", vn_flux=0.05),
    "tet_von_neumann": dict(mesh_kind="tet", vn_flux=0.05),
}


@pytest.mark.parametrize("case", list(QUAD_CASES))
def test_quad_on_a_lattice_matches_jax_and_the_p2_fem(case):
    """The quad model on a lattice mesh runs the jvp lane, as in the
    reference: its 3-step trajectory within rel-L2 1e-8 of the JAX
    package's (same Newton iterations) and its final c and u within 1e-6
    of the scipy P2 FEM (tests/test_p2_parity.py:116-167); a von Neumann
    influx moves c."""
    kw = QUAD_CASES[case]
    sim = _quad("torch", **kw)
    assert sim.matrix_free and sim.lattice
    got = _trajectory(sim, 3)
    want = _trajectory(_quad("jax", **kw), 3, "jax")
    assert got[2] and want[2] and got[3] == want[3]
    for k in range(3):
        assert _rel(got[1][k], want[1][k]) <= 1e-8
        assert _rel(got[0][k], want[0][k]) <= 1e-8
    fem = {key: kw[key] for key in ("dirichlet_conc", "vn_flux") if key in kw}
    u_ref, c_ref = _fem_p2(sim, **fem)
    assert _rel(got[1][-1], c_ref) < 1e-6 and _rel(got[0][-1], u_ref) < 1e-6
    if case == "tri_von_neumann":
        no_flux = _trajectory(_quad("torch", mesh_kind=kw["mesh_kind"]), 3)
        assert np.linalg.norm(got[1][-1] - no_flux[1][-1]) > 1e-6


def test_quad_von_neumann_on_the_unstructured_lane():
    """The P2 influx on the unstructured lane (assembled P2 rd operators,
    the gather residual with the P2 trace term) against the scipy P2 FEM
    at 1e-6."""
    sim = _quad("torch", "tri", vn_flux=0.05, unstructured=True)
    assert not sim.matrix_free and not sim.lattice
    u, c, ok, _ = _trajectory(sim, 3)
    u_ref, c_ref = _fem_p2(sim, vn_flux=0.05)
    assert ok and _rel(c[-1], c_ref) < 1e-6 and _rel(u[-1], u_ref) < 1e-6


def test_sharding_a_matrix_free_model_takes_cells(caplog):
    """use_sharding's auto on a matrix-free model takes the reference's
    'cells' mode, says why, and swaps the model's kernels for
    ShardedP1Kernels (tests/test_torch_nodeshard.py runs it at gloo
    ranks); 'nodes' on the matrix-free lattice takes the rank's slab."""
    import logging

    from glimslib_tpu_torch.parallel import ShardedP1Kernels

    sim = _rect("torch", "matrix-free")
    mesh = DeviceMesh(None, 0, 1, torch.device("cpu"), "mesh_x", "gloo")
    with caplog.at_level(logging.WARNING):
        assert sim.use_sharding(mesh) is mesh
    assert sim.sharding_mode == "cells" and isinstance(sim.kernels, ShardedP1Kernels)
    assert any("fell back to the SLOW 'cells' lane" in r.getMessage()
               and "matrix-free" in r.getMessage() for r in caplog.records)
    sim = _rect("torch", "matrix-free")
    sim.use_sharding(mesh, mode="nodes")
    assert sim.sharding_mode == "nodes" and sim._node_slab is not None and sim.matrix_free
