"""The public API that glimslib_tpu_torch shares with the JAX package,
on the CPU at f64.

- (a) the JAX package's own unit tests run on the port, ported case by
  case with the same assertions: tests/test_unit_helpers.py (all eleven),
  tests/test_assembly.py::test_stiffness_action (against the scipy
  assembly of tests/reference_fem.py, atol 1e-12),
  tests/test_solvers.py::test_cg_fixed_iters_differentiable (central
  difference, rtol 1e-4) and tests/test_bell.py's halo_ids and streamed
  residual checks (atol 1e-12 and 1e-9);
- (b) parity with the JAX package on the same numpy inputs from a seed:
  ``pack`` order and round trip, ``interpolate`` and ``cell_coefficient``
  exactly; ``stiffness_residual``, ``integrate_p1``, ``cell_gradient``,
  the P2 gathers and quadrature-point values and gradients, ``scatter``
  and the four element-contribution functions within rel 1e-12;
  ``build_bell_mass`` and ``build_bell_coupling_uc`` on the n = 4
  Morton box within rel 1e-12 of the JAX tables and of the model's own
  ``_BellMrd`` / ``_BellCuc``; ``cg_fixed_iters``' value and gradient
  within rel 1e-10 of ``jax.grad`` of the JAX one;
- (c) a static walk: every public top-level name and public method of
  every module of glimslib_tpu/ exists in the port (inherited members
  count), or is one of the names left out on purpose, each with its
  reason (:data:`LEFT_OUT`).
"""

import ast
import importlib
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glimslib_tpu.core.functionspace import FunctionSpace as JaxFunctionSpace
from glimslib_tpu.core.mesh import Mesh as JaxMesh
from glimslib_tpu.core.mesh import box_mesh as jax_box_mesh
from glimslib_tpu.core.mesh import rectangle_mesh as jax_rectangle_mesh
from glimslib_tpu.core.params import Parameters as JaxParameters
from glimslib_tpu.core.subdomains import SubDomains as JaxSubDomains
from glimslib_tpu.ops import assembly as jax_assembly
from glimslib_tpu.ops import bell as jax_bell
from glimslib_tpu.ops.p2 import P2Kernels as JaxP2Kernels
from glimslib_tpu.solvers.cg import cg_fixed_iters as jax_cg_fixed_iters
from glimslib_tpu_torch.core.bcs import BoundaryConditions
from glimslib_tpu_torch.core.functionspace import FunctionSpace, SubSpace, SubSpaces
from glimslib_tpu_torch.core.mesh import Mesh, box_mesh, rectangle_mesh
from glimslib_tpu_torch.core.params import Parameters, TissueCoefficient
from glimslib_tpu_torch.core.results import Results, TimeSeriesData, TimeSeriesMultiData
from glimslib_tpu_torch.core.subdomains import SubDomains
from glimslib_tpu_torch.ops import assembly, bell
from glimslib_tpu_torch.ops.assembly import P1Kernels
from glimslib_tpu_torch.ops.p2 import P2Kernels
from glimslib_tpu_torch.solvers.cg import cg_fixed_iters
from reference_fem import ReferenceFEM
from torch_threads import one_torch_thread  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parents[1]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


# -- (a) tests/test_unit_helpers.py on the port ------------------------------------


@pytest.fixture()
def fs2d():
    mesh = rectangle_mesh((0, 0), (1, 1), 4, 4)
    fs = FunctionSpace(mesh)
    fs.init_function_space([(1, 1), (0, 1)], {0: "displacement", 1: "concentration"})
    return fs


def test_subspaces_registry():
    ss = SubSpaces(2)
    ss.set_subspace(0, SubSpace("displacement", 1, 1, 25, 2))
    ss.set_subspace(1, SubSpace("concentration", 0, 1, 25, 2))
    assert ss.get_subspace_ids() == [0, 1]
    assert ss.get_subspace(0).value_size == 2
    assert ss.get_subspace(1).value_size == 1
    assert ss.get_subspace(0).shape == (25, 2)
    assert ss.get_subspace(0).size == 50
    assert ss.exists(1) and not ss.exists(2)


def test_functionspace_pack_unpack(fs2d):
    f = fs2d.zero_function()
    assert f[0].shape == (25, 2)
    assert f[1].shape == (25,)
    f[0][:] = 1.0
    f[1][:] = 2.0
    flat = fs2d.pack(f)
    assert flat.shape == (75,)
    back = fs2d.unpack(flat)
    assert np.allclose(back[0], 1.0)
    assert np.allclose(back[1], 2.0)


def test_functionspace_projection_exact_for_linears(fs2d):
    """L2 projection reproduces polynomials in the space exactly."""
    vals = fs2d.project(lambda x: 2 * x[:, 0] - x[:, 1] + 1, subspace_id=1)
    want = 2 * fs2d.mesh.points[:, 0] - fs2d.mesh.points[:, 1] + 1
    assert np.allclose(vals, want, atol=1e-9)


def test_functionspace_project_over_space(fs2d):
    out = fs2d.project_over_space({0: np.array([1.0, -1.0]), 1: 0.5})
    assert np.allclose(out[0], [1.0, -1.0], atol=1e-9)
    assert np.allclose(out[1], 0.5, atol=1e-9)


def test_parameters_validation(fs2d):
    sd = SubDomains(fs2d.mesh)
    sd.setup_subdomains()
    p = Parameters(fs2d, sd, time_dependent=True)
    p.define_required_params(["diffusion", "E"])
    p.define_optional_params(["source"])
    with pytest.raises(ValueError, match="missing"):
        p.init_parameters({"diffusion": 0.1})
    with pytest.raises(ValueError, match="unknown"):
        p.init_parameters({"diffusion": 0.1, "E": 1.0, "sim_time": 1,
                           "sim_time_step": 1, "bogus": 2})
    p.init_parameters({"diffusion": 0.1, "E": 1.0, "sim_time": 2, "sim_time_step": 1})
    assert p.diffusion == 0.1
    assert p.get_names() == ["diffusion", "E", "sim_time", "sim_time_step"]
    assert p.time_update_parameters(1.0) is None


def test_parameters_tissue_dict(fs2d):
    mesh = fs2d.mesh
    labels = np.where(mesh.points[:, 0] < 0.5, 1.0, 2.0)
    sd = SubDomains(mesh)
    sd.setup_subdomains(label_function=labels)
    sd.setup_boundaries(tissue_map={1: "left", 2: "right"})
    p = Parameters(fs2d, sd)
    p.define_required_params(["diffusion"])
    p.init_parameters({"diffusion": {"left": 0.1, "right": 0.3}})
    assert isinstance(p.diffusion, TissueCoefficient)
    per_cell = np.asarray(p.cell_coefficient("diffusion"))
    assert set(np.round(np.unique(per_cell), 10)) <= {0.1, 0.3}
    # with_values keeps the labels; a tensor's gradient flows through per_cell
    v = torch.tensor(np.asarray(p.diffusion.values) * 2.0, requires_grad=True)
    tc = p.diffusion.with_values(v)
    assert np.array_equal(tc.cell_labels, p.diffusion.cell_labels)
    assert np.allclose(tc.per_cell().detach().numpy(), 2.0 * per_cell)
    tc.per_cell().sum().backward()
    assert np.array_equal(v.grad.numpy(),
                          np.bincount(tc.cell_labels, minlength=len(v)).astype(float))


class _Left:
    def inside(self, x, on_boundary):
        return on_boundary & (np.atleast_2d(x.T)[:, 0] < 1e-10)


class _All:
    def inside(self, x, on_boundary):
        return on_boundary


def test_dirichlet_and_von_neumann_counts(fs2d):
    mesh = fs2d.mesh
    sd = SubDomains(mesh)
    sd.setup_subdomains()
    sd.setup_boundaries(boundary_fct_dict={"left": _Left(), "all": _All()})
    bcs = BoundaryConditions(fs2d, sd)
    bcs.setup_dirichlet_boundary_conditions({
        "clamp_left": {"bc_value": np.zeros(2), "named_boundary": "left",
                       "subspace_id": 0},
        "conc_all": {"bc_value": 1.0, "named_boundary": "all", "subspace_id": 1},
        "broken": {"named_boundary": "left"},  # missing bc_value -> skipped
    })
    assert len(bcs.dirichlet_bcs) == 2
    mask_u, vals_u = bcs.dirichlet_mask_and_values(0)
    assert int(np.asarray(mask_u).sum()) == 5 * 2  # left edge nodes x 2 comps
    mask_c, vals_c = bcs.dirichlet_mask_and_values(1)
    assert int(np.asarray(mask_c).sum()) == 16  # all boundary nodes
    assert np.allclose(np.asarray(vals_c)[np.asarray(mask_c)], 1.0)
    assert bcs.time_update_bcs(1.0) is None

    bcs.setup_von_neumann_boundary_conditions({
        "flux": {"bc_value": 2.0, "named_boundary": "left", "subspace_id": 1},
    })
    assert len(bcs.von_neumann_bcs) == 1
    r = np.asarray(bcs.von_neumann_residual(1))
    assert np.isclose(r.sum(), 2.0 * 1.0)  # ∫ q ds over left edge length 1


def test_time_dependent_dirichlet(fs2d):
    sd = SubDomains(fs2d.mesh)
    sd.setup_subdomains()
    sd.setup_boundaries(boundary_fct_dict={"all": _All()})
    bcs = BoundaryConditions(fs2d, sd)
    bcs.setup_dirichlet_boundary_conditions({
        "ramp": {"bc_value": lambda x, t: t * x[:, 0], "named_boundary": "all",
                 "subspace_id": 1},
    })
    assert bcs.has_time_dependent_dirichlet
    _, v1 = bcs.dirichlet_mask_and_values(1, t=1.0)
    _, v2 = bcs.dirichlet_mask_and_values(1, t=2.0)
    nz = np.asarray(v1) != 0
    assert np.allclose(np.asarray(v2)[nz], 2 * np.asarray(v1)[nz])


def test_timeseries_and_results(fs2d, tmp_path):
    ts = TimeSeriesData("solution")
    f0 = {0: np.zeros((25, 2)), 1: np.ones(25)}
    ts.add_observation(f0, time=0.0, time_step=0, recording_step=0)
    ts.add_observation({0: np.ones((25, 2)), 1: 2 * np.ones(25)},
                       time=1.0, time_step=1, recording_step=1)
    # deep copy: mutating the source must not alter the record
    f0[1][:] = 99.0
    assert np.allclose(ts.get_solution_function(0, 1), 1.0)
    assert ts.get_recording_steps() == [0, 1]
    assert ts.get_most_recent_observation().time == 1.0
    # no replace by default
    ts.add_observation(f0, 5.0, 5, 1)
    assert ts.get_observation(1).time == 1.0

    multi = TimeSeriesMultiData()
    multi.register_time_series("solution")
    multi.add_observation("solution", {0: np.zeros((25, 2)), 1: np.ones(25)}, 0.0, 0, 0)
    p = str(tmp_path / "ts.h5")
    multi.save_to_hdf5(p, mesh=fs2d.mesh)
    multi2 = TimeSeriesMultiData()
    multi2.load_from_hdf5(p)
    assert np.allclose(multi2.get_solution_function("solution", 0, 1), 1.0)
    assert TimeSeriesMultiData.read_mesh_hdf5(p).n_nodes == 25


def test_results_vtk_output(fs2d, tmp_path):
    res = Results(fs2d, output_dir=str(tmp_path))
    res.save_solution_start(method="vtk")
    res.add_to_results(0.0, 0, 0, {0: np.zeros((25, 2)), 1: np.ones(25)})
    res.save_solution(0, 0.0, method="vtk")
    res.save_solution_end(method="vtk")
    assert os.path.exists(tmp_path / "solution_000000.vtu")
    assert os.path.exists(tmp_path / "solution.pvd")


def test_reference_compat_module_paths():
    """The reference's module paths: simulation_helpers / simulation."""
    from glimslib_tpu_torch.simulation.simulation_tumor_growth import TumorGrowth
    from glimslib_tpu_torch.simulation.simulation_tumor_growth_brain_quad import (
        TumorGrowthBrain,
    )
    from glimslib_tpu_torch.simulation_helpers import (
        DiscontinuousScalar,
        math_linear_elasticity as mle,
        math_reaction_diffusion as mrd,
    )

    assert DiscontinuousScalar is TissueCoefficient
    assert float(mle.compute_mu(1.0, 0.25)) == pytest.approx(0.4)
    assert float(mrd.compute_growth_logistic(0.5, 2.0, 1.0)) == pytest.approx(0.5)
    assert TumorGrowth.__name__ == "TumorGrowth"
    assert TumorGrowthBrain.CONCENTRATION_DEGREE == 2


# -- (a) tests/test_assembly.py, tests/test_solvers.py, tests/test_bell.py ---------


def _meshes():
    return [rectangle_mesh((-1, -1), (1, 1), 7, 5), box_mesh((0, 0, 0), (1, 1, 1), 3, 3, 3)]


@pytest.mark.parametrize("mesh", _meshes(), ids=["tri", "tet"])
def test_stiffness_action(mesh):
    k = P1Kernels(mesh)
    ref = ReferenceFEM(mesh)
    rng = np.random.default_rng(1)
    c = rng.standard_normal(mesh.n_nodes)
    D = rng.uniform(0.5, 2.0, mesh.n_cells)
    got = k.stiffness_residual(torch.as_tensor(c), torch.as_tensor(D)).numpy()
    want = ref.stiffness_matrix(D) @ c
    assert np.allclose(got, want, atol=1e-12)


def _spd_system():
    rng = np.random.default_rng(0)
    n = 60
    Q = rng.standard_normal((n, n))
    return Q @ Q.T + n * np.eye(n), rng.standard_normal(n)


def test_cg_fixed_iters_differentiable():
    A, b = (torch.as_tensor(a) for a in _spd_system())

    def solve_norm(bb):
        x = cg_fixed_iters(lambda v: A @ v, bb, iters=80)
        return torch.sum(x ** 2)

    bv = b.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(solve_norm(bv), bv)
    eps = 1e-5
    v = torch.as_tensor(np.random.default_rng(1).standard_normal(b.shape))
    fd = (solve_norm(b + eps * v) - solve_norm(b - eps * v)) / (2 * eps)
    assert np.isclose(float(g @ v), float(fd), rtol=1e-4)


def _morton(mesh):
    return Mesh.from_arrays(mesh.points, mesh.cells).reordered_morton()


def test_supernode_jacobi_inverts_self_blocks():
    """apply_supernode_jacobi(Binv, r) solves the per-supernode self-block
    system: dense-reconstruct block 0 from ``halo_ids`` and compare;
    masked dofs identity."""
    mesh = _morton(box_mesh((0, 0, 0), (1, 1, 2), 3, 3, 4))
    n, d = mesh.n_nodes, mesh.dim
    k = P1Kernels(mesh)
    s = 16
    plan = bell.BellPlan(mesh, s=s)
    W = bell.build_bell_elasticity(plan, (k.grads_T, k.vol), 1.0, 9.0)
    mask = np.zeros((n, d), bool)
    mask[mesh.boundary_nodes] = True
    B = bell.extract_self_blocks_vector(plan, W)

    halos = plan.halo_ids[0]
    Wnp = W.numpy()  # (nb, s, d, Kh, d)
    m = s * d
    B0 = np.zeros((m, m))
    for i in range(min(s, n)):
        for kh, j in enumerate(halos):
            if 0 <= j < s:  # own nodes of block 0 are ids [0, s)
                B0[i * d:(i + 1) * d, j * d:(j + 1) * d] = Wnp[0, i, :, kh, :]
    assert np.allclose(B.numpy()[0], B0, atol=1e-12)

    Binv = bell.supernode_jacobi_inverse(plan, B, mask=torch.as_tensor(mask))
    r = torch.as_tensor(np.random.default_rng(2).standard_normal((n, d)))
    z = bell.apply_supernode_jacobi(plan, Binv, r).numpy()
    fm = mask.reshape(-1)[:m]
    Bm = B0 * np.outer(1 - fm, 1 - fm) + np.diag(fm.astype(float))
    want0 = np.linalg.solve(Bm, r.numpy().reshape(-1)[:m])
    assert np.allclose(z.reshape(-1)[:m], want0, atol=1e-9)
    rm = r.numpy().reshape(-1)[:m][fm]
    assert np.allclose(z.reshape(-1)[:m][fm], rm, atol=1e-12)


@pytest.mark.parametrize("G", [1, 4])
def test_halo_ids_equal_jax(G):
    """``halo_ids`` (the chunk-aligned halo expanded) equals the JAX
    plan's on the Morton box."""
    mt = box_mesh((0, 0, 0), (1, 1, 2), 3, 3, 4)
    mj = jax_box_mesh((0, 0, 0), (1, 1, 2), 3, 3, 4)
    pt = bell.BellPlan(_morton(mt), s=16, halo_chunk=G)
    pj = jax_bell.BellPlan(JaxMesh.from_arrays(mj.points, mj.cells).reordered_morton(),
                           s=16, halo_chunk=G)
    assert np.array_equal(pt.halo_ids, pj.halo_ids)


@pytest.mark.parametrize("residual", ["el", "rd"])
def test_bell_streaming_residual_matches_matrix_free(residual):
    """The streamed residuals of the unstructured lane (elasticity A u +
    C c - load through ``build_bell_coupling_uc``'s plane, rd W_const c +
    dtρ/c_max ∫c²φ - M c_prev - load through ``build_bell_mass``'s) equal
    the matrix-free per-cell evaluation on an unstructured mesh."""
    from glimslib_tpu_torch.models.tumor_growth import TumorGrowth

    mesh = _morton(box_mesh((-1, -1, -1), (1, 1, 1), 5, 5, 5))
    sim = TumorGrowth(mesh, dtype=torch.float64, device="cpu")
    sim.setup_global_parameters(
        boundaries={"all": _All()},
        dirichlet_bcs={"clamped": {"bc_value": np.zeros(3), "named_boundary": "all",
                                   "subspace_id": 0}})
    sim.setup_model_parameters(
        iv_expression={0: np.zeros(3), 1: lambda x: np.exp(-(x ** 2).sum(axis=1))},
        diffusion=0.1, coupling=0.2, proliferation=0.1, E=0.01, poisson=0.45,
        sim_time=2, sim_time_step=1)
    theta = sim.make_theta(sim.params.as_dict())
    aug = sim._augment_theta_with_operators({**theta, **sim.runtime_aux()})
    assert f"_Bell_{residual}_load" in aug, "streamed residual not built"
    plan, arrays = sim._get_bell_plan(), sim._mesh_arrays()
    rng = np.random.default_rng(11 if residual == "el" else 7)
    t = torch.tensor(1.0, dtype=torch.float64)
    if residual == "el":
        W = bell.build_bell_coupling_uc(plan, arrays, theta["mu"], theta["lam"],
                                        theta["coupling"])
        u = torch.as_tensor(rng.standard_normal((mesh.n_nodes, 3)))
        c = torch.as_tensor(rng.random(mesh.n_nodes))
        got = sim.el_residual(u, c, {**aug, "_BellCuc": W}, t).numpy()
        want = sim.el_residual(u, c, theta, t).numpy()  # matrix-free
    else:
        W = bell.build_bell_mass(plan, arrays, sim.kernels._m0)
        c = torch.as_tensor(rng.random(mesh.n_nodes))
        c_prev = torch.as_tensor(rng.random(mesh.n_nodes))
        got = sim.rd_residual(c, c_prev, {**aug, "_BellMrd": W}, t).numpy()
        want = sim.rd_residual(c, c_prev, theta, t).numpy()  # matrix-free
    assert np.allclose(got, want, atol=1e-9), np.abs(got - want).max()


# -- (b) parity with the JAX package -------------------------------------------------


def _fs_pair(quad=False):
    spec = [(1, 1), (0, 2 if quad else 1)]
    names = {0: "displacement", 1: "concentration"}
    fs = FunctionSpace(rectangle_mesh((0, 0), (1, 1), 4, 3))
    fj = JaxFunctionSpace(jax_rectangle_mesh((0, 0), (1, 1), 4, 3))
    fs.init_function_space(spec, names)
    fj.init_function_space(spec, names)
    return fs, fj


@pytest.mark.parametrize("quad", [False, True], ids=["p1", "p2"])
def test_functionspace_members_equal_jax(quad):
    fs, fj = _fs_pair(quad)
    assert fs.projection_parameters == fj.projection_parameters
    zs, zj = fs.zero_function(), fj.zero_function()
    assert {k: (v.shape, v.dtype) for k, v in zs.items()} == {
        k: (v.shape, v.dtype) for k, v in zj.items()}
    rng = np.random.default_rng(0)
    fields = {sid: rng.standard_normal(v.shape) for sid, v in zs.items()}
    flat = fs.pack(fields)
    assert np.array_equal(flat, np.asarray(fj.pack(fields)))
    # a tensor field makes a tensor of the same order
    ft = fs.pack({1: torch.as_tensor(fields[1]), 0: fields[0]})
    assert isinstance(ft, torch.Tensor) and np.array_equal(ft.numpy(), flat)
    for back in (fs.unpack(flat), fs.unpack(torch.as_tensor(flat))):
        for sid in fields:
            assert np.array_equal(np.asarray(back[sid]), fields[sid])
            assert fs.split_function(back, sid) is back[sid]
    expr = lambda x: np.sin(3 * x[:, 0]) + x[:, 1] ** 2  # noqa: E731
    for sid, e in ((1, expr), (0, np.array([0.5, -2.0])), (1, 0.25)):
        got, want = fs.interpolate(e, sid), np.asarray(fj.interpolate(e, sid))
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_cell_coefficient_equals_jax():
    mt = rectangle_mesh((0, 0), (1, 1), 5, 4)
    mj = jax_rectangle_mesh((0, 0), (1, 1), 5, 4)
    labels = np.where(mt.points[:, 0] < 0.5, 1.0, 2.0)
    out = []
    for fsc, sdc, pc, mesh in ((FunctionSpace, SubDomains, Parameters, mt),
                               (JaxFunctionSpace, JaxSubDomains, JaxParameters, mj)):
        fs = fsc(mesh)
        fs.init_function_space([(0, 1)], {0: "concentration"})
        sd = sdc(mesh)
        sd.setup_subdomains(label_function=labels)
        sd.setup_boundaries(tissue_map={1: "left", 2: "right"})
        p = pc(fs, sd)
        p.define_required_params(["diffusion", "rho"])
        p.init_parameters({"diffusion": {"left": 0.1, "right": 0.3}, "rho": 0.7})
        out.append((np.asarray(p.cell_coefficient("diffusion")),
                    p.cell_coefficient("rho"), p.get_names()))
    (dt_, rt, nt), (dj, rj, nj) = out
    assert np.array_equal(dt_, dj) and rt == rj and nt == nj


@pytest.fixture(scope="module")
def kernel_pair():
    """A P1Kernels and P2Kernels of each package on the 3 x 3 x 2 box, and
    seeded fields and per-cell coefficients."""
    mt = box_mesh((0, 0, 0), (1, 1, 1), 3, 3, 2)
    mj = jax_box_mesh((0, 0, 0), (1, 1, 1), 3, 3, 2)
    rng = np.random.default_rng(5)
    p2t, p2j = P2Kernels(mt, dtype=torch.float64), JaxP2Kernels(mj, dtype=jnp.float64)
    return dict(
        kt=P1Kernels(mt, dtype=torch.float64),
        kj=jax_assembly.P1Kernels(mj, dtype=jnp.float64),
        p2t=p2t, p2j=p2j, c=rng.random(mt.n_nodes), cp=rng.random(mt.n_nodes),
        u=rng.standard_normal((mt.n_nodes, 3)), f2=rng.standard_normal(p2t.n_dofs),
        g2=rng.standard_normal(p2t.n_dofs),
        co={k: 0.5 + rng.random(mt.n_cells) for k in ("D", "rho", "mu", "lam", "s")},
        bf=rng.standard_normal((3, mt.n_cells)))


def test_p1_members_equal_jax(kernel_pair):
    kt, kj, c, D = (kernel_pair[k] for k in ("kt", "kj", "c", "co"))
    D = D["D"]
    T, J = torch.as_tensor, jnp.asarray
    pairs = [
        (kt.stiffness_residual(T(c), T(D)), kj.stiffness_residual(J(c), J(D))),
        (kt.stiffness_residual(T(c)), kj.stiffness_residual(J(c))),
        (kt.integrate_p1(T(c)), kj.integrate_p1(J(c))),
        (kt.integrate_cellwise(T(D)), kj.integrate_cellwise(J(D))),
        (kt.cell_gradient(T(c)), kj.cell_gradient(J(c))),
        (kt.gather(T(kernel_pair["u"])), kj.gather(J(kernel_pair["u"]))),
    ]
    for got, want in pairs:
        assert tuple(got.shape) == tuple(want.shape)
        assert _rel(got.numpy(), want) <= 1e-12


def test_p2_members_equal_jax(kernel_pair):
    pt, pj, f, g = (kernel_pair[k] for k in ("p2t", "p2j", "f2", "g2"))
    ft, gt, fj, gj = torch.as_tensor(f), torch.as_tensor(g), jnp.asarray(f), jnp.asarray(g)
    fe_t, fe_j = pt.gather(ft), pj.gather(fj)
    pairs = [
        (fe_t, fe_j), (pt.gather2(ft, gt), pj.gather2(fj, gj)),
        (pt.gather2_T(ft, gt), pj.gather2_T(fj, gj)),
        (pt.at_quad(fe_t), pj.at_quad(fe_j)),
        (pt.ref_grad_at_quad(fe_t), pj.ref_grad_at_quad(fe_j)),
        (pt.phys_grad_at_quad(fe_t), pj.phys_grad_at_quad(fe_j)),
    ]
    for got, want in pairs:
        assert tuple(got.shape) == tuple(want.shape)
        assert _rel(got.numpy(), want) <= 1e-12


def test_element_contributions_equal_jax(kernel_pair):
    """The four element-contribution functions (the formulas P1Kernels'
    residuals and diagonals run) and ``scatter``, per-cell coefficients."""
    kt, kj = kernel_pair["kt"], kernel_pair["kj"]
    co, bf = kernel_pair["co"], kernel_pair["bf"]
    T, J = torch.as_tensor, jnp.asarray
    ce, cpe = (kt._gather_T(T(kernel_pair[k])) for k in ("c", "cp"))
    ue = kt._gather_T(T(kernel_pair["u"])).permute(2, 0, 1)  # (d, npe, nc)
    c_int = kt.cell_integral(T(kernel_pair["c"]))
    args_t = (kt.grads_T, kt.vol)
    args_j = (kj.grads_T, kj.vol)
    m0, t0, d = kt._m0, kt._t0, kt.dim
    pairs = [
        (assembly.rd_element_contrib(ce, cpe, *args_t, T(co["D"]), T(co["rho"]), 0.7,
                                     T(co["s"]), 1.3, m0, t0, d),
         jax_assembly.rd_element_contrib(J(ce.numpy()), J(cpe.numpy()), *args_j,
                                         J(co["D"]), J(co["rho"]), 0.7, J(co["s"]), 1.3,
                                         m0, t0, d)),
        (assembly.rd_diag_contrib(*args_t, T(co["D"]), 0.7, m0, d),
         jax_assembly.rd_diag_contrib(*args_j, J(co["D"]), 0.7, m0, d)),
        (assembly.elasticity_element_contrib(ue, c_int, *args_t, T(co["mu"]),
                                             T(co["lam"]), 0.2, T(bf), d),
         jax_assembly.elasticity_element_contrib(J(ue.numpy()), J(c_int.numpy()), *args_j,
                                                 J(co["mu"]), J(co["lam"]), 0.2, J(bf), d)),
        (assembly.elasticity_diag_contrib(*args_t, T(co["mu"]), T(co["lam"])),
         jax_assembly.elasticity_diag_contrib(*args_j, J(co["mu"]), J(co["lam"]))),
    ]
    for got, want in pairs:
        assert tuple(got.shape) == tuple(want.shape)
        assert _rel(got.numpy(), want) <= 1e-12
    plan = assembly.make_scatter_plan(kt.cells_T.numpy(), kt.n_nodes)
    contrib = pairs[0][0].reshape(-1)
    got = assembly.scatter(plan, contrib)
    want = jax_assembly.scatter(jax_assembly.make_scatter_plan(kt.cells_T.numpy(),
                                                               kt.n_nodes),
                                J(contrib.numpy()))
    assert _rel(got.numpy(), want) <= 1e-12
    # the same sums as the method that runs the formula
    rd = kt.rd_residual(T(kernel_pair["c"]), T(kernel_pair["cp"]), T(co["D"]),
                        T(co["rho"]), 0.7, source=T(co["s"]), conc_max=1.3)
    assert _rel(got.numpy(), rd.numpy()) <= 1e-12


def test_bell_mass_and_coupling_equal_jax_and_the_model():
    """``build_bell_mass`` / ``build_bell_coupling_uc`` on the n = 4 Morton
    brain box (the plan at the model's s = 32): the JAX package's tables
    on the same per-cell coefficients, and the model's ``_BellMrd`` /
    ``_BellCuc`` at its theta."""
    from glimslib_tpu_torch.examples import brain_sim

    sim = brain_sim(n=4, dtype=torch.float64, device="cpu", unstructured=True)
    theta = sim.make_theta(sim.params.as_dict())
    aug = sim._augment_theta_with_operators({**theta, **sim.runtime_aux()})
    plan, arrays = sim._get_bell_plan(), sim._mesh_arrays()
    M = bell.build_bell_mass(plan, arrays, sim.kernels._m0)
    C = bell.build_bell_coupling_uc(plan, arrays, theta["mu"], theta["lam"],
                                    theta["coupling"])
    assert _rel(M.numpy(), aug["_BellMrd"].numpy()) <= 1e-12
    assert _rel(C.numpy(), aug["_BellCuc"].numpy()) <= 1e-12

    mj = jax_box_mesh((0, 0, 0), (10, 10, 10), 4, 4, 4)
    mj = JaxMesh.from_arrays(mj.points, mj.cells).reordered_morton()
    assert np.array_equal(mj.cells, sim.mesh.cells)
    kj = jax_assembly.P1Kernels(mj, dtype=jnp.float64)
    pj = jax_bell.BellPlan(mj, s=plan.s)
    aj = (kj.grads_T, kj.vol)
    co = [np.broadcast_to(theta[k].numpy(), (mj.n_cells,)) for k in ("mu", "lam")]
    Mj = jax_bell.build_bell_mass(pj, aj, kj._m0, jnp.float64)
    Cj = jax_bell.build_bell_coupling_uc(pj, aj, jnp.asarray(co[0]), jnp.asarray(co[1]),
                                         float(theta["coupling"]), jnp.float64)
    assert M.shape == Mj.shape and C.shape == Cj.shape
    assert _rel(M.numpy(), Mj) <= 1e-12
    assert _rel(C.numpy(), Cj) <= 1e-12


def test_cg_fixed_iters_equals_jax():
    """Value and gradient (of |x|², wrt b) at a Jacobi preconditioner and
    a start vector, against ``jax.grad`` of the JAX function."""
    A, b = _spd_system()
    x0 = np.random.default_rng(3).standard_normal(b.shape)
    dA = np.diag(A).copy()
    At, Aj = torch.as_tensor(A), jnp.asarray(A)

    def f_t(bb):
        return torch.sum(cg_fixed_iters(lambda v: At @ v, bb, x0=torch.as_tensor(x0),
                                        M=lambda r: r / torch.as_tensor(dA), iters=12) ** 2)

    def f_j(bb):
        return jnp.sum(jax_cg_fixed_iters(lambda v: Aj @ v, bb, x0=jnp.asarray(x0),
                                          M=lambda r: r / jnp.asarray(dA), iters=12) ** 2)

    bt = torch.as_tensor(b).requires_grad_(True)
    Jt = f_t(bt)
    (gt,) = torch.autograd.grad(Jt, bt)
    Jj, gj = jax.value_and_grad(f_j)(jnp.asarray(b))
    assert abs(Jt.item() - float(Jj)) <= 1e-10 * abs(float(Jj))
    assert _rel(gt.numpy(), gj) <= 1e-10


# -- (c) the static walk ---------------------------------------------------------------

#: Names of glimslib_tpu that the port leaves out on purpose, by reason.
LEFT_OUT = {
    # TPU layouts: the lane-major (cell axis on the 128-wide lanes) applies
    # and tables; the port keeps no TPU-only structure
    "ops.bell.transpose_tables_T": "TPU layout",
    "ops.bell.from_kernel_layout": "TPU layout",
    "ops.bell.bell_T_available": "TPU layout",
    "ops.bell.apply_bell_vector_T": "TPU layout",
    "ops.bell.apply_bell_scalar_T": "TPU layout",
    "ops.bell.apply_bell_coupling_T": "TPU layout",
    "ops.bell.apply_supernode_jacobi_T": "TPU layout",
    "solvers.twolevel.AggPlan.restrict_T": "TPU layout",
    "solvers.twolevel.AggPlan.prolong_T": "TPU layout",
    "solvers.twolevel.AggPlan.restrict_scalar_T": "TPU layout",
    "solvers.twolevel.AggPlan.prolong_scalar_T": "TPU layout",
    # jit-argument threading: plan tables passed as jit arguments, for the
    # remote compile's payload limit
    "ops.bell.BellPlan.tables": "jit-argument threading",
    "ops.bell.BellPlan.tables_from_theta": "jit-argument threading",
    # the Pallas modules: their kernels are csrc/*.cu behind ops/*_kernels.py
    "ops.stencil_pallas": "Pallas module",
    "ops.pallas_cg": "Pallas module",
    "ops.bell_pallas": "Pallas module",
    # JAX's dtype switches: a port model takes its dtype as an argument
    "config.default_dtype": "JAX dtype switch",
    "config.enable_x64": "JAX dtype switch",
    "config.get_default_dtype": "JAX dtype switch",
    # pandas: OptimizationProgress.to_columns returns numpy columns
    "optimize.lbfgsb.OptimizationProgress.to_dataframe": "pandas",
}


def _public_names(path):
    """(name, None) for every public top-level def, class and assignment
    of a module, (class, method) for every public method."""
    out = []
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            if node.name.startswith("_"):
                continue
            out.append((node.name, None))
            if isinstance(node, ast.ClassDef):
                out += [(node.name, m.name) for m in node.body
                        if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
                        and not m.name.startswith("_")]
        targets = (node.targets if isinstance(node, ast.Assign)
                   else [node.target] if isinstance(node, ast.AnnAssign) else [])
        out += [(t.id, None) for t in targets
                if isinstance(t, ast.Name) and not t.id.startswith("_")]
    return out


def test_every_public_name_is_ported_or_left_out_with_a_reason():
    root = REPO / "glimslib_tpu"
    missing, seen = [], set()
    for path in sorted(root.rglob("*.py")):
        parts = path.relative_to(root).with_suffix("").parts
        rel = ".".join(parts[:-1] if parts[-1] == "__init__" else parts)
        if rel in LEFT_OUT:
            seen.add(rel)
            continue
        mod = importlib.import_module("glimslib_tpu_torch" + ("." + rel if rel else ""))
        for name, member in _public_names(path):
            key = ".".join(p for p in (rel, name, member) if p)
            if key in LEFT_OUT:
                seen.add(key)
                continue
            if not hasattr(mod, name) or (member is not None
                                          and not hasattr(getattr(mod, name), member)):
                missing.append(key)
    assert not missing, f"not in glimslib_tpu_torch: {missing}"
    # a name that the port gains, or the JAX package loses, leaves the list
    assert seen == set(LEFT_OUT), sorted(set(LEFT_OUT) - seen)


def test_simulation_stubs_and_adjoint_logger():
    from glimslib_tpu_torch.core.results import _ORBAX
    from glimslib_tpu_torch.examples import rect_sim
    from glimslib_tpu_torch.models.base import Simulation
    from glimslib_tpu_torch.optimize import adjoint

    assert adjoint.logger.name == "glimslib_tpu_torch.optimize.adjoint"
    sim = rect_sim(n=4, dtype=torch.float64, device="cpu")
    with pytest.raises(NotImplementedError, match="Orbax"):
        sim.reload_from_orbax("checkpoint")
    assert str(_ORBAX) and Simulation.run_for_adjoint is not type(sim).run_for_adjoint
    with pytest.raises(NotImplementedError):
        Simulation.run_for_adjoint(sim, {})
