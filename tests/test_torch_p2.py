"""Port parity of the P2 (quad) building blocks: the interleaved P2 dof
layout, the quadrature kernels (``glimslib_tpu_torch/ops/p2.py``), the
P2 function space and Dirichlet conditions, the P2 supernode plan and
its assembled rd Jacobian (``ops/p2_ell.py``) and the factored P2
channels (``ops/bell_factored.py``), against the JAX package at f64 on
the CPU.

Tolerances: the layout and the plan's tables (at the port's flat halo,
``GLIMS_P2_HALO_CHUNK=1`` on the JAX side) equal exactly; kernels,
Jacobians and planes within rel 1e-12 (re-associated sums); the L2
projection within 1e-10 of the JAX package's and 1e-8 of a scipy direct
mass solve.  The P2 path reaches no Pallas kernel but the batched matvec,
which runs its plain fallback on the CPU on both sides.
"""

import math
import os
import sys

import numpy as np
import pytest
import jax.numpy as jnp
import scipy.sparse.linalg as spla
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from glimslib_tpu.core.mesh import Mesh as JaxMesh  # noqa: E402
from glimslib_tpu.core.mesh import box_mesh as jax_box_mesh  # noqa: E402
from glimslib_tpu.core.mesh import rectangle_mesh as jax_rectangle_mesh  # noqa: E402
from glimslib_tpu.ops import bell as jax_bell  # noqa: E402
from glimslib_tpu.ops import bell_factored as jax_bell_factored  # noqa: E402
from glimslib_tpu.ops import p2_ell as jax_p2_ell  # noqa: E402
from glimslib_tpu.ops.p2 import P2Kernels as JaxP2Kernels  # noqa: E402
from glimslib_tpu.ops.p2 import p2_dof_layout as jax_p2_dof_layout  # noqa: E402
from glimslib_tpu_torch.core.elements import P1Element, simplex_quadrature  # noqa: E402
from glimslib_tpu_torch.core.mesh import Mesh, box_mesh, rectangle_mesh  # noqa: E402
from glimslib_tpu_torch.ops import bell, bell_factored, p2_ell  # noqa: E402
from glimslib_tpu_torch.ops.p2 import P2Kernels, p2_dof_layout  # noqa: E402

from reference_fem import ReferenceFEMP2  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401


def _rel(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


def _meshes(kind):
    """(port mesh, JAX mesh): the Morton box n=4 or the lattice-stripped
    Morton 6 x 6 rectangle."""
    if kind == "tet":
        mt, mj = box_mesh((0, 0, 0), (1, 1, 1), 4, 4, 4), jax_box_mesh(
            (0, 0, 0), (1, 1, 1), 4, 4, 4)
    else:
        mt, mj = rectangle_mesh((0, 0), (2, 1), 6, 6), jax_rectangle_mesh(
            (0, 0), (2, 1), 6, 6)
    return (Mesh.from_arrays(mt.points, mt.cells).reordered_morton(),
            JaxMesh.from_arrays(mj.points, mj.cells).reordered_morton())


def _kernels(kind):
    mt, mj = _meshes(kind)
    return P2Kernels(mt), JaxP2Kernels(mj, dtype=jnp.float64), mt


def _coefs(mesh):
    mids = np.asarray(mesh.cell_midpoints)
    return 0.05 + 0.02 * mids[:, 0], 0.1 + 0.05 * mids[:, 1]


KINDS = ["tet", "tri"]


@pytest.mark.parametrize("kind", KINDS)
def test_dof_layout_equals_jax(kind):
    """perm and rank of the interleaved layout, the dof coordinates and
    the cell connectivity equal the JAX package's exactly."""
    mt, mj = _meshes(kind)
    got, want = p2_dof_layout(mt), jax_p2_dof_layout(mj)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]
    kt, kj = P2Kernels(mt), JaxP2Kernels(mj, dtype=jnp.float64)
    np.testing.assert_array_equal(kt.cell_dofs, np.asarray(kj.cell_dofs))
    np.testing.assert_array_equal(kt.dof_coords, kj.dof_coords)
    np.testing.assert_array_equal(kt.vertex_ids.numpy(), np.asarray(kj.vertex_ids))
    assert p2_dof_layout(mt) is got  # cached on the mesh


@pytest.mark.parametrize("s", [16, 64])
@pytest.mark.parametrize("kind", KINDS)
def test_p2_plan_tables_equal_jax(monkeypatch, kind, s):
    """The P2 supernode plan's halo, placement and both pull tables equal
    the JAX package's exactly at the port's flat halo."""
    monkeypatch.setenv("GLIMS_P2_HALO_CHUNK", "1")
    kt, kj, _ = _kernels(kind)
    pt, pj = p2_ell.make_p2_plan(kt, s=s), jax_p2_ell.make_p2_plan(kj, s=s)
    assert (pt.nb, pt.s, pt.Kh, pt.n, pt.prefix) == (pj.nb, pj.s, pj.Kh, pj.n, pj.prefix)
    np.testing.assert_array_equal(pt.ext_ids, pj.ext_ids)
    np.testing.assert_array_equal(pt.place, pj.place)
    np.testing.assert_array_equal(pt.diag_plan.pull_table, pj.diag_plan.pull_table)
    np.testing.assert_array_equal(pt.off_plan.pull_table, pj.off_plan.pull_table)


_KERNEL_FNS = ["rd_residual", "mass_residual", "rd_mass_stiffness_diag",
               "cell_integral", "integrate", "project_rhs", "mass_diag",
               "lumped_mass"]


@pytest.mark.parametrize("fn", _KERNEL_FNS)
@pytest.mark.parametrize("kind", KINDS)
def test_kernels_equal_jax(kind, fn):
    """Every P2 kernel against the JAX package's, per-cell D and rho,
    rel-L2 <= 1e-12."""
    kt, kj, mesh = _kernels(kind)
    rng = np.random.default_rng(3)
    c, cp = rng.random(kt.n_dofs), rng.random(kt.n_dofs)
    D, rho = _coefs(mesh)
    T, J = torch.as_tensor, jnp.asarray
    f = lambda x: np.sin(x[:, 0]) + x[:, 1] ** 2  # noqa: E731
    got, want = {
        "rd_residual": lambda: (
            kt.rd_residual(T(c), T(cp), T(D), T(rho), 0.7, source=0.2),
            kj.rd_residual(J(c), J(cp), J(D), J(rho), 0.7, source=0.2)),
        "mass_residual": lambda: (kt.mass_residual(T(c)), kj.mass_residual(J(c))),
        "rd_mass_stiffness_diag": lambda: (
            kt.rd_mass_stiffness_diag(T(D), T(rho), 0.7),
            kj.rd_mass_stiffness_diag(J(D), J(rho), 0.7)),
        "cell_integral": lambda: (kt.cell_integral(T(c)), kj.cell_integral(J(c))),
        "integrate": lambda: (kt.integrate(T(c)), kj.integrate(J(c))),
        "project_rhs": lambda: (kt.project_rhs(f), kj.project_rhs(f)),
        "mass_diag": lambda: (kt.mass_diag(), kj.mass_diag()),
        "lumped_mass": lambda: (kt.lumped_mass(), kj.lumped_mass()),
    }[fn]()
    assert _rel(got, want) <= 1e-12, _rel(got, want)


def _exact(mesh, integrand, degree):
    """∫ integrand(x) dx over the mesh by a degree-``degree`` rule."""
    qp, qw = simplex_quadrature(mesh.dim, degree)
    p1v, _ = P1Element(mesh.dim).tabulate(qp)
    xq = np.matmul(p1v, mesh.points[mesh.cells])  # (nc, nq, d)
    detJ = mesh.cell_volumes * math.factorial(mesh.dim)
    return float(np.sum(detJ[:, None] * qw[None, :] * integrand(xq)))


_QUAD_MESHES = {"tri": lambda: rectangle_mesh((0, 0), (2, 1), 5, 4),
                "tet": lambda: box_mesh((0, 0, 0), (1, 1, 2), 2, 2, 3)}


@pytest.mark.parametrize("kind", ["tri", "tet"])
def test_mass_exact_on_quadratics(kind):
    """g·M f = ∫ x² · x y dx for f = x², g = x y (both in P2): the port's
    counterpart of the reference's test_p2.py:22-49."""
    mesh = _QUAD_MESHES[kind]()
    k = P2Kernels(mesh)
    X = k.dof_coords
    got = float(torch.as_tensor(X[:, 0] * X[:, 1]) @ k.mass_residual(
        torch.as_tensor(X[:, 0] ** 2)))
    want = _exact(mesh, lambda x: x[..., 0] ** 3 * x[..., 1], 8)
    assert np.isclose(got, want, rtol=1e-12)


@pytest.mark.parametrize("kind", ["tri", "tet"])
def test_stiffness_exact_on_quadratics(kind):
    """g·K f = ∫ ∇(x²)·∇(x² + y²) = ∫ 4 x² dx (rd_residual with D = dt =
    1, rho = 0, c_prev = c): test_p2.py:52-73's counterpart."""
    mesh = _QUAD_MESHES[kind]()
    k = P2Kernels(mesh)
    X = k.dof_coords
    f = torch.as_tensor(X[:, 0] ** 2)
    got = float(torch.as_tensor(X[:, 0] ** 2 + X[:, 1] ** 2) @ k.rd_residual(
        f, f, 1.0, 0.0, 1.0))
    want = _exact(mesh, lambda x: 4.0 * x[..., 0] ** 2, 6)
    assert np.isclose(got, want, rtol=1e-12)


def test_cell_integral_and_total():
    """∫ (1 + x) over the unit square is 1.5; a constant integrates to the
    cell volumes (test_p2.py:76-84's counterpart)."""
    mesh = rectangle_mesh((0, 0), (1, 1), 4, 4)
    k = P2Kernels(mesh)
    assert np.isclose(float(k.integrate(torch.as_tensor(1.0 + k.dof_coords[:, 0]))),
                      1.5, rtol=1e-13)
    np.testing.assert_allclose(k.cell_integral(torch.ones(k.n_dofs)).numpy(),
                               mesh.cell_volumes, rtol=1e-13)


def _quad_sim(mesh, port):
    """The quad TumorGrowth on ``mesh`` with the boundary named (no
    model parameters): the function space and boundary conditions."""
    from glimslib_tpu.models.tumor_growth_quad import TumorGrowth as JaxQuad
    from glimslib_tpu_torch.models.tumor_growth_quad import TumorGrowth

    class Boundary:
        def inside(self, x, on_boundary):
            return on_boundary

    sim = TumorGrowth(mesh, dtype=torch.float64, device="cpu") if port else JaxQuad(mesh)
    sim.setup_global_parameters(
        boundaries={"boundary_all": Boundary()},
        dirichlet_bcs={"conc_wall": {"bc_value": 0.25, "named_boundary": "boundary_all",
                                     "subspace_id": 1}})
    return sim


def test_l2_projection_equals_jax_and_scipy():
    """The P2 L2 projection of a cubic (not in P2) equals the JAX
    package's to 1e-10 and a scipy direct mass solve to 1e-8, and differs
    from the nodal interpolant (test_p2_parity.py:169's counterpart)."""
    m = rectangle_mesh((0, 0), (2, 1), 7, 5)
    mt = Mesh.from_arrays(m.points, m.cells)  # the port's quad models: no lattice
    mj = jax_rectangle_mesh((0, 0), (2, 1), 7, 5)
    f = lambda x: x[:, 0] ** 3 + x[:, 1] ** 2 - 0.5 * x[:, 0] * x[:, 1]  # noqa: E731
    st, sj = _quad_sim(mt, True), _quad_sim(mj, False)
    got = st.functionspace.project(f, 1)
    assert _rel(got, sj.functionspace.project(f, 1)) <= 1e-10

    ref = ReferenceFEMP2(mt)
    M = ref.mass_matrix2()
    lam = np.concatenate([(1 - ref.qp2.sum(axis=1))[:, None], ref.qp2], axis=1)
    xq = np.matmul(lam, mt.points[mt.cells])
    fq = f(xq.reshape(-1, 2)).reshape(mt.n_cells, -1)
    b = np.zeros(ref.n_dofs2)
    np.add.at(b, ref.cell_dofs2.ravel(),
              ((ref.detJ[:, None] * fq * ref.qw2) @ ref.vals2).ravel())
    want = spla.spsolve(M.tocsc(), b)
    canon = got[st.p2.dof_rank]
    assert _rel(canon, want) < 1e-8
    assert _rel(want, f(ref.dof_coords2)) > 1e-6


def test_p2_vector_projection():
    """A P2 vector subspace projects one scalar mass system a component: a
    field in the space reproduces its interpolant."""
    from glimslib_tpu_torch.core.functionspace import FunctionSpace

    fs = FunctionSpace(rectangle_mesh((0, 0), (1, 1), 3, 3))
    fs.init_function_space([(1, 2)], {0: "displacement"})
    coords = fs.dof_coordinates(0)
    f = lambda x: np.stack([x[:, 0] ** 2 + 2.0 * x[:, 1],  # noqa: E731
                            3.0 * x[:, 0] - x[:, 1] ** 2], axis=1)
    np.testing.assert_allclose(fs.project(f, 0), f(coords), rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(fs.project(np.zeros(2), 0), 0.0, atol=1e-12)


@pytest.mark.parametrize("kind", KINDS)
def test_p2_dirichlet_mask_equals_jax(kind):
    """Dirichlet on the P2 concentration constrains every boundary
    vertex dof and every boundary-facet edge dof: mask and values equal
    the JAX package's exactly."""
    mt, mj = _meshes(kind)
    st, sj = _quad_sim(mt, True), _quad_sim(mj, False)
    mask_t, val_t = st.bcs.dirichlet_mask_and_values(1)
    mask_j, val_j = sj.bcs.dirichlet_mask_and_values(1)
    np.testing.assert_array_equal(mask_t, np.asarray(mask_j))
    np.testing.assert_array_equal(val_t, np.asarray(val_j))
    canon = mask_t[st.p2.dof_rank]
    fvs = mt.boundary_facet_nodes
    if mt.dim == 3:
        fvs = np.concatenate([fvs[:, [0, 1]], fvs[:, [0, 2]], fvs[:, [1, 2]]])
    n_edges = len(np.unique(mt.edge_ids_for_pairs(fvs)))
    assert canon[: mt.n_nodes].sum() == len(mt.boundary_nodes)
    assert canon[mt.n_nodes:].sum() == n_edges > 0


@pytest.fixture
def plan_setup(monkeypatch):
    """The tet kernels on both sides, their P2 plans at s=16 (flat halo)
    and per-cell D, rho."""
    monkeypatch.setenv("GLIMS_P2_HALO_CHUNK", "1")
    kt, kj, mesh = _kernels("tet")
    D, rho = _coefs(mesh)
    return dict(kt=kt, kj=kj, mesh=mesh, pt=p2_ell.make_p2_plan(kt, s=16),
                pj=jax_p2_ell.make_p2_plan(kj, s=16), D=D, rho=rho)


def test_jacobian_matches_jvp_and_jax(plan_setup):
    """The assembled exact P2 rd Jacobian's matvec equals torch.func.jvp
    of rd_residual and the JAX package's assembled matvec, rel 1e-12
    (test_p2_ell.py:28's counterpart)."""
    S = plan_setup
    kt, pt = S["kt"], S["pt"]
    rng = np.random.default_rng(3)
    c, v, cp = (rng.random(kt.n_dofs), rng.standard_normal(kt.n_dofs),
                rng.random(kt.n_dofs))
    T = torch.as_tensor
    D, rho = T(S["D"]), T(S["rho"])
    _, want = torch.func.jvp(
        lambda cc: kt.rd_residual(cc, T(cp), D, rho, 0.7, source=0.2), (T(c),), (T(v),))
    W = p2_ell.build_p2_rd_const(pt, kt, D, rho, 0.7) + p2_ell.build_p2_rd_wc(
        pt, kt, T(c), rho, 0.7, 1.0)
    got = bell.apply_bell_scalar(pt, W, T(v))
    assert _rel(got, want) <= 1e-12, _rel(got, want)

    kj, pj, J = S["kj"], S["pj"], jnp.asarray
    Wj = jax_p2_ell.build_p2_rd_const(pj, kj, J(S["D"]), J(S["rho"]), 0.7, jnp.float64)
    Wj = Wj + jax_p2_ell.build_p2_rd_wc(pj, kj, J(c), J(S["rho"]), 0.7, 1.0, jnp.float64)
    np.testing.assert_array_equal(W.shape, Wj.shape)
    assert _rel(W, Wj) <= 1e-12
    yj = jax_bell.apply_bell_scalar(pj, pj.tables()["_P2BHalo"], Wj, J(v))
    assert _rel(got, yj) <= 1e-12


def test_lumped_chord_is_row_sum(plan_setup):
    """The chord operator's lumped diagonal is the row sums of the exact
    logistic correction and equals the JAX package's (test_p2_ell.py:50)."""
    S = plan_setup
    kt, pt = S["kt"], S["pt"]
    c = torch.as_tensor(np.random.default_rng(5).random(kt.n_dofs))
    Wc = p2_ell.build_p2_rd_wc(pt, kt, c, 0.3, 0.5, 1.0)
    rowsum = bell.apply_bell_scalar(pt, Wc, torch.ones(kt.n_dofs, dtype=torch.float64))
    dl = p2_ell.build_p2_rd_wc_lumped(kt, c, 0.3, 0.5, 1.0)
    assert _rel(dl, rowsum) <= 1e-12
    want = jax_p2_ell.build_p2_rd_wc_lumped(S["pj"], S["kj"], jnp.asarray(c.numpy()),
                                            0.3, 0.5, 1.0, jnp.float64)
    assert _rel(dl, want) <= 1e-12


def test_factored_p2_planes_match_dense_and_jax(plan_setup):
    """The factored P2 channels reduced with per-class D, rho equal the
    dense build_p2_rd_const plane (rel 1e-12), and the channels and
    representative cells equal the JAX package's build_p2_cache
    (test_p2_ell.py:192's counterpart)."""
    S = plan_setup
    kt, pt, mesh = S["kt"], S["pt"], S["mesh"]
    labels = (mesh.points[:, 0] > 0.5).astype(np.int64) + 1
    cell_labels = labels[mesh.cells[:, 0]]
    D = np.array([{1: 0.02, 2: 0.1}[int(c)] for c in cell_labels])
    # rho vanishes on class 1 for any parameters: its channel is dropped
    rho = np.array([{1: 0.0, 2: 0.2}[int(c)] for c in cell_labels])
    support = {"rho": {2}}
    T = torch.as_tensor
    want = p2_ell.build_p2_rd_const(pt, kt, T(D), T(rho), 0.7)
    cache = bell_factored.build_p2_cache(pt, kt, cell_labels, support=support)
    assert cache["_FP2Wrd"].shape[0] == 1 + 1 + 2
    got = bell_factored.p2_planes_from_theta(
        {**cache, "D": T(D), "rho": T(rho), "dt": 0.7})
    assert _rel(got, want) <= 1e-12

    cj = jax_bell_factored.build_p2_cache(S["pj"], S["kj"], cell_labels, jnp.float64,
                                          want_mass=False, support=support)
    assert _rel(cache["_FP2Wrd"], cj["_FP2Wrd"]) <= 1e-12
    for k in ("_FP2RhoReps", "_FP2DReps"):
        np.testing.assert_array_equal(cache[k].numpy(), np.asarray(cj[k]))


def test_gradcheck_p2_plane_builders():
    """torch.autograd.gradcheck of the P2 plane builders in their
    coefficients (the dense constant plane in D and rho, the logistic
    correction in c and rho, the lumped chord diagonal in c) and of the
    factored reduction in per-class D and rho, on a 2 x 2 rectangle."""
    k = P2Kernels(rectangle_mesh((0, 0), (1, 1), 2, 2))
    plan = p2_ell.make_p2_plan(k, s=8)
    nc = k.n_cells
    rng = np.random.default_rng(0)
    D = torch.tensor(0.1 + 0.05 * rng.random(nc), requires_grad=True)
    rho = torch.tensor(0.2 + 0.1 * rng.random(nc), requires_grad=True)
    c = torch.tensor(rng.random(k.n_dofs), requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda D, rho: p2_ell.build_p2_rd_const(plan, k, D, rho, 0.7), (D, rho))
    assert torch.autograd.gradcheck(
        lambda c, rho: p2_ell.build_p2_rd_wc(plan, k, c, rho, 0.7, 1.0), (c, rho))
    assert torch.autograd.gradcheck(
        lambda c: p2_ell.build_p2_rd_wc_lumped(k, c, rho.detach(), 0.7, 1.0), (c,))
    labels = np.arange(nc) % 2
    cache = bell_factored.build_p2_cache(plan, k, labels)
    Dt = torch.tensor([0.1, 0.05], dtype=torch.float64, requires_grad=True)
    rt = torch.tensor([0.2, 0.3], dtype=torch.float64, requires_grad=True)
    lab = torch.as_tensor(labels)
    assert torch.autograd.gradcheck(
        lambda Dt, rt: bell_factored.p2_planes_from_theta(
            {**cache, "D": Dt[lab], "rho": rt[lab], "dt": 0.7}), (Dt, rt))
