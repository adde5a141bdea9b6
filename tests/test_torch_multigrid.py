"""Port parity of geometric multigrid (glimslib_tpu_torch/solvers/multigrid.py)
against the JAX package's (glimslib_tpu/solvers/multigrid.py), at f64 on
the CPU, where every level apply runs the stencil kernel's plain version.

Inputs are made with numpy from a seed and fed to both packages.
Tolerances: the grid transfers, the injected masks and the restriction
tables equal exactly; restrict_cell_coeff, the built per-level data and
one V-cycle rel 1e-12 (the same sums in another order); a gradient of a
functional of the V-cycle with respect to a per-cell mu rel 1e-10.  The
JAX test's own claims (tests/test_multigrid.py) hold on the port: the
V-cycle symmetric to rel 1e-10, the same solution as (block-)Jacobi PCG
to rel 1e-8, and its iteration bounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glimslib_tpu.core.mesh import box_mesh as jax_box_mesh
from glimslib_tpu.core.mesh import rectangle_mesh as jax_rectangle_mesh
from glimslib_tpu.solvers import multigrid as jmg
from glimslib_tpu_torch.core.mesh import box_mesh, rectangle_mesh
from glimslib_tpu_torch.ops.stencil import StencilOperators
from glimslib_tpu_torch.solvers import multigrid as mg
from glimslib_tpu_torch.solvers.cg import pcg
from torch_threads import one_torch_thread  # noqa: E402,F401

F64 = torch.float64


def _rel(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


def _meshes(kind, n=None):
    if kind == "tri":
        return (rectangle_mesh((0, 0), (2, 1), 8, 8),
                jax_rectangle_mesh((0, 0), (2, 1), 8, 8))
    n = n or 4
    return (box_mesh((0, 0, 0), (1, 1, 1), n, n, n),
            jax_box_mesh((0, 0, 0), (1, 1, 1), n, n, n))


@pytest.mark.parametrize("kind", ["tri", "tet"])
def test_transfers_and_tables_equal_jax(kind):
    """prolong, restrict (and their adjointness), inject_mask, the
    restriction tables and restrict_cell_coeff on tri 8x8 and tet 4^3."""
    mt, mj = _meshes(kind)
    h = mg.LatticeHierarchy(mt, dtype=F64, device="cpu")
    hj = jmg.LatticeHierarchy(mj, dtype=jnp.float64)
    assert h.usable and h.n_levels == hj.n_levels and h.shapes == hj.shapes
    for lv in range(h.n_levels - 1):
        np.testing.assert_array_equal(h.tables[lv], hj.tables[lv])
        np.testing.assert_array_equal(h.meshes[lv + 1].points, hj.meshes[lv + 1].points)
        np.testing.assert_array_equal(h.meshes[lv + 1].cells, hj.meshes[lv + 1].cells)
    rng = np.random.default_rng(0)
    nc, nf = h.meshes[1].n_nodes, mt.n_nodes
    for comp in ((), (2,)):
        xc = rng.standard_normal((nc,) + comp)
        yf = rng.standard_normal((nf,) + comp)
        p = mg.prolong(_t(xc), h.shapes[1], h.ndim)
        r = mg.restrict(_t(yf), h.shapes[0], h.ndim)
        np.testing.assert_array_equal(p.numpy(), np.asarray(
            jmg.prolong(jnp.asarray(xc), hj.shapes[1], hj.ndim)))
        np.testing.assert_array_equal(r.numpy(), np.asarray(
            jmg.restrict(jnp.asarray(yf), hj.shapes[0], hj.ndim)))
        lhs, rhs = float((p * _t(yf)).sum()), float((_t(xc) * r).sum())
        assert np.isclose(lhs, rhs, rtol=1e-12), (lhs, rhs)
    mask = rng.random((nf, mt.dim)) < 0.3
    want = np.asarray(jmg.inject_mask(mask, hj.shapes[0], hj.ndim))
    np.testing.assert_array_equal(mg.inject_mask(mask, h.shapes[0], h.ndim), want)
    np.testing.assert_array_equal(
        mg.inject_mask(torch.as_tensor(mask), h.shapes[0], h.ndim).numpy(), want)
    coeff = rng.random(mt.n_cells)
    got = mg.restrict_cell_coeff(_t(coeff), h.tables[0]).numpy()
    assert _rel(got, jmg.restrict_cell_coeff(jnp.asarray(coeff), hj.tables[0])) <= 1e-12
    assert mg.restrict_cell_coeff(2.5, h.tables[0]) == 2.5


def _mask(mesh, d=None):
    m = np.zeros((mesh.n_nodes,) + ((d,) if d else ()), dtype=bool)
    m[mesh.boundary_nodes] = True
    return m


def _pair(kind, mt, mj, mask):
    """(port MG, JAX MG, build args for each)."""
    ht = mg.LatticeHierarchy(mt, dtype=F64, device="cpu")
    hj = jmg.LatticeHierarchy(mj, dtype=jnp.float64)
    rng = np.random.default_rng(5)
    if kind == "elasticity":
        mu = 100.0 + 300.0 * rng.random(mt.n_cells)
        lam = 3.0 * mu
        return (mg.MGElasticity(ht, mask), jmg.MGElasticity(hj, jnp.asarray(mask)),
                (_t(mu), _t(lam)), (jnp.asarray(mu), jnp.asarray(lam)))
    D = 0.5 + rng.random(mt.n_cells)
    rho = 0.1 * rng.random(mt.n_cells)
    return (mg.MGScalar(ht, mask), jmg.MGScalar(hj, jnp.asarray(mask)),
            (_t(D), _t(rho), 1.0), (jnp.asarray(D), jnp.asarray(rho), 1.0))


@pytest.mark.parametrize("kind", ["scalar", "elasticity"])
@pytest.mark.parametrize("n", [4, 8])
def test_build_and_apply_equal_jax(kind, n):
    """Per-level data (planes, Binv / diag, Cinv or lmax) and one V-cycle
    on the 4^3 box (2 levels) and the 8^3 box (3 levels) with heterogeneous
    per-cell coefficients, clamped (elasticity) or unmasked (scalar)."""
    mt, mj = _meshes("tet", n)
    mask = _mask(mt, 3) if kind == "elasticity" else np.zeros(mt.n_nodes, dtype=bool)
    mgt, mgj, args_t, args_j = _pair(kind, mt, mj, mask)
    data = mgt.build(*args_t)
    data_j = jax.jit(lambda: mgj.build(*args_j))()
    assert len(data) == len(data_j) == mgt.h.n_levels
    for lv, (d, dj) in enumerate(zip(data, data_j)):
        assert sorted(d) == sorted(dj), (lv, sorted(d), sorted(dj))
        for k in d:
            assert _rel(d[k], dj[k]) <= 1e-12, (lv, k, _rel(d[k], dj[k]))
    assert "Cinv" in data[-1]
    rng = np.random.default_rng(9)
    r = np.where(mask, 0.0, rng.standard_normal(mask.shape))
    got = mgt.apply(data, _t(r)).numpy()
    want = np.asarray(jax.jit(lambda r: mgj.apply(data_j, r))(jnp.asarray(r)))
    assert _rel(got, want) <= 1e-12, _rel(got, want)


def _elasticity_setup(n):
    mesh = box_mesh((0, 0, 0), (1, 1, 1), n, n, n)
    h = mg.LatticeHierarchy(mesh, dtype=F64, device="cpu")
    mask = torch.as_tensor(_mask(mesh, 3))
    E, nu = 1000.0, 0.45
    mu = E / (2 * (1 + nu))
    lam = E * nu / ((1 + nu) * (1 - 2 * nu))
    ops = StencilOperators(mesh, dtype=F64)
    W = ops.build_elasticity(mu, lam)

    def A(v):
        return torch.where(mask, v, ops.apply_vector(W, torch.where(mask, 0.0, v)))

    rng = np.random.default_rng(1)
    b = torch.where(mask, 0.0, _t(rng.standard_normal((mesh.n_nodes, 3))))
    return mesh, h, ops, W, A, b, mask, mu, lam


def test_mg_elasticity_symmetric_and_correct():
    """tests/test_multigrid.py:57-92 on the port (8^3, nu = 0.45, clamped):
    the V-cycle is symmetric, MG-PCG reaches block-Jacobi PCG's solution,
    in at most 1.2x its iterations + 5."""
    mesh, h, ops, W, A, b, mask, mu, lam = _elasticity_setup(8)
    mgt = mg.MGElasticity(h, mask)
    data = mgt.build(_t(mu), _t(lam))

    def M(r):
        return mgt.apply(data, r)

    rng = np.random.default_rng(2)
    r1 = torch.where(mask, 0.0, _t(rng.standard_normal(b.shape)))
    r2 = torch.where(mask, 0.0, _t(rng.standard_normal(b.shape)))
    s12, s21 = float((M(r1) * r2).sum()), float((r1 * M(r2)).sum())
    assert np.isclose(s12, s21, rtol=1e-10), (s12, s21)

    Binv = ops.block_jacobi_inverse(W, mask=mask)

    def Mbj(r):
        return torch.where(mask, r, ops.apply_block_jacobi(Binv, torch.where(mask, 0.0, r)))

    x_bj, info_bj = pcg(A, b, M=Mbj, rtol=1e-10, maxiter=2000)
    x_mg, info_mg = pcg(A, b, M=M, rtol=1e-10, maxiter=2000)
    it_bj, it_mg = int(info_bj["iters"]), int(info_mg["iters"])
    assert _rel(x_mg, x_bj) < 1e-8
    assert it_mg <= int(1.2 * it_bj) + 5, (it_mg, it_bj)


def test_mg_scalar_fast():
    """tests/test_multigrid.py:95-122 on the port: the stiffness-dominated
    scalar block (16^3, D = 5, rho = 0.1, dt = 1) reaches Jacobi PCG's
    solution in at most a third of its iterations."""
    mesh = box_mesh((0, 0, 0), (1, 1, 1), 16, 16, 16)
    h = mg.LatticeHierarchy(mesh, dtype=F64, device="cpu")
    assert h.n_levels == 4
    mask = torch.zeros(mesh.n_nodes, dtype=torch.bool)
    ops = StencilOperators(mesh, dtype=F64)
    D, rho, dt = 5.0, 0.1, 1.0
    W = ops.build_rd_jacobian_const(D, rho, dt)
    diag = W[ops.offsets.index(0)]
    rng = np.random.default_rng(3)
    b = _t(rng.standard_normal(mesh.n_nodes))
    mgt = mg.MGScalar(h, mask)
    data = mgt.build(D, rho, dt)

    def A(v):
        return ops.apply_scalar(W, v)

    x_j, info_j = pcg(A, b, M=lambda r: r / diag, rtol=1e-10, maxiter=2000)
    x_m, info_m = pcg(A, b, M=lambda r: mgt.apply(data, r), rtol=1e-10, maxiter=2000)
    assert _rel(x_m, x_j) < 1e-8
    assert int(info_m["iters"]) * 3 <= int(info_j["iters"]), (
        int(info_m["iters"]), int(info_j["iters"]))


def test_mg_heterogeneous_coefficients():
    """tests/test_multigrid.py:125-153 on the port: per-cell (tissue)
    coefficients restrict through the hierarchy, and MG-PCG converges
    (residual rel 1e-9) in under 60 iterations."""
    mesh = box_mesh((0, 0, 0), (1, 1, 1), 8, 8, 8)
    h = mg.LatticeHierarchy(mesh, dtype=F64, device="cpu")
    rng = np.random.default_rng(4)
    mu = _t(np.where(mesh.cell_midpoints[:, 0] < 0.5, 100.0, 400.0))
    lam = 3.0 * mu
    mask = torch.as_tensor(_mask(mesh, 3))
    ops = StencilOperators(mesh, dtype=F64)
    W = ops.build_elasticity(mu, lam)

    def A(v):
        return torch.where(mask, v, ops.apply_vector(W, torch.where(mask, 0.0, v)))

    b = torch.where(mask, 0.0, _t(rng.standard_normal((mesh.n_nodes, 3))))
    mgt = mg.MGElasticity(h, mask)
    data = mgt.build(mu, lam)
    x, info = pcg(A, b, M=lambda r: mgt.apply(data, r), rtol=1e-10, maxiter=500)
    assert float((b - A(x)).norm() / b.norm()) < 1e-9
    assert int(info["iters"]) < 60


def test_plain_route_equals_the_wrappers():
    """plain=True (every level apply the plain version) gives the wrappers'
    result bit for bit on the CPU, where the wrappers run the plain
    version too."""
    mt, mj = _meshes("tet", 8)
    mask = _mask(mt, 3)
    mgt, _, args_t, _ = _pair("elasticity", mt, mj, mask)
    plain = mg.MGElasticity(mgt.h, mask, plain=True)
    r = _t(np.where(mask, 0.0, np.random.default_rng(1).standard_normal(mask.shape)))
    a = mgt.apply(mgt.build(*args_t), r)
    b = plain.apply(plain.build(*args_t), r)
    assert torch.equal(a, b)


def test_gradient_wrt_cell_mu_equals_jax(monkeypatch):
    """d/dmu of sum(w * V-cycle(r)) with a per-cell mu (the 4^3 box, 2
    levels, the dense coarse inverse's columns on the path) equals
    jax.grad's to rel 1e-10.

    jax.grad runs eagerly over the JAX hierarchy with its level operators
    and grid transfers jitted one by one: jitting the whole gradient takes
    XLA minutes to compile on the CPU, and the eager gradient with every
    primitive dispatched alone over a minute; jit changes no value."""
    mt, mj = _meshes("tet", 4)
    mask = _mask(mt, 3)
    rng = np.random.default_rng(6)
    mu = 100.0 + 300.0 * rng.random(mt.n_cells)
    r = np.where(mask, 0.0, rng.standard_normal(mask.shape))
    w = rng.standard_normal(mask.shape)
    mgt = mg.MGElasticity(mg.LatticeHierarchy(mt, dtype=F64, device="cpu"), mask)
    hj = jmg.LatticeHierarchy(mj, dtype=jnp.float64)
    for ops in hj.ops:
        for name in ("apply_vector", "apply_block_jacobi", "build_elasticity",
                     "block_jacobi_inverse"):
            setattr(ops, name, jax.jit(getattr(ops, name)))
    monkeypatch.setattr(jmg, "restrict", jax.jit(jmg.restrict, static_argnums=(1, 2)))
    monkeypatch.setattr(jmg, "prolong", jax.jit(jmg.prolong, static_argnums=(1, 2)))
    mgj = jmg.MGElasticity(hj, jnp.asarray(mask))

    mu_t = _t(mu).requires_grad_(True)
    J = (_t(w) * mgt.apply(mgt.build(mu_t, 3.0 * mu_t), _t(r))).sum()
    (g,) = torch.autograd.grad(J, mu_t)

    def fj(m):
        return jnp.sum(jnp.asarray(w) * mgj.apply(mgj.build(m, 3.0 * m), jnp.asarray(r)))

    gj = jax.grad(fj)(jnp.asarray(mu))
    assert np.abs(g.numpy()).max() > 0
    assert _rel(g.numpy(), gj) <= 1e-10, _rel(g.numpy(), gj)
