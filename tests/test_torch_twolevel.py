"""Port parity of the two-level coarse level: ``glimslib_tpu_torch``
``solvers/twolevel.py`` (with ``ops/ell.py``) against ``glimslib_tpu``
``solvers/twolevel.py`` on a small Morton-ordered box at f64.

Mode matrices, Galerkin coarse matrices, the preconditioner B Bᵀ of the
coarse Gram factor and both preconditioner applies agree to 1e-10
relative (the factor itself is defined only up to the eigenvectors'
signs, so B Bᵀ is compared).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from glimslib_tpu.core.mesh import Mesh as JaxMesh, box_mesh as jax_box_mesh
from glimslib_tpu.ops import ell as jell
from glimslib_tpu.ops.assembly import P1Kernels as JaxP1Kernels
from glimslib_tpu.solvers import twolevel as jtl
from glimslib_tpu_torch.core.mesh import Mesh, box_mesh
from glimslib_tpu_torch.ops import ell
from glimslib_tpu_torch.ops.assembly import P1Kernels
from glimslib_tpu_torch.solvers import twolevel as tl

AGG = 16


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


@pytest.fixture(scope="module")
def setup():
    mj = jax_box_mesh((0, 0, 0), (1, 1, 1), 5, 5, 5)
    mt = box_mesh((0, 0, 0), (1, 1, 1), 5, 5, 5)
    mesh_j = JaxMesh.from_arrays(mj.points, mj.cells).reordered_morton()
    mesh_t = Mesh.from_arrays(mt.points, mt.cells).reordered_morton()
    n = mesh_t.n_nodes
    rng = np.random.default_rng(1)
    mu = 1.0 + rng.random(mesh_t.n_cells)
    lam = 5.0 + rng.random(mesh_t.n_cells)
    D = 0.1 * (1.0 + rng.random(mesh_t.n_cells))
    mask = np.zeros((n, 3), bool)
    mask[mesh_t.boundary_nodes] = True

    kj = JaxP1Kernels(mesh_j, dtype=jnp.float64)
    ej = jell.EllPlan(mesh_j)
    aj = jtl.AggPlan(mesh_j, agg_size=AGG)
    Bj = jell.build_ell_elasticity(ej, (kj.grads_T, kj.vol), mu, lam, jnp.float64)
    Wj = jell.build_ell_rd_const(ej, (kj.grads_T, kj.vol), D, 0.1, 1.0,
                                 kj._m0, jnp.float64)
    Acj = jtl.build_coarse(aj, jnp.asarray(ej.adj), Bj, jnp.asarray(mask))
    Acsj = jtl.build_coarse_scalar(aj, jnp.asarray(ej.adj), Wj,
                                   jnp.asarray(mask[:, 0]))

    kt = P1Kernels(mesh_t, dtype=torch.float64)
    et = ell.EllPlan(mesh_t)
    at = tl.AggPlan(mesh_t, agg_size=AGG)
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)  # noqa: E731
    Bt = ell.build_ell_elasticity(et, (kt.grads_T, kt.vol), t(mu), t(lam))
    Wt = ell.build_ell_rd_const(et, (kt.grads_T, kt.vol), t(D), 0.1, 1.0, kt._m0)
    Act = tl.build_coarse(at, et.adj_idx, Bt, torch.as_tensor(mask))
    Acst = tl.build_coarse_scalar(at, et.adj_idx, Wt, torch.as_tensor(mask[:, 0]))
    return dict(n=n, mask=mask, rng=rng, aj=aj, at=at, Bj=Bj, Bt=Bt, Wj=Wj,
                Wt=Wt, Acj=Acj, Act=Act, Acsj=Acsj, Acst=Acst, ej=ej, et=et)


def test_ell_values_equal_jax(setup):
    S = setup
    assert np.array_equal(S["et"].adj, S["ej"].adj)
    assert _rel(S["Bt"], S["Bj"]) <= 1e-12
    assert _rel(S["Wt"], S["Wj"]) <= 1e-12


def test_mode_matrices_equal_jax(setup):
    S = setup
    f = 1.0 - S["mask"].astype(np.float64)
    assert _rel(S["at"].mode_matrix(f), S["aj"].mode_matrix(f)) <= 1e-10
    assert _rel(S["at"].mode_matrix_scalar(f[:, 0]),
                S["aj"].mode_matrix_scalar(f[:, 0])) <= 1e-10


@pytest.mark.parametrize("which", ["vector", "scalar"])
def test_coarse_matrix_equals_jax(setup, which):
    S = setup
    got, want = (S["Act"], S["Acj"]) if which == "vector" else (S["Acst"], S["Acsj"])
    assert tuple(got.shape) == want.shape
    assert _rel(got, want) <= 1e-10


@pytest.mark.parametrize("k", [None, 40])
def test_coarse_inverse_gram_equals_jax(setup, k):
    S = setup
    Cj = np.asarray(jtl.coarse_inverse(S["Acj"], k=k))
    Ct = tl.coarse_inverse(S["Act"], k=k).numpy()
    assert Ct.shape == Cj.shape
    assert _rel(Ct @ Ct.T, Cj @ Cj.T) <= 1e-10


@pytest.mark.parametrize("which", ["vector", "scalar"])
def test_twolevel_precond_apply_equals_jax(setup, which):
    S = setup
    n = S["n"]
    f = 1.0 - S["mask"].astype(np.float64)
    base_j = lambda r: 0.5 * r  # noqa: E731
    base_t = lambda r: 0.5 * r  # noqa: E731
    if which == "vector":
        Cj = jtl.coarse_inverse(S["Acj"])
        Mj = jtl.make_twolevel_precond(S["aj"], Cj, S["aj"].mode_matrix(f), base_j)
        Mt = tl.make_twolevel_precond(
            S["at"], torch.as_tensor(np.array(Cj)),
            torch.as_tensor(S["at"].mode_matrix(f)), base_t)
        r = S["rng"].standard_normal((n, 3))
    else:
        Cj = jtl.coarse_inverse(S["Acsj"])
        Mj = jtl.make_twolevel_precond_scalar(
            S["aj"], Cj, S["aj"].mode_matrix_scalar(f[:, 0]), base_j)
        Mt = tl.make_twolevel_precond_scalar(
            S["at"], torch.as_tensor(np.array(Cj)),
            torch.as_tensor(S["at"].mode_matrix_scalar(f[:, 0])), base_t)
        r = S["rng"].standard_normal(n)
    want = np.asarray(Mj(jnp.asarray(r)))
    got = Mt(torch.as_tensor(r))
    assert tuple(got.shape) == want.shape
    assert _rel(got, want) <= 1e-10
