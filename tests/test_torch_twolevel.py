"""Port parity of the two-level coarse level: ``glimslib_tpu_torch``
``solvers/twolevel.py`` (with ``ops/ell.py``) against ``glimslib_tpu``
``solvers/twolevel.py`` on a small Morton-ordered box at f64.

Mode matrices, Galerkin coarse matrices, the preconditioner B Bᵀ of the
coarse Gram factor and both preconditioner applies agree to 1e-10
relative (the factor itself is defined only up to the eigenvectors'
signs, so B Bᵀ is compared).  The bf16 factors of f32 models: both
applies on the same bf16 factor to 1e-5,
coarse products that return float32, an f32 model with bf16 and with f32
factors (states 1e-5, CG iterations 10%), and ``convert`` keeping bf16.
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
from torch_threads import one_torch_thread  # noqa: E402,F401

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


# -- bf16 coarse factors (f32 models) -------------------------------------------


@pytest.mark.parametrize("which", ["vector", "scalar"])
def test_bf16_precond_apply_equals_jax(setup, which):
    """The bf16 branch: the same bf16 factor and f32 mode matrices in both
    packages, an f32 residual; M(r) to rel 1e-5 (f32 accumulation in
    other orders), returned in f32."""
    import ml_dtypes

    from glimslib_tpu_torch import convert

    S = setup
    n = S["n"]
    f = 1.0 - S["mask"].astype(np.float64)
    base = lambda r: 0.5 * r  # noqa: E731
    if which == "vector":
        C = np.asarray(jtl.coarse_inverse(S["Acj"]), np.float32)
        mode, make_j, make_t = (S["aj"].mode_matrix(f), jtl.make_twolevel_precond,
                                tl.make_twolevel_precond)
        r = S["rng"].standard_normal((n, 3)).astype(np.float32)
    else:
        C = np.asarray(jtl.coarse_inverse(S["Acsj"]), np.float32)
        mode, make_j, make_t = (S["aj"].mode_matrix_scalar(f[:, 0]),
                                jtl.make_twolevel_precond_scalar,
                                tl.make_twolevel_precond_scalar)
        r = S["rng"].standard_normal(n).astype(np.float32)
    Cb = C.astype(ml_dtypes.bfloat16)
    Mj = make_j(S["aj"], jnp.asarray(Cb), jnp.asarray(mode, jnp.float32), base)
    Bt = convert.aux_from_numpy({"_TLCfac": Cb})["_TLCfac"]
    assert Bt.dtype == torch.bfloat16
    Mt = make_t(S["at"], Bt, torch.as_tensor(mode, dtype=torch.float32), base)
    want = np.asarray(Mj(jnp.asarray(r)))
    got = Mt(torch.as_tensor(r))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    assert _rel(got, want) <= 1e-5


def test_bf16_coarse_products_return_f32():
    """Both coarse products take bf16 operands and return float32: the
    result is the f32 product of the bf16 values, never rounded to bf16."""
    rng = np.random.default_rng(5)
    B = torch.as_tensor(rng.standard_normal((40, 24)), dtype=torch.float32)
    Bb = B.to(torch.bfloat16)
    rc = torch.as_tensor(rng.standard_normal(40), dtype=torch.float32)
    w = tl._coarse_apply(Bb, rc)
    z = (Bb.double().T @ rc.to(torch.bfloat16).double()).float()
    want = Bb.double() @ z.to(torch.bfloat16).double()
    assert w.dtype == torch.float32
    assert _rel(w, want) <= 1e-6
    assert not torch.equal(w, w.to(torch.bfloat16).float())


def _f32_brain(monkeypatch, bf16):
    """The f32 model's run with its bf16 factors, or with f32 ones built
    from the same coarse matrices (the two-level arrays in the working
    dtype, without the model's cast)."""
    from glimslib_tpu_torch.examples import brain_sim

    monkeypatch.setenv("GLIMS_TWOLEVEL_MIN_NODES", "100")
    sim = brain_sim(n=6, dtype=torch.float32, device="cpu", unstructured=True)
    aux = sim.runtime_aux()
    assert aux["_TLCfac"].dtype == aux["_TLCfacS"].dtype == torch.bfloat16
    if not bf16:
        theta0 = sim.make_theta(sim.params.as_dict())
        sim._aux_cache = aux = {**aux, **sim._twolevel_aux(theta0, {})}
        assert aux["_TLCfac"].dtype == aux["_TLCfacS"].dtype == torch.float32
    u, c, ok, _ = sim.build_simulate_fn(5, 1.0)(sim.make_theta(sim.params.as_dict()),
                                               *sim.initial_state())
    assert bool(ok.all())
    iters = {k: sum(int(i) for i in sim.solver_info[k])
             for k in ("rd_cg_iters", "el_cg_iters")}
    return u[-1], c[-1], iters


def test_bf16_model_matches_f32_factors(monkeypatch):
    """An f32 model (the n=6 Morton brain box, 5 steps, its default step)
    with bf16 factors and with f32 ones: final states within rel-L2 1e-5,
    CG iterations within 10%."""
    u_b, c_b, it_b = _f32_brain(monkeypatch, True)
    u_f, c_f, it_f = _f32_brain(monkeypatch, False)
    assert _rel_l2(c_b, c_f) <= 1e-5 and _rel_l2(u_b, u_f) <= 1e-5
    for k in it_b:
        assert abs(it_b[k] - it_f[k]) <= 0.1 * it_f[k], (k, it_b, it_f)


def test_convert_keeps_bf16_factors(monkeypatch):
    """The JAX package's f32 aux carries bf16 factors: convert keeps them
    bf16, bit for bit, whatever the working dtype asked for."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from __graft_entry__ import _brain_sim as jax_brain_sim
    from glimslib_tpu.core.mesh import Mesh as JaxMesh
    from glimslib_tpu_torch import convert

    monkeypatch.setenv("GLIMS_TWOLEVEL_MIN_NODES", "100")
    sim_j = jax_brain_sim(n=6, dims=3, dtype=jnp.float32, mesh_transform=lambda m: (
        JaxMesh.from_arrays(m.points, m.cells).reordered_morton()))
    aux_j = {k: np.asarray(v) for k, v in sim_j.runtime_aux().items()}
    assert aux_j["_TLCfac"].dtype.name == "bfloat16"
    aux_t = convert.aux_from_numpy(aux_j, dtype=torch.float32)
    for k in ("_TLCfac", "_TLCfacS"):
        assert aux_t[k].dtype == torch.bfloat16
        assert np.array_equal(aux_t[k].view(torch.int16).numpy(), aux_j[k].view(np.int16))
    assert aux_t["_TLMt"].dtype == torch.float32


def _rel_l2(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-300)
