"""Port parity of the supernode halo-ELL operators: ``glimslib_tpu_torch``
``ops/bell.py`` and ``ops/bell_kernels.py`` against ``glimslib_tpu``
``ops/bell.py`` and ``ops/bell_pallas.py`` on small Morton-ordered boxes.

Plans must be identical (integer arrays equal); assembled planes and
applies agree to 1e-12 relative at f64 (the same sums in another order);
the plain batched matvec agrees with the Pallas kernel in interpret mode
to 1e-6 at f32 (summation order of 474 products).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from glimslib_tpu.core.mesh import Mesh as JaxMesh, box_mesh as jax_box_mesh
from glimslib_tpu.ops import bell as jbell
from glimslib_tpu.ops.assembly import P1Kernels as JaxP1Kernels
from glimslib_tpu_torch.core.mesh import Mesh, box_mesh
from glimslib_tpu_torch.ops import bell, bell_kernels
from glimslib_tpu_torch.ops.assembly import P1Kernels

N_BOX = 5


def _meshes(n=N_BOX):
    mj = jax_box_mesh((0, 0, 0), (1, 1, 2), n, n, n)
    mt = box_mesh((0, 0, 0), (1, 1, 2), n, n, n)
    return (JaxMesh.from_arrays(mj.points, mj.cells).reordered_morton(),
            Mesh.from_arrays(mt.points, mt.cells).reordered_morton())


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


@pytest.fixture(scope="module")
def setup():
    mesh_j, mesh_t = _meshes()
    kj = JaxP1Kernels(mesh_j, dtype=jnp.float64)
    kt = P1Kernels(mesh_t, dtype=torch.float64)
    plan_j = jbell.BellPlan(mesh_j, s=8)
    plan_t = bell.BellPlan(mesh_t, s=8)
    rng = np.random.default_rng(0)
    nc, n = mesh_t.n_cells, mesh_t.n_nodes
    coef = {k: 0.5 + rng.random(nc) for k in ("mu", "lam", "D", "rho")}
    coef["coupling"] = 0.15
    coef["dt"] = 0.7
    return dict(mesh_t=mesh_t, kj=kj, kt=kt, plan_j=plan_j, plan_t=plan_t,
                coef=coef, rng=rng, n=n)


@pytest.mark.parametrize("s", [8, 32])
def test_bell_plan_equals_jax(s):
    mesh_j, mesh_t = _meshes()
    pj = jbell.BellPlan(mesh_j, s=s)
    pt = bell.BellPlan(mesh_t, s=s)
    for attr in ("nb", "n_pad", "Kh", "Khe", "n_off"):
        assert getattr(pt, attr) == getattr(pj, attr), attr
    for attr in ("ext_ids", "place", "off_entry_idx"):
        assert np.array_equal(getattr(pt, attr), getattr(pj, attr)), attr
    assert np.array_equal(pt.diag_plan.pull_table, pj.diag_plan.pull_table)
    assert np.array_equal(pt.off_plan.pull_table, pj.off_plan.pull_table)
    assert np.array_equal(pt.ext_idx.numpy(), pj.ext_ids)
    assert np.array_equal(pt.place_idx.numpy(), pj.place)


def _jax_planes(S):
    c = S["coef"]
    arrays = (S["kj"].grads_T, S["kj"].vol)
    m0 = S["kj"]._m0
    ents = [
        jbell.elasticity_entries(arrays, c["mu"], c["lam"], jnp.float64),
        jbell.coupling_uc_entries(arrays, c["mu"], c["lam"], c["coupling"],
                                  jnp.float64),
        jbell.rd_const_entries(arrays, c["D"], c["rho"], c["dt"], m0,
                               jnp.float64),
        jbell.mass_entries(arrays, m0, jnp.float64),
    ]
    return [np.asarray(p) for p in jbell.assemble_fused(S["plan_j"], ents)]


def _torch_planes(S):
    c = {k: torch.as_tensor(v, dtype=torch.float64) for k, v in S["coef"].items()}
    arrays = (S["kt"].grads_T, S["kt"].vol)
    m0 = S["kt"]._m0
    return bell.assemble_fused(S["plan_t"], [
        bell.elasticity_entries(arrays, c["mu"], c["lam"]),
        bell.coupling_uc_entries(arrays, c["mu"], c["lam"], c["coupling"]),
        bell.rd_const_entries(arrays, c["D"], c["rho"], c["dt"], m0),
        bell.mass_entries(arrays, m0),
    ])


@pytest.mark.parametrize("plane", ["elasticity", "coupling", "rd_const", "mass"])
def test_assemble_fused_planes_equal_jax(setup, plane):
    i = ["elasticity", "coupling", "rd_const", "mass"].index(plane)
    want = _jax_planes(setup)[i]
    got = _torch_planes(setup)[i]
    assert tuple(got.shape) == want.shape
    assert _rel(got, want) <= 1e-12


def test_rd_wc_exact_and_lumped_equal_jax(setup):
    S = setup
    c = S["rng"].random(S["n"])
    rho, dt = S["coef"]["rho"], S["coef"]["dt"]
    kj, kt = S["kj"], S["kt"]
    want = jbell.build_bell_rd_wc(S["plan_j"], (kj.grads_T, kj.vol),
                                  kj.cells_flat, jnp.asarray(c), rho, dt,
                                  kj._t0, 1.0, jnp.float64)
    want_l = jbell.build_bell_rd_wc_lumped(S["plan_j"], (kj.grads_T, kj.vol),
                                           kj.cells_flat, jnp.asarray(c), rho,
                                           dt, kj._t0, 1.0, jnp.float64)
    ct, rt = torch.as_tensor(c), torch.as_tensor(rho)
    got = bell.build_bell_rd_wc(S["plan_t"], (kt.grads_T, kt.vol),
                                kt.cells_flat, ct, rt, dt, kt._t0, 1.0)
    got_l = bell.build_bell_rd_wc_lumped(S["plan_t"], (kt.grads_T, kt.vol),
                                         kt.cells_flat, ct, rt, dt, kt._t0, 1.0)
    assert _rel(got, want) <= 1e-12
    assert _rel(got_l, want_l) <= 1e-12


@pytest.mark.parametrize("which", ["vector", "scalar", "coupling",
                                   "jacobi_vector", "jacobi_scalar"])
def test_applies_equal_jax(setup, which):
    S = setup
    pj, pt = S["plan_j"], S["plan_t"]
    Wel_j, Wc_j, Wrd_j, _ = _jax_planes(S)
    Wel_t, Wc_t, Wrd_t, _ = _torch_planes(S)
    Wel_j = np.transpose(Wel_j, (0, 1, 3, 2, 4))
    Wc_j = np.transpose(Wc_j, (0, 1, 3, 2))
    Wel_t = Wel_t.permute(0, 1, 3, 2, 4).contiguous()
    Wc_t = Wc_t.permute(0, 1, 3, 2).contiguous()
    halo = jnp.asarray(pj.ext_ids)
    n = S["n"]
    u = S["rng"].standard_normal((n, 3))
    v = S["rng"].standard_normal(n)
    mask = np.zeros((n, 3), bool)
    mask[S["mesh_t"].boundary_nodes] = True
    if which == "vector":
        want = jbell.apply_bell_vector(pj, halo, jnp.asarray(Wel_j), jnp.asarray(u))
        got = bell.apply_bell_vector(pt, Wel_t, torch.as_tensor(u))
    elif which == "scalar":
        want = jbell.apply_bell_scalar(pj, halo, jnp.asarray(Wrd_j), jnp.asarray(v))
        got = bell.apply_bell_scalar(pt, Wrd_t, torch.as_tensor(v))
    elif which == "coupling":
        want = jbell.apply_bell_coupling(pj, halo, jnp.asarray(Wc_j), jnp.asarray(v))
        got = bell.apply_bell_coupling(pt, Wc_t, torch.as_tensor(v))
    elif which == "jacobi_vector":
        Bj = jbell.supernode_jacobi_inverse(
            pj, jbell.extract_self_blocks_vector(pj, jnp.asarray(Wel_j)),
            mask=jnp.asarray(mask))
        Bt = bell.supernode_jacobi_inverse(
            pt, bell.extract_self_blocks_vector(pt, Wel_t),
            mask=torch.as_tensor(mask))
        assert _rel(Bt, Bj) <= 1e-12
        want = jbell.apply_supernode_jacobi(pj, Bj, jnp.asarray(u))
        got = bell.apply_supernode_jacobi(pt, Bt, torch.as_tensor(u))
    else:
        Bj = jbell.supernode_jacobi_inverse(
            pj, jbell.extract_self_blocks_scalar(pj, jnp.asarray(Wrd_j)),
            mask=jnp.asarray(mask[:, 0]))
        Bt = bell.supernode_jacobi_inverse(
            pt, bell.extract_self_blocks_scalar(pt, Wrd_t),
            mask=torch.as_tensor(mask[:, 0]))
        assert _rel(Bt, Bj) <= 1e-12
        want = jbell.apply_supernode_jacobi(pj, Bj, jnp.asarray(v))
        got = bell.apply_supernode_jacobi(pt, Bt, torch.as_tensor(v))
    assert tuple(got.shape) == np.asarray(want).shape
    assert _rel(got, want) <= 1e-12


@pytest.mark.parametrize("shape", [(16, 96, 474), (8, 32, 158), (24, 48, 48),
                                   (4352, 64, 64), (64, 64, 353)])
def test_batched_matvec_plain_equals_pallas_interpret(monkeypatch, shape):
    from glimslib_tpu.ops import bell_pallas

    monkeypatch.setenv("GLIMS_PALLAS_INTERPRET", "1")
    rng = np.random.default_rng(7)
    A = rng.standard_normal(shape).astype(np.float32)
    x = rng.standard_normal(shape[::2]).astype(np.float32)
    want = np.asarray(bell_pallas.batched_matvec(jnp.asarray(A), jnp.asarray(x)))
    got = bell_kernels.batched_matvec(torch.as_tensor(A), torch.as_tensor(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert np.abs(got.numpy() - want).max() <= 1e-6 * np.abs(want).max()


def test_rd_quad_residual_equals_jax(setup):
    S = setup
    c = S["rng"].random(S["n"])
    rho = S["coef"]["rho"]
    want = S["kj"].rd_quad_residual(jnp.asarray(c), jnp.asarray(rho), 0.7)
    got = S["kt"].rd_quad_residual(torch.as_tensor(c), torch.as_tensor(rho), 0.7)
    assert _rel(got, want) <= 1e-12
