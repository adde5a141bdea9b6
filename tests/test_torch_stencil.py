"""Port parity: offset-stencil planes and stencil applies
(glimslib_tpu_torch/ops/stencil.py, ops/stencil_kernels.py) against the JAX
package (glimslib_tpu/ops/stencil.py, ops/stencil_pallas.py).

Inputs are made with numpy from a seed and fed to both packages.  Planes
are compared at f64 (rel 1e-12: the same sums, accumulated in another
order).  The plain stencil applies are compared at f32 with the Pallas
matvec kernels run in interpret mode (rel 1e-6: f32 summation order).
The lattice rd residual as one multi-operand apply is compared with the
JAX package's at f64 (rel 1e-12).  The same holds at d=2 on rectangle
lattices (7 offsets): planes at f64, and the plain (2, 2) and (2, 1)
applies at f32.
"""

import os
import sys

import numpy as np
import pytest
import jax.numpy as jnp
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from __graft_entry__ import _brain_sim as jax_brain_sim  # noqa: E402
from glimslib_tpu.core.mesh import box_mesh as jax_box_mesh  # noqa: E402
from glimslib_tpu.core.mesh import rectangle_mesh as jax_rectangle_mesh  # noqa: E402
from glimslib_tpu.ops import stencil_pallas as sp  # noqa: E402
from glimslib_tpu.ops.stencil import StencilOperators as JaxStencilOperators  # noqa: E402
from glimslib_tpu_torch import _build as kernel_build  # noqa: E402
from glimslib_tpu_torch.core.mesh import box_mesh, rectangle_mesh  # noqa: E402
from glimslib_tpu_torch.examples import brain_sim  # noqa: E402
from glimslib_tpu_torch.ops import stencil_kernels as sk  # noqa: E402
from glimslib_tpu_torch.ops.stencil import StencilOperators  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


def _coeffs(mesh, seed):
    """Per-cell coefficients and a nodal field, numpy f64."""
    rng = np.random.default_rng(seed)
    nc, n = mesh.n_cells, mesh.n_nodes
    return {
        "mu": 1.0 + rng.random(nc),
        "lam": 3.0 + rng.random(nc),
        "D": 0.05 + 0.1 * rng.random(nc),
        "rho": 0.1 * rng.random(nc),
        "coupling": 0.15,
        "c": rng.random(n),
        "mask": rng.random((n, mesh.dim)) < 0.2,
    }


def _build(ops, kind, p, xp):
    """``xp(array, dtype=None)`` converts a numpy input for one package."""
    f = xp
    if kind == "elasticity":
        return ops.build_elasticity(f(p["mu"]), f(p["lam"]))
    if kind == "rd_jacobian":
        return ops.build_rd_jacobian(f(p["c"]), f(p["D"]), f(p["rho"]), 1.0)
    if kind == "rd_const":
        return ops.build_rd_jacobian_const(f(p["D"]), f(p["rho"]), 1.0)
    if kind == "rd_wc":
        return ops.build_rd_wc(f(p["c"]), f(p["rho"]), 1.0)
    if kind == "mass":
        return ops.build_mass_planes()
    if kind == "coupling":
        return ops.build_coupling_uc(f(p["mu"]), f(p["lam"]), p["coupling"])
    if kind == "block_jacobi":
        Wel = ops.build_elasticity(f(p["mu"]), f(p["lam"]))
        return ops.block_jacobi_inverse(Wel, mask=xp(p["mask"], bool))
    raise ValueError(kind)


@pytest.mark.parametrize("n", [4, 5])
@pytest.mark.parametrize(
    "kind", ["elasticity", "rd_jacobian", "rd_const", "rd_wc", "mass",
             "coupling", "block_jacobi"],
)
def test_planes_match_jax_f64(kind, n):
    mesh_j = jax_box_mesh((0, 0, 0), (1, 1.5, 2), n, n, n)
    mesh_t = box_mesh((0, 0, 0), (1, 1.5, 2), n, n, n)
    p = _coeffs(mesh_t, seed=n)
    ops_j = JaxStencilOperators(mesh_j, dtype=jnp.float64)
    ops_t = StencilOperators(mesh_t, dtype=torch.float64)
    assert ops_t.offsets == ops_j.offsets
    want = _build(ops_j, kind, p,
                  lambda a, dt=jnp.float64: jnp.asarray(a, dtype=dt))
    got = _build(ops_t, kind, p,
                 lambda a, dt=torch.float64: torch.as_tensor(a, dtype=dt))
    assert tuple(got.shape) == tuple(want.shape)
    assert _rel(got, want) <= 1e-12


@pytest.fixture
def lattice_f32():
    mesh_j = jax_box_mesh((0, 0, 0), (1, 1, 1), 5, 5, 5)
    mesh_t = box_mesh((0, 0, 0), (1, 1, 1), 5, 5, 5)
    p = _coeffs(mesh_t, seed=7)
    ops_j = JaxStencilOperators(mesh_j, dtype=jnp.float32)
    ops_t = StencilOperators(mesh_t, dtype=torch.float32)
    rng = np.random.default_rng(11)
    u = rng.standard_normal((mesh_t.n_nodes, 3)).astype(np.float32)
    c = rng.standard_normal(mesh_t.n_nodes).astype(np.float32)
    return ops_j, ops_t, p, u, c


@pytest.mark.parametrize("shape", ["scalar", "vector", "coupling"])
def test_plain_stencil_apply_matches_jax_f32(shape, lattice_f32, monkeypatch):
    """The plain stencil_apply against the Pallas matvec kernels (interpret
    mode) for the scalar and vector shapes, and against the XLA coupling
    apply for (d_out, d_in) = (3, 1), which has no Pallas kernel."""
    monkeypatch.setenv("GLIMS_PALLAS_INTERPRET", "1")
    ops_j, ops_t, p, u, c = lattice_f32
    jf = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
    tf = lambda a: torch.as_tensor(a, dtype=torch.float32)  # noqa: E731
    if shape == "scalar":
        Wj = ops_j.build_rd_jacobian(jf(p["c"]), jf(p["D"]), jf(p["rho"]), 1.0)
        want = sp.apply_scalar_pallas(ops_j.offsets, Wj, jf(c))
        got = sk.apply_scalar(ops_t.offsets, tf(np.array(Wj)), tf(c))
    elif shape == "vector":
        Wj = ops_j.build_elasticity(jf(p["mu"]), jf(p["lam"]))
        want = sp.apply_vector_pallas(ops_j.offsets, Wj, jf(u))
        got = sk.apply_vector(ops_t.offsets, tf(np.array(Wj)), tf(u))
    else:
        Cj = ops_j.build_coupling_uc(jf(p["mu"]), jf(p["lam"]), p["coupling"])
        want = ops_j.apply_coupling(Cj, jf(c))
        got = sk.apply_coupling(ops_t.offsets, tf(np.array(Cj)), tf(c))
    assert got.dtype == torch.float32
    assert _rel(got, want) <= 1e-6


@pytest.mark.parametrize("n", [4, 7])
@pytest.mark.parametrize(
    "kind", ["elasticity", "rd_jacobian", "rd_const", "rd_wc", "mass",
             "coupling", "block_jacobi"],
)
def test_planes_2d_match_jax_f64(kind, n):
    """Every plane construction on an n x (n + 1) rectangle lattice (d=2,
    7 offsets) against the JAX package's, rel 1e-12."""
    mesh_j = jax_rectangle_mesh((0, 0), (1, 1.5), n, n + 1)
    mesh_t = rectangle_mesh((0, 0), (1, 1.5), n, n + 1)
    p = _coeffs(mesh_t, seed=10 + n)
    ops_j = JaxStencilOperators(mesh_j, dtype=jnp.float64)
    ops_t = StencilOperators(mesh_t, dtype=torch.float64)
    assert ops_t.offsets == ops_j.offsets and len(ops_t.offsets) == 7
    want = _build(ops_j, kind, p,
                  lambda a, dt=jnp.float64: jnp.asarray(a, dtype=dt))
    got = _build(ops_t, kind, p,
                 lambda a, dt=torch.float64: torch.as_tensor(a, dtype=dt))
    assert tuple(got.shape) == tuple(want.shape)
    assert _rel(got, want) <= 1e-12


@pytest.mark.parametrize("shape", ["vector", "coupling"])
def test_plain_stencil_apply_2d_matches_jax_f32(shape, monkeypatch):
    """The plain (2, 2) apply against the Pallas vector kernel at d=2
    (interpret mode) and the plain (2, 1) apply against the XLA coupling
    apply, on a 20 x 23 rectangle lattice at f32, rel 1e-6."""
    monkeypatch.setenv("GLIMS_PALLAS_INTERPRET", "1")
    mesh_j = jax_rectangle_mesh((0, 0), (1, 1), 20, 23)
    mesh_t = rectangle_mesh((0, 0), (1, 1), 20, 23)
    p = _coeffs(mesh_t, seed=8)
    ops_j = JaxStencilOperators(mesh_j, dtype=jnp.float32)
    rng = np.random.default_rng(12)
    u = rng.standard_normal((mesh_t.n_nodes, 2)).astype(np.float32)
    c = rng.standard_normal(mesh_t.n_nodes).astype(np.float32)
    jf = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
    tf = lambda a: torch.as_tensor(np.array(a), dtype=torch.float32)  # noqa: E731
    offs = StencilOperators(mesh_t, dtype=torch.float32).offsets
    if shape == "vector":
        Wj = ops_j.build_elasticity(jf(p["mu"]), jf(p["lam"]))
        want = sp.apply_vector_pallas(ops_j.offsets, Wj, jf(u))
        got = sk.apply_vector(offs, tf(Wj), tf(u))
    else:
        Cj = ops_j.build_coupling_uc(jf(p["mu"]), jf(p["lam"]), p["coupling"])
        want = ops_j.apply_coupling(Cj, jf(c))
        got = sk.apply_coupling(offs, tf(Cj), tf(c))
    assert got.dtype == torch.float32 and tuple(got.shape) == (mesh_t.n_nodes, 2)
    assert _rel(got, want) <= 1e-6


@pytest.mark.parametrize("wrapper", ["apply_vector", "apply_scalar",
                                     "apply_coupling", "apply_scalar_sum"])
def test_cpu_wrappers_take_the_plain_path_and_count_nothing(lattice_f32, wrapper):
    """On CPU tensors the wrappers return the plain version's result and
    launch no kernel."""
    _, ops_t, p, u, c = lattice_f32
    W = ops_t.build_elasticity(torch.as_tensor(p["mu"], dtype=torch.float32),
                               torch.as_tensor(p["lam"], dtype=torch.float32))
    Ws = W[:, 0, 0].contiguous()
    ct = torch.as_tensor(c)
    args = {
        "apply_vector": (W, torch.as_tensor(u)),
        "apply_scalar": (Ws, ct),
        "apply_coupling": (W[:, :, 0].contiguous(), ct),
        "apply_scalar_sum": (((Ws, ct, 1.0), (W[:, 1, 1], ct, 0.5),
                              (W[:, 2, 2], ct.flip(0), -1.0)), ct),
    }[wrapper]
    kern = getattr(sk, wrapper)
    before = kern.launches
    got = kern(ops_t.offsets, *args)
    assert kern.launches == before
    assert torch.equal(got, getattr(sk, wrapper + "_plain")(ops_t.offsets, *args))


@pytest.mark.parametrize("n", [4, 5])
@pytest.mark.parametrize("entry", ["plain_sum", "model"])
def test_rd_residual_sum_matches_jax_f64(n, entry):
    """The lattice rd residual W_const c + wc(c) c / 2 - M c_prev - load as
    one multi-operand apply (its plain form, and the model's rd_residual,
    which calls the wrapper) against the JAX package's lattice rd_residual
    at f64 (rel 1e-12: the same sums)."""
    sim_j = jax_brain_sim(n=n, dims=3, dtype=jnp.float64)
    sim_j._build_step()
    theta_j = sim_j._augment_theta_with_operators(sim_j.make_theta(sim_j.params.as_dict()))
    sim_t = brain_sim(n=n, dtype=torch.float64, device="cpu")
    sim_t._build_step()
    theta_t = sim_t._augment_theta_with_operators(sim_t.make_theta(sim_t.params.as_dict()))
    rng = np.random.default_rng(n)
    c = rng.random(sim_t.mesh.n_nodes)
    c_prev = rng.random(sim_t.mesh.n_nodes)
    want = sim_j.rd_residual(jnp.asarray(c), jnp.asarray(c_prev), theta_j, 1.0)
    ct, cpt = torch.as_tensor(c), torch.as_tensor(c_prev)
    if entry == "model":
        got = sim_t.rd_residual(ct, cpt, theta_t, 1.0)
    else:
        ops = sim_t._stencil_ops
        wc = ops.build_rd_wc(ct, theta_t["rho"], theta_t["dt"], conc_max=1.0)
        got = sk.apply_scalar_sum_plain(
            ops.offsets, ((theta_t["_Wrd_const"], ct, 1.0), (wc, ct, 0.5),
                          (theta_t["_Mst"], cpt, -1.0)), theta_t["_rd_load"])
    assert got.dtype == torch.float64
    assert _rel(got, want) <= 1e-12


@pytest.mark.parametrize("offsets", [(0, 1, -1, 7, -7, 49, -49, 48, -48, 6, -6,
                                      42, -42, 43, -43), (0, 1, -1, 6, -6, 5, -5)])
def test_packed_offsets_cached_by_value(offsets):
    """The C entry points' offsets are packed once per (offsets, n), mod n;
    a sequence changed in place is packed anew, never served a stale pack."""
    n = 343
    pack, addr = kernel_build.pack_offsets(list(offsets), n)
    assert pack.n == len(offsets)
    assert list(pack.v)[:len(offsets)] == [o % n for o in offsets]
    assert all(0 <= o < n for o in pack.v)
    assert kernel_build.pack_offsets(list(offsets), n)[1] == addr  # cached
    changed = list(offsets)
    changed[1] = 2
    pack2, addr2 = kernel_build.pack_offsets(changed, n)
    assert addr2 != addr and pack2.v[1] == 2 and pack.v[1] == 1
    assert list(kernel_build.pack_offsets(offsets, 100)[0].v)[:len(offsets)] == [
        o % 100 for o in offsets]
    with pytest.raises(ValueError):
        kernel_build.pack_offsets(list(range(kernel_build.MAX_OFF + 1)), n)


@pytest.mark.parametrize("kind", ["rect", "box"])
def test_folded_symmetric_applies_match_full_and_jax(kind):
    """fold_sym and the *_sym applies (tests/test_stencil.py:179-215) on
    the 6 x 5 rectangle and the 3 x 4 x 3 box at f64: the folded
    elasticity and rd Jacobian applies equal the port's full-plane ones
    and the JAX package's folded ones (max abs 1e-12, values O(1-10)),
    block_jacobi_inverse_sym the full-plane inverse and JAX's (1e-12);
    the folded planes are JAX's exactly."""
    if kind == "rect":
        mt, mj = rectangle_mesh((0, 0), (2, 1), 6, 5), jax_rectangle_mesh((0, 0), (2, 1), 6, 5)
    else:
        mt, mj = box_mesh((0, 0, 0), (1, 2, 1), 3, 4, 3), jax_box_mesh(
            (0, 0, 0), (1, 2, 1), 3, 4, 3)
    ops, opsj = StencilOperators(mt), JaxStencilOperators(mj, dtype=jnp.float64)
    assert ops.sym_idx.tolist() == np.asarray(opsj.sym_idx).tolist()
    assert ops.pos_offsets == list(opsj.pos_offsets)
    rng = np.random.default_rng(7)
    mids = mt.cell_midpoints
    mu, lam = 1.0 + mids[:, 0], 2.0 + mids[:, 1]
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)  # noqa: E731
    W = ops.build_elasticity(t(mu), t(lam))
    Wj = opsj.build_elasticity(jnp.asarray(mu), jnp.asarray(lam))
    Ws, Wsj = ops.fold_sym(W), opsj.fold_sym(Wj)
    assert Ws.shape[0] == len(ops.pos_offsets) + 1
    np.testing.assert_array_equal(Ws.numpy(), np.asarray(opsj.fold_sym(jnp.asarray(W.numpy()))))
    u = rng.standard_normal((mt.n_nodes, mt.dim))
    sym = ops.apply_vector_sym(Ws, t(u)).numpy()
    np.testing.assert_allclose(sym, ops.apply_vector(W, t(u)).numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(sym, np.asarray(opsj.apply_vector_sym(Wsj, jnp.asarray(u))),
                               rtol=0, atol=1e-12)

    c = rng.standard_normal(mt.n_nodes)
    Wrd = ops.build_rd_jacobian(t(0.1 * c + 0.5), t(0.3), t(0.2), 1.0)
    Wrdj = opsj.build_rd_jacobian(jnp.asarray(0.1 * c + 0.5), jnp.asarray(0.3),
                                  jnp.asarray(0.2), 1.0)
    sym_s = ops.apply_scalar_sym(ops.fold_sym(Wrd), t(c)).numpy()
    np.testing.assert_allclose(sym_s, ops.apply_scalar(Wrd, t(c)).numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(
        sym_s, np.asarray(opsj.apply_scalar_sym(opsj.fold_sym(Wrdj), jnp.asarray(c))),
        rtol=0, atol=1e-12)

    mask = rng.random((mt.n_nodes, mt.dim)) < 0.2
    for m in (None, mask):
        tm = None if m is None else torch.as_tensor(m)
        jm = None if m is None else jnp.asarray(m)
        Binv = ops.block_jacobi_inverse_sym(Ws, mask=tm).numpy()
        np.testing.assert_allclose(Binv, ops.block_jacobi_inverse(W, mask=tm).numpy(),
                                   rtol=0, atol=1e-12)
        np.testing.assert_allclose(Binv, np.asarray(opsj.block_jacobi_inverse_sym(Wsj, mask=jm)),
                                   rtol=0, atol=1e-12)
