"""Port parity: offset-stencil planes and stencil applies
(glimslib_tpu_torch/ops/stencil.py, ops/stencil_kernels.py) against the JAX
package (glimslib_tpu/ops/stencil.py, ops/stencil_pallas.py).

Inputs are made with numpy from a seed and fed to both packages.  Planes
are compared at f64 (rel 1e-12: the same sums, accumulated in another
order).  The plain stencil applies are compared at f32 with the Pallas
matvec kernels run in interpret mode (rel 1e-6: f32 summation order).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from glimslib_tpu.core.mesh import box_mesh as jax_box_mesh
from glimslib_tpu.ops import stencil_pallas as sp
from glimslib_tpu.ops.stencil import StencilOperators as JaxStencilOperators
from glimslib_tpu_torch.core.mesh import box_mesh
from glimslib_tpu_torch.ops import stencil_kernels as sk
from glimslib_tpu_torch.ops.stencil import StencilOperators


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


def test_cpu_wrappers_take_the_plain_path_and_count_nothing(lattice_f32):
    """On CPU tensors the wrappers return the plain version's result and
    launch no kernel."""
    _, ops_t, p, u, c = lattice_f32
    W = ops_t.build_elasticity(torch.as_tensor(p["mu"], dtype=torch.float32),
                               torch.as_tensor(p["lam"], dtype=torch.float32))
    ut = torch.as_tensor(u)
    before = sk.apply_vector.launches
    got = sk.apply_vector(ops_t.offsets, W, ut)
    assert sk.apply_vector.launches == before
    assert torch.equal(got, sk.apply_vector_plain(ops_t.offsets, W, ut))
    Ws = W[:, 0, 0].contiguous()
    ct = torch.as_tensor(c)
    before = sk.apply_scalar.launches
    assert torch.equal(sk.apply_scalar(ops_t.offsets, Ws, ct),
                       sk.apply_scalar_plain(ops_t.offsets, Ws, ct))
    assert sk.apply_scalar.launches == before
