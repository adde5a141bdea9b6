"""Port parity: mask folding and the whole-solve stencil PCG
(glimslib_tpu_torch/ops/fused_cg.py) against the JAX package
(glimslib_tpu/ops/pallas_cg.py, glimslib_tpu/solvers/cg.py).

- fold_mask_* at f64 against JAX's: rel 1e-12.
- The plain fused solves at f32 against the Pallas whole-solve kernels in
  interpret mode: |Δiters| <= 2 (reductions re-associate near the
  tolerance) and rel 1e-4.
- The plain fused solves at f64 against JAX ``pcg`` on the where-masked
  operator: equal iteration counts and rel 1e-10.
- The plain vector solve at f32 against the streamed Pallas kernel (K3c)
  in interpret mode, chunked small so that several chunks and the halo
  rows run: |Δiters| <= 2 and rel 1e-4.
- The CUDA kernel's launch plan (Python, so testable here): the mode for
  each lattice size up to N=128 and on 132 or 114 SMs, the owned node
  ranges, the shared-memory bytes of every mode that fits.
- The same at d=2, on rectangle lattices (7 offsets): the plain vector
  solve against both Pallas kernels in interpret mode, and the launch plan
  from the 50 x 50 rectangle to 1024 x 1024.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from glimslib_tpu.core.mesh import box_mesh as jax_box_mesh
from glimslib_tpu.core.mesh import rectangle_mesh as jax_rectangle_mesh
from glimslib_tpu.ops import pallas_cg as jpc
from glimslib_tpu.ops.stencil import StencilOperators as JaxStencilOperators
from glimslib_tpu.solvers.cg import pcg as jax_pcg
from glimslib_tpu_torch.core.mesh import box_mesh, rectangle_mesh
from glimslib_tpu_torch.ops import fused_cg as fc
from glimslib_tpu_torch.ops.stencil import StencilOperators
from torch_threads import one_torch_thread  # noqa: E402,F401

N = 5


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


def _problem(seed, jdtype, tdtype, rect=None):
    """The masked scalar (rd Jacobian) and vector (elasticity) systems of a
    small lattice, built by both packages from the same numpy inputs: the
    N^3 box, or with ``rect`` the rect x rect rectangle (d=2)."""
    if rect is None:
        mesh_j = jax_box_mesh((0, 0, 0), (1, 1, 1), N, N, N)
        mesh_t = box_mesh((0, 0, 0), (1, 1, 1), N, N, N)
    else:
        mesh_j = jax_rectangle_mesh((0, 0), (1, 1.5), rect, rect)
        mesh_t = rectangle_mesh((0, 0), (1, 1.5), rect, rect)
    n, nc, d = mesh_t.n_nodes, mesh_t.n_cells, mesh_t.dim
    rng = np.random.default_rng(seed)
    mu = 1.0 + rng.random(nc)
    c = rng.random(n)
    mask_u = np.zeros((n, d), bool)
    mask_u[mesh_t.boundary_nodes] = True
    mask_c = np.isin(np.arange(n), mesh_t.boundary_nodes[::3])
    b_u = np.where(mask_u, 0.0, rng.standard_normal((n, d)))
    b_c = np.where(mask_c, 0.0, rng.standard_normal(n))
    out = {}
    for name, ops, xp, dt in (
        ("jax", JaxStencilOperators(mesh_j, dtype=jdtype),
         lambda a, d: jnp.asarray(a, dtype=d), jdtype),
        ("torch", StencilOperators(mesh_t, dtype=tdtype),
         lambda a, d: torch.as_tensor(a, dtype=d), tdtype),
    ):
        Wel = ops.build_elasticity(xp(mu, dt), xp(4.0 * mu, dt))
        Wrd = ops.build_rd_jacobian(xp(c, dt), xp(0.1, dt), xp(0.1, dt), 1.0)
        out[name] = dict(
            ops=ops, Wel=Wel, Binv=ops.block_jacobi_inverse(Wel), Wrd=Wrd,
            mask_u=xp(mask_u, bool), mask_c=xp(mask_c, bool),
            b_u=xp(b_u, dt), b_c=xp(b_c, dt),
        )
    return out


@pytest.mark.parametrize("which", ["scalar", "vector", "binv", "invdiag"])
def test_fold_mask_matches_jax_f64(which):
    P = _problem(0, jnp.float64, torch.float64)
    j, t = P["jax"], P["torch"]
    offs = t["ops"].offsets
    if which == "scalar":
        want = jpc.fold_mask_scalar(offs, j["Wrd"], j["mask_c"])
        got = fc.fold_mask_scalar(offs, t["Wrd"], t["mask_c"])
    elif which == "vector":
        want = jpc.fold_mask_vector(offs, j["Wel"], j["mask_u"])
        got = fc.fold_mask_vector(offs, t["Wel"], t["mask_u"])
    elif which == "binv":
        want = jpc.fold_mask_binv(j["Binv"], j["mask_u"])
        got = fc.fold_mask_binv(t["Binv"], t["mask_u"])
    else:
        o0 = offs.index(0)
        want = jpc.fold_mask_invdiag(j["Wrd"][o0], j["mask_c"])
        got = fc.fold_mask_invdiag(t["Wrd"][o0], t["mask_c"])
    assert tuple(got.shape) == tuple(want.shape)
    assert _rel(got, want) <= 1e-12


def _torch_solve(t, kind, rtol, maxiter):
    offs = t["ops"].offsets
    if kind == "scalar":
        Wm = fc.fold_mask_scalar(offs, t["Wrd"], t["mask_c"])
        invd = fc.fold_mask_invdiag(t["Wrd"][offs.index(0)], t["mask_c"])
        return fc.cg_scalar(offs, Wm, invd, t["b_c"], rtol, 0.0, maxiter)
    Wm = fc.fold_mask_vector(offs, t["Wel"], t["mask_u"])
    Bm = fc.fold_mask_binv(t["Binv"], t["mask_u"])
    return fc.cg_vector(offs, Wm, Bm, t["b_u"], rtol, 0.0, maxiter)


@pytest.mark.parametrize("kind", ["scalar", "vector"])
def test_plain_fused_solve_matches_pallas_interpret_f32(kind, monkeypatch):
    monkeypatch.setenv("GLIMS_PALLAS_INTERPRET", "1")
    P = _problem(1, jnp.float32, torch.float32)
    j, t = P["jax"], P["torch"]
    offs = j["ops"].offsets
    n = j["b_c"].shape[0]
    if kind == "scalar":
        Wt = jpc.tile_scalar_planes(
            jpc.fold_mask_scalar(offs, j["Wrd"], j["mask_c"]), n)
        invdt = jpc.tile_field(
            jpc.fold_mask_invdiag(j["Wrd"][offs.index(0)], j["mask_c"]), n)
        x_j, info_j = jpc.cg_scalar(offs, Wt, invdt, j["b_c"], 1e-6, 0.0, 400, n)
    else:
        Wt = jpc.tile_vector_planes(
            jpc.fold_mask_vector(offs, j["Wel"], j["mask_u"]), n)
        Bt = jpc.tile_binv(jpc.fold_mask_binv(j["Binv"], j["mask_u"]), n)
        x_j, info_j = jpc.cg_vector(offs, Wt, Bt, j["b_u"], 1e-6, 0.0, 400, n)
    x_t, info_t = _torch_solve(t, kind, 1e-6, 400)
    assert x_t.dtype == torch.float32
    assert abs(int(info_t["iters"]) - int(info_j["iters"])) <= 2
    assert _rel(x_t, x_j) <= 1e-4


@pytest.mark.parametrize("kind", ["scalar", "vector"])
def test_plain_fused_solve_matches_jax_pcg_f64(kind):
    P = _problem(2, jnp.float64, torch.float64)
    j, t = P["jax"], P["torch"]
    ops = j["ops"]
    if kind == "scalar":
        m = j["mask_c"]
        diag = jnp.where(m, 1.0, j["Wrd"][ops.offsets.index(0)])
        A = lambda v: jnp.where(  # noqa: E731
            m, v, ops.apply_scalar(j["Wrd"], jnp.where(m, 0.0, v)))
        x_j, info_j = jax_pcg(A, j["b_c"], M=lambda r: r / diag,
                              rtol=1e-10, atol=0.0, maxiter=500)
    else:
        m = j["mask_u"]
        A = lambda v: jnp.where(  # noqa: E731
            m, v, ops.apply_vector(j["Wel"], jnp.where(m, 0.0, v)))
        M = lambda r: jnp.where(  # noqa: E731
            m, r, ops.apply_block_jacobi(j["Binv"], jnp.where(m, 0.0, r)))
        x_j, info_j = jax_pcg(A, j["b_u"], M=M, rtol=1e-10, atol=0.0,
                              maxiter=500)
    x_t, info_t = _torch_solve(t, kind, 1e-10, 500)
    assert int(info_t["iters"]) == int(info_j["iters"])
    assert _rel(x_t, x_j) <= 1e-10


def test_plain_vector_solve_matches_streamed_pallas_interpret_f32(monkeypatch):
    monkeypatch.setenv("GLIMS_PALLAS_INTERPRET", "1")
    P = _problem(1, jnp.float32, torch.float32)
    j, t = P["jax"], P["torch"]
    offs = j["ops"].offsets
    n = j["b_u"].shape[0]
    Wt = jpc.tile_vector_planes(
        jpc.fold_mask_vector(offs, j["Wel"], j["mask_u"]), n)
    Bt = jpc.tile_binv(jpc.fold_mask_binv(j["Binv"], j["mask_u"]), n)
    cfg = jpc.streamed_cfg(offs, n, 3, rv_candidates=(8,))
    assert cfg is not None and cfg[2] // cfg[0] >= 2  # several chunks
    x_j, info_j = jpc.cg_vector_streamed(offs, Wt, Bt, j["b_u"], 1e-6, 0.0,
                                         400, n, cfg=cfg)
    x_t, info_t = _torch_solve(t, "vector", 1e-6, 400)
    assert x_t.dtype == torch.float32
    assert abs(int(info_t["iters"]) - int(info_j["iters"])) <= 2
    assert _rel(x_t, x_j) <= 1e-4


SMS = 132  # an H100 SXM's SMs; an H100 PCIe has 114
MODE_FITS = {  # (N, d, blocks) -> mode: whether each forced mode fits
    "resident": {(32, 1, SMS), (32, 3, SMS), (64, 1, SMS), (64, 1, 114)},
    "streamed": {(32, 1, SMS), (32, 3, SMS), (64, 1, SMS), (64, 3, SMS),
                 (64, 1, 114), (96, 1, SMS), (128, 1, SMS)},
}


@pytest.mark.parametrize("N,d,blocks,mode", [
    (32, 1, SMS, "resident"), (32, 3, SMS, "resident"),
    (64, 1, SMS, "resident"), (64, 3, SMS, "streamed"),
    (64, 1, 114, "resident"), (64, 3, 114, "streamed_global"),
    (96, 1, SMS, "streamed"), (96, 3, SMS, "streamed_global"),
    (128, 1, SMS, "streamed"), (128, 3, SMS, "streamed_global"),
])
def test_launch_plan_mode_ranges_and_shared_memory(N, d, blocks, mode):
    """Every lattice size gets a plan: the mode that fits first, owned
    ranges that cover [0, n) exactly, and shared memory within the card's
    232,448 bytes a block in every mode that fits."""
    n = (N + 1) ** 3
    plan = fc.launch_plan(n, d, 15, blocks)
    assert plan.mode == mode and plan.blocks == blocks
    ranges = plan.ranges(n)
    assert ranges[0][0] == 0 and ranges[-1][1] == n
    assert all(r0 <= r1 and r1 - r0 <= plan.nloc for r0, r1 in ranges)
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert sum(r1 - r0 for r0, r1 in ranges) == n
    for forced in fc.MODES:
        if forced != "streamed_global" and (N, d, blocks) not in MODE_FITS[forced]:
            with pytest.raises(ValueError, match=forced):
                fc.launch_plan(n, d, 15, blocks, mode=forced)
            continue
        p = fc.launch_plan(n, d, 15, blocks, mode=forced)
        assert p.smem_bytes <= 232_448
        if forced != "resident":
            assert 2 <= p.stages <= fc.PCG_MAX_STAGES
    assert plan.smem_bytes <= 232_448


def test_launch_plan_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="resident"):
        fc.launch_plan(65 ** 3, 3, 15, SMS, mode="resident")
    with pytest.raises(ValueError, match="mode"):
        fc.launch_plan(100, 1, 15, SMS, mode="fast")
    with pytest.raises(NotImplementedError):
        fc.launch_plan(100, 1, 27, SMS)


# -- d=2: rectangle lattices ----------------------------------------------------


def _pallas_vector_solve(j, streamed):
    offs = j["ops"].offsets
    n = j["b_u"].shape[0]
    Wt = jpc.tile_vector_planes(jpc.fold_mask_vector(offs, j["Wel"], j["mask_u"]), n)
    Bt = jpc.tile_binv(jpc.fold_mask_binv(j["Binv"], j["mask_u"]), n)
    if not streamed:
        return jpc.cg_vector(offs, Wt, Bt, j["b_u"], 1e-6, 0.0, 400, n)
    cfg = jpc.streamed_cfg(offs, n, 2, rv_candidates=(8,))
    assert cfg is not None and cfg[2] // cfg[0] >= 2  # several chunks
    return jpc.cg_vector_streamed(offs, Wt, Bt, j["b_u"], 1e-6, 0.0, 400, n, cfg=cfg)


@pytest.mark.parametrize("streamed", [False, True], ids=["resident", "streamed"])
def test_plain_vector_solve_2d_matches_pallas_interpret_f32(streamed, monkeypatch):
    """The plain d=2 block-Jacobi solve on a 48 x 48 rectangle (2,401 nodes,
    7 offsets) at f32 against the resident (K3b) and the streamed (K3c)
    Pallas kernel in interpret mode, the latter in several chunks:
    |Δiters| <= 2 and rel 1e-4."""
    monkeypatch.setenv("GLIMS_PALLAS_INTERPRET", "1")
    P = _problem(4, jnp.float32, torch.float32, rect=48)
    j, t = P["jax"], P["torch"]
    assert len(t["ops"].offsets) == 7 and tuple(t["b_u"].shape) == (49 ** 2, 2)
    x_j, info_j = _pallas_vector_solve(j, streamed)
    x_t, info_t = _torch_solve(t, "vector", 1e-6, 400)
    assert x_t.dtype == torch.float32
    assert abs(int(info_t["iters"]) - int(info_j["iters"])) <= 2
    assert _rel(x_t, x_j) <= 1e-4


@pytest.mark.parametrize("kind", ["scalar", "vector"])
def test_plain_fused_solve_2d_matches_jax_pcg_f64(kind):
    """The plain solves on a 12 x 12 rectangle at f64 against JAX ``pcg``
    on the where-masked operator: equal iterations and rel 1e-10."""
    P = _problem(5, jnp.float64, torch.float64, rect=12)
    j, t = P["jax"], P["torch"]
    ops = j["ops"]
    if kind == "scalar":
        m = j["mask_c"]
        diag = jnp.where(m, 1.0, j["Wrd"][ops.offsets.index(0)])
        x_j, info_j = jax_pcg(
            lambda v: jnp.where(m, v, ops.apply_scalar(j["Wrd"], jnp.where(m, 0.0, v))),
            j["b_c"], M=lambda r: r / diag, rtol=1e-10, atol=0.0, maxiter=500)
    else:
        m = j["mask_u"]
        x_j, info_j = jax_pcg(
            lambda v: jnp.where(m, v, ops.apply_vector(j["Wel"], jnp.where(m, 0.0, v))),
            j["b_u"], M=lambda r: jnp.where(
                m, r, ops.apply_block_jacobi(j["Binv"], jnp.where(m, 0.0, r))),
            rtol=1e-10, atol=0.0, maxiter=500)
    x_t, info_t = _torch_solve(t, kind, 1e-10, 500)
    assert int(info_t["iters"]) == int(info_j["iters"])
    assert _rel(x_t, x_j) <= 1e-10


MODE_FITS_2D = {  # (N, blocks) of an N x N rectangle: whether each forced mode fits
    "resident": {(50, SMS), (50, 114), (50, 4), (300, SMS), (422, SMS)},
    "streamed": {(50, SMS), (50, 114), (50, 4), (300, SMS), (422, SMS), (423, SMS),
                 (512, SMS), (512, 114), (1024, SMS)},
}


@pytest.mark.parametrize("N,blocks,mode", [
    (50, SMS, "resident"), (50, 114, "resident"), (50, 4, "resident"),
    (300, SMS, "resident"), (422, SMS, "resident"), (423, SMS, "streamed"),
    (512, SMS, "streamed"), (512, 114, "streamed"), (1024, SMS, "streamed"),
    (1024, 114, "streamed_global"),
])
def test_launch_plan_2d_mode_ranges_and_shared_memory(N, blocks, mode):
    """d=2, 7 offsets: resident up to 179,520 nodes on 132 SMs (a 423 x 423
    lattice, 178,929 nodes; 1,360 a block), streamed past it (the 512 x 512
    rectangle with 4 ring stages), streamed_global where x, r and Ap do not
    fit beside two stages; ranges cover [0, n) and shared memory stays
    within 232,448 bytes in every mode that fits."""
    n = (N + 1) ** 2
    plan = fc.launch_plan(n, 2, 7, blocks)
    assert plan.mode == mode and plan.blocks == blocks
    ranges = plan.ranges(n)
    assert ranges[0][0] == 0 and ranges[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert sum(r1 - r0 for r0, r1 in ranges) == n
    if (N, blocks) == (512, SMS):
        assert plan.stages == 4
    for forced in fc.MODES:
        if forced != "streamed_global" and (N, blocks) not in MODE_FITS_2D[forced]:
            with pytest.raises(ValueError, match=forced):
                fc.launch_plan(n, 2, 7, blocks, mode=forced)
            continue
        p = fc.launch_plan(n, 2, 7, blocks, mode=forced)
        assert p.smem_bytes <= 232_448
        if forced != "resident":
            assert 2 <= p.stages <= fc.PCG_MAX_STAGES
    with pytest.raises(NotImplementedError, match="d=4"):
        fc.launch_plan(n, 4, 7, blocks)


def test_cuda_wrappers_take_the_plain_path_on_cpu():
    P = _problem(3, jnp.float64, torch.float64)
    t = P["torch"]
    offs = t["ops"].offsets
    Wm = fc.fold_mask_vector(offs, t["Wel"], t["mask_u"])
    Bm = fc.fold_mask_binv(t["Binv"], t["mask_u"])
    want, _ = fc.cg_vector_plain(offs, Wm, Bm, t["b_u"], 1e-8, 0.0, 300)
    before = fc.cg_vector.launches
    got, _ = fc.cg_vector(offs, Wm, Bm, t["b_u"], 1e-8, 0.0, 300)
    assert fc.cg_vector.launches == before
    assert torch.equal(got, want)
