"""The node block-ELL lane (``GLIMS_BELL=0``) of glimslib_tpu_torch against
the JAX package's, on the CPU at f64.

- ``ops/ell.py``: ``apply_ell_vector``, ``apply_ell_scalar`` and
  ``build_ell_rd_wc`` against ``glimslib_tpu/ops/ell.py`` within 1e-12 on a
  triangle and a tet mesh, their VJPs (in the values and x; in c) against
  ``jax.vjp`` within 1e-12.
- tests/test_ell.py's unstructured brain (the n = 6 box, RCM-ordered)
  with GLIMS_BELL=0 set for both packages, the TIGHT step, 2 steps: c and
  u within rel 1e-8 of the JAX package's, the Newton counts equal and
  every CG count within one (Jacobi on the rd block and per-node
  block-Jacobi on the elasticity block on both sides), no chord operator
  and no supernode state; ``value_and_grad`` of type 2 at the benchmark's
  cell: J and the gradient within 1e-8; the same forward with the
  two-level level on (GLIMS_TWOLEVEL_MIN_NODES=100, the JAX side given its
  runtime_aux); the quad model on the Morton n = 3 box (rd on the jvp
  lane, elasticity on node ELL); ``use_sharding("auto")`` falling back to
  ``cells`` with the reference's reason, and ``mode="bell"`` raising, as
  the JAX package's do.
"""

import logging
import os
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch_switch_cases as cases  # noqa: E402
import torch_switch_jax as J  # noqa: E402
from glimslib_tpu.core.mesh import Mesh as JaxMesh  # noqa: E402
from glimslib_tpu.core.mesh import box_mesh as jax_box_mesh  # noqa: E402
from glimslib_tpu.core.mesh import rectangle_mesh as jax_rectangle_mesh  # noqa: E402
from glimslib_tpu.ops import ell as jell  # noqa: E402
from glimslib_tpu.ops.assembly import P1Kernels as JaxP1Kernels  # noqa: E402
from glimslib_tpu.parallel.shard import make_device_mesh as jax_device_mesh  # noqa: E402
from glimslib_tpu_torch.core.mesh import Mesh, box_mesh, rectangle_mesh  # noqa: E402
from glimslib_tpu_torch.ops import ell  # noqa: E402
from glimslib_tpu_torch.ops.assembly import P1Kernels  # noqa: E402
from glimslib_tpu_torch.parallel.shard import DeviceMesh  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401


_rel = J.rel


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


# -- ops/ell.py ------------------------------------------------------------------------


def _ell_pair(kind):
    if kind == "tri":
        mt, mj = rectangle_mesh((0, 0), (2, 1), 6, 5), jax_rectangle_mesh((0, 0), (2, 1), 6, 5)
    else:
        mt = box_mesh((0, 0, 0), (1, 1, 2), 3, 3, 4)
        mj = jax_box_mesh((0, 0, 0), (1, 1, 2), 3, 3, 4)
    mt = Mesh.from_arrays(mt.points, mt.cells).reordered_rcm()
    mj = JaxMesh.from_arrays(mj.points, mj.cells).reordered_rcm()
    return (mt, P1Kernels(mt, dtype=torch.float64), ell.EllPlan(mt),
            mj, JaxP1Kernels(mj, dtype=jnp.float64), jell.EllPlan(mj))


@pytest.mark.parametrize("kind", ["tri", "tet"])
def test_ell_primitives_equal_jax(kind):
    """apply_ell_vector / apply_ell_scalar / build_ell_rd_wc and their VJPs
    within 1e-12 of the JAX package's."""
    mt, kt, pt, mj, kj, pj = _ell_pair(kind)
    assert np.array_equal(pt.adj, pj.adj)
    n, d, K = mt.n_nodes, mt.dim, pt.K
    rng = np.random.default_rng(3)
    B = rng.standard_normal((n, K, d, d))
    W = rng.standard_normal((n, K))
    x = rng.standard_normal((n, d))
    xs = rng.standard_normal(n)
    adj_j = jnp.asarray(pj.adj)
    for fj, ft, A, v in ((jell.apply_ell_vector, ell.apply_ell_vector, B, x),
                         (jell.apply_ell_scalar, ell.apply_ell_scalar, W, xs)):
        yj, vjp = jax.vjp(lambda a, z: fj(adj_j, a, z), jnp.asarray(A), jnp.asarray(v))
        At, vt = _t(A).requires_grad_(), _t(v).requires_grad_()
        yt = ft(pt.adj_idx, At, vt)
        assert _rel(yt.detach(), yj) <= 1e-12
        ybar = rng.standard_normal(yj.shape)
        gA, gv = torch.autograd.grad(yt, (At, vt), _t(ybar))
        gAj, gvj = vjp(jnp.asarray(ybar))
        assert _rel(gA, gAj) <= 1e-12 and _rel(gv, gvj) <= 1e-12
    c = rng.random(n)
    rho = 0.2 + 0.1 * rng.random(mt.n_cells)

    def wc_j(cc):
        return jell.build_ell_rd_wc(pj, (kj.grads_T, kj.vol), kj.cells_flat, cc, rho, 0.7,
                                    kj._t0, 1.0, jnp.float64)

    Wj, vjp = jax.vjp(wc_j, jnp.asarray(c))
    ct = _t(c).requires_grad_()
    Wt = ell.build_ell_rd_wc(pt, (kt.grads_T, kt.vol), kt.cells_flat, ct, _t(rho), 0.7,
                             kt._t0, 1.0)
    assert tuple(Wt.shape) == (n, K) and _rel(Wt.detach(), Wj) <= 1e-12
    wbar = rng.standard_normal((n, K))
    (gc,) = torch.autograd.grad(Wt, ct, _t(wbar))
    assert _rel(gc, vjp(jnp.asarray(wbar))[0]) <= 1e-12


# -- the lane ----------------------------------------------------------------------------


def _ell_lane(sim):
    """The port model is on the node block-ELL lane: no supernode plan or
    state, no chord operator."""
    assert not sim._use_bell() and not sim.matrix_free
    b = sim._ell_builders()
    assert "rd_jacobian_chord" not in b and sim._bell_plan is None
    aux = sim.runtime_aux()
    assert not any(k.startswith(("_Bell", "_BinvSN", "_McSN", "_F")) for k in aux)
    return b


@pytest.mark.parametrize("twolevel", [False, True], ids=["jacobi", "twolevel"])
def test_ell_lane_forward_matches_jax(twolevel, monkeypatch):
    """GLIMS_BELL=0 on both sides: 2 steps within 1e-8, Newton equal, CG
    within one; with the two-level level the frozen coarse arrays on both
    sides and no supernode state."""
    monkeypatch.setenv("GLIMS_BELL", "0")
    if twolevel:
        monkeypatch.setenv("GLIMS_TWOLEVEL_MIN_NODES", "100")
    jsim = J.ell_brain()
    assert not jsim._use_bell() and jsim._rd_jacobian_chord is None
    want = J.jax_run(jsim, monkeypatch)
    sim = cases.ell_brain()
    _ell_lane(sim)
    aux = sorted(sim.runtime_aux())
    assert aux == want["aux"]
    assert ("_TLCfac" in aux) == twolevel
    J.check_forward(cases.run(sim), want)


def test_ell_lane_value_and_grad_matches_jax(monkeypatch):
    """GLIMS_BELL=0: J and the gradient of type 2 within 1e-8 of the JAX
    package's (the IFT adjoint's solves on the ELL operators), on the
    targets of the port's forward, and the forward inside it within 1e-8
    of the one inside the JAX package's (Newton equal, CG within one)."""
    monkeypatch.setenv("GLIMS_BELL", "0")
    sim = cases.ell_brain()
    _ell_lane(sim)
    out = cases.run(sim, "own")
    want = J.jax_vg(J.ell_brain(), monkeypatch, out["targets"])
    J.check_forward(out["v0"], want)
    assert abs(out["J"] - want["J"]) <= 1e-8 * abs(want["J"])
    assert _rel(out["g"], want["g"]) <= 1e-8, (out["g"], want["g"])
    assert sim.solver_info["el_adj_cg_iters"] and sim.solver_info["rd_adj_cg_iters"]


def test_quad_ell_lane_forward_matches_jax(monkeypatch):
    """A quad model under GLIMS_BELL=0: its P2 rd block on the jvp lane,
    its elasticity block on node ELL (a mixed step), forward within 1e-8
    of the JAX package's, Newton equal, CG within one."""
    monkeypatch.setenv("GLIMS_BELL", "0")
    want = J.jax_run(J.box_brain(3, quad=True), monkeypatch)
    sim = cases.box_brain(3, quad=True)
    b = _ell_lane(sim)
    assert b["rd_jacobian"] is None and b["el_operator"] is not None
    out = cases.run(sim)
    assert not sim._warm_start_ok
    J.check_forward(out, want)


def test_sharding_without_the_bell_lane(caplog, monkeypatch):
    """GLIMS_BELL=0: use_sharding("auto") takes 'cells' with the
    reference's reason (a world of 2 that divides the supernode blocks),
    and mode='bell' raises, in both packages."""
    monkeypatch.setenv("GLIMS_BELL", "0")
    why = "supernode halo-ELL path inactive"
    jsim = J.box_brain(4)
    two = DeviceMesh(None, 0, 2, torch.device("cpu"), "mesh_x", "gloo")
    with caplog.at_level(logging.WARNING):
        caplog.clear()
        jsim.use_sharding(jax_device_mesh(2))
        assert jsim.sharding_mode == "cells"
        assert any(why in r.getMessage() for r in caplog.records)
        caplog.clear()
        sim = cases.box_brain(4)
        assert sim._get_bell_plan().nb % 2 == 0
        assert sim.use_sharding(two) is two and sim.sharding_mode == "cells"
        assert any("fell back to the SLOW 'cells' lane" in r.getMessage()
                   and why in r.getMessage() for r in caplog.records)
    match = "mode='bell' needs the supernode halo-ELL path"
    with pytest.raises(ValueError, match=match):
        J.box_brain(4).use_sharding(jax_device_mesh(2), mode="bell")
    with pytest.raises(ValueError, match=match):
        cases.box_brain(4).use_sharding(two, mode="bell")
