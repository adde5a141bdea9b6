"""Chebyshev polynomial preconditioning (``StepConfig.precond_degree > 1``)
in glimslib_tpu_torch against the JAX package, on the CPU at f64.

- (a) ``solvers/cg.py estimate_lmax`` and ``make_chebyshev_precond``
  against the JAX functions on the SPD system of the reference's
  tests/test_solvers.py:72-94 (I + 40 L) within 1e-12, at an even and an
  odd degree (the even one rounded up to odd), and that test's claim: the
  polynomial reaches Jacobi's solution in at most half its iterations;
- (b) at degrees 3 and 6 (run as 7) on the lanes of the brain box
  (tests/torch_chebyshev_cases.py, which the spawned ranks import): the
  n = 4 lattice padded for two ranks (the pcg branch on the stencil
  planes, where degree 0 takes the whole-solve PCG), unsharded and at
  two gloo ranks under ``use_sharding(mode="nodes")`` (the power
  iteration's norms reduced over the ranks, its start vector the rows of
  the whole one), the same box stripped of its lattice (the supernode
  halo-ELL lane), the lattice on the matrix-free jvp lane and the quad
  model on the stripped n = 3 box.  ``value_and_grad`` of type 2 at V0
  (2 steps) on the targets of the port's unsharded forward at the set-up
  parameters: the forward inside it (c and u of every step) and J within
  rel 1e-8 of the JAX package's value_and_grad at the same degree (one
  jitted program, its forward handed out by a debug callback; its
  unsharded lattice for both lattice runs, its pcg branch being the one
  its 'nodes' mode takes), the Newton counts equal and every solve's CG
  count, forward and adjoint, within one of the JAX package's (on the
  supernode lanes with the rd preconditioner its model builds and leaves
  unused wired into its step, ``_wire_rd_precond``); the gradient within
  1e-8;
- (c) the reference's tests/test_solvers.py:96-135 on the port: a 12 x
  12 rectangle, 3 steps, degree 6 against degree 0: c within 1e-8, u
  within 1e-7;
- (d) the sharded modes at degree 3 and two gloo ranks, on the brain box
  of tests/torch_nodeshard_cases.py (n = 4, Morton-ordered, padded to 128
  nodes): 'bell' (the supernode lane on replicated vectors), 'cells' and
  the unstructured 'nodes' (the matrix-free lane; under 'nodes' the
  power iteration's norms reduced over the ranks): forward, J and the
  gradient within 1e-8 of the JAX package's matrix-free run at degree 3,
  bit-equal on both ranks; under 'nodes' (the same preconditioners as
  that run) the Newton counts equal and every CG count within one.
"""

import os
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch_chebyshev_cases as cases  # noqa: E402
from __graft_entry__ import _brain_sim as jax_brain_sim  # noqa: E402
from glimslib_tpu.core.mesh import Mesh as JaxMesh  # noqa: E402
from glimslib_tpu.core.mesh import pad_mesh_nodes as jax_pad  # noqa: E402
from glimslib_tpu.optimize.adjoint import param_map_for_type  # noqa: E402
from glimslib_tpu.solvers import cg as jax_cg  # noqa: E402
from glimslib_tpu.solvers.coupled import StepConfig as JaxStepConfig  # noqa: E402
from glimslib_tpu_torch.core.mesh import rectangle_mesh  # noqa: E402
from glimslib_tpu_torch.models.tumor_growth import TumorGrowth  # noqa: E402
from glimslib_tpu_torch.parallel import run_ranks  # noqa: E402
from glimslib_tpu_torch.solvers import cg  # noqa: E402
from torch_jax_vg import value_and_grad_with_forward  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

LANES = ("lattice", "stripped", "matrix_free", "quad")
DEGREES = (3, 6)


def _rel(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


# -- (a) the primitives ------------------------------------------------------------


def _spd(n=64):
    L = 2.0 * np.eye(n) - np.eye(n, k=1) - np.eye(n, k=-1)
    A = np.eye(n) + 40.0 * L
    b = np.random.default_rng(3).standard_normal(n)
    return A, b


@pytest.mark.parametrize("degree", [6, 7])
def test_primitives_match_jax(degree):
    """(a) (module docstring)."""
    A, b = _spd()
    At, bt = torch.as_tensor(A), torch.as_tensor(b)
    Aj, bj = jnp.asarray(A), jnp.asarray(b)
    dt_, dj = torch.diagonal(At), jnp.diag(Aj)
    lmax_t = cg.estimate_lmax(lambda v: At @ v, lambda r: r / dt_, bt.shape, bt.dtype)
    lmax_j = float(jax_cg.estimate_lmax(lambda v: Aj @ v, lambda r: r / dj, bj.shape,
                                        bj.dtype))
    assert abs(float(lmax_t) - lmax_j) <= 1e-12 * lmax_j
    Mt = cg.make_chebyshev_precond(lambda v: At @ v, lambda r: r / dt_, lmax_t, degree)
    Mj = jax_cg.make_chebyshev_precond(lambda v: Aj @ v, lambda r: r / dj, lmax_j, degree)
    M7 = cg.make_chebyshev_precond(lambda v: At @ v, lambda r: r / dt_, lmax_t, 7)
    for seed in range(3):
        r = np.random.default_rng(seed).standard_normal(b.shape)
        got, want = Mt(torch.as_tensor(r)).numpy(), np.asarray(Mj(jnp.asarray(r)))
        assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
        # an even degree is rounded up to odd
        assert np.array_equal(got, M7(torch.as_tensor(r)).numpy())
    xj, info_j = cg.pcg(lambda v: At @ v, bt, M=lambda r: r / dt_, rtol=1e-10,
                        maxiter=2000)
    xc, info_c = cg.pcg(lambda v: At @ v, bt, M=Mt, rtol=1e-10, maxiter=2000)
    _, info_jax = jax_cg.pcg(lambda v: Aj @ v, bj, M=Mj, rtol=1e-10, maxiter=2000)
    assert np.allclose(xc.numpy(), xj.numpy(), atol=1e-7)
    assert int(info_c["iters"]) * 2 <= int(info_j["iters"])
    assert abs(int(info_c["iters"]) - int(info_jax["iters"])) <= 1


# -- (b) the lanes --------------------------------------------------------------------


def _jax_model(lane, degree):
    """The JAX package's model of cases.port_model."""
    kw = dict(dims=3, dtype=jnp.float64)
    morton = dict(mesh_transform=lambda m: JaxMesh.from_arrays(
        m.points, m.cells).reordered_morton())
    if lane == "quad":
        sim = jax_brain_sim(n=3, quad=True, **morton, **kw)
    elif lane == "lattice":
        sim = jax_brain_sim(n=4, pad_to=cases.NODES_WORLD, **kw)
    elif lane == "stripped":
        sim = jax_brain_sim(n=4, **morton, **kw)
    else:
        sim = jax_brain_sim(n=4, **kw)
    if lane == "matrix_free":
        sim.operator_mode = "matrix-free"
    sim.step_config = JaxStepConfig(**cases.TIGHT, precond_degree=degree)
    return sim


def _jax_run(sim, monkeypatch, targets):
    """The JAX package's value_and_grad of type 2 at V0 on ``targets`` with
    the forward inside it (tests/torch_jax_vg.py: one jitted program), on
    the supernode lane with its rd preconditioner wired
    (:func:`_wire_rd_precond`)."""
    if sim.mesh.lattice_strides is None and sim.operator_mode != "matrix-free":
        _wire_rd_precond(sim, monkeypatch)
    names, update = param_map_for_type(2)
    out = value_and_grad_with_forward(sim, names, update, targets, cases.V0,
                                      cases.N_STEPS, monkeypatch)
    assert out["ok"]
    return out


def _wire_rd_precond(sim, monkeypatch):
    """The JAX package's supernode lane builds ``rd_precond`` (supernode
    block-Jacobi, glimslib_tpu/models/base.py:1639-1681) and never hands
    it to ``make_step`` (:1693-1711), so its rd solves take Jacobi on
    ``rd_diag``; the port's take that preconditioner.  Hand it over, as
    written there (no two-level level below GLIMS_TWOLEVEL_MIN_NODES)."""
    from glimslib_tpu.models import base as jax_base
    from glimslib_tpu.ops import bell as jax_bell

    quad = getattr(sim, "CONCENTRATION_DEGREE", 1) == 2
    plan = sim._get_p2_plan() if quad else sim._get_bell_plan()
    key = "_McSNP2" if quad else "_McSN"

    def rd_precond(theta):
        if isinstance(theta, dict) and key in theta:
            Minv = theta[key]
            return lambda r: jax_bell.apply_supernode_jacobi(plan, Minv, r)
        diag = sim.rd_diag(theta)
        return lambda r: r / diag

    make_step = jax_base.make_step
    monkeypatch.setattr(jax_base, "make_step",
                        lambda **kw: make_step(**kw, rd_precond=rd_precond))


def _within_one(got, want):
    return (len(got) == len(want)
            and all(abs(a - b) <= 1 for a, b in zip(got, want))), (got, want)


@pytest.mark.parametrize("degree", DEGREES)
@pytest.mark.parametrize("lane", LANES)
def test_lane_matches_jax(lane, degree, monkeypatch):
    """(b) (module docstring)."""
    # the JAX package's P2 plan with the port's flat halo
    monkeypatch.setenv("GLIMS_P2_HALO_CHUNK", "1")
    outs = [cases.run(cases.port_model(lane, degree))]
    targets = outs[0]["targets"]
    want = _jax_run(_jax_model(lane, degree), monkeypatch, targets)
    if lane == "lattice":
        ranks = run_ranks(cases.nodes_rank, cases.NODES_WORLD, "gloo", "cpu",
                          args=(degree, targets), timeout=300)
        for r in ranks[1:]:
            assert r["J"] == ranks[0]["J"] and np.array_equal(r["g"], ranks[0]["g"])
            assert np.array_equal(r["c"], ranks[0]["c"])
            assert r["vg_counts"] == ranks[0]["vg_counts"]
        outs.append(ranks[0])
    for out in outs:
        # the lattice leaves the whole-solve PCG for the pcg branch
        assert out["pcg"] == (lane == "lattice")
        assert out["ok"] and out["newton"] == want["newton"]
        for blk in ("rd", "el"):
            ok, why = _within_one(out["counts"][blk], want["counts"][blk])
            assert ok, (blk, why)
            ok, why = _within_one(out["vg_counts"][blk], want["vg_counts"][blk])
            assert ok, (blk, "value_and_grad", why)
        for k in range(cases.N_STEPS):
            assert _rel(out["c"][k], want["c"][k]) <= 1e-8
            assert _rel(out["u"][k], want["u"][k]) <= 1e-8
        assert abs(out["J"] - want["J"]) <= 1e-8 * abs(want["J"])
        assert _rel(out["g"], want["g"]) <= 1e-8, (out["g"], want["g"])


# -- (c) degree 6 against degree 0 -----------------------------------------------------


class _Boundary:
    def inside(self, x, on_boundary):
        return on_boundary


def test_chebyshev_step_solution_unchanged(tmp_path):
    """(c) (module docstring)."""

    def run(degree):
        sim = TumorGrowth(rectangle_mesh((-5, -5), (5, 5), 12, 12), dtype=torch.float64,
                          device="cpu")
        sim.setup_global_parameters(
            boundaries={"boundary_all": _Boundary()},
            dirichlet_bcs={"clamped": {"bc_value": np.zeros(2),
                                       "named_boundary": "boundary_all",
                                       "subspace_id": 0}})
        sim.setup_model_parameters(
            iv_expression={0: np.zeros(2),
                           1: lambda x: np.exp(-0.5 * (x ** 2).sum(axis=1))},
            diffusion=0.2, coupling=0.2, proliferation=0.1, E=0.001, poisson=0.45,
            sim_time=3, sim_time_step=1)
        sim.step_config = sim.step_config._replace(precond_degree=degree)
        sim.run(save_method=None, output_dir=str(tmp_path / f"d{degree}"))
        return sim

    s0, s6 = run(0), run(6)
    assert not s0._lattice_pcg and s6._lattice_pcg
    assert _rel(s6.solution[1], s0.solution[1]) < 1e-8
    assert _rel(s6.solution[0], s0.solution[0]) < 1e-7
