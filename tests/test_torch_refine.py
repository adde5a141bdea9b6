"""Port parity of mixed-precision refinement (``StepConfig.refine_f64``):
f32 solves with f64 residuals and one f64-defect correction solve of the
elasticity block (``glimslib_tpu_torch/solvers/coupled.py``), against the
JAX package (x64 on, as tier-1 runs it) and the independent scipy FEM
(``tests/reference_fem.py``), on the CPU.

Tolerances: the 30 x 30 rectangle's final c and u within 1e-6 of the
scipy FEM (the reference's own test, ``test_solvers.py:138-209``); the
port's f32-refined final states within rel-L2 1e-5 of the JAX package's
(both converge the f64 residual with f32 operators whose rounding
differs); under the bench's REFINED_STEP_CONFIG, each package's
f32-refined distance from its own f64 path within 2% of the other's; the
f64 gather residual within 1e-12 of the JAX one; J of the refined
unstructured lane within 1e-4 of the f64 J.
"""

import os
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from __graft_entry__ import _brain_sim as jax_brain_sim  # noqa: E402
from glimslib_tpu.core.mesh import Mesh as JaxMesh  # noqa: E402
from glimslib_tpu.core.mesh import rectangle_mesh as jax_rectangle_mesh  # noqa: E402
from glimslib_tpu.models.tumor_growth import TumorGrowth as JaxTumorGrowth  # noqa: E402
from glimslib_tpu.ops.assembly import P1Kernels as JaxP1Kernels  # noqa: E402
from glimslib_tpu.solvers.coupled import StepConfig as JaxStepConfig  # noqa: E402
from glimslib_tpu_torch import config  # noqa: E402
from glimslib_tpu_torch import convert  # noqa: E402
from glimslib_tpu_torch.core.mesh import Mesh, box_mesh, rectangle_mesh  # noqa: E402
from glimslib_tpu_torch.examples import (  # noqa: E402
    REFINED_STEP_CONFIG, UNSTRUCT_STEP_CONFIG, adjoint_problem, brain_sim,
)
from glimslib_tpu_torch.models.tumor_growth import TumorGrowth  # noqa: E402
from glimslib_tpu_torch.ops.assembly import P1Kernels  # noqa: E402
from glimslib_tpu_torch.solvers.coupled import StepConfig  # noqa: E402

from reference_fem import ReferenceFEM  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.linalg.norm(a.ravel() - b.ravel()) / max(np.linalg.norm(b), 1e-300)


class Boundary:
    def inside(self, x, on_boundary):
        return on_boundary


_CLAMPED = {"clamped": {"bc_value": np.zeros(2), "named_boundary": "boundary_all",
                        "subspace_id": 0}}
_RECT_PARAMS = dict(diffusion=0.1, coupling=1.0, proliferation=0.1, E=0.001,
                    poisson=0.45, sim_time=3, sim_time_step=1)


def _rect_iv():
    return {0: np.zeros(2), 1: lambda x: np.exp(-(x ** 2).sum(axis=1))}


def test_refine_f64_auto_default(monkeypatch):
    """The tri-state (the reference's test_solvers.py:211-233 under x64):
    "auto" is on for f32 and off for f64, "0" and "1" win, and a model's
    default step takes it."""
    monkeypatch.setattr(config, "refine_f64", "auto")
    assert config.resolve_refine_f64(torch.float32) is True
    assert config.resolve_refine_f64(torch.float64) is False
    monkeypatch.setattr(config, "refine_f64", "0")
    assert config.resolve_refine_f64(torch.float32) is False
    monkeypatch.setattr(config, "refine_f64", "1")
    assert config.resolve_refine_f64(torch.float32) is True

    monkeypatch.setattr(config, "refine_f64", "auto")
    mesh = rectangle_mesh((0, 0), (1, 1), 4, 4)
    assert TumorGrowth(mesh, dtype=torch.float32, device="cpu").step_config.refine_f64
    assert not TumorGrowth(mesh, dtype=torch.float64, device="cpu").step_config.refine_f64


def _rect_sim(refine):
    sim = TumorGrowth(rectangle_mesh((-5, -5), (5, 5), 30, 30), dtype=torch.float32,
                      device="cpu")
    sim.setup_global_parameters(boundaries={"boundary_all": Boundary()},
                                dirichlet_bcs=_CLAMPED)
    sim.setup_model_parameters(iv_expression=_rect_iv(), **_RECT_PARAMS)
    sim.step_config = StepConfig(newton_rtol=1e-5, newton_atol=1e-6, cg_rtol=3e-7,
                                 cg_maxiter=2000, refine_f64=refine)
    return sim


def _final(sim, n_steps=3):
    u_tr, c_tr, ok, _ = sim.build_simulate_fn(n_steps, 1.0)(
        sim.make_theta(sim.params.as_dict()), *sim.initial_state())
    assert bool(ok.all())
    return u_tr[-1].numpy(), c_tr[-1].numpy()


def test_refinement_beats_f32_against_scipy_fem():
    """The reference's 30 x 30 rectangle (test_solvers.py:138-209) through
    the port at f32: refined c and u within 1e-6 of the scipy FEM, and c
    closer to it than plain f32's; every step runs one correction solve."""
    sim = _rect_sim(True)
    mesh = sim.mesh
    ref = ReferenceFEM(mesh)
    c = np.asarray(sim.params.create_initial_value_function()[1], dtype=np.float64)
    u = np.zeros(mesh.n_nodes * 2)
    bn = mesh.boundary_nodes
    E, nu = 0.001, 0.45
    mu = E / (2 * (1 + nu))
    lam = E * nu / ((1 + nu) * (1 - 2 * nu))
    for _ in range(3):
        u, c = ref.solve_step(u, c, 0.1, 0.1, mu, lam, 1.0, 1.0,
                              dirichlet_disp_nodes=bn,
                              dirichlet_disp_values=np.zeros((len(bn), 2)))
    ur, cr = _final(sim)
    assert len(sim.solver_info["el_refine_cg_iters"]) == 3
    u32, c32 = _final(_rect_sim(False))
    assert _rel(cr, c) < 1e-6, _rel(cr, c)
    assert _rel(ur, u.reshape(-1, 2)) < 1e-6, _rel(ur, u.reshape(-1, 2))
    assert _rel(cr, c) < _rel(c32, c)


def _jax_rect_refined():
    sim = JaxTumorGrowth(jax_rectangle_mesh((-5, -5), (5, 5), 12, 12), dtype=jnp.float32)
    sim.setup_global_parameters(boundaries={"boundary_all": Boundary()},
                                dirichlet_bcs=_CLAMPED)
    sim.setup_model_parameters(iv_expression=_rect_iv(), **_RECT_PARAMS)
    assert sim.step_config.refine_f64
    return sim


def _jax_final(sim, n_steps=3):
    theta = sim.make_theta(sim.params.as_dict())
    theta = {k: jnp.asarray(v, jnp.float32) if jnp.asarray(v).dtype.kind == "f" else v
             for k, v in theta.items()}
    iv = sim.params.create_initial_value_function()
    aux = sim.runtime_aux()
    args = (theta, jnp.asarray(iv[0], jnp.float32), jnp.asarray(iv[1], jnp.float32))
    u, c, ok, _ = jax.jit(sim.build_simulate_fn(n_steps, 1.0))(
        *(args + (aux,) if aux else args))
    assert bool(np.asarray(ok).all())
    return np.asarray(u[-1]), np.asarray(c[-1]), theta, iv, aux


@pytest.mark.parametrize("lane", ["lattice", "unstructured"])
def test_refined_f32_matches_jax_refined(monkeypatch, lane):
    """The models' f32 defaults refine on both sides: the port's final
    states within rel-L2 1e-5 of the JAX package's on a 12 x 12 rectangle
    lattice and on the n=6 Morton brain box (two-level level on, its
    factors in bf16 on both sides and carried across)."""
    monkeypatch.setenv("GLIMS_TWOLEVEL_MIN_NODES", "100")
    if lane == "lattice":
        sim_j = _jax_rect_refined()
        sim_t = TumorGrowth(rectangle_mesh((-5, -5), (5, 5), 12, 12),
                            dtype=torch.float32, device="cpu")
        sim_t.setup_global_parameters(boundaries={"boundary_all": Boundary()},
                                      dirichlet_bcs=_CLAMPED)
        sim_t.setup_model_parameters(iv_expression=_rect_iv(), **_RECT_PARAMS)
    else:
        sim_j = jax_brain_sim(n=6, dims=3, dtype=jnp.float32, mesh_transform=lambda m: (
            JaxMesh.from_arrays(m.points, m.cells).reordered_morton()))
        assert sim_j.step_config.refine_f64
        sim_t = brain_sim(n=6, dtype=torch.float32, device="cpu", unstructured=True)
    assert sim_t.step_config.refine_f64
    u_j, c_j, theta_j, iv, aux_j = _jax_final(sim_j)
    theta_t = convert.theta_from_numpy({k: np.asarray(v) for k, v in theta_j.items()},
                                       dtype=torch.float32)
    u0, c0 = convert.state_from_numpy(iv[0], iv[1], dtype=torch.float32)
    aux_t = convert.aux_from_numpy({k: np.asarray(v) for k, v in aux_j.items()},
                                   dtype=torch.float32)
    if lane == "unstructured":
        assert aux_t["_TLCfac"].dtype == torch.bfloat16
    u_t, c_t, ok, _ = sim_t.build_simulate_fn(3, 1.0)(theta_t, u0, c0, aux_t)
    assert bool(ok.all())
    assert len(sim_t.solver_info["el_refine_cg_iters"]) == 3
    assert _rel(c_t[-1], c_j) <= 1e-5, _rel(c_t[-1], c_j)
    assert _rel(u_t[-1], u_j) <= 1e-5, _rel(u_t[-1], u_j)


@pytest.mark.parametrize("dim", [2, 3])
def test_elasticity_gather_path_matches_jax(dim):
    """P1Kernels.elasticity_residual (per-cell mu, lam, coupling and a body
    force) against the JAX package's at f64, max rel 1e-12."""
    from glimslib_tpu.core.mesh import box_mesh as jax_box_mesh

    if dim == 2:
        mt, mj = rectangle_mesh((0, 0), (2, 1), 6, 5), jax_rectangle_mesh((0, 0), (2, 1), 6, 5)
    else:
        mt, mj = box_mesh((0, 0, 0), (1, 1, 2), 3, 3, 4), jax_box_mesh((0, 0, 0), (1, 1, 2), 3, 3, 4)
    mt = Mesh.from_arrays(mt.points, mt.cells).reordered_morton()
    mj = JaxMesh.from_arrays(mj.points, mj.cells).reordered_morton()
    kt, kj = P1Kernels(mt, dtype=torch.float64), JaxP1Kernels(mj, dtype=jnp.float64)
    rng = np.random.default_rng(11)
    mids = mt.cell_midpoints
    mu, lam = 1.0 + mids[:, 0], 2.0 + mids[:, 1]
    cpl = 0.1 + 0.05 * rng.random(mt.n_cells)
    bf = rng.standard_normal(dim)
    u = rng.standard_normal((mt.n_nodes, dim))
    c = rng.random(mt.n_nodes)
    t = torch.as_tensor
    got = kt.elasticity_residual(t(u), t(c), t(mu), t(lam), t(cpl), body_force=t(bf))
    want = kj.elasticity_residual(jnp.asarray(u), jnp.asarray(c), jnp.asarray(mu),
                                  jnp.asarray(lam), jnp.asarray(cpl),
                                  body_force=jnp.asarray(bf))
    scale = np.abs(np.asarray(want)).max()
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-12 * scale


def test_refined_unstructured_J_matches_f64():
    """The unstructured lane's operating point (UNSTRUCT_STEP_CONFIG) at
    f32, refined: J within 1e-4 of the f64 J on the same targets (ROADMAP
    queue 1 item 7's measure; unrefined it sits at 1.5-1.9e-4), and the
    gradient within rel-L2 1e-2."""
    sim = brain_sim(n=6, dtype=torch.float32, device="cpu", unstructured=True)
    ip0, v0 = adjoint_problem(sim=sim)
    sim.step_config = UNSTRUCT_STEP_CONFIG._replace(refine_f64=True)
    same = dict(update_fn=ip0.update_fn, n_steps=ip0.n_steps, dt=ip0.dt)
    ip = type(ip0)(sim, ip0.param_names, ip0.targets, **same)
    J, g = ip.value_and_grad(v0)
    assert len(sim.solver_info["el_refine_cg_iters"]) == ip0.n_steps
    ref = brain_sim(n=6, dtype=torch.float64, device="cpu", unstructured=True)
    ip64 = type(ip0)(ref, ip0.param_names, ip0.targets, **same)
    J64, g64 = ip64.value_and_grad(v0)
    assert abs(J - J64) <= 1e-4 * abs(J64), (J, J64)
    assert np.linalg.norm(g - g64) <= 1e-2 * np.linalg.norm(g64), (g, g64)


def test_refined_error_at_the_bench_config_matches_jax(monkeypatch):
    """Under REFINED_STEP_CONFIG (newton_atol 1e-5, an absolute residual
    norm) the refined f32 state's distance from the f64 one is set by
    where the warm-started Newton stops, in both packages alike: on the
    n=6 Morton brain box (two-level level on, the JAX package's frozen
    arrays carried across), 5 steps, each side's f32-refined final state
    against its own f64 path at tight tolerances.  Newton counts equal
    step by step, and the last step stops after one iteration (the
    regime this test is for); the two errors agree to 2%, and the two
    f32-refined states to rel-L2 1e-6."""
    monkeypatch.setenv("GLIMS_TWOLEVEL_MIN_NODES", "100")
    tight = dict(newton_rtol=1e-10, newton_atol=1e-14, cg_rtol=1e-12, cg_maxiter=4000)
    n_steps = 5
    final, newton = {}, {}
    for name, jdt, tdt, cfg in (
            ("f32", jnp.float32, torch.float32, REFINED_STEP_CONFIG),
            ("f64", jnp.float64, torch.float64, StepConfig(**tight))):
        sim_j = jax_brain_sim(n=6, dims=3, dtype=jdt, mesh_transform=lambda m: (
            JaxMesh.from_arrays(m.points, m.cells).reordered_morton()))
        sim_j.step_config = JaxStepConfig(**cfg._asdict())
        theta = sim_j.make_theta(sim_j.params.as_dict())
        iv = sim_j.params.create_initial_value_function()
        aux = sim_j.runtime_aux()
        args = (theta, jnp.asarray(iv[0], jdt), jnp.asarray(iv[1], jdt), aux)
        u, c, ok, nn = jax.jit(sim_j.build_simulate_fn(n_steps, 1.0))(*args)
        assert bool(np.asarray(ok).all())
        final["jax", name] = (np.asarray(u[-1]), np.asarray(c[-1]))
        newton["jax", name] = np.asarray(nn).tolist()
        sim_t = brain_sim(n=6, dtype=tdt, device="cpu", unstructured=True)
        sim_t.step_config = cfg
        u, c, ok, nn = sim_t.build_simulate_fn(n_steps, 1.0)(
            convert.theta_from_numpy({k: np.asarray(v) for k, v in theta.items()},
                                     dtype=tdt),
            *convert.state_from_numpy(iv[0], iv[1], dtype=tdt),
            convert.aux_from_numpy({k: np.asarray(v) for k, v in aux.items()}, dtype=tdt))
        assert bool(ok.all())
        final["port", name] = (u[-1].numpy(), c[-1].numpy())
        newton["port", name] = nn.tolist()
    assert newton["port", "f32"] == newton["jax", "f32"]
    assert newton["jax", "f32"][-1] == 1
    for i, field in ((1, "c"), (0, "u")):
        err = {side: _rel(final[side, "f32"][i], final[side, "f64"][i])
               for side in ("port", "jax")}
        assert abs(err["port"] - err["jax"]) <= 0.02 * err["jax"], (field, err)
        assert _rel(final["port", "f32"][i], final["jax", "f32"][i]) <= 1e-6, field
