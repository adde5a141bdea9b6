"""Extrapolated warm starts change iteration counts, never converged
states (anchored tolerances, ``solvers/coupled.py``): the port's linear
guesses against a cold start and against the JAX package, mirroring the
JAX package's ``tests/test_warmstart.py`` at f64 on the CPU.

A 14 x 14 rectangle with its lattice structure stripped (the
unstructured lane, which owns warm starts), 4 steps, the f64 default
tolerances: warm and cold agree to 5e-9; the algebraic rd anchor and
the exact one to 5e-12; the port and the JAX package to 1e-8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from glimslib_tpu.core.mesh import Mesh as JaxMesh
from glimslib_tpu.core.mesh import rectangle_mesh as jax_rectangle_mesh
from glimslib_tpu.models.tumor_growth import TumorGrowth as JaxTumorGrowth
from glimslib_tpu_torch.core.mesh import Mesh, rectangle_mesh
from glimslib_tpu_torch.models.tumor_growth import TumorGrowth
from torch_threads import one_torch_thread  # noqa: E402,F401

N_STEPS = 4


class _All:
    def inside(self, x, on_boundary):
        return on_boundary


def _setup(sim):
    sim.setup_global_parameters(
        boundaries={"all": _All()},
        dirichlet_bcs={"clamped": {"bc_value": np.zeros(2), "named_boundary": "all",
                                   "subspace_id": 0}},
    )
    sim.setup_model_parameters(
        iv_expression={0: np.zeros(2), 1: lambda x: np.exp(-(x ** 2).sum(axis=1))},
        diffusion=0.1, coupling=0.15, proliferation=0.12, E=0.001, poisson=0.45,
        sim_time=N_STEPS, sim_time_step=1,
    )
    return sim


def _sim():
    m = rectangle_mesh((-5, -5), (5, 5), 14, 14)
    sim = _setup(TumorGrowth(Mesh.from_arrays(m.points, m.cells), dtype=torch.float64,
                             device="cpu"))
    assert not sim.lattice
    return sim


def _final(sim):
    u_tr, c_tr, ok, _ = sim.build_simulate_fn(N_STEPS, 1.0)(
        sim.make_theta(sim.params.as_dict()), *sim.initial_state())
    assert bool(ok.all())
    return u_tr[-1].numpy(), c_tr[-1].numpy()


def _cold(sim):
    """The same steps with no history: one-step simulates chained, each
    of which starts from its own initial state (the extrapolation of one
    state is that state)."""
    theta = sim.make_theta(sim.params.as_dict())
    u, c = sim.initial_state()
    step = sim.build_simulate_fn(1, 1.0)
    for _ in range(N_STEPS):
        u_tr, c_tr, ok, _ = step(theta, u, c)
        assert bool(ok.all())
        u, c = u_tr[-1], c_tr[-1]
    return u.numpy(), c.numpy()


def test_warm_start_matches_cold():
    u_w, c_w = _final(_sim())
    u_c, c_c = _cold(_sim())
    tol = 5e-9
    assert np.abs(u_w - u_c).max() < tol and np.abs(c_w - c_c).max() < tol


def test_algebraic_anchor_matches_exact(monkeypatch):
    """The anchor carried as ||M dc|| reproduces the trajectory of the
    exact anchor ||r_c(c_prev)||, which the step evaluates where no mass
    action is given (as with concentration Dirichlet conditions)."""
    ua, ca = _final(_sim())
    monkeypatch.setattr(TumorGrowth, "_streamed_mass_action", lambda self, theta: None)
    ue, ce = _final(_sim())
    assert np.abs(ua - ue).max() < 5e-12
    assert np.abs(ca - ce).max() < 5e-12


def test_warm_start_matches_jax():
    """The port's final state equals the JAX package's (linear warm
    starts on both sides) to 1e-8 (max abs; states are O(1))."""
    u_t, c_t = _final(_sim())
    m = jax_rectangle_mesh((-5, -5), (5, 5), 14, 14)
    sim = _setup(JaxTumorGrowth(JaxMesh.from_arrays(m.points, m.cells)))
    theta = sim.make_theta(sim.params.as_dict())
    iv = sim.params.create_initial_value_function()
    aux = sim.runtime_aux()
    args = (theta, jnp.asarray(iv[0], sim.dtype), jnp.asarray(iv[1], sim.dtype))
    u_j, c_j, ok, _ = jax.jit(sim.build_simulate_fn(N_STEPS, 1.0))(
        *(args + (aux,) if aux else args))
    assert bool(np.asarray(ok).all()) and sim._warm_start_ok
    assert np.abs(u_t - np.asarray(u_j[-1])).max() < 1e-8
    assert np.abs(c_t - np.asarray(c_j[-1])).max() < 1e-8


def test_quadratic_warm_start_matches_linear_and_cold(monkeypatch):
    """GLIMS_WARM_ORDER=3 (the quadratic guess 3 x_k - 3 x_{k-1} +
    x_{k-2}, read when the simulate is built) lands where the linear guess
    and a cold start do, to 5e-9 (tests/test_warmstart.py:71-82)."""
    u2, c2 = _final(_sim())
    monkeypatch.setenv("GLIMS_WARM_ORDER", "3")
    sim = _sim()
    simulate = sim.build_simulate_fn(N_STEPS, 1.0)
    monkeypatch.setenv("GLIMS_WARM_ORDER", "2")  # read at build time: no effect
    u_tr, c_tr, ok, _ = simulate(sim.make_theta(sim.params.as_dict()), *sim.initial_state())
    assert bool(ok.all())
    u3, c3 = u_tr[-1].numpy(), c_tr[-1].numpy()
    uc, cc = _cold(_sim())
    tol = 5e-9
    assert np.abs(u3 - u2).max() < tol and np.abs(c3 - c2).max() < tol
    assert np.abs(u3 - uc).max() < tol and np.abs(c3 - cc).max() < tol
    # the guesses differ, so the iterations may: the states do not
    assert not np.array_equal(c3, c2) or not np.array_equal(u3, u2)


def test_alg_anchor_switch_matches_exact(monkeypatch):
    """GLIMS_ALG_ANCHOR=0 leaves the step to evaluate the exact anchor
    ||r_c(c_prev)||; the trajectory equals the algebraic anchor's to 5e-12
    (tests/test_warmstart.py:98-110), at both warm-start orders, and the
    step evaluates the rd residual once more a step."""
    for order in ("2", "3"):
        monkeypatch.setenv("GLIMS_WARM_ORDER", order)
        monkeypatch.setenv("GLIMS_ALG_ANCHOR", "1")
        ua, ca = _final(_sim())
        monkeypatch.setenv("GLIMS_ALG_ANCHOR", "0")
        sim = _sim()
        calls = []
        rd = sim.rd_residual
        monkeypatch.setattr(sim, "rd_residual", lambda *a: calls.append(1) or rd(*a))
        ue, ce = _final(sim)
        n_exact = len(calls)
        monkeypatch.setenv("GLIMS_ALG_ANCHOR", "1")
        sim = _sim()
        calls.clear()
        rd = sim.rd_residual
        monkeypatch.setattr(sim, "rd_residual", lambda *a: calls.append(1) or rd(*a))
        _final(sim)
        assert n_exact > len(calls), (n_exact, len(calls))
        assert np.abs(ua - ue).max() < 5e-12
        assert np.abs(ca - ce).max() < 5e-12


def test_quadratic_warm_start_on_the_chebyshev_lattice(monkeypatch):
    """The lattice lane warm-starts where it takes the pcg branch
    (Chebyshev preconditioning): GLIMS_WARM_ORDER=3 lands within 5e-9 of
    the linear guess there too."""
    out = {}
    for order in ("2", "3"):
        monkeypatch.setenv("GLIMS_WARM_ORDER", order)
        sim = _setup(TumorGrowth(rectangle_mesh((-5, -5), (5, 5), 14, 14),
                                 dtype=torch.float64, device="cpu"))
        sim.step_config = sim.step_config._replace(precond_degree=3)
        assert sim.lattice
        out[order] = _final(sim)
    assert np.abs(out["3"][0] - out["2"][0]).max() < 5e-9
    assert np.abs(out["3"][1] - out["2"][1]).max() < 5e-9


def test_quadratic_warm_start_matches_jax(monkeypatch):
    """GLIMS_WARM_ORDER=3 on both sides: the port's final state equals the
    JAX package's to 1e-8 (max abs)."""
    monkeypatch.setenv("GLIMS_WARM_ORDER", "3")
    u_t, c_t = _final(_sim())
    m = jax_rectangle_mesh((-5, -5), (5, 5), 14, 14)
    sim = _setup(JaxTumorGrowth(JaxMesh.from_arrays(m.points, m.cells)))
    theta = sim.make_theta(sim.params.as_dict())
    iv = sim.params.create_initial_value_function()
    aux = sim.runtime_aux()
    args = (theta, jnp.asarray(iv[0], sim.dtype), jnp.asarray(iv[1], sim.dtype))
    u_j, c_j, ok, _ = jax.jit(sim.build_simulate_fn(N_STEPS, 1.0))(
        *(args + (aux,) if aux else args))
    assert bool(np.asarray(ok).all()) and sim._warm_start_ok
    assert np.abs(u_t - np.asarray(u_j[-1])).max() < 1e-8
    assert np.abs(c_t - np.asarray(c_j[-1])).max() < 1e-8
