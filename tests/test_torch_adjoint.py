"""Port parity for the gradient path: the implicit-function-theorem
adjoint of the step and the inverse problem (``optimize/``) of
glimslib_tpu_torch against the JAX package, at f64 on the CPU.

Both packages converge the same discrete systems with tight tolerances
(newton_rtol 1e-10, cg_rtol 1e-12), so the objective J and every gradient
component agree to rel 1e-8 on the 2D uniform model and on both lanes of
the brain box.  Also: the step's backward alone against the JAX package's
``step_bwd``, central finite differences of the port's own objective
(rel 1e-5), ``gradcheck`` of every kernel wrapper's autograd Function and
of the theta-plane constructions, L-BFGS-B recovery, and the time loop's graph
(a frozen step keeps the gradient finite).
"""

import os
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from torch.autograd import gradcheck

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from __graft_entry__ import _brain_sim as jax_brain_sim  # noqa: E402
from glimslib_tpu.core.mesh import Mesh as JaxMesh  # noqa: E402
from glimslib_tpu.core.mesh import rectangle_mesh as jax_rectangle_mesh  # noqa: E402
from glimslib_tpu.models.tumor_growth import TumorGrowth as JaxTumorGrowth  # noqa: E402
from glimslib_tpu.optimize import adjoint as jax_adjoint  # noqa: E402
from glimslib_tpu.solvers.coupled import StepConfig as JaxStepConfig  # noqa: E402
from glimslib_tpu_torch.core.mesh import Mesh, box_mesh, rectangle_mesh  # noqa: E402
from glimslib_tpu_torch.examples import adjoint_problem, brain_sim  # noqa: E402
from glimslib_tpu_torch.models.tumor_growth import TumorGrowth  # noqa: E402
from glimslib_tpu_torch.ops import bell, bell_kernels, stencil_kernels as sk  # noqa: E402
from glimslib_tpu_torch.ops.assembly import P1Kernels  # noqa: E402
from glimslib_tpu_torch.ops.stencil import StencilOperators  # noqa: E402
from glimslib_tpu_torch.optimize import adjoint  # noqa: E402
from glimslib_tpu_torch.solvers.coupled import StepConfig  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

TIGHT = dict(newton_rtol=1e-10, newton_atol=1e-14, cg_rtol=1e-12)
F64 = torch.float64


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


class Boundary:
    def inside(self, x, on_boundary):
        return on_boundary


def _setup_2d(sim):
    """The 2D uniform model of tests/test_adjoint.py (6 x 6 rectangle)."""
    sim.setup_global_parameters(
        boundaries={"boundary_all": Boundary()},
        dirichlet_bcs={"clamped": {"bc_value": np.zeros(2),
                                   "named_boundary": "boundary_all",
                                   "subspace_id": 0}},
        von_neumann_bcs={},
    )
    sim.setup_model_parameters(
        iv_expression={0: np.zeros(2),
                       1: lambda x: np.exp(-0.5 * (x ** 2).sum(axis=1))},
        diffusion=0.1, coupling=0.1, proliferation=0.1, E=0.001, poisson=0.45,
        sim_time=2, sim_time_step=1,
    )
    return sim


def _port_2d(n_params, v_true, **ip_kw):
    """The port's 2D inverse problem with targets from a forward run at
    ``v_true``."""
    sim = _setup_2d(TumorGrowth(rectangle_mesh((-3, -3), (3, 3), 6, 6), dtype=F64,
                                device="cpu"))
    names, update = adjoint.tumor_growth_param_map(n_params)
    p = dict(sim.params.as_dict())
    p.update(update(torch.as_tensor(v_true, dtype=F64)))
    u0, c0 = sim.initial_state()
    u, c, ok, _ = sim.build_simulate_fn(2, 1.0)(sim.make_theta(p), u0, c0)
    assert bool(ok.all())
    targets = {"conc_T2": adjoint.thresh(c[-1], 0.12),
               "conc_T1": adjoint.thresh(c[-1], 0.80), "disp": u[-1]}
    return adjoint.InverseProblem(sim, names, targets, update_fn=update, **ip_kw)


def _jax_problem(case, targets, n_steps):
    """The JAX package's inverse problem on the same model and targets."""
    if case == "tumor_growth_2d":
        sim = _setup_2d(JaxTumorGrowth(jax_rectangle_mesh((-3, -3), (3, 3), 6, 6)))
        names, update = jax_adjoint.tumor_growth_param_map(3)
    else:
        mt = None
        if case == "brain_unstructured":
            mt = lambda m: JaxMesh.from_arrays(m.points, m.cells).reordered_morton()  # noqa: E731
        sim = jax_brain_sim(n=6, dims=3, dtype=jnp.float64, mesh_transform=mt)
        names, update = jax_adjoint.param_map_for_type(2)
    sim.step_config = JaxStepConfig(**TIGHT)
    return jax_adjoint.InverseProblem(
        sim, names, {k: v.numpy() for k, v in targets.items()}, update_fn=update,
        n_steps=n_steps, dt=1.0)


def _reschedule(ip, n_steps, config=None):
    """Rebuild the problem's simulate for ``n_steps`` (and ``config``)."""
    if config is not None:
        ip.sim.step_config = config
    ip.n_steps = n_steps
    ip._simulate = ip.sim.build_simulate_fn(n_steps, 1.0)


@pytest.mark.parametrize("case", ["tumor_growth_2d", "brain_lattice",
                                  "brain_unstructured"])
def test_value_and_grad_matches_jax(case):
    """J and every gradient component to rel 1e-8: the 2D model with 3
    parameters (2 steps), the n=6 brain lattice (type 2, 5 steps), the n=6
    Morton brain on the unstructured lane (type 2, 2 steps)."""
    if case == "tumor_growth_2d":
        ip = _port_2d(3, [0.15, 0.12, 0.2])
        v0 = np.array([0.1, 0.1, 0.1])
        n_steps = 2
    else:
        ip, v0 = adjoint_problem(n=6, unstructured=case == "brain_unstructured",
                                 dtype=F64, device="cpu")
        n_steps = 2 if case == "brain_unstructured" else 5
    _reschedule(ip, n_steps, StepConfig(**TIGHT))
    J, g = ip.value_and_grad(v0)
    assert g.dtype == np.float64 and g.shape == v0.shape
    J_ref, g_ref = _jax_problem(case, ip.targets, n_steps).value_and_grad(v0)
    assert abs(J - J_ref) <= 1e-8 * abs(J_ref), (J, J_ref)
    np.testing.assert_allclose(g, np.asarray(g_ref), rtol=1e-8, atol=0)
    info = ip.sim.solver_info
    assert len(info["rd_adj_cg_iters"]) == len(info["el_adj_cg_iters"]) == n_steps
    assert len(info["el_cg_iters"]) == n_steps


def test_gradient_matches_finite_differences():
    """Central differences of the port's own objective (2D model, 3
    parameters), rel < 1e-5, as tests/test_adjoint.py checks the JAX
    package."""
    ip = _port_2d(3, [0.15, 0.12, 0.2])
    v0 = np.array([0.1, 0.1, 0.1])
    J0, g = ip.value_and_grad(v0)
    assert J0 > 0 and J0 == ip.objective(v0)
    eps = 1e-6
    for i in range(3):
        vp = v0.copy()
        vp[i] += eps
        vm = v0.copy()
        vm[i] -= eps
        fd = (ip.objective(vp) - ip.objective(vm)) / (2 * eps)
        assert abs(fd - g[i]) / max(abs(fd), 1e-12) < 1e-5, (i, fd, g[i])


def test_step_backward_matches_jax_step_bwd():
    """One lattice step's VJP alone (n=6 brain, f64), seeded (u_bar, c_bar):
    the cotangents of the physical coefficients D, rho, mu, lam (per cell)
    and coupling, through the theta planes, and of c_prev, to rel 1e-8."""
    keys = ("D", "rho", "mu", "lam", "coupling")
    rng = np.random.default_rng(7)
    sim_j = jax_brain_sim(n=6, dims=3, dtype=jnp.float64)
    sim_j.step_config = JaxStepConfig(**TIGHT)
    step_j = sim_j._build_step()
    theta_j = sim_j.make_theta(sim_j.params.as_dict())
    n = sim_j.mesh.n_nodes
    c_prev = np.asarray(sim_j.params.create_initial_value_function()[1])
    u_prev = np.zeros((n, 3))
    u_bar = rng.standard_normal((n, 3))
    c_bar = rng.standard_normal(n)

    def f(phys, cp):
        th = sim_j._augment_theta_with_operators({**theta_j, **phys})
        u, c, _, _ = step_j(th, jnp.asarray(u_prev), cp, jnp.asarray(1.0))
        return u, c

    (u_j, c_j), vjp = jax.vjp(jax.jit(f), {k: theta_j[k] for k in keys},
                             jnp.asarray(c_prev))
    phys_bar_j, cp_bar_j = vjp((jnp.asarray(u_bar), jnp.asarray(c_bar)))

    sim = brain_sim(n=6, dtype=F64, device="cpu")
    sim.step_config = StepConfig(**TIGHT)
    step = sim._build_step()
    theta = sim.make_theta(sim.params.as_dict())
    leaves = {k: theta[k].detach().clone().requires_grad_() for k in keys}
    cp = torch.tensor(c_prev, dtype=F64, requires_grad=True)
    th = sim._augment_theta_with_operators({**theta, **leaves})
    u, c, ok, _ = step(th, torch.zeros((n, 3), dtype=F64), cp, 1.0)
    assert bool(ok)
    assert _rel(c.detach(), c_j) <= 1e-8 and _rel(u.detach(), u_j) <= 1e-8
    grads = torch.autograd.grad((u, c), [*leaves.values(), cp],
                                (torch.tensor(u_bar), torch.tensor(c_bar)))
    for k, g in zip(keys, grads):
        assert g.shape == leaves[k].shape, k
        assert _rel(g, phys_bar_j[k]) <= 1e-8, (k, _rel(g, phys_bar_j[k]))
    assert _rel(grads[-1], cp_bar_j) <= 1e-8
    assert len(sim.solver_info["rd_adj_cg_iters"]) == 1


# -- autograd Functions of the kernel wrappers --------------------------------


def _random_offsets(rng, n):
    """15 symmetric offsets, some past n."""
    half = [int(o) for o in rng.choice(np.arange(1, 3 * n), 7, replace=False)]
    return sorted([0] + half + [-o for o in half])


@pytest.mark.parametrize("form", ["scalar", "vector", "coupling", "sum",
                                  "vector_cached", "coupling_cached", "bmv"])
def test_autograd_functions_pass_gradcheck(form):
    """gradcheck at f64 of every wrapper's Function, dv and dW both
    (the mirrored-plane transposed apply, cached or not)."""
    rng = np.random.default_rng(11)
    n = 7
    offs = _random_offsets(rng, n)
    t = lambda *s: torch.tensor(rng.standard_normal(s), dtype=F64, requires_grad=True)  # noqa: E731
    if form == "bmv":
        assert gradcheck(bell_kernels.batched_matvec, (t(5, 4, 6), t(5, 6)))
        return
    if form == "sum":
        W1, W2, W3, v, v2, b = t(15, n), t(15, n), t(15, n), t(n), t(n), t(n)
        assert gradcheck(lambda W1, W2, W3, v, v2, b: sk.apply_scalar_sum(
            offs, ((W1, v, 1.0), (W2, v, 0.5), (W3, v2, -1.0)), b),
            (W1, W2, W3, v, v2, b))
        return
    kind = form.split("_")[0]
    fn, W, x = {
        "scalar": (sk.apply_scalar, t(15, n), t(n)),
        "vector": (sk.apply_vector, t(15, 3, 3, n), t(n, 3)),
        "coupling": (sk.apply_coupling, t(15, 3, n), t(n)),
    }[kind]
    cache = sk.MirrorCache([W.detach()]) if form.endswith("cached") else None
    assert gradcheck(lambda W, x: fn(offs, W, x, cache=cache), (W, x))
    if cache is not None:
        assert len(cache._built) == 1


def test_mirrored_planes_apply_the_transpose():
    """stencil_apply on mirrored planes is A^T (the dense matrices), and an
    asymmetric offset set raises."""
    rng = np.random.default_rng(3)
    n = 11
    offs = _random_offsets(rng, n)
    W = torch.tensor(rng.standard_normal((15, 3, 2, n)), dtype=F64)
    A = torch.zeros(n * 3, n * 2, dtype=F64)
    for o, off in enumerate(offs):
        for i in range(n):
            A[3 * i:3 * i + 3, 2 * ((i + off) % n):2 * ((i + off) % n) + 2] += W[o, :, :, i]
    y = torch.tensor(rng.standard_normal((n, 3)), dtype=F64)
    got = sk.stencil_apply_plain(offs, sk.mirror_planes(offs, W), y)
    torch.testing.assert_close(got.reshape(-1), A.T @ y.reshape(-1), rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError, match="symmetric"):
        sk.mirror_planes([0, 1, 2, -1], W[:4])


def test_no_grad_calls_skip_autograd(monkeypatch):
    """Where no input requires grad, or grad is disabled, the wrappers call
    their kernels (here: the plain versions) without a Function."""
    def boom(*a, **k):
        raise AssertionError("autograd Function on a no-grad call")

    monkeypatch.setattr(sk._Apply, "apply", boom)
    monkeypatch.setattr(sk._ApplySum, "apply", boom)
    monkeypatch.setattr(bell_kernels._BatchedMatvec, "apply", boom)
    sim = brain_sim(n=4, dtype=F64, device="cpu")
    u0, c0 = sim.initial_state()
    theta = sim.make_theta(sim.params.as_dict())
    _, c, ok, _ = sim.build_simulate_fn(1, 1.0)(theta, u0, c0)
    assert bool(ok.all()) and c.grad_fn is None
    W = torch.ones(3, 5, dtype=F64, requires_grad=True)
    with torch.no_grad():
        sk.apply_scalar([-1, 0, 1], W, torch.ones(5, dtype=F64))
        bell_kernels.batched_matvec(torch.ones(2, 3, 4, requires_grad=True),
                                    torch.ones(2, 4))


# -- theta-plane constructions ------------------------------------------------


@pytest.mark.parametrize("fn_name", [
    "build_elasticity", "build_coupling_uc", "build_rd_jacobian_const",
    "build_rd_wc", "assemble_fused", "build_bell_rd_wc", "rd_quad_residual",
    "mass_residual", "mass_vector_residual"])
def test_theta_planes_are_differentiable(fn_name):
    """Each construction passes gradients to its per-cell coefficients (or its
    field), gradcheck at f64 (fast mode: random projections of the
    Jacobian) on a 2x2x2 box (48 cells)."""
    mesh = box_mesh((0, 0, 0), (1, 1, 1), 2, 2, 2)
    rng = np.random.default_rng(5)
    nc, n = mesh.n_cells, mesh.n_nodes
    t = lambda *s: torch.tensor(0.5 + rng.random(s), dtype=F64, requires_grad=True)  # noqa: E731
    dt = torch.tensor(0.7, dtype=F64)
    if fn_name.startswith("build_") and fn_name != "build_bell_rd_wc":
        ops = StencilOperators(mesh, dtype=F64)
        fn, args = {
            "build_elasticity": (ops.build_elasticity, (t(nc), t(nc))),
            "build_coupling_uc": (ops.build_coupling_uc, (t(nc), t(nc), t())),
            "build_rd_jacobian_const": (lambda D, rho: ops.build_rd_jacobian_const(
                D, rho, dt), (t(nc), t(nc))),
            "build_rd_wc": (lambda c, rho: ops.build_rd_wc(c, rho, dt),
                            (t(n), t(nc))),
        }[fn_name]
        assert gradcheck(fn, args, fast_mode=True)
        return
    kern = P1Kernels(mesh, dtype=F64)
    if fn_name in ("rd_quad_residual", "mass_residual", "mass_vector_residual"):
        fn, args = {
            "rd_quad_residual": (lambda c, rho: kern.rd_quad_residual(c, rho, dt),
                                 (t(n), t(nc))),
            "mass_residual": (kern.mass_residual, (t(n),)),
            "mass_vector_residual": (kern.mass_vector_residual, (t(n, 3),)),
        }[fn_name]
        assert gradcheck(fn, args, fast_mode=True)
        return
    umesh = Mesh.from_arrays(mesh.points, mesh.cells).reordered_morton()
    kern = P1Kernels(umesh, dtype=F64)
    plan = bell.BellPlan(umesh, s=4)
    arrays = (kern.grads_T, kern.vol)
    if fn_name == "build_bell_rd_wc":
        assert gradcheck(lambda c, rho: bell.build_bell_rd_wc(
            plan, arrays, kern.cells_flat, c, rho, dt, kern._t0, 1.0), (t(n), t(nc)),
            fast_mode=True)
        return
    assert gradcheck(lambda mu, lam, cp, D, rho: torch.cat([w.reshape(-1) for w in (
        bell.assemble_fused(plan, [
            bell.elasticity_entries(arrays, mu, lam),
            bell.coupling_uc_entries(arrays, mu, lam, cp),
            bell.rd_const_entries(arrays, D, rho, dt, kern._m0)]))]),
        (t(nc), t(nc), t(), t(nc), t(nc)), fast_mode=True)


# -- the inverse problem and the time loop ------------------------------------


def test_lbfgsb_recovers_parameters():
    """Recover (diffusion, proliferation) from synthetic targets on the 2D
    model, as tests/test_adjoint.py does for the JAX package."""
    v_true = np.array([0.12, 0.08])
    ip = _port_2d(2, v_true)
    x_opt, progress, res = ip.minimize(
        x0=np.array([0.05, 0.2]), bounds=[(0.005, 0.5)] * 2,
        opt_params={"tol": 1e-12, "gtol": 1e-10})
    assert np.allclose(x_opt, v_true, rtol=1e-3), (x_opt, v_true)
    assert progress.number_iterations >= 2
    assert ip.objective(v_true) < 1e-16


def test_trajectory_keeps_graph_and_frozen_step_stays_finite(monkeypatch):
    """The stacked trajectory carries the graph to every step, and with
    the second step forced unconverged (frozen: c_2 = c_1, the anchor's
    norm exactly 0) the gradient is finite and equals that of the
    one-step problem: the anchor carries no gradient."""
    ip, v0 = adjoint_problem(n=4, unstructured=True, dtype=F64, device="cpu")
    sim = ip.sim
    vt = torch.tensor(v0, dtype=F64, requires_grad=True)
    p = dict(sim.params.as_dict())
    p.update(ip.update_fn(vt))
    u_tr, c_tr, ok, _ = sim.build_simulate_fn(3, 1.0)(sim.make_theta(p),
                                                     *sim.initial_state())
    assert u_tr.requires_grad and c_tr.requires_grad and bool(ok.all())
    for i in range(3):
        (g,) = torch.autograd.grad(c_tr[i].sum(), vt, retain_graph=True)
        assert bool(torch.isfinite(g).all()) and float(g.abs().sum()) > 0

    _reschedule(ip, 1)
    J1, g1 = ip.value_and_grad(v0)
    build = sim._build_step

    def freeze_second(*a, **k):
        step = build(*a, **k)

        def stepped(theta, u_prev, c_prev, t, *rest):
            u, c, conv, n = step(theta, u_prev, c_prev, t, *rest)
            return u, c, conv & (t < 1.5), n
        return stepped

    monkeypatch.setattr(sim, "_build_step", freeze_second)
    _reschedule(ip, 3)
    J3, g3 = ip.value_and_grad(v0)
    assert np.isfinite(g3).all()
    assert J3 == J1
    np.testing.assert_allclose(g3, g1, rtol=1e-12, atol=0)
