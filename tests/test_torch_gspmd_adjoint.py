"""The adjoint of the lattice node sharding
(``Simulation.use_sharding(mode="nodes")``, ``parallel/gspmd.py``) of
glimslib_tpu_torch, at gloo ranks on the CPU (``parallel.run_ranks``;
torch on one thread a rank), at f64, against the JAX package.

The JAX side is the JAX package's single-device ``value_and_grad`` of the
unpadded model with tight tolerances (tests/torch_gspmd_cases.py TIGHT),
on targets from the port's unsharded forward of that model, one a case a
session (tests/torch_once.py); the JAX package's own node-sharded
gradient equals it (``__graft_entry__.dryrun_multichip``'s first leg)
but takes too long to compile here.  Both packages take the pcg branch
with warm starts there.  Held here:

- (a) the box of ``dryrun_multichip``'s first leg (n=5, 216 nodes; type
  5, the five parameters, 2 steps; T2, T1 and displacement targets) at 2
  and 4 ranks (54 rows a rank under a halo of 43: past the neighbour);
  tests/test_gspmd.py's n=6 box padded to 392 nodes at 2 ranks, type 2;
  the 2D subdomains rectangle padded to 90 nodes at 2 ranks, type 3 (the
  <2,2> and <2,1> backward): J within rtol 1e-10 and the gradient within
  rtol 1e-8 of JAX's, J and the gradient bit-equal on every rank, the
  forward and adjoint CG counts equal on every rank; on the rectangle
  minimize's L-BFGS-B iterates bit-equal on every rank and rank 0 alone
  writing export_computation_graph's file;
- (b) f32 with the default step (refine_f64) at 2 ranks on the n=5 box,
  the benchmark's adjoint cell: J within 1e-4 and the gradient within
  rel-L2 1e-3 of the f64 one (the lattice limits of PERF.md §2,
  chip_smoke.py ADJ_J_RTOL / ADJ_G_RTOL);
- (c) the differentiable exchange's dot-product test at 2 and 4 ranks:
  the sums over the ranks of <X x, y> and <x, X^T y> agree to 1e-12;
- (d) ``torch.autograd.gradcheck`` of every halo form's backward (plain,
  f64), with and without a MirrorCache;
- (e) the planes' cotangents reach theta's per-cell coefficients once: a
  fixed random cotangent of every plane, summed over 2 ranks, gives the
  unsharded model's coefficient cotangent (the ranks' cells overlap);
- (f) a gradient of a functional of ``run_for_adjoint_2params``'s
  solution at 2 ranks equals the unsharded port's;
- (g) where the node-sharded lattice's f32 J lands at
  ``REFINED_STEP_CONFIG``: the JAX package's ``nodes`` mode (two forced
  host devices) and the port's (two gloo ranks) on the same f32 refined
  problem land the same distance from the f64 J, within a factor of 2,
  with the same Newton iterations a step, within the warm-started limit
  5e-4: on the benchmark's adjoint cell (where the port's unsharded
  lattice, the whole-solve branch, lands under the lattice limit 1e-4)
  and on (a)'s type-5 problem.
"""

import os
import sys

import numpy as np
import pytest
import jax.numpy as jnp
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch_gspmd_cases as cases  # noqa: E402
from __graft_entry__ import _brain_sim as jax_brain_sim  # noqa: E402
from glimslib_tpu.solvers.coupled import StepConfig as JaxStepConfig  # noqa: E402
from glimslib_tpu_torch.ops import stencil_kernels as sk  # noqa: E402
from glimslib_tpu_torch.parallel import run_ranks  # noqa: E402
from torch_once import once  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

# dryrun_multichip's first leg: type 5 at these values
V_BOX5 = np.array([0.08, 0.015, 0.08, 0.015, 0.1])
V_BOX6 = np.array([0.08, 0.05])
V_RECT = np.array([0.15, 0.1, 0.1])
# the lattice limits of the f32 gradient against f64 (PERF.md §2)
F32_J_RTOL, F32_G_RTOL = 1e-4, 1e-3
CASES = {
    "box5": (dict(kind="brain", n=5), 5, V_BOX5, 216),
    "box6_padded": (dict(kind="brain", n=6, pad_to=2), 2, V_BOX6, 343),
    "rect_padded": (dict(kind="rect", n=8, pad_to=2), 3, V_RECT, 81),
}


def _jax_gradient(spec, opt_type, v0):
    """(targets, J, gradient): targets from the port's unsharded, unpadded
    forward of ``spec`` at the model's parameters (T2, T1 and displacement
    on the brain box; c and u on the rectangle), then the JAX package's
    single-device value_and_grad at ``v0`` on them."""
    from glimslib_tpu.optimize.adjoint import (
        InverseProblem, param_map_for_type, tumor_growth_param_map,
    )
    from glimslib_tpu_torch.optimize.adjoint import thresh

    whole = cases.port_model({k: v for k, v in spec.items() if k != "pad_to"})
    u, c, ok, _ = whole.build_simulate_fn(cases.N_STEPS, 1.0)(
        whole.make_theta(whole.params.as_dict()), *whole.initial_state())
    assert bool(ok.all())
    u_T, c_T = u[-1], c[-1]
    if spec["kind"] == "brain":
        targets = {"conc_T2": thresh(c_T, 0.12).numpy(),
                   "conc_T1": thresh(c_T, 0.80).numpy(), "disp": u_T.numpy()}
    else:
        targets = {"conc": c_T.numpy(), "disp": u_T.numpy()}
    if spec["kind"] == "brain":
        sim = jax_brain_sim(n=spec["n"], dims=3, dtype=jnp.float64)
        names, update = param_map_for_type(opt_type)
    else:
        from test_torch_2d import _jax_rect_sim

        sim = _jax_rect_sim(spec["n"], subdomains=True)
        names, update = tumor_growth_param_map(opt_type)
    sim.step_config = JaxStepConfig(**cases.TIGHT)
    ip = InverseProblem(sim, names, targets, update_fn=update, n_steps=cases.N_STEPS,
                        dt=1.0)
    J, g = ip.value_and_grad(v0)
    return targets, float(J), np.asarray(g)


@pytest.fixture(scope="module")
def jax_grads(tmp_path_factory):
    """The JAX gradient of each case, computed once a case a session
    (tests/torch_once.py)."""
    got = {}

    def get(name):
        if name not in got:
            spec, opt_type, v0, _ = CASES[name]
            got[name] = once(tmp_path_factory, f"gspmd_adjoint-{name}",
                             lambda: _jax_gradient(spec, opt_type, v0))
        return got[name]
    return get


def _padded(targets, n_total):
    """The targets on a padded mesh: zeros on the padding nodes."""
    return {k: np.concatenate([v, np.zeros((n_total - len(v),) + v.shape[1:])])
            for k, v in targets.items()}


def _check_same_on_every_rank(ranks):
    for out in ranks:
        assert out["mode"] == "nodes"
        assert out["J"] == ranks[0]["J"]
        assert np.array_equal(out["g"], ranks[0]["g"])
        assert out["counts"] == ranks[0]["counts"]
    counts = ranks[0]["counts"]
    assert len(counts["rd_adj_cg_iters"]) == len(counts["el_adj_cg_iters"]) == cases.N_STEPS
    assert sum(counts["rd_adj_cg_iters"]) > 0


# -- (a), (b) value_and_grad against JAX ----------------------------------------


@pytest.mark.parametrize("name, world", [("box5", 2), ("box5", 4), ("box6_padded", 2),
                                         ("rect_padded", 2)],
                         ids=["box5_world2", "box5_world4", "box6_padded_world2",
                              "rect_padded_world2"])
def test_value_and_grad_matches_jax(jax_grads, name, world):
    """(a): J rtol 1e-10 and gradient rtol 1e-8 against the JAX package's
    single-device value_and_grad on the same targets (zeros on padding
    nodes, where the mass action of ones is exactly 0, so they add
    nothing); bit-equal on every rank with the same CG counts; every rank
    holds its rows of the targets."""
    spec, opt_type, v0, n_real = CASES[name]
    targets, J_j, g_j = jax_grads(name)
    n_total = {"box5": 216, "box6_padded": 392, "rect_padded": 90}[name]
    ranks = run_ranks(cases.grad_rank, world, "gloo", "cpu",
                      args=(spec, opt_type, _padded(targets, n_total), v0))
    _check_same_on_every_rank(ranks)
    mass_ones = np.concatenate([out["mass_ones"] for out in ranks])
    assert mass_ones.shape == (n_total,)
    assert np.all(mass_ones[n_real:] == 0.0) and np.all(mass_ones[:n_real] > 0.0)
    for out in ranks:
        assert out["n_own"] * world == n_total and out["start"] == out["rank"] * out["n_own"]
        assert out["target_rows"]["disp"][0] == out["n_own"]
        np.testing.assert_allclose(out["J"], J_j, rtol=1e-10)
        np.testing.assert_allclose(out["g"], g_j, rtol=1e-8, atol=1e-14)


def test_f32_refined_within_the_lattice_limits():
    """(b): the benchmark's adjoint cell (``examples.adjoint_problem``:
    conc_T2 and displacement targets from a forward run at the set-up
    parameters, type 2 from v0 = 0.05, here N_STEPS steps) on the n=5 box
    at f32 with the default step (refine_f64: f64 gather residuals on the
    slab's cells in the forward, the IFT backward on the working
    residuals) at 2 ranks: J within 1e-4 and the gradient within rel-L2
    1e-3 of the unsharded port's f64 ones (TIGHT), bit-equal on both ranks.
    PERF.md §2's limits are set on this cell; on (a)'s type-5 problem,
    whose T1 target sits at the threshold's steep flank, f32's newton_rtol
    1e-4 leaves J 1.2e-4 off sharded and 2.0e-4 off unsharded."""
    from glimslib_tpu_torch.optimize.adjoint import InverseProblem, param_map_for_type, thresh

    spec = dict(kind="brain", n=5)
    sim = cases.port_model(spec)
    theta = sim.make_theta(sim.params.as_dict())
    u, c, ok, _ = sim.build_simulate_fn(cases.N_STEPS, 1.0)(theta, *sim.initial_state())
    targets = {"conc_T2": thresh(c[-1], 0.12).numpy(), "disp": u[-1].numpy()}
    v0 = np.array([0.05, 0.05])
    names, update = param_map_for_type(2)
    J64, g64 = InverseProblem(sim, names, targets, update_fn=update, n_steps=cases.N_STEPS,
                              dt=1.0).value_and_grad(v0)
    ranks = run_ranks(cases.grad_rank, 2, "gloo", "cpu",
                      args=(dict(spec, dtype="float32", config="default"), 2, targets, v0))
    _check_same_on_every_rank(ranks)
    assert ranks[0]["counts"]["el_refine_cg_iters"], "the forward did not refine"
    g = np.asarray(ranks[0]["g"], np.float64)
    assert abs(ranks[0]["J"] - J64) / abs(J64) <= F32_J_RTOL
    assert np.linalg.norm(g - g64) / np.linalg.norm(g64) <= F32_G_RTOL


def test_minimize_and_graph_on_every_rank(tmp_path):
    """(a): on the 2D subdomains rectangle at 2 ranks (type 3), minimize
    (L-BFGS-B, 2 iterations) takes the same iterates on every rank, bit
    for bit, and the unsharded port's to rel 1e-6; export_computation_graph
    runs on every rank and rank 0 alone writes, naming one
    _ImplicitStepBackward a step."""
    from glimslib_tpu_torch.optimize.adjoint import InverseProblem, tumor_growth_param_map

    spec, opt_type, v0, _ = CASES["rect_padded"]
    sim = cases.port_model(spec)
    theta = sim.make_theta(sim.params.as_dict())
    u, c, ok, _ = sim.build_simulate_fn(cases.N_STEPS, 1.0)(theta, *sim.initial_state())
    targets = {"conc": c[-1].numpy(), "disp": u[-1].numpy()}
    graph = str(tmp_path / "graph_{rank}.txt")
    ranks = run_ranks(cases.grad_rank, 2, "gloo", "cpu",
                      args=(spec, opt_type, targets, v0, graph, 2))
    names, update = tumor_growth_param_map(opt_type)
    x_w, _, res_w = InverseProblem(sim, names, targets, update_fn=update,
                                   n_steps=cases.N_STEPS, dt=1.0).minimize(
        v0, opt_params={"maxiter": 2})
    for out in ranks:
        assert out["nit"] == int(res_w.nit) == 2
        assert np.array_equal(out["x_opt"], ranks[0]["x_opt"])
        np.testing.assert_allclose(out["x_opt"], x_w, rtol=1e-6)
    assert not os.path.exists(graph.format(rank=1))
    text = open(graph.format(rank=0)).read()
    assert f"# {cases.N_STEPS} _ImplicitStepBackward" in text


# -- (c) the exchange's transpose ----------------------------------------------


@pytest.mark.parametrize("world", [2, 4])
def test_exchange_transpose_dot_product(world):
    """(c): sum_r <X(x)_r, y_r> = sum_r <x_r, X^T(y)_r> to 1e-12 (rel) for
    halo_exchange and halo_exchange_many on the n=5 box (at 4 ranks a
    halo of 43 rows against 54 owned, and the band holds rows of three
    ranks)."""
    ranks = run_ranks(cases.exchange_rank, world, "gloo", "cpu",
                      args=(dict(kind="brain", n=5), 3))
    assert ranks[0]["halo"] == 43 and ranks[0]["n_own"] == 216 // world
    for out in ranks:
        lhs, rhs, lhs_many, rhs_many = out["sums"]
        assert abs(lhs - rhs) <= 1e-12 * abs(lhs)
        assert abs(lhs_many - rhs_many) <= 1e-12 * abs(lhs_many)
        assert np.array_equal(out["sums"], ranks[0]["sums"])


# -- (d) gradcheck of the halo forms ---------------------------------------------

FORMS = ("scalar", "vector2", "vector3", "coupling2", "coupling3", "sum2", "sum3")


@pytest.mark.parametrize("cached", [False, True], ids=["fresh", "mirror_cache"])
@pytest.mark.parametrize("form", FORMS)
def test_halo_form_backward_gradcheck(form, cached):
    """(d): torch.autograd.gradcheck of the halo form (plain, f64) in W and
    v on 9 owned rows under the whole lattice's halo (3D: the 3^3 box's
    offsets, halo 21; 2D: the 4 x 4 rectangle's, halo 6), the backward's
    dv the transposed halo form on mirrored extended planes (module
    docstring of ops/stencil_kernels.py); with a MirrorCache holding the
    planes the mirrored planes are built once and reused."""
    from glimslib_tpu_torch.core.mesh import box_mesh, rectangle_mesh
    from glimslib_tpu_torch.ops.stencil import stencil_offsets

    d = 2 if form.endswith("2") and not form.startswith("sum") else 3
    mesh = (box_mesh((0, 0, 0), (1, 1, 1), 3, 3, 3) if d == 3
            else rectangle_mesh((0, 0), (1, 1), 4, 4))
    offs = [int(o) for o in stencil_offsets(mesh.cells)]
    h, n, k = max(abs(o) for o in offs), 9, len(offs)
    rng = np.random.default_rng(5)
    t = lambda *s: torch.as_tensor(rng.standard_normal(s)).requires_grad_()  # noqa: E731
    if form == "scalar":
        W, args = t(k, n), [t(n + 2 * h)]
    elif form.startswith("vector"):
        W, args = t(k, d, d, n), [t(n + 2 * h, d)]
    elif form.startswith("coupling"):
        W, args = t(k, d, n), [t(n + 2 * h)]
    else:
        W, args = t(k, n), [t(n + 2 * h), t(k, n), t(n + 2 * h)]
        args += [t(n + 2 * h)] if form == "sum3" else []
        args += [t(n)]
    cache = sk.MirrorCache([W]) if cached else None

    def fn(W, *rest):
        if form == "scalar":
            return sk.apply_scalar(offs, W, rest[0], cache=cache, halo=h)
        if form.startswith("vector"):
            return sk.apply_vector(offs, W, rest[0], cache=cache, halo=h)
        if form.startswith("coupling"):
            return sk.apply_coupling(offs, W, rest[0], cache=cache, halo=h)
        terms = [(W, rest[0], 1.0), (rest[1], rest[2], -0.5)]
        if form == "sum3":
            terms.append((W, rest[3], 2.0))
        return sk.apply_scalar_sum(offs, terms, rest[-1], cache=cache, halo=h)

    assert torch.autograd.gradcheck(fn, (W, *args))
    if cached:
        # dv reads the cached mirrored planes: W's own, extended by 2 h
        assert any(v.shape[-1] == n + 2 * h for v in cache._built.values())


# -- (e) the planes' cotangents, once a cell ------------------------------------


def test_plane_cotangents_reach_each_cell_once():
    """(e): theta's per-cell D, rho and mu under a fixed random cotangent of
    every plane and load (the whole mesh's rows, each rank its own) at 2
    ranks on the n=6 padded box, summed over the ranks once by
    ``shard.enter``, equal the unsharded padded model's at 1e-12 on every
    rank: no cell touching both ranks' rows counts twice.  The ranks'
    cells do overlap, and each plane holds n / 2 rows."""
    spec = dict(kind="brain", n=6, pad_to=2)
    ranks = run_ranks(cases.plane_vjp_rank, 2, "gloo", "cpu", args=(spec, 4))
    want = cases.plane_cotangent(cases.port_model(spec), 4)
    shared = np.intersect1d(ranks[0]["cell_ids"], ranks[1]["cell_ids"])
    assert len(shared) > 0 and ranks[0]["n_own"] == 196
    for out in ranks:
        for k, g in want.items():
            np.testing.assert_allclose(out["grads"][k], g, rtol=1e-12,
                                       atol=1e-12 * np.abs(g).max())
            assert np.array_equal(out["grads"][k], ranks[0]["grads"][k])


# -- (f) run_for_adjoint ---------------------------------------------------------


def test_run_for_adjoint_solution_gradient_matches_unsharded():
    """(f): F = sum w_c c + sum w_u |u|^2 of ``run_for_adjoint_2params``'s
    solution (D_WM, rho_WM given as tensors that require grad; run()
    gathers the rows differentiably) at 2 ranks on the n=6 padded box:
    F and dF/d(D_WM, rho_WM) equal the unsharded port's (rel 1e-8: the two
    take other solver paths), bit-equal on both ranks."""
    spec = dict(kind="brain", n=6, pad_to=2)
    params = (0.08, 0.05)
    ranks = run_ranks(cases.run_adjoint_rank, 2, "gloo", "cpu", args=(spec, params, 9))
    F_w, g_w = cases.run_adjoint_functional(cases.port_model(spec), params, 9)
    assert np.all(np.abs(g_w) > 0)
    for out in ranks:
        assert out["mode"] == "nodes"
        np.testing.assert_allclose(out["F"], F_w, rtol=1e-8)
        np.testing.assert_allclose(out["g"], g_w, rtol=1e-8)
        assert out["F"] == ranks[0]["F"] and np.array_equal(out["g"], ranks[0]["g"])


# -- (g) the node-sharded lattice's f32 refined J against the JAX package's ----

# examples.REFINED_STEP_CONFIG in the JAX package's StepConfig
REFINED = dict(newton_rtol=1e-4, newton_atol=1e-5, cg_rtol=1e-7, cg_maxiter=800,
               refine_f64=True)
# the benchmark's adjoint cell (examples.adjoint_problem: type 2 from v0 = 0.05,
# conc_T2 and displacement targets, 5 steps) on the n=6 box padded to 344
# nodes, and dryrun_multichip's type-5 problem (T2, T1 and displacement
# targets, 2 steps) on the n=5 box; the last entry is the limit of the
# unsharded lattice's distance: the lattice limit 1e-4 on the adjoint
# cell; on the type-5 problem, whose T1 target sits on the threshold's
# steep flank, f32's newton_rtol 1e-4 leaves J ~2e-4 off f64 on the
# whole-solve branch too, within the warm-started limit 5e-4
REFINED_CASES = {
    "adjoint_cell": (dict(kind="brain", n=6, pad_to=2), 2, np.array([0.05, 0.05]), 5,
                     ("conc_T2", "disp"), 1e-4),
    "type5": (dict(kind="brain", n=5), 5, V_BOX5, cases.N_STEPS,
              ("conc_T2", "conc_T1", "disp"), 5e-4),
}


def _jax_nodes_f32(spec, opt_type, v0, n_steps):
    """The JAX package's final (u, c) and Newton iterations a step of the
    model of ``spec`` at f32 under ``use_sharding(mode="nodes")`` over two
    forced host devices, REFINED, at the parameters of ``v0``."""
    import jax
    from jax.sharding import Mesh as JaxDeviceMesh
    from glimslib_tpu.optimize.adjoint import param_map_for_type

    sim = jax_brain_sim(n=spec["n"], dims=3, dtype=jnp.float32, pad_to=spec.get("pad_to"))
    sim.use_sharding(JaxDeviceMesh(np.array(jax.devices()[:2]), ("mesh_x",)), mode="nodes")
    sim.step_config = JaxStepConfig(**REFINED)
    _, update = param_map_for_type(opt_type)
    p = {**sim.params.as_dict(), **update(v0)}
    iv = sim.params.create_initial_value_function()
    u, c, ok, newton = sim.build_simulate_fn(n_steps, 1.0)(
        sim.make_theta(p), jnp.asarray(iv[0], jnp.float32), jnp.asarray(iv[1], jnp.float32))
    assert bool(np.asarray(ok).all())
    return (torch.as_tensor(np.asarray(u[-1]), dtype=torch.float64),
            torch.as_tensor(np.asarray(c[-1]), dtype=torch.float64),
            np.asarray(newton).tolist())


@pytest.mark.parametrize("name", sorted(REFINED_CASES))
def test_nodes_refined_j_lands_where_the_references_does(name):
    """(g), ROADMAP queue 3a.  ``chip_smoke.py`` [14c] measured the
    node-sharded lattice's f32 J 3.4e-4 off f64 at REFINED_STEP_CONFIG
    where the unsharded lattice lands ~3e-7.  Both packages' ``nodes``
    mode takes the pcg branch with extrapolated warm starts (the
    whole-solve kernels are off there), whose Newton stops at newton_rtol
    1e-4 of ||r(c_prev)|| after one iteration from the guess.  Held here
    on the same f32 refined problem: the port's distance from the f64 J
    is the JAX package's within a factor of 2 (the two differ only in the
    rounding of f32 sums), with the same Newton iterations a step, and
    within the warm-started limit 5e-4 (PERF.md §2); the port's
    unsharded lattice (the whole-solve branch, 2 Newton iterations a
    step) stays under the lattice limit 1e-4 on the adjoint cell.  The
    f64 J
    is the port's unsharded one (equal to the JAX package's to 1e-10,
    (a)); the JAX package's f32 fields are scored by the same objective."""
    from glimslib_tpu_torch.optimize.adjoint import InverseProblem, thresh

    spec, opt_type, v0, n_steps, keys, whole_limit = REFINED_CASES[name]
    sim = cases.port_model(spec)
    theta = sim.make_theta(sim.params.as_dict())
    u, c, ok, _ = sim.build_simulate_fn(n_steps, 1.0)(theta, *sim.initial_state())
    every = {"conc_T2": thresh(c[-1], 0.12).numpy(), "conc_T1": thresh(c[-1], 0.80).numpy(),
             "disp": u[-1].numpy()}
    targets = {k: every[k] for k in keys}
    names, update = cases._param_map(spec, opt_type)
    ip64 = InverseProblem(sim, names, targets, update_fn=update, n_steps=n_steps, dt=1.0)
    J64 = ip64.objective(v0)

    u_j, c_j, newton_j = _jax_nodes_f32(spec, opt_type, v0, n_steps)
    ip64._simulate = lambda *args: (u_j[None], c_j[None], None, None)
    J_j = ip64.objective(v0)
    spec32 = dict(spec, dtype="float32", config="refined")
    ranks = run_ranks(cases.objective_rank, 2, "gloo", "cpu",
                      args=(spec32, opt_type, targets, v0, n_steps))
    unsharded = cases.objective_rank(None, spec32, opt_type, targets, v0, n_steps,
                                     mode=None)
    d_jax, d_port, d_whole = (abs(J - J64) / abs(J64) for J in
                              (J_j, ranks[0]["J"], unsharded["J"]))
    print(f"{name}: J64 {J64!r} d_jax {d_jax:.3e} d_port {d_port:.3e} "
          f"d_unsharded {d_whole:.3e} newton {newton_j} / {unsharded['newton']}")
    assert all(out["mode"] == "nodes" and out["ok"] for out in ranks)
    assert ranks[0]["J"] == ranks[1]["J"] and ranks[0]["newton"] == newton_j
    assert 0.5 <= d_port / d_jax <= 2.0, (d_port, d_jax)
    assert d_port <= 5e-4 and d_jax <= 5e-4, (d_port, d_jax)
    assert unsharded["ok"] and d_whole <= whole_limit, d_whole
