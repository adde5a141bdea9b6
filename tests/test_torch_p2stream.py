"""The streamed P2 rd residual (``GLIMS_P2STREAM=1``): the port's
``ops/p2_ell.py p2_mass_entries`` / ``p2_cubic_residual`` and the quad
models' streamed ``rd_residual`` (two assembled matvecs, the quadratic
term and the constant load) against the JAX package and against the
port's quadrature residual, at f64 on the CPU.

Tolerances: the mass entries and the quadratic term within rel 1e-12 of
the JAX package's (the same degree-6 sums); the streamed residual within
rel 1e-10 (atol 1e-12) of the quadrature one (tests/test_p2_ell.py:136-165);
2-step quad forwards with the switch on within rel-L2 1e-8 of the JAX
model's with the switch and of the port's default; value_and_grad with
the switch on within rel 1e-8 of the default's (J and gradient); under
``use_sharding(mode="bell")`` at two gloo ranks within atol 1e-11 of the
unsharded streamed run.  The JAX side builds its P2 plan with the port's
flat halo (``GLIMS_P2_HALO_CHUNK=1``).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from glimslib_tpu.core.mesh import Mesh as JaxMesh  # noqa: E402
from glimslib_tpu.core.mesh import box_mesh as jax_box_mesh  # noqa: E402
from glimslib_tpu.core.mesh import rectangle_mesh as jax_rectangle_mesh  # noqa: E402
from glimslib_tpu.models.tumor_growth_quad import TumorGrowth as JaxQuad  # noqa: E402
from glimslib_tpu.ops import p2_ell as jax_p2_ell  # noqa: E402
from glimslib_tpu.ops.p2 import P2Kernels as JaxP2Kernels  # noqa: E402
from glimslib_tpu_torch import convert  # noqa: E402
from glimslib_tpu_torch.core.mesh import Mesh, box_mesh, rectangle_mesh  # noqa: E402
from glimslib_tpu_torch.models.tumor_growth_brain_quad import TumorGrowthBrain  # noqa: E402
from glimslib_tpu_torch.models.tumor_growth_quad import TumorGrowth  # noqa: E402
from glimslib_tpu_torch.ops import bell, p2_ell  # noqa: E402
from glimslib_tpu_torch.ops.p2 import P2Kernels  # noqa: E402
from glimslib_tpu_torch.optimize.adjoint import InverseProblem, param_map_for_type  # noqa: E402
from glimslib_tpu_torch.parallel import run_ranks  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_shard_cases as shard_cases  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

N_STEPS = 2


@pytest.fixture
def quad_env(monkeypatch):
    monkeypatch.setenv("GLIMS_P2_HALO_CHUNK", "1")
    monkeypatch.setenv("GLIMS_TWOLEVEL_MIN_NODES", "100")


def _rel(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


def _morton(kind, n):
    """(port mesh, JAX mesh) without lattice, in Morton order: the box
    [0, 10]^3 of n^3 voxels or the rectangle [0, 10]^2 of n x n."""
    if kind == "box":
        mt, mj = (box_mesh((0, 0, 0), (10, 10, 10), n, n, n),
                  jax_box_mesh((0, 0, 0), (10, 10, 10), n, n, n))
    else:
        mt, mj = (rectangle_mesh((0, 0), (10, 10), n, n),
                  jax_rectangle_mesh((0, 0), (10, 10), n, n))
    return (Mesh.from_arrays(mt.points, mt.cells).reordered_morton(),
            JaxMesh.from_arrays(mj.points, mj.cells).reordered_morton())


def _coefs(mesh):
    mids = np.asarray(mesh.cell_midpoints)
    return 0.05 + 0.02 * mids[:, 0], 0.1 + 0.05 * mids[:, 1]


@pytest.mark.parametrize("kind", ["rect", "box"])
def test_mass_entries_and_cubic_term_equal_jax(kind):
    mt, mj = _morton(kind, 4)
    kt, kj = P2Kernels(mt), JaxP2Kernels(mj, dtype=jnp.float64)
    _, rho = _coefs(mt)
    c = np.random.default_rng(3).random(kt.n_dofs)
    got = p2_ell.p2_cubic_residual(kt, torch.as_tensor(c), torch.as_tensor(rho), 0.7, 1.0)
    plan_j = jax_p2_ell.make_p2_plan(kj, s=16)
    want = jax_p2_ell.p2_cubic_residual(plan_j, kj, jnp.asarray(c), jnp.asarray(rho), 0.7,
                                        1.0, jnp.float64)
    assert _rel(got, want) <= 1e-12, _rel(got, want)
    M = p2_ell.p2_mass_entries(kt)
    assert _rel(M, jax_p2_ell.p2_mass_entries(kj, jnp.float64)) <= 1e-12


def test_streamed_residual_matches_quadrature():
    """W_const c - M c_prev + q(c) - load equals P2Kernels.rd_residual on
    the 4^3 Morton box with per-cell D, rho and a constant source."""
    mt, _ = _morton("box", 4)
    p2k = P2Kernels(mt)
    plan = p2_ell.make_p2_plan(p2k, s=16)
    rng = np.random.default_rng(11)
    c = torch.as_tensor(rng.random(p2k.n_dofs))
    cp = torch.as_tensor(rng.random(p2k.n_dofs))
    D, rho = (torch.as_tensor(a) for a in _coefs(mt))
    dt, src = 0.7, 0.15
    want = p2k.rd_residual(c, cp, D, rho, dt, source=src, conc_max=1.0)
    W = p2_ell.build_p2_rd_const(plan, p2k, D, rho, dt)
    M = plan.assemble(p2_ell.p2_mass_entries(p2k))
    zero = torch.zeros(p2k.n_dofs, dtype=torch.float64)
    load = -p2k.rd_residual(zero, zero, D, rho, dt, source=src)
    got = (bell.apply_bell_scalar(plan, W, c) - bell.apply_bell_scalar(plan, M, cp)
           + p2_ell.p2_cubic_residual(p2k, c, rho, dt, 1.0) - load)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-10, atol=1e-12)


class Boundary:
    def inside(self, x, on_boundary):
        return on_boundary


def _setup_quad(sim):
    """TumorGrowth (quad) as tests/test_torch_quad.py sets it up: clamped,
    a Gaussian seed at the centre."""
    d = sim.mesh.dim
    sim.setup_global_parameters(
        boundaries={"boundary_all": Boundary()},
        dirichlet_bcs={"clamped": {"bc_value": np.zeros(d), "named_boundary": "boundary_all",
                                   "subspace_id": 0}})
    center = np.full(d, 5.0)
    sim.setup_model_parameters(
        iv_expression={0: np.zeros(d),
                       1: lambda x: np.exp(-0.5 * ((x - center) ** 2).sum(axis=1))},
        diffusion=0.2, coupling=0.15, proliferation=0.1, E=0.001, poisson=0.45,
        sim_time=N_STEPS, sim_time_step=1)
    return sim


def _port_final(sim, aux=None):
    theta = sim.make_theta(sim.params.as_dict())
    u, c, ok, newton = sim.build_simulate_fn(N_STEPS, 1.0)(theta, *sim.initial_state(), aux)
    assert bool(ok.all())
    return u[-1].numpy(), c[-1].numpy(), newton.tolist()


def test_quad_forward_streamed_matches_jax_and_default(quad_env, monkeypatch):
    """The quad TumorGrowth on the 4^3 lattice-stripped Morton box, 2 steps
    with GLIMS_P2STREAM=1: the augmented theta carries the streamed
    planes and the quadrature residual runs for the load alone; the final
    state equals the JAX model's with the same switch (its frozen arrays
    carried, _FP2Mrd among them) and the port's default run."""
    mt, mj = _morton("box", 4)
    u_d, c_d, newton_d = _port_final(_setup_quad(TumorGrowth(mt, dtype=torch.float64,
                                                             device="cpu")))
    monkeypatch.setenv("GLIMS_P2STREAM", "1")
    sim = _setup_quad(TumorGrowth(mt, dtype=torch.float64, device="cpu"))
    aux_own = sim.runtime_aux()
    assert torch.equal(aux_own["_FP2Mrd"], aux_own["_FP2Wrd"][0])
    aug = sim._augment_theta_with_operators({**sim.make_theta(sim.params.as_dict()),
                                             **aux_own})
    assert {"_P2BMrd", "_P2B_rd_load"} <= set(aug)
    calls = []
    quadrature = sim.p2.rd_residual
    monkeypatch.setattr(sim.p2, "rd_residual",
                        lambda *a, **k: calls.append(1) or quadrature(*a, **k))
    u_s, c_s, newton_s = _port_final(sim)
    assert len(calls) == 1  # the load, once a simulate
    assert _rel(c_s, c_d) <= 1e-8 and _rel(u_s, u_d) <= 1e-8, (_rel(c_s, c_d),
                                                              _rel(u_s, u_d))

    sim_j = _setup_quad(JaxQuad(mj))
    theta = sim_j.make_theta(sim_j.params.as_dict())
    iv = sim_j.params.create_initial_value_function()
    aux = sim_j.runtime_aux()
    assert "_FP2Mrd" in aux
    u_j, c_j, ok_j, newton_j = jax.jit(sim_j.build_simulate_fn(N_STEPS, 1.0))(
        theta, jnp.asarray(iv[0]), jnp.asarray(iv[1]), aux)
    assert bool(np.asarray(ok_j).all())
    u_t, c_t, newton_t = _port_final(
        sim, convert.aux_from_numpy({k: np.asarray(v) for k, v in aux.items()}))
    assert newton_t == np.asarray(newton_j).tolist()
    assert _rel(c_t, c_j[-1]) <= 1e-8, _rel(c_t, c_j[-1])
    assert _rel(u_t, u_j[-1]) <= 1e-8, _rel(u_t, u_j[-1])


def _setup_brain(sim):
    """TumorGrowthBrain (quad) on [0, 10]^2 as tests/test_torch_quad.py's
    adjoint test sets it up."""
    mesh = sim.mesh
    r = np.linalg.norm((mesh.points - 5.0) / 5.0, axis=1)
    labels = np.zeros(mesh.n_nodes)
    labels[r < 0.95] = 1
    labels[r < 0.8] = 2
    labels[r < 0.6] = 3
    labels[r < 0.2] = 4
    sim.setup_global_parameters(
        label_function=labels,
        domain_names={0: "outside", 1: "CSF", 2: "GM", 3: "WM", 4: "Ventricles"},
        boundaries={"boundary_all": Boundary()},
        dirichlet_bcs={"clamped": {"bc_value": np.zeros(2),
                                   "named_boundary": "boundary_all", "subspace_id": 0}})
    sim.setup_model_parameters(
        iv_expression={0: np.zeros(2),
                       1: lambda x: np.exp(-((x - 5.5) ** 2).sum(axis=1) / 2.0)},
        E_GM=3e3, E_WM=3e3, E_CSF=1e3, E_VENT=1e3,
        nu_GM=0.45, nu_WM=0.45, nu_CSF=0.45, nu_VENT=0.3,
        D_GM=0.02, D_WM=0.1, rho_GM=0.02, rho_WM=0.1, coupling=0.15,
        sim_time=N_STEPS, sim_time_step=1)
    return sim


def test_value_and_grad_streamed_matches_default(monkeypatch):
    """J and the gradient of the 2-parameter (D_WM, rho_WM) inverse problem
    on the quad brain model (7 x 7 Morton rectangle, 2 steps) with
    GLIMS_P2STREAM=1 equal the default's: the IFT adjoint's residual VJPs
    pass through the two bell_bmv matvecs and the quadratic term."""
    mt, _ = _morton("rect", 7)
    sim = _setup_brain(TumorGrowthBrain(mt, dtype=torch.float64, device="cpu"))
    with torch.no_grad():
        u_tr, c_tr, ok, _ = sim.build_simulate_fn(N_STEPS, 1.0)(
            sim.make_theta(sim.params.as_dict()), *sim.initial_state())
    assert bool(ok.all())
    from glimslib_tpu_torch.optimize.adjoint import thresh

    targets = {"conc_T2": thresh(c_tr[-1], 0.12).numpy(), "disp": u_tr[-1].numpy()}
    names, update = param_map_for_type(2)
    v0 = np.array([0.05, 0.05])
    J, g = InverseProblem(sim, names, targets, update_fn=update).value_and_grad(v0)
    monkeypatch.setenv("GLIMS_P2STREAM", "1")
    sim_s = _setup_brain(TumorGrowthBrain(mt, dtype=torch.float64, device="cpu"))
    assert "_FP2Mrd" in sim_s.runtime_aux()
    J_s, g_s = InverseProblem(sim_s, names, targets, update_fn=update).value_and_grad(v0)
    assert abs(J_s - J) <= 1e-8 * abs(J), (J_s, J)
    assert _rel(g_s, g) <= 1e-8, (g_s, g)
    assert np.abs(g).max() > 0


def test_streamed_residual_under_bell_sharding(monkeypatch):
    """GLIMS_P2STREAM=1 under use_sharding(mode="bell") at two gloo ranks
    (tests/test_torch_shard.py's quad box): the P2 tables sharded, the mass
    plane the rank's half of the blocks, the streamed residual through the
    slab apply; the trajectory within atol 1e-11 of the unsharded streamed
    run on every rank (as the default's sharded run is held)."""
    monkeypatch.setenv("GLIMS_TWOLEVEL_MIN_NODES", "100")
    monkeypatch.setenv("GLIMS_P2STREAM", "1")
    ranks = run_ranks(shard_cases.p2stream_rank, 2, "gloo", "cpu")
    for out in ranks:
        assert out["p2_sharded"] and out["load"]
        got, whole = out["mass"]
        assert got[0] * 2 == whole[0] and got[1:] == whole[1:]
        u, c, ok, newton = out["sharded"]
        uw, cw, okw, neww = out["whole"]
        assert ok.all() and okw.all() and newton.tolist() == neww.tolist()
        np.testing.assert_allclose(c, cw, rtol=0, atol=1e-11)
        np.testing.assert_allclose(u, uw, rtol=0, atol=1e-11)
    for i in (0, 1):
        assert np.array_equal(ranks[0]["sharded"][i], ranks[1]["sharded"][i])
