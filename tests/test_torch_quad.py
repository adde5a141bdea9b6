"""Port parity of the quad (P2-concentration) models on the unstructured
lane: ``models/tumor_growth_quad.py`` and ``tumor_growth_brain_quad.py``
of glimslib_tpu_torch against the JAX package and against the
independent scipy P2 FEM (``tests/reference_fem.py ReferenceFEMP2``), on
the CPU.

Both packages take their default path on a mesh without lattice
structure: the assembled P2 rd Jacobian over the P2 supernode plan, its
supernode block-Jacobi, the P1 elasticity operators with the two-level
level (``GLIMS_TWOLEVEL_MIN_NODES=100`` switches it on at these sizes),
the chord method, warm starts and the factored assembly.  The JAX side
builds its P2 plan with the port's flat halo (``GLIMS_P2_HALO_CHUNK=1``,
read when it builds the plan), so its frozen arrays carry over
(``convert.aux_from_numpy``) and both iterate with identical
preconditioners.

Tolerances: 3-step forwards within rel-L2 1e-8 of the JAX package's at
f64 (Newton counts equal) and 1e-6 of the scipy P2 FEM; the f32-refined
step within 1e-5 of the JAX package's f32-refined step; J and the
gradient of the 2-parameter inverse problem within rel 1e-8 of the JAX
package's, and a central difference within 1e-5.
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
from glimslib_tpu.core.mesh import box_mesh as jax_box_mesh  # noqa: E402
from glimslib_tpu.core.mesh import rectangle_mesh as jax_rectangle_mesh  # noqa: E402
from glimslib_tpu.models.tumor_growth_brain_quad import (  # noqa: E402
    TumorGrowthBrain as JaxBrainQuad,
)
from glimslib_tpu.models.tumor_growth_quad import TumorGrowth as JaxQuad  # noqa: E402
from glimslib_tpu.optimize.adjoint import InverseProblem as JaxInverseProblem  # noqa: E402
from glimslib_tpu.optimize.adjoint import param_map_for_type as jax_param_map  # noqa: E402
from glimslib_tpu_torch import convert  # noqa: E402
from glimslib_tpu_torch.core.mesh import Mesh, box_mesh, rectangle_mesh  # noqa: E402
from glimslib_tpu_torch.examples import adjoint_problem, brain_sim  # noqa: E402
from glimslib_tpu_torch.models.tumor_growth_brain_quad import TumorGrowthBrain  # noqa: E402
from glimslib_tpu_torch.models.tumor_growth_quad import TumorGrowth  # noqa: E402
from glimslib_tpu_torch.optimize.adjoint import InverseProblem, param_map_for_type  # noqa: E402

from reference_fem import ReferenceFEMP2  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

N_STEPS = 3


def _rel(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


class Boundary:
    def inside(self, x, on_boundary):
        return on_boundary


@pytest.fixture
def quad_env(monkeypatch):
    monkeypatch.setenv("GLIMS_P2_HALO_CHUNK", "1")
    monkeypatch.setenv("GLIMS_TWOLEVEL_MIN_NODES", "100")


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


def _setup_quad(sim, dirichlet_conc=False, sim_time=N_STEPS):
    """TumorGrowth (quad) as the reference's P2 parity harness sets it up
    (test_p2_parity.py:30-58): clamped, optionally c = 0 on the boundary,
    a Gaussian seed at the centre."""
    d = sim.mesh.dim
    bcs = {"clamped": {"bc_value": np.zeros(d), "named_boundary": "boundary_all",
                       "subspace_id": 0}}
    if dirichlet_conc:
        bcs["conc_wall"] = {"bc_value": 0.0, "named_boundary": "boundary_all",
                            "subspace_id": 1}
    sim.setup_global_parameters(boundaries={"boundary_all": Boundary()},
                                dirichlet_bcs=bcs)
    center = np.full(d, 5.0)
    sim.setup_model_parameters(
        iv_expression={0: np.zeros(d),
                       1: lambda x: np.exp(-0.5 * ((x - center) ** 2).sum(axis=1))},
        diffusion=0.2, coupling=0.15, proliferation=0.1, E=0.001, poisson=0.45,
        sim_time=sim_time, sim_time_step=1,
    )
    return sim


def _setup_brain(sim, sim_time=N_STEPS):
    """TumorGrowthBrain (quad) on a 2D mesh of [0, 10]^2 as the reference's
    quad adjoint test sets it up (test_p2.py:134-170)."""
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
                                   "named_boundary": "boundary_all", "subspace_id": 0}},
    )
    sim.setup_model_parameters(
        iv_expression={0: np.zeros(2),
                       1: lambda x: np.exp(-((x - 5.5) ** 2).sum(axis=1) / 2.0)},
        E_GM=3e3, E_WM=3e3, E_CSF=1e3, E_VENT=1e3,
        nu_GM=0.45, nu_WM=0.45, nu_CSF=0.45, nu_VENT=0.3,
        D_GM=0.02, D_WM=0.1, rho_GM=0.02, rho_WM=0.1, coupling=0.15,
        sim_time=sim_time, sim_time_step=1,
    )
    return sim


def _jax_run(sim_j, n_steps=N_STEPS, dtype=jnp.float64):
    """The JAX model's jitted simulate with its own runtime aux: (u, c,
    ok, newton) of the last step and (theta, iv, aux) as numpy."""
    theta = sim_j.make_theta(sim_j.params.as_dict())
    theta = {k: jnp.asarray(v, dtype) if jnp.asarray(v).dtype.kind == "f" else v
             for k, v in theta.items()}
    iv = sim_j.params.create_initial_value_function()
    aux = sim_j.runtime_aux()
    u, c, ok, newton = jax.jit(sim_j.build_simulate_fn(n_steps, 1.0))(
        theta, jnp.asarray(iv[0], dtype), jnp.asarray(iv[1], dtype), aux)
    np_ = lambda d: {k: np.asarray(v) for k, v in d.items()}  # noqa: E731
    return (np.asarray(u[-1]), np.asarray(c[-1]), np.asarray(ok), np.asarray(newton),
            np_(theta), iv, np_(aux))


def _port_run(sim_t, theta_np, iv, aux_np, n_steps=N_STEPS, dtype=torch.float64):
    theta = convert.theta_from_numpy(theta_np, dtype=dtype)
    u0, c0 = convert.state_from_numpy(iv[0], iv[1], dtype=dtype)
    aux = None if aux_np is None else convert.aux_from_numpy(aux_np, dtype=dtype)
    return sim_t.build_simulate_fn(n_steps, 1.0)(theta, u0, c0, aux)


def _pair(case):
    """(port model, JAX model) of a forward case."""
    if case == "brain_box":
        sim_j = jax_brain_sim(n=4, dims=3, dtype=jnp.float64, quad=True,
                              mesh_transform=lambda m: JaxMesh.from_arrays(
                                  m.points, m.cells).reordered_morton())
        sim_t = brain_sim(n=4, dtype=torch.float64, device="cpu", unstructured=True,
                          quad=True)
        return sim_t, sim_j
    kind, n, conc = {"quad_box": ("box", 4, False),
                     "quad_rect_dirichlet_c": ("rect", 9, True)}[case]
    mt, mj = _morton(kind, n)
    return (_setup_quad(TumorGrowth(mt, dtype=torch.float64, device="cpu"), conc),
            _setup_quad(JaxQuad(mj), conc))


@pytest.mark.parametrize("case", ["brain_box", "quad_box", "quad_rect_dirichlet_c"])
def test_forward_matches_jax_f64(quad_env, case):
    """3 steps at f64 with the reference's aux carried across: converged
    flags and Newton counts equal, rel-L2 of c and u <= 1e-8.  The port's
    own frozen arrays equal the carried ones (1e-10; representative cells
    exactly; coarse factors as B Bᵀ), and simulating with them gives the
    same trajectory.  ``quad_rect_dirichlet_c`` clamps c on the
    boundary, edge dofs included."""
    sim_t, sim_j = _pair(case)
    assert sim_t.mesh.lattice_strides is None
    u_j, c_j, ok_j, newton_j, theta, iv, aux_j = _jax_run(sim_j)
    assert "_FP2Wrd" in aux_j and "_McSNP2" in aux_j
    u_t, c_t, ok_t, newton_t = _port_run(sim_t, theta, iv, aux_j)
    assert ok_t.tolist() == ok_j.tolist() == [True] * N_STEPS
    assert newton_t.tolist() == newton_j.tolist()
    assert _rel(c_t[-1], c_j) <= 1e-8, _rel(c_t[-1], c_j)
    assert _rel(u_t[-1], u_j) <= 1e-8, _rel(u_t[-1], u_j)
    if case == "quad_rect_dirichlet_c":
        mask_c = sim_t._bc_masks_and_values()[1].numpy()
        assert mask_c.sum() > len(sim_t.mesh.boundary_nodes)  # edge dofs too
        np.testing.assert_allclose(c_t[-1].numpy()[mask_c], 0.0, atol=0)

    carried = convert.aux_from_numpy(aux_j)
    own = sim_t.runtime_aux()
    assert sorted(own) == sorted(carried)
    for k, v in own.items():
        if not v.is_floating_point():
            assert torch.equal(v, carried[k]), k
        elif k.startswith("_TLCfac"):
            assert _rel(v @ v.T, carried[k] @ carried[k].T) <= 1e-10, k
        else:
            assert _rel(v, carried[k]) <= 1e-10, k
    u_o, c_o, ok_o, _ = _port_run(sim_t, theta, iv, None)
    assert bool(ok_o.all())
    assert _rel(c_o[-1], c_t[-1]) <= 1e-10 and _rel(u_o[-1], u_t[-1]) <= 1e-10


def test_chunk_aligned_p2_aux_raises(monkeypatch):
    """A factored P2 stack built on the reference's chunk-aligned halo
    (GLIMS_P2_HALO_CHUNK=4, its default) carries into a port model whose
    P2 plan has the same halo (the switch set for the port too), and the
    two compute the same (rel 1e-10); into a port model with a flat halo
    the conversion raises and says so."""
    monkeypatch.setenv("GLIMS_P2_HALO_CHUNK", "4")
    mt, mj = _morton("rect", 5)
    sim_j = _setup_quad(JaxQuad(mj), sim_time=2)
    aux = {k: np.asarray(v) for k, v in sim_j.runtime_aux().items()}
    assert "_FP2Wrd" in aux
    sim_t = _setup_quad(TumorGrowth(mt, dtype=torch.float64, device="cpu"), sim_time=2)
    assert sim_t._get_p2_plan().halo_chunk == 4
    carried = convert.aux_from_numpy(aux)
    own = sim_t.runtime_aux()
    assert carried["_FP2Wrd"].shape == own["_FP2Wrd"].shape
    assert _rel(carried["_FP2Wrd"], own["_FP2Wrd"]) <= 1e-10
    theta = sim_t.make_theta(sim_t.params.as_dict())
    a = sim_t.build_simulate_fn(2, 1.0)(theta, *sim_t.initial_state(), carried)
    b = sim_t.build_simulate_fn(2, 1.0)(theta, *sim_t.initial_state(), own)
    assert bool(a[2].all()) and bool(b[2].all())
    assert _rel(a[1], b[1]) <= 1e-10 and _rel(a[0], b[0]) <= 1e-10
    with pytest.raises(ValueError, match="GLIMS_P2_HALO_CHUNK=1"):
        convert.aux_from_numpy(aux, p2_halo_chunk=1)
    monkeypatch.setenv("GLIMS_P2_HALO_CHUNK", "1")
    with pytest.raises(ValueError, match="GLIMS_P2_HALO_CHUNK=1"):
        convert.aux_from_numpy(aux)


def _canon(sim, c):
    """A P2 vector in the interleaved dof order -> the scipy harness's
    canonical [vertices | edges] order."""
    return np.asarray(c, dtype=np.float64)[sim.p2.dof_rank]


@pytest.mark.parametrize("case", ["rcm_box", "rect_dirichlet_c"])
def test_forward_matches_reference_fem_p2(case):
    """The port's quad TumorGrowth, 3 steps at f64, against the scipy P2
    FEM: rel-L2 of c and u <= 1e-6 (test_p2_parity.py:201-225's
    counterpart on the RCM-reordered box; and with c clamped on the 2D
    lattice-stripped rectangle, every boundary edge dof included)."""
    if case == "rcm_box":
        m0 = box_mesh((0, 0, 0), (10, 10, 10), 4, 4, 4)
        mesh = Mesh.from_arrays(m0.points, m0.cells).reordered_rcm()
        conc = False
    else:
        mesh, conc = _morton("rect", 9)[0], True
    sim = _setup_quad(TumorGrowth(mesh, dtype=torch.float64, device="cpu"), conc)
    sim.run(save_method=None)
    assert sim.results.get_recording_steps() == list(range(N_STEPS + 1))

    ref = ReferenceFEMP2(mesh)
    c = _canon(sim, sim.params.create_initial_value_function()[1])
    d = mesh.dim
    u = np.zeros((mesh.n_nodes, d))
    bn = mesh.boundary_nodes
    E, nu = 0.001, 0.45
    kw = {}
    if conc:
        fvs = mesh.boundary_facet_nodes
        eids = mesh.edge_ids_for_pairs(fvs) if d == 2 else mesh.edge_ids_for_pairs(
            np.concatenate([fvs[:, [0, 1]], fvs[:, [0, 2]], fvs[:, [1, 2]]]))
        dofs = np.concatenate([bn, mesh.n_nodes + np.unique(eids)])
        kw = dict(dirichlet_conc_dofs=dofs, dirichlet_conc_values=np.zeros(len(dofs)))
        c[dofs] = 0.0
    for _ in range(N_STEPS):
        u, c = ref.solve_step2(
            u.ravel(), c, D_cell=0.2, rho_cell=0.1, mu_cell=E / (2 * (1 + nu)),
            lam_cell=E * nu / ((1 + nu) * (1 - 2 * nu)), coupling=0.15, dt=1.0,
            dirichlet_disp_nodes=bn, dirichlet_disp_values=np.zeros((len(bn), d)), **kw)
    assert _rel(_canon(sim, sim.solution[1]), c) <= 1e-6
    assert _rel(sim.solution[0], u) <= 1e-6


def test_refined_f32_matches_jax_refined(quad_env):
    """The quad model's f32 default refines on both sides (f32 solves, f64
    P2 residuals, one correction solve a step): the port's final states
    within rel-L2 1e-5 of the JAX package's, the reference's aux carried
    across, on the n=4 Morton box."""
    mt, mj = _morton("box", 4)
    sim_j = _setup_quad(JaxQuad(mj, dtype=jnp.float32))
    assert sim_j.step_config.refine_f64
    sim_t = _setup_quad(TumorGrowth(mt, dtype=torch.float32, device="cpu"))
    assert sim_t.step_config.refine_f64
    u_j, c_j, ok_j, _, theta, iv, aux_j = _jax_run(sim_j, dtype=jnp.float32)
    assert ok_j.all()
    u_t, c_t, ok_t, _ = _port_run(sim_t, theta, iv, aux_j, dtype=torch.float32)
    assert bool(ok_t.all())
    assert len(sim_t.solver_info["el_refine_cg_iters"]) == N_STEPS
    assert _rel(c_t[-1], c_j) <= 1e-5, _rel(c_t[-1], c_j)
    assert _rel(u_t[-1], u_j) <= 1e-5, _rel(u_t[-1], u_j)


def test_brain_quad_refines_with_p2_residuals():
    """The quad brain model's refined step measures the f64 P2 residuals
    (its concentration has n_dofs entries): 2 f32 steps on the n=3 Morton
    box converge with one correction solve a step and land within 1e-5
    of the f64 path."""
    sim = brain_sim(n=3, dtype=torch.float32, device="cpu", unstructured=True, quad=True)
    from glimslib_tpu_torch.models.base import default_step_config

    sim.step_config = default_step_config(torch.float32)
    assert sim.step_config.refine_f64
    u, c, ok, _ = sim.build_simulate_fn(2, 1.0)(
        sim.make_theta(sim.params.as_dict()), *sim.initial_state())
    assert bool(ok.all())
    assert len(sim.solver_info["el_refine_cg_iters"]) == 2
    ref = brain_sim(n=3, dtype=torch.float64, device="cpu", unstructured=True, quad=True)
    u64, c64, ok64, _ = ref.build_simulate_fn(2, 1.0)(
        ref.make_theta(ref.params.as_dict()), *ref.initial_state())
    assert bool(ok64.all())
    assert _rel(c[-1], c64[-1]) <= 1e-5
    assert _rel(u[-1], u64[-1]) <= 1e-5


def test_quad_adjoint_matches_jax():
    """J and the gradient of the 2-parameter (type 2: D_WM, rho_WM)
    inverse problem on the quad brain model, 7 x 7 Morton rectangle, 2
    steps, f64: within rel 1e-8 of the JAX package's single-device
    value_and_grad, and a central difference of the port's objective
    within 1e-5 (the port's counterpart of test_p2.py:134-192 on an
    unstructured mesh)."""
    mt, mj = _morton("rect", 7)
    sim_j = _setup_brain(JaxBrainQuad(mj), sim_time=2)
    sim_t = _setup_brain(TumorGrowthBrain(mt, dtype=torch.float64, device="cpu"),
                         sim_time=2)
    with torch.no_grad():
        u_tr, c_tr, ok, _ = sim_t.build_simulate_fn(2, 1.0)(
            sim_t.make_theta(sim_t.params.as_dict()), *sim_t.initial_state())
    assert bool(ok.all())
    from glimslib_tpu_torch.optimize.adjoint import thresh

    targets = {"conc_T2": thresh(c_tr[-1], 0.12).numpy(), "disp": u_tr[-1].numpy()}
    names, update = param_map_for_type(2)
    ip = InverseProblem(sim_t, names, targets, update_fn=update)
    names_j, update_j = jax_param_map(2)
    ip_j = JaxInverseProblem(sim_j, names_j, targets, update_fn=update_j)
    v0 = np.array([0.05, 0.05])
    J, g = ip.value_and_grad(v0)
    assert len(sim_t.solver_info["rd_adj_cg_iters"]) == 2
    J_j, g_j = ip_j.value_and_grad(v0)
    assert abs(J - J_j) <= 1e-8 * abs(J_j), (J, J_j)
    assert _rel(g, g_j) <= 1e-8, (g, g_j)
    eps = 1e-5
    direction = np.array([0.6, 0.8])
    fd = (ip.objective(v0 + eps * direction) - ip.objective(v0 - eps * direction)) / (
        2 * eps)
    assert abs(fd - g @ direction) <= 1e-5 * abs(fd), (fd, g @ direction)


def test_export_computation_graph(tmp_path):
    """InverseProblem.export_computation_graph writes the autograd graph of
    one objective evaluation: the file names one _ImplicitStepBackward node
    a step."""
    ip, v0 = adjoint_problem(n=3, unstructured=True, quad=True,
                             dtype=torch.float64, device="cpu")
    path = ip.export_computation_graph(str(tmp_path / "graph.txt"), v0)
    text = open(path).read()
    assert f"# {ip.n_steps} _ImplicitStepBackward\n" in text
    assert sum(line.split()[-1] == "_ImplicitStepBackward"
               for line in text.splitlines() if not line.startswith("#")
               and "[" not in line) == ip.n_steps
