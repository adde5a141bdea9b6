"""The port's side of tests/test_torch_ell_lane.py and
tests/test_torch_switches.py, importable without JAX: the ranks that
``run_ranks`` spawns import this module, not the tests.

``ell_brain(n)`` is tests/test_ell.py's unstructured brain (an n^3 box
of (0, 8)^3, RCM-ordered) in glimslib_tpu_torch; ``box_brain(n, quad)``
is ``examples.brain_sim`` on the Morton-ordered box; both on the CPU at
f64 with the TIGHT step.  ``run`` returns numpy arrays and plain values.
"""

import numpy as np
import torch

from torch_vg import value_and_grad_with_forward

N_STEPS = 2
TIGHT = dict(newton_rtol=1e-10, newton_atol=1e-14, cg_rtol=1e-12)
V0 = (0.05, 0.05)  # the benchmark's adjoint cell (type 2)


class _Boundary:
    def inside(self, x, on_boundary):
        return on_boundary


def _tight(sim):
    from glimslib_tpu_torch.solvers.coupled import StepConfig

    sim.step_config = StepConfig(**TIGHT)
    return sim


def ell_brain(n=6):
    """tests/test_ell.py's ``_brain_unstructured`` in the port."""
    from glimslib_tpu_torch.core.mesh import Mesh, box_mesh
    from glimslib_tpu_torch.models.tumor_growth_brain import TumorGrowthBrain

    m0 = box_mesh((0, 0, 0), (8, 8, 8), n, n, n)
    mesh = Mesh.from_arrays(m0.points, m0.cells).reordered_rcm()
    r = np.linalg.norm((mesh.points - 4.0) / 4.0, axis=1)
    labels = np.zeros(mesh.n_nodes)
    labels[r < 0.95] = 1
    labels[r < 0.8] = 2
    labels[r < 0.6] = 3
    labels[r < 0.2] = 4
    sim = TumorGrowthBrain(mesh, dtype=torch.float64, device="cpu")
    sim.setup_global_parameters(
        label_function=labels,
        domain_names={0: "outside", 1: "CSF", 2: "GM", 3: "WM", 4: "Ventricles"},
        boundaries={"boundary_all": _Boundary()},
        dirichlet_bcs={"clamped": {"bc_value": np.zeros(3),
                                   "named_boundary": "boundary_all",
                                   "subspace_id": 0}},
    )
    center = np.array([4.5, 4.0, 4.0])
    sim.setup_model_parameters(
        iv_expression={0: np.zeros(3),
                       1: lambda x: np.exp(-((x - center) ** 2).sum(axis=1))},
        E_GM=3e3, E_WM=3e3, E_CSF=1e3, E_VENT=1e3,
        nu_GM=0.45, nu_WM=0.45, nu_CSF=0.45, nu_VENT=0.3,
        D_GM=0.02, D_WM=0.1, rho_GM=0.02, rho_WM=0.1, coupling=0.15,
        sim_time=2, sim_time_step=1,
    )
    return _tight(sim)


def box_brain(n=4, quad=False):
    """``examples.brain_sim`` on the Morton-ordered n^3 box (the supernode
    lane), the quad model with ``quad``."""
    from glimslib_tpu_torch.examples import brain_sim

    return _tight(brain_sim(n=n, dtype=torch.float64, device="cpu", unstructured=True,
                            quad=quad))


def setup_quad(sim, sim_time=N_STEPS):
    """The quad TumorGrowth of either package as tests/test_torch_quad.py
    sets it up (the reference's P2 parity harness): clamped, a Gaussian
    seed at the centre of [0, 10]^d."""
    d = sim.mesh.dim
    sim.setup_global_parameters(
        boundaries={"boundary_all": _Boundary()},
        dirichlet_bcs={"clamped": {"bc_value": np.zeros(d),
                                   "named_boundary": "boundary_all", "subspace_id": 0}})
    center = np.full(d, 5.0)
    sim.setup_model_parameters(
        iv_expression={0: np.zeros(d),
                       1: lambda x: np.exp(-0.5 * ((x - center) ** 2).sum(axis=1))},
        diffusion=0.2, coupling=0.15, proliferation=0.1, E=0.001, poisson=0.45,
        sim_time=sim_time, sim_time_step=1,
    )
    return sim


def _counts(sim, *kinds):
    """The CG iterations of the last simulate's (and backward's) solves of
    ``kinds``, by block ("rd": scalar, "el": vector), sorted."""
    info = sim.solver_info
    return {b: sorted(int(i) for k in kinds if k.startswith(b) for i in info[k])
            for b in ("rd", "el")}


def run(sim, targets=None, n_steps=N_STEPS):
    """``n_steps`` steps with the Newton and CG counts of the forward; with
    ``targets`` (a string: conc_T2 and disp of the run's own final state)
    ``value_and_grad`` of type 2 at V0 too, with the forward inside it
    (``v0``: its trajectory and counts)."""
    from glimslib_tpu_torch.optimize.adjoint import (
        InverseProblem, param_map_for_type, thresh,
    )

    theta = sim.make_theta(sim.params.as_dict())
    u, c, ok, newton = sim.build_simulate_fn(n_steps, 1.0)(theta, *sim.initial_state())
    out = dict(u=u.numpy(), c=c.numpy(), ok=bool(ok.all()), newton=newton.tolist(),
               counts=_counts(sim, "rd_cg_iters", "el_cg_iters"))
    if targets is not None:
        if isinstance(targets, str):
            targets = {"conc_T2": thresh(c[-1], 0.12).numpy(), "disp": u[-1].numpy()}
        names, update = param_map_for_type(2)
        ip = InverseProblem(sim, names, targets, update_fn=update, n_steps=n_steps, dt=1.0)
        J, g, (u, c, ok, newton) = value_and_grad_with_forward(ip, V0)
        out.update(J=J, g=g, targets=targets, v0=dict(
            u=u.numpy(), c=c.numpy(), ok=bool(ok.all()), newton=newton.tolist(),
            counts=_counts(sim, "rd_cg_iters", "el_cg_iters")))
    return out


def chunked_bell_rank(mesh):
    """One rank: the quad model on the n = 3 box under
    ``use_sharding(mode="bell")`` with GLIMS_BELL_S=64 and
    GLIMS_P2_HALO_CHUNK=4 (set by the caller): its slab sizes, 2 steps
    and value_and_grad on its own final state."""
    torch.set_num_threads(1)
    sim = box_brain(3, quad=True)
    sim.use_sharding(mesh, mode="bell")
    p2 = sim._get_p2_plan()
    out = run(sim, "own")
    out.update(p2_chunk=p2.halo_chunk, p2_nb=(p2.nb, p2.nb_total),
               bell_s=sim._get_bell_plan().s, p2_sharded=sim._p2_sharded)
    return out
