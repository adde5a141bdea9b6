"""What the 2D uniform adjoint scripts share: the model of
``examples/tumor_growth_2D_uniform_adjoint*.py`` and its target run."""

import numpy as np
import torch

from glimslib_tpu_torch.core.mesh import rectangle_mesh
from glimslib_tpu_torch.example_scripts.example_config import BoundaryAll, gaussian_iv
from glimslib_tpu_torch.models.tumor_growth import TumorGrowth


def uniform_sim(n, device, dtype, seed=(0, 0), **param_overrides):
    """TumorGrowth on the n x n rectangle of [-5, 5]^2, clamped, the
    scripts' parameters (diffusion 0.1, coupling 0.2, proliferation 0.1,
    E 0.001, poisson 0.45; ``param_overrides`` win), a Gaussian seed at
    ``seed``, 5 steps of dt 1."""
    mesh = rectangle_mesh((-5, -5), (5, 5), n, n)
    sim = TumorGrowth(mesh, dtype=dtype, device=device)
    sim.setup_global_parameters(
        boundaries={"boundary_all": BoundaryAll()},
        dirichlet_bcs={
            "clamped_boundary": {
                "bc_value": np.zeros(2),
                "named_boundary": "boundary_all",
                "subspace_id": 0,
            }
        },
    )
    params = dict(diffusion=0.1, coupling=0.2, proliferation=0.1, E=0.001,
                  poisson=0.45)
    params.update(param_overrides)
    sim.setup_model_parameters(
        iv_expression={0: np.zeros(2), 1: gaussian_iv(seed)},
        sim_time=5, sim_time_step=1, **params,
    )
    return sim


def simulate(sim, params, n_steps, dt):
    """The trajectory (u, c) at ``params`` as host arrays, no graph (the
    reference scripts' jitted ``build_simulate_fn``); raises where a step
    did not converge."""
    u0, c0 = sim.initial_state()
    with torch.no_grad():
        u_traj, c_traj, ok, _ = sim.build_simulate_fn(n_steps, dt)(
            sim.make_theta(params), u0, c0)
    if not bool(ok.all()):
        raise AssertionError("the target run did not converge")
    return u_traj.cpu().numpy(), c_traj.cpu().numpy()


def first_call(progress):
    """J and the gradient of L-BFGS-B's first call (at x0)."""
    cols = progress.to_columns()
    grad = np.asarray([cols[f"dJd{n}"][0] for n in progress.param_names])
    return float(cols["J"][0]), grad
