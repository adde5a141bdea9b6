"""The system under test: ``glimslib_tpu_torch``, set up from a
configuration file through its public API (``core.mesh``, the
``TumorGrowthBrain`` models, ``setup_global_parameters``,
``setup_model_parameters``, ``optimize.adjoint.InverseProblem``).

This is the only module of the benchmark that imports the port, and it
imports it inside functions, so that the reference and the harness's
arithmetic load without it.
"""

from __future__ import annotations

import numpy as np
import torch

from port_bench.reference.model import tissue_labels


class _WholeBoundary:
    def inside(self, x, on_boundary):
        return on_boundary


def _model_class(cfg):
    from glimslib_tpu_torch.models import tumor_growth_brain, tumor_growth_brain_quad

    return {"TumorGrowthBrain": tumor_growth_brain.TumorGrowthBrain,
            "TumorGrowthBrainQuad": tumor_growth_brain_quad.TumorGrowthBrain}[cfg["model"]]


def build_mesh(cfg):
    """The configuration's box mesh: the port's Kuhn lattice, or its cells
    as an unstructured mesh in Morton order."""
    from glimslib_tpu_torch.core.mesh import Mesh, box_mesh

    n, L = cfg["voxels_per_side"], cfg["box_length"]
    mesh = box_mesh((0.0, 0.0, 0.0), (L, L, L), n, n, n)
    if cfg["mesh_order"] == "morton":
        mesh = Mesh.from_arrays(mesh.points, mesh.cells).reordered_morton()
    elif cfg["mesh_order"] != "lattice":
        raise ValueError(f"unknown mesh order {cfg['mesh_order']!r}")
    return mesh


def build_sim(cfg, device, dtype=None):
    """The configuration's model on ``device``, set up with its labels,
    clamped boundary and parameters, its initial concentration 0 (the
    forward cells hand their c0 to the simulate function;
    :func:`set_initial_concentration` sets it for the inverse problem)."""
    dtype = dtype or getattr(torch, cfg["dtype"])
    mesh = build_mesh(cfg)
    labels = tissue_labels(torch.as_tensor(mesh.points, dtype=torch.float64), cfg).numpy()
    sim = _model_class(cfg)(mesh, dtype=dtype, device=device)
    sim.setup_global_parameters(
        label_function=labels.astype(np.float64),
        domain_names={t["id"]: name for name, t in cfg["tissues"].items()},
        boundaries={"boundary_all": _WholeBoundary()},
        dirichlet_bcs={"clamped": {"bc_value": np.zeros(3),
                                   "named_boundary": "boundary_all",
                                   "subspace_id": 0}},
    )
    sim.setup_model_parameters(
        iv_expression={0: np.zeros(3), 1: 0.0},
        sim_time=cfg["sim_time"], sim_time_step=cfg["sim_time_step"],
        **cfg["parameters"])
    return sim


def concentration_points(sim):
    """Coordinates of the concentration dofs, in the model's order."""
    return sim.functionspace.dof_coordinates(1)


def inverse_problem(sim, targets, parameter_map, n_steps, dt, level):
    """The port's ``InverseProblem`` over v, the parameters a linear map
    of v (``parameter_map``: name -> [[k, a], ...]), targets
    ``conc_T2`` and ``disp`` as arrays in the model's dof order."""
    from glimslib_tpu_torch.optimize.adjoint import InverseProblem

    names = sorted({k for terms in parameter_map.values() for k, _ in terms})

    def update(v):
        return {name: sum(a * v[k] for k, a in terms)
                for name, terms in parameter_map.items()}

    return InverseProblem(sim, [f"v{k}" for k in names], targets, update_fn=update,
                          threshold_levels={"T2": level}, n_steps=n_steps, dt=dt)


def keep_final_state(sim):
    """Make every simulate that ``sim`` builds from now on keep its final
    (u, c), detached, under ``"u_T"`` and ``"c_T"`` of the returned dict:
    the state that an inverse problem's value_and_grad reaches."""
    held = {}
    make = sim.build_simulate_fn

    def build_simulate_fn(n_steps, dt):
        simulate = make(n_steps, dt)

        def run(*args, **kwargs):
            out = simulate(*args, **kwargs)
            held["u_T"], held["c_T"] = out[0][-1].detach(), out[1][-1].detach()
            return out
        return run

    sim.build_simulate_fn = build_simulate_fn
    return held


def kernel_counters():
    """The port's launch counters the per-layer metrics read: block-matvec
    launches by (B, M, K)."""
    from glimslib_tpu_torch.ops import bell_kernels

    return {"bell_bmv_by_shape": dict(bell_kernels.batched_matvec.launches_by_shape)}


def set_initial_concentration(sim, cfg, c0):
    """Set the model's initial concentration to the dof values ``c0`` (its
    dof order; the displacement starts at 0): the model projects an array
    of dof values onto its space, which returns them."""
    sim.setup_model_parameters(
        iv_expression={0: np.zeros(3), 1: np.asarray(c0, dtype=np.float64)},
        sim_time=cfg["sim_time"], sim_time_step=cfg["sim_time_step"],
        **cfg["parameters"])
