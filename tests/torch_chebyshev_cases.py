"""The port's side of tests/test_torch_chebyshev.py, importable without
JAX: the ranks that ``run_ranks`` spawns import this module, not the
test.

``port_model(lane, degree)`` builds ``examples.brain_sim`` in
glimslib_tpu_torch on the CPU at f64 with the TIGHT step and Chebyshev
preconditioning of ``degree``, on one lane: ``"lattice"`` (the n = 4 box
lattice padded for NODES_WORLD ranks, which ``nodes_rank`` runs under
``use_sharding(mode="nodes")``), ``"stripped"`` (the box without its
lattice, Morton-ordered: the supernode halo-ELL lane), ``"matrix_free"``
(the box lattice on the matrix-free jvp lane) or ``"quad"`` (the quad
model on the stripped n = 3 box).  ``run`` and ``nodes_rank`` return
numpy arrays and plain values."""

import numpy as np
import torch

from torch_vg import value_and_grad_with_forward

N_STEPS = 2
TIGHT = dict(newton_rtol=1e-10, newton_atol=1e-14, cg_rtol=1e-12)
V0 = (0.05, 0.05)  # the benchmark's adjoint cell (type 2)
NODES_WORLD = 2


def port_model(lane, degree):
    from glimslib_tpu_torch.core.mesh import box_mesh, pad_mesh_nodes
    from glimslib_tpu_torch.examples import brain_sim
    from glimslib_tpu_torch.solvers.coupled import StepConfig

    kw = dict(dtype=torch.float64, device="cpu")
    if lane == "quad":
        sim = brain_sim(n=3, unstructured=True, quad=True, **kw)
    elif lane == "lattice":
        mesh = pad_mesh_nodes(box_mesh((0, 0, 0), (10, 10, 10), 4, 4, 4), NODES_WORLD)
        sim = brain_sim(mesh=mesh, **kw)
    else:
        sim = brain_sim(n=4, unstructured=lane == "stripped", **kw)
    if lane == "matrix_free":
        sim.operator_mode = "matrix-free"
    sim.step_config = StepConfig(**TIGHT, precond_degree=degree)
    return sim


def run(sim, targets=None, mesh=None):
    """``value_and_grad`` of type 2 at V0 on ``targets`` (None: conc_T2 and
    disp of this model's N_STEPS-step forward at its set-up parameters)
    and the forward that runs inside it (its whole trajectory gathered
    under node sharding): its Newton and CG counts, then those of the
    adjoint solves too."""
    from glimslib_tpu_torch.optimize.adjoint import (
        InverseProblem, param_map_for_type, thresh)
    from glimslib_tpu_torch.parallel import gather_rows

    if targets is None:
        theta = sim.make_theta(sim.params.as_dict())
        u, c, _, _ = sim.build_simulate_fn(N_STEPS, 1.0)(theta, *sim.initial_state())
        targets = {"conc_T2": thresh(c[-1], 0.12).numpy(), "disp": u[-1].numpy()}
    names, update = param_map_for_type(2)
    ip = InverseProblem(sim, names, targets, update_fn=update, n_steps=N_STEPS, dt=1.0)
    J, g, (u, c, ok, newton) = value_and_grad_with_forward(ip, V0)
    rows = sim._node_rows
    if rows is not None:
        whole = lambda a: gather_rows(mesh, a.movedim(1, 0), rows.start,  # noqa: E731
                                      rows.n_total).movedim(0, 1)
        u, c = whole(u), whole(c)
    return dict(u=u.numpy(), c=c.numpy(), ok=bool(ok.all()), newton=newton.tolist(),
                counts=_counts(sim, "rd_cg_iters", "el_cg_iters"),
                vg_counts=_counts(sim, "rd_cg_iters", "rd_adj_cg_iters", "el_cg_iters",
                                  "el_adj_cg_iters"),
                J=J, g=g, pcg=bool(sim._lattice_pcg), targets=targets)


def _counts(sim, *kinds):
    """The CG iterations of the last simulate's (and backward's) solves of
    ``kinds``, by block ("rd": scalar, "el": vector), sorted."""
    info = sim.solver_info
    return {b: sorted(int(i) for k in kinds if k.startswith(b) for i in info[k])
            for b in ("rd", "el")}


def nodes_rank(mesh, degree, targets):
    """One rank: the padded lattice box under 'nodes' at ``degree``."""
    torch.set_num_threads(1)
    sim = port_model("lattice", degree)
    sim.use_sharding(mesh, mode="nodes")
    return run(sim, targets, mesh)


SHARD_MODES = ("bell", "cells", "nodes")


def modes_rank(mesh, degree, targets):
    """One rank: the brain box of tests/torch_nodeshard_cases.py (n = 4,
    unstructured, Morton-ordered, padded to 128 nodes) at ``degree`` under
    'bell', 'cells' and the unstructured 'nodes' in turn, each run as
    :func:`run` does."""
    from torch_nodeshard_cases import morton_mesh

    from glimslib_tpu_torch.examples import brain_sim
    from glimslib_tpu_torch.solvers.coupled import StepConfig

    torch.set_num_threads(1)
    out = {}
    for mode in SHARD_MODES:
        sim = brain_sim(dtype=torch.float64, device="cpu", mesh=morton_mesh())
        sim.step_config = StepConfig(**TIGHT, precond_degree=degree)
        sim.use_sharding(mesh, mode=mode)
        out[mode] = dict(run(sim, targets, mesh), matrix_free=sim.matrix_free)
    return out
