"""The port's side of tests/test_torch_vn_shard.py, importable without
JAX: the ranks that ``run_ranks`` spawns import this module, not the
test.

``port_model`` builds ``examples.influx_sim`` (a von Neumann influx of c
through the whole boundary scaled by the boundary cells' D, a
time-dependent source) with the traction ``TRACTION`` through the whole
boundary and the displacement clamped on the boundary but its x = 10
face, in
glimslib_tpu_torch on the CPU at f64 with the TIGHT step, on the n = 4
box padded to a multiple of ``PAD`` nodes: its lattice (``"lattice"``,
whole planes: 200 nodes) or the same box made unstructured and
Morton-ordered (``"stripped"``, 128 nodes).  ``model_rank`` is what each rank runs; it returns
numpy arrays and plain values."""

import numpy as np
import torch

from torch_vg import value_and_grad_with_forward

N = 4  # the box: 125 nodes, 384 tets
PAD = 4  # padded for 2 and 4 ranks
N_STEPS = 2
TIGHT = dict(newton_rtol=1e-10, newton_atol=1e-14, cg_rtol=1e-12)
TRACTION = (20.0, 0.0, 5.0)
V0 = (0.05, 0.05)


def box(kind):
    """The test's mesh: the lattice box, or the stripped Morton box, padded
    to a multiple of PAD nodes."""
    from glimslib_tpu_torch.core.mesh import Mesh, box_mesh, pad_mesh_nodes

    m = box_mesh((0, 0, 0), (10, 10, 10), N, N, N)
    if kind != "lattice":
        m = Mesh.from_arrays(m.points, m.cells).reordered_morton()
    return pad_mesh_nodes(m, PAD)


def port_model(kind, **step):
    """influx_sim with the traction on :func:`box` at f64 on the CPU."""
    from glimslib_tpu_torch.examples import influx_sim
    from glimslib_tpu_torch.solvers.coupled import StepConfig

    sim = influx_sim(dtype=torch.float64, device="cpu", mesh=box(kind),
                     traction=TRACTION)
    sim.step_config = StepConfig(**TIGHT, **step)
    return sim


def tissue_masks(sim):
    """Per-cell WM and GM indicators (nc,) of the model's subdomains."""
    names = {v: k for k, v in sim.subdomains.tissue_id_name_map.items()}
    labels = np.asarray(sim.subdomains.cell_labels)
    return labels == names["WM"], labels == names["GM"]


def update_fn(wm, gm):
    """The parameter map (D_WM, rho_WM): per-cell diffusion and
    proliferation, influx_sim's elsewhere (``wm``, ``gm``: the per-cell
    WM and GM indicators as torch or jnp arrays)."""
    def update(v):
        return {"diffusion": v[0] * wm + 0.02 * (1.0 - wm),
                "proliferation": v[1] * wm + 0.02 * gm}
    return update


def trajectory(sim, n_steps=N_STEPS):
    theta = sim.make_theta(sim.params.as_dict())
    return sim.build_simulate_fn(n_steps, 1.0)(theta, *sim.initial_state())


def targets(kind):
    """conc_T2 and disp of the unsharded port model's N_STEPS-step forward
    at its set-up parameters."""
    from glimslib_tpu_torch.optimize.adjoint import thresh

    u, c, ok, _ = trajectory(port_model(kind))
    assert bool(ok.all())
    return {"conc_T2": thresh(c[-1], 0.12).numpy(), "disp": u[-1].numpy()}


def model_rank(mesh, mode, kind, targets, out_dir=None):
    """One rank: the model under ``use_sharding(mesh, mode)``, N_STEPS
    steps (gathered under 'nodes'), its Newton and CG counts, then
    ``InverseProblem.value_and_grad`` at V0 on the whole ``targets`` with
    the trajectory of the forward inside it (``u_v0``, ``c_v0``), and
    where ``out_dir`` is given ``run()`` with VTU output into it (rank 0
    alone writes)."""
    from glimslib_tpu_torch.optimize.adjoint import InverseProblem
    from glimslib_tpu_torch.parallel import gather_rows

    torch.set_num_threads(1)
    sim = port_model(kind)
    sim.use_sharding(mesh, mode=mode)
    u, c, ok, newton = trajectory(sim)
    rows = sim._node_rows
    if rows is not None:
        whole = lambda a: gather_rows(mesh, a.movedim(1, 0), rows.start,  # noqa: E731
                                      rows.n_total).movedim(0, 1)
        u, c = whole(u), whole(c)
    info = {k: [int(i) for i in v] for k, v in sim.solver_info.items()}
    wm, gm = (torch.as_tensor(m, dtype=torch.float64) for m in tissue_masks(sim))
    ip = InverseProblem(sim, ["D_WM", "rho_WM"], targets,
                        update_fn=update_fn(wm, gm), n_steps=N_STEPS, dt=1.0)
    J, g, (u_v0, c_v0, _, _) = value_and_grad_with_forward(ip, V0)
    if rows is not None:
        u_v0, c_v0 = whole(u_v0), whole(c_v0)
    out = dict(mode=sim.sharding_mode, kernels=type(sim.kernels).__name__,
               u=u.numpy(), c=c.numpy(), ok=bool(ok.all()), newton=newton.tolist(),
               rd_cg=info["rd_cg_iters"], el_cg=info["el_cg_iters"], J=J, g=g,
               u_v0=u_v0.numpy(), c_v0=c_v0.numpy(),
               facets={name: len(sim._von_neumann_kernels(name, bc)[1])
                       for name, bc in sim.bcs.von_neumann_bcs.items()})
    if out_dir is not None:
        sol = sim.run(save_method="vtk", output_dir=out_dir)
        out.update(run_c=np.asarray(sol[1]), run_u=np.asarray(sol[0]))
    return out
