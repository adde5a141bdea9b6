"""The port's side of tests/test_torch_nodeshard.py, importable without
JAX: the ranks that ``run_ranks`` spawns import this module, not the
test.

``port_model`` builds the test's model in glimslib_tpu_torch on the CPU
at f64: the brain box of ``examples.brain_sim`` on an n x n x n box mesh
made unstructured, Morton-ordered and padded with ``pad_mesh_nodes`` to
a multiple of ``PAD`` (or, ``lattice``, the lattice box padded for
``world`` ranks); the ``*_rank`` functions are what each rank runs, and
return numpy arrays and plain values."""

import numpy as np
import torch

from torch_vg import value_and_grad_with_forward

N = 4  # the box: 125 nodes, 384 tets
PAD = 4  # padded to 128 nodes: 64 rows a rank at 2 ranks, 32 at 4
N_STEPS = 2
TIGHT = dict(newton_rtol=1e-10, newton_atol=1e-14, cg_rtol=1e-12)
V0 = (0.05, 0.05)  # the benchmark's adjoint cell (type 2)


def morton_mesh(n=N, pad=PAD):
    from glimslib_tpu_torch.core.mesh import Mesh, box_mesh, pad_mesh_nodes

    m = box_mesh((0, 0, 0), (10, 10, 10), n, n, n)
    return pad_mesh_nodes(Mesh.from_arrays(m.points, m.cells).reordered_morton(), pad)


def port_model(lattice=False, world=2):
    """The brain model on :func:`morton_mesh` (``lattice``: on the lattice
    box padded for ``world`` ranks, on the matrix-free lane) at f64 on the
    CPU with the TIGHT step."""
    from glimslib_tpu_torch.core.mesh import box_mesh, pad_mesh_nodes
    from glimslib_tpu_torch.examples import brain_sim
    from glimslib_tpu_torch.solvers.coupled import StepConfig

    if lattice:
        mesh = pad_mesh_nodes(box_mesh((0, 0, 0), (10, 10, 10), N, N, N), world)
    else:
        mesh = morton_mesh()
    sim = brain_sim(dtype=torch.float64, device="cpu", mesh=mesh)
    sim.step_config = StepConfig(**TIGHT)
    sim.params.set_parameter("sim_time", N_STEPS)  # run() takes N_STEPS steps
    if lattice:
        sim.operator_mode = "matrix-free"
    return sim


def random_inputs(mesh, seed):
    """Node and per-cell inputs of every kernel member, from ``seed``."""
    rng = np.random.default_rng(seed)
    n, d, nc = mesh.n_nodes, mesh.dim, mesh.n_cells
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)  # noqa: E731
    return dict(c=t(rng.random(n)), cp=t(rng.random(n)), u=t(rng.standard_normal((n, d))),
                D=t(rng.uniform(0.01, 0.2, nc)), rho=t(rng.uniform(0.01, 0.2, nc)),
                mu=t(rng.uniform(0.5, 2.0, nc)), lam=t(rng.uniform(0.5, 2.0, nc)),
                src=t(rng.uniform(0.0, 0.1, nc)), bf=t(rng.standard_normal(d)),
                v=t(rng.standard_normal(n)), w=t(rng.standard_normal((n, d))))


def kernel_calls(k, x, rows):
    """Every member of the sharded kernels' surface on the inputs ``x``
    (``rows``: the node rows a node input takes), by name."""
    c, cp, u = rows(x["c"]), rows(x["cp"]), rows(x["u"])
    out = {
        "rd_residual": k.rd_residual(c, cp, x["D"], x["rho"], 0.7, source=x["src"]),
        "elasticity_residual": k.elasticity_residual(u, c, x["mu"], x["lam"], 0.15,
                                                     body_force=x["bf"]),
        "rd_mass_stiffness_diag": k.rd_mass_stiffness_diag(x["D"], 0.0, 0.7),
        "elasticity_diag": k.elasticity_diag(x["mu"], x["lam"]),
        "mass_residual": k.mass_residual(c),
        "mass_vector_residual": k.mass_vector_residual(u),
        # P1Kernels has the per-cell integrals: their sum
        "integrate_p1": (k.integrate_p1(c) if hasattr(k, "integrate_p1")
                         else k.cell_integral(c).sum()),
    }
    if hasattr(k, "elasticity_diag_blocks"):
        B = k.elasticity_diag_blocks(x["mu"], x["lam"])
        # the padding nodes' blocks are zero: identity, as the model masks them
        unused = (B == 0).flatten(1).all(dim=1)
        Binv = k.block_jacobi_inverse_blocks(B, mask=unused[:, None].expand(-1, B.shape[1]))
        out.update(elasticity_diag_blocks=B, block_jacobi_inverse_blocks=Binv,
                   apply_block_jacobi=k.apply_block_jacobi(Binv, rows(x["w"])),
                   lumped_mass=k.lumped_mass())
    # forward-mode AD under no_grad through the collectives (the jvp lane)
    with torch.no_grad():
        out["jvp_rd"] = torch.func.jvp(
            lambda z: k.rd_residual(z, cp, x["D"], x["rho"], 0.7, source=x["src"]),
            (c,), (rows(x["v"]),))[1]
        out["jvp_el"] = torch.func.jvp(
            lambda z: k.elasticity_residual(z, c, x["mu"], x["lam"], 0.15),
            (u,), (rows(x["w"]),))[1]
        out["jvp_el_c"] = torch.func.jvp(
            lambda z: k.elasticity_residual(u, z, x["mu"], x["lam"], 0.15),
            (c,), (rows(x["v"]),))[1]
    return {key: val.detach().numpy() for key, val in out.items()}


def kernels_rank(mesh, seed):
    """One rank: every member of ``ShardedP1Kernels`` and of
    ``NodeShardedP1Kernels`` on :func:`morton_mesh` (the latter's node
    inputs and outputs this rank's rows), and the unsharded ``P1Kernels``
    on the whole inputs, from ``seed``; the rank's row range and its
    local sizes."""
    from glimslib_tpu_torch.ops.assembly import P1Kernels
    from glimslib_tpu_torch.parallel import NodeShardedP1Kernels, ShardedP1Kernels

    torch.set_num_threads(1)
    m = morton_mesh()
    x = random_inputs(m, seed)
    cells = ShardedP1Kernels(m, mesh)
    nodes = NodeShardedP1Kernels(m, mesh)
    whole = P1Kernels(m)
    return dict(
        cells=kernel_calls(cells, x, lambda a: a),
        nodes=kernel_calls(nodes, x, nodes.own),
        whole=kernel_calls(whole, x, lambda a: a),
        start=nodes.start, n_own=nodes.n_own, block_cells=len(cells.block_cells),
        local_cells=nodes._k.n_cells, method=cells.part.method,
        has_blocks=hasattr(cells, "elasticity_diag_blocks"))


def trajectory(sim, n_steps=N_STEPS):
    theta = sim.make_theta(sim.params.as_dict())
    return sim.build_simulate_fn(n_steps, 1.0)(theta, *sim.initial_state())


def targets(lattice=False, world=2):
    """conc_T2 and disp of the unsharded model's N_STEPS-step forward at
    its set-up parameters."""
    from glimslib_tpu_torch.optimize.adjoint import thresh

    u, c, ok, _ = trajectory(port_model(lattice, world))
    assert bool(ok.all())
    return {"conc_T2": thresh(c[-1], 0.12).numpy(), "disp": u[-1].numpy()}


def model_rank(mesh, mode, targets, lattice=False):
    """One rank: the model under ``use_sharding(mesh, mode)``, N_STEPS
    steps (the whole trajectory gathered under 'nodes'), the Newton and CG
    counts, the preconditioner state the lane builds, then
    ``InverseProblem.value_and_grad`` of type 2 at V0 on the whole
    ``targets`` with the forward inside it (``v0``: its trajectory,
    gathered under 'nodes', and its counts), and ``run()``'s solution
    (rank 0 writes no file here)."""
    from glimslib_tpu_torch.optimize.adjoint import InverseProblem, param_map_for_type
    from glimslib_tpu_torch.parallel import gather_rows

    torch.set_num_threads(1)
    sim = port_model(lattice, mesh.world)
    sim.use_sharding(mesh, mode=mode)
    u, c, ok, newton = trajectory(sim)
    rows = sim._node_rows
    if rows is not None:
        whole = lambda a: gather_rows(mesh, a.movedim(1, 0), rows.start,  # noqa: E731
                                      rows.n_total).movedim(0, 1)
        u, c = whole(u), whole(c)
    aug = sim._augment_theta_with_operators(sim.make_theta(sim.params.as_dict()))
    info = {k: [int(i) for i in v] for k, v in sim.solver_info.items()}
    names, update = param_map_for_type(2)
    ip = InverseProblem(sim, names, targets, update_fn=update, n_steps=N_STEPS, dt=1.0)
    J, g, (u_v, c_v, ok_v, newton_v) = value_and_grad_with_forward(ip, V0)
    if rows is not None:
        u_v, c_v = whole(u_v), whole(c_v)
    vg = {k: [int(i) for i in v] for k, v in sim.solver_info.items()}
    sol = sim.run(save_method=None)
    return dict(mode=sim.sharding_mode, kernels=type(sim.kernels).__name__,
                u=u.numpy(), c=c.numpy(), ok=bool(ok.all()), newton=newton.tolist(),
                rd_cg=info["rd_cg_iters"], el_cg=info["el_cg_iters"],
                aug=sorted(k for k in aug if k.startswith("_")), J=J, g=g,
                adj={k: vg[k] for k in ("rd_adj_cg_iters", "el_adj_cg_iters")},
                v0=dict(u=u_v.numpy(), c=c_v.numpy(), ok=bool(ok_v.all()),
                        newton=newton_v.tolist(), rd_cg=vg["rd_cg_iters"],
                        el_cg=vg["el_cg_iters"]),
                run_c=np.asarray(sol[1]), run_u=np.asarray(sol[0]),
                matrix_free=sim.matrix_free)
