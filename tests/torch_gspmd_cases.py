"""The port's side of tests/test_torch_gspmd.py, importable without JAX:
the ranks that ``run_ranks`` spawns import this module, not the test.

``port_model`` builds the inputs of tests/test_gspmd.py (``_brain(n)``:
the n x n x n brain box of ``__graft_entry__._brain_sim``, padded with
``pad_mesh_nodes`` where ``pad_to`` is given) or of the 2D subdomains
rectangle (``examples.rect_sim``) in glimslib_tpu_torch on the CPU; the
``*_rank`` functions are what each rank runs, and return numpy arrays
and plain values."""

import os

import numpy as np
import torch

N_STEPS = 2
TIGHT = dict(newton_rtol=1e-10, newton_atol=1e-14, cg_rtol=1e-12)


def port_model(spec):
    """The port's model of ``spec``: {"kind": "brain" | "rect", "n", and
    optionally "pad_to", "dtype" ("float64" default), "config" ("tight"
    for TIGHT, "default" for the dtype's default step, "refined" for
    ``examples.REFINED_STEP_CONFIG``)}."""
    from glimslib_tpu_torch.core.mesh import box_mesh, pad_mesh_nodes, rectangle_mesh
    from glimslib_tpu_torch.examples import REFINED_STEP_CONFIG, brain_sim, rect_sim
    from glimslib_tpu_torch.solvers.coupled import StepConfig

    n, pad_to = spec["n"], spec.get("pad_to")
    dtype = getattr(torch, spec.get("dtype", "float64"))
    if spec["kind"] == "brain":
        mesh = box_mesh((0, 0, 0), (10, 10, 10), n, n, n)
        sim = brain_sim(dtype=dtype, device="cpu",
                        mesh=pad_mesh_nodes(mesh, pad_to) if pad_to else mesh)
    else:
        mesh = rectangle_mesh((-5, -5), (5, 5), n, n)
        sim = rect_sim(n, subdomains=True, dtype=dtype, device="cpu",
                       mesh=pad_mesh_nodes(mesh, pad_to) if pad_to else mesh)
    config = spec.get("config", "tight")
    if config == "tight":
        sim.step_config = StepConfig(**TIGHT)
    elif config == "refined":
        sim.step_config = REFINED_STEP_CONFIG
    return sim


def _trajectory(sim):
    theta = sim.make_theta(sim.params.as_dict())
    u0, c0 = sim.initial_state()
    u, c, ok, newton = sim.build_simulate_fn(N_STEPS, 1.0)(theta, u0, c0)
    return theta, (u0, c0), (u, c, ok, newton)


def forward_rank(mesh, spec, mode="auto"):
    """One rank: the model of ``spec`` under ``use_sharding(mesh, mode)``,
    N_STEPS steps; the whole trajectory (gathered), the Newton and CG
    counts, the rows of every plane and state tensor this rank holds, the
    slab and the planes' bytes."""
    from glimslib_tpu_torch.parallel import gather_nodes

    torch.set_num_threads(1)
    sim = port_model(spec)
    sim.use_sharding(mesh, mode=mode)
    slab = sim._node_slab
    theta, (u0, c0), (u, c, ok, newton) = _trajectory(sim)
    aug = sim._augment_theta_with_operators(theta)
    planes = {k: tuple(v.shape) for k, v in aug.items()
              if k.startswith("_") and torch.is_tensor(v)}
    whole = lambda x: gather_nodes(mesh, slab, x.movedim(1, 0)).movedim(0, 1)  # noqa: E731
    info = sim.solver_info
    return dict(
        mode=sim.sharding_mode, world=mesh.world, rank=mesh.rank,
        u=whole(u).numpy(), c=whole(c).numpy(), ok=ok.numpy(), newton=newton.numpy(),
        rd_cg=[int(i) for i in info["rd_cg_iters"]],
        el_cg=[int(i) for i in info["el_cg_iters"]],
        n_total=slab.n_total, n_own=slab.n_own, start=slab.start, halo=slab.halo,
        planes=planes,
        plane_bytes=sum(v.numel() * v.element_size() for k, v in aug.items()
                        if k in planes),
        state=[tuple(t.shape) for t in (u0, c0)] + [tuple(u.shape), tuple(c.shape)],
        mask_rows=[tuple(m.shape) for m in sim._bc_masks_and_values()[:2]],
    )


def run_rank(mesh, spec, out_root):
    """One rank: ``run()`` of the model of ``spec`` under use_sharding()
    (auto) into ``out_root/rank<r>`` with VTU output; the mode, the
    solution and the files this rank wrote."""
    torch.set_num_threads(1)
    sim = port_model(spec)
    sim.use_sharding(mesh)
    out = os.path.join(out_root, f"rank{mesh.rank}")
    sol = sim.run(save_method="vtk", output_dir=out)
    files = sorted(os.listdir(out)) if os.path.isdir(out) else []
    return dict(mode=sim.sharding_mode, u=sol[0], c=sol[1], files=files,
                newton=np.asarray(sim.solver_info["newton_iters"]))


def card_rank(mesh, n, pad_to, n_steps):
    """One rank on the card: the n-box (padded to ``pad_to``) at f32 with
    the benchmark's StepConfig under use_sharding() (auto: 'nodes'),
    ``n_steps`` steps with every stencil wrapper's count at 0 just before;
    the gathered final c and u, the counts, Newton and CG counts."""
    from glimslib_tpu_torch.core.mesh import box_mesh, pad_mesh_nodes
    from glimslib_tpu_torch.examples import BENCH_STEP_CONFIG, brain_sim
    from glimslib_tpu_torch.ops import fused_cg as fc
    from glimslib_tpu_torch.ops import stencil_kernels as sk
    from glimslib_tpu_torch.parallel import gather_nodes

    mesh_ = pad_mesh_nodes(box_mesh((0, 0, 0), (10, 10, 10), n, n, n), pad_to)
    sim = brain_sim(dtype=torch.float32, device=mesh.device, mesh=mesh_)
    sim.step_config = BENCH_STEP_CONFIG
    sim.use_sharding(mesh)
    theta = sim.make_theta(sim.params.as_dict())
    simulate = sim.build_simulate_fn(n_steps, 1.0)
    wrappers = (sk.apply_scalar, sk.apply_scalar_sum, sk.apply_vector, sk.apply_coupling,
                fc.cg_scalar, fc.cg_vector)
    for w in wrappers:
        w.launches = 0
    u, c, ok, newton = simulate(theta, *sim.initial_state())
    torch.cuda.synchronize()
    launches = {w.__name__: w.launches for w in wrappers}
    slab = sim._node_slab
    return dict(mode=sim.sharding_mode, ok=ok.cpu().numpy(), newton=newton.numpy(),
                el_cg=[int(i) for i in sim.solver_info["el_cg_iters"]],
                launches=launches, n_total=slab.n_total,
                u=gather_nodes(mesh, slab, u[-1]).cpu().numpy(),
                c=gather_nodes(mesh, slab, c[-1]).cpu().numpy())


# -- the adjoint (tests/test_torch_gspmd_adjoint.py) ---------------------------


def _param_map(spec, opt_type):
    from glimslib_tpu_torch.optimize.adjoint import param_map_for_type, tumor_growth_param_map

    return (param_map_for_type(opt_type) if spec["kind"] == "brain"
            else tumor_growth_param_map(opt_type))


def grad_rank(mesh, spec, opt_type, targets, v0, graph=None, maxiter=0):
    """One rank: ``InverseProblem.value_and_grad`` of ``opt_type`` (the
    brain models' ``param_map_for_type``, the rectangle's
    ``tumor_growth_param_map``) on the model of ``spec`` under
    use_sharding(mesh, 'nodes'), N_STEPS steps, on the whole ``targets``;
    J, the gradient, the solver counts (forward and adjoint), the rows of
    the targets the problem holds, and the concentration mass action of
    ones on this rank's rows (zero on padding rows).  ``graph``: a path
    for ``export_computation_graph`` (every rank calls it; ``{rank}`` in
    it is the rank); ``maxiter`` > 0: then ``minimize`` from v0 with that
    many L-BFGS-B iterations (its x and nit)."""
    from glimslib_tpu_torch.optimize.adjoint import InverseProblem

    torch.set_num_threads(1)
    sim = port_model(spec)
    sim.use_sharding(mesh, mode="nodes")
    names, update = _param_map(spec, opt_type)
    ip = InverseProblem(sim, names, targets, update_fn=update, n_steps=N_STEPS, dt=1.0)
    J, g = ip.value_and_grad(np.asarray(v0))
    counts = {k: [int(i) for i in v] for k, v in sim.solver_info.items()}
    slab = sim._node_slab
    ones = torch.ones(slab.n_own, dtype=sim.dtype)
    if graph is not None:
        ip.export_computation_graph(graph.format(rank=mesh.rank), v0)
    x_opt = nit = None
    if maxiter:
        x_opt, _, res = ip.minimize(np.asarray(v0), opt_params={"maxiter": maxiter})
        nit = int(res.nit)
    return dict(mode=sim.sharding_mode, rank=mesh.rank, J=J, g=g, counts=counts,
                x_opt=x_opt, nit=nit,
                start=slab.start, n_own=slab.n_own,
                target_rows={k: tuple(v.shape) for k, v in ip.targets.items()},
                mass_ones=sim.concentration_mass_action(ones).numpy())


def objective_rank(mesh, spec, opt_type, targets, v0, n_steps, mode="nodes"):
    """One rank: the model of ``spec`` under use_sharding(mesh, mode) (or
    unsharded with ``mode`` None), ``InverseProblem.objective`` of
    ``opt_type`` at ``v0`` over ``n_steps`` steps on the whole
    ``targets``, and the Newton iterations a step of the forward at v0."""
    from glimslib_tpu_torch.optimize.adjoint import InverseProblem

    torch.set_num_threads(1)
    sim = port_model(spec)
    if mode is not None:
        sim.use_sharding(mesh, mode=mode)
    names, update = _param_map(spec, opt_type)
    ip = InverseProblem(sim, names, targets, update_fn=update, n_steps=n_steps, dt=1.0)
    J = float(ip.objective(np.asarray(v0)))
    p = {**sim.params.as_dict(), **update(torch.as_tensor(np.asarray(v0), dtype=sim.dtype))}
    _, _, ok, newton = sim.build_simulate_fn(n_steps, 1.0)(sim.make_theta(p),
                                                           *sim.initial_state())
    return dict(J=J, newton=newton.tolist(), ok=bool(ok.all()), mode=sim.sharding_mode)


def exchange_rank(mesh, spec, seed):
    """One rank: the dot-product test of the differentiable halo exchange,
    X and its transpose X^T (autograd of the exchange), on random x (the
    rank's rows) and y (its padded rows) from ``seed`` and the rank; for
    ``halo_exchange`` of (n_own, 3) and ``halo_exchange_many`` of an
    (n_own,) and an (n_own, 2) vector: sum over the ranks of <X x, y> and
    of <x, X^T y>."""
    from glimslib_tpu_torch.parallel import halo_exchange, halo_exchange_many

    torch.set_num_threads(1)
    sim = port_model(spec)
    sim.use_sharding(mesh, mode="nodes")
    slab = sim._node_slab
    rng = np.random.default_rng(seed + 1000 * mesh.rank)
    t = lambda *s: torch.as_tensor(rng.standard_normal(s))  # noqa: E731
    x, y = t(slab.n_own, 3).requires_grad_(), t(slab.n_pad, 3)
    a, b = t(slab.n_own).requires_grad_(), t(slab.n_own, 2).requires_grad_()
    ya, yb = t(slab.n_pad), t(slab.n_pad, 2)
    lhs = (halo_exchange(mesh, slab, x) * y).sum()
    (gx,) = torch.autograd.grad(lhs, x)
    pa, pb = halo_exchange_many(mesh, slab, a, b)
    lhs_many = (pa * ya).sum() + (pb * yb).sum()
    ga, gb = torch.autograd.grad(lhs_many, [a, b])
    local = torch.stack([lhs, (x * gx).sum(), lhs_many, (a * ga).sum() + (b * gb).sum()])
    return dict(sums=mesh.all_reduce(local.detach()).numpy(), halo=slab.halo,
                n_own=slab.n_own)


def plane_cotangent(sim, seed):
    """The cotangents of theta's per-cell D, rho and mu through the
    planes (``_Wrd_const``, ``_Wel``, ``_Cuc``) and loads of the model,
    under a fixed random cotangent of every plane (drawn from ``seed``
    over the whole mesh's rows; a node-sharded model takes its rows)."""
    sim._build_step()  # the stencil operators
    theta = sim.make_theta(sim.params.as_dict())
    keys = ("D", "rho", "mu")
    for k in keys:
        theta[k] = theta[k].detach().clone().requires_grad_()
    aug = sim._augment_theta_with_operators(theta)
    slab, n = sim._node_slab, sim.mesh.n_nodes
    rng = np.random.default_rng(seed)
    loss = 0.0
    for k in ("_Wrd_const", "_Wel", "_Cuc", "_rd_load", "_el_load"):
        P = aug[k]
        node_axis = -1 if k.startswith("_W") or k == "_Cuc" else 0
        shape = list(P.shape)
        shape[node_axis] = n
        G = torch.as_tensor(rng.standard_normal(shape), dtype=P.dtype)
        if slab is not None:
            G = G.narrow(node_axis % P.dim(), slab.start, slab.n_own)
        loss = loss + (P * G).sum()
    return {k: g.numpy() for k, g in zip(keys, torch.autograd.grad(loss, [theta[k]
                                                                        for k in keys]))}


def plane_vjp_rank(mesh, spec, seed):
    """One rank: :func:`plane_cotangent` on the 'nodes' model (the
    cotangent each rank's planes give theta's coefficients, summed over
    the ranks once by ``shard.enter``), the rank's cells and its plane
    widths."""
    torch.set_num_threads(1)
    sim = port_model(spec)
    sim.use_sharding(mesh, mode="nodes")
    return dict(grads=plane_cotangent(sim, seed), cell_ids=sim._node_slab.cell_ids,
                n_own=sim._node_slab.n_own)


def run_adjoint_functional(sim, params, seed):
    """F = sum w_c c + sum w_u |u|^2 of the solution of
    ``run_for_adjoint_2params(params)`` (params as tensors that require
    grad), weights from ``seed`` over the whole mesh; (F, dF/dparams)."""
    import tempfile

    p = torch.tensor(np.asarray(params, np.float64), dtype=sim.dtype, requires_grad=True)
    with tempfile.TemporaryDirectory() as tmp:
        sol = sim.run_for_adjoint_2params([p[0], p[1]], output_dir=tmp)
    u, c = sol[0], sol[1]
    rng = np.random.default_rng(seed)
    w_c = torch.as_tensor(rng.standard_normal(c.shape), dtype=c.dtype)
    w_u = torch.as_tensor(rng.standard_normal(u.shape[:1]), dtype=u.dtype)
    F = (w_c * c).sum() + (w_u[:, None] * u * u).sum()
    (g,) = torch.autograd.grad(F, p)
    return float(F.detach()), g.numpy()


def run_adjoint_rank(mesh, spec, params, seed):
    """One rank: :func:`run_adjoint_functional` on the 'nodes' model (the
    solution gathered by ``run()``, differentiably)."""
    torch.set_num_threads(1)
    sim = port_model(spec)
    sim.use_sharding(mesh, mode="nodes")
    F, g = run_adjoint_functional(sim, params, seed)
    return dict(F=F, g=g, mode=sim.sharding_mode)


def card_grad_rank(mesh, n, pad_to, targets, v0):
    """One rank on the card: the n-box padded to ``pad_to`` at f32 with
    the default step (refine_f64) under use_sharding() (auto: 'nodes'),
    value_and_grad of type 2 on the whole ``targets`` over N_STEPS steps,
    with every stencil wrapper's count at 0 just before and read between
    the forward and the backward; J, the gradient, the launches by
    direction and the adjoint CG counts."""
    from glimslib_tpu_torch.core.mesh import box_mesh, pad_mesh_nodes
    from glimslib_tpu_torch.examples import brain_sim
    from glimslib_tpu_torch.ops import fused_cg as fc
    from glimslib_tpu_torch.ops import stencil_kernels as sk
    from glimslib_tpu_torch.optimize.adjoint import InverseProblem, param_map_for_type

    mesh_ = pad_mesh_nodes(box_mesh((0, 0, 0), (10, 10, 10), n, n, n), pad_to)
    sim = brain_sim(dtype=torch.float32, device=mesh.device, mesh=mesh_)
    sim.use_sharding(mesh)
    names, update = param_map_for_type(2)
    ip = InverseProblem(sim, names, targets, update_fn=update, n_steps=N_STEPS, dt=1.0)
    wrappers = (sk.apply_scalar, sk.apply_scalar_sum, sk.apply_vector, sk.apply_coupling,
                fc.cg_scalar, fc.cg_vector)
    for w in wrappers:
        w.launches = 0
    vt = ip._param(np.asarray(v0), True)
    with torch.enable_grad():
        J = ip._objective(vt)
    fwd = {w.__name__: w.launches for w in wrappers}
    (g,) = torch.autograd.grad(J, vt)
    torch.cuda.synchronize()
    bwd = {w.__name__: w.launches - fwd[w.__name__] for w in wrappers}
    return dict(mode=sim.sharding_mode, J=float(J.detach()), g=g.cpu().numpy(),
                forward=fwd, backward=bwd,
                adj=[[int(i) for i in sim.solver_info[k]]
                     for k in ("rd_adj_cg_iters", "el_adj_cg_iters")])
