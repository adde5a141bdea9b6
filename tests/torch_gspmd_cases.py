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
    for TIGHT, "default" for the dtype's default step)}."""
    from glimslib_tpu_torch.core.mesh import box_mesh, pad_mesh_nodes, rectangle_mesh
    from glimslib_tpu_torch.examples import brain_sim, rect_sim
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
    if spec.get("config", "tight") == "tight":
        sim.step_config = StepConfig(**TIGHT)
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
