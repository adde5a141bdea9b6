"""The port's side of tests/test_torch_shard.py, importable without JAX:
the ranks that ``run_ranks`` spawns import this module, not the test.

``port_sim`` builds the inputs of tests/test_bellshard.py (``_sim``,
``_sim_quad``: the Morton n=6 box, its radial tissue labels, the clamped
boundary and the parameters) in glimslib_tpu_torch at f64 on the CPU;
the ``*_rank`` functions are what each rank runs, and return numpy arrays
and plain values."""

import numpy as np
import torch

from glimslib_tpu_torch.core.mesh import Mesh, box_mesh

N_STEPS = 2
# tables on the supernode-block axis (ops/bell.py SlabPlan), by the axis
# that holds the blocks; the two-level arrays on the axis of the
# aggregates' rows (solvers/twolevel.py coarse_slab)
BLOCK_AXIS = {"_BellWel": 0, "_BellCuc": 0, "_BellWrdC": 0, "_BellMrd": 0,
              "_BinvSN": 0, "_McSN": 0, "_FWel": 1, "_FCuc": 1, "_FWrd": 1,
              "_FMrd": 0, "_P2BWrdC": 0, "_McSNP2": 0, "_FP2Wrd": 1}
ROW_AXIS = {"_TLCfac": 0, "_TLCfacS": 0, "_TLMt": 0, "_TLMtS": 0}


class _Boundary:
    def inside(self, x, on_boundary):
        return on_boundary


def morton_box(n=6):
    m = box_mesh((0, 0, 0), (10, 10, 10), n, n, n)
    return Mesh.from_arrays(m.points, m.cells).reordered_morton()


def port_sim(quad=False, mesh=None):
    """tests/test_bellshard.py ``_sim`` (``_sim_quad`` with ``quad``) in
    the port, at f64 on the CPU, on ``mesh`` (default a new Morton box)."""
    if quad:
        from glimslib_tpu_torch.models.tumor_growth_brain_quad import TumorGrowthBrain
    else:
        from glimslib_tpu_torch.models.tumor_growth_brain import TumorGrowthBrain
    mesh = morton_box() if mesh is None else mesh
    r = np.linalg.norm((mesh.points - 5.0) / 5.0, axis=1)
    labels = np.zeros(mesh.n_nodes)
    labels[r < 0.95] = 1
    labels[r < 0.80] = 2
    labels[r < 0.62] = 3
    labels[r < 0.20] = 4
    sim = TumorGrowthBrain(mesh, dtype=torch.float64, device="cpu")
    sim.setup_global_parameters(
        label_function=labels,
        domain_names={0: "outside", 1: "CSF", 2: "GM", 3: "WM", 4: "Ventricles"},
        boundaries={"boundary_all": _Boundary()},
        dirichlet_bcs={"clamped": {"bc_value": np.zeros(3),
                                   "named_boundary": "boundary_all",
                                   "subspace_id": 0}},
    )
    center = np.full(3, 5.0)
    center[0] += 1.0
    sim.setup_model_parameters(
        iv_expression={0: np.zeros(3),
                       1: lambda x: np.exp(-((x - center) ** 2).sum(axis=1) / 0.5)},
        E_GM=3e3, E_WM=3e3, E_CSF=1e3, E_VENT=1e3,
        nu_GM=0.45, nu_WM=0.45, nu_CSF=0.45, nu_VENT=0.3,
        D_GM=0.02, D_WM=0.1, rho_GM=0.02, rho_WM=0.1, coupling=0.15,
        sim_time=2, sim_time_step=1,
    )
    return sim


def _run(sim):
    theta = sim.make_theta(sim.params.as_dict())
    u, c, ok, newton = sim.build_simulate_fn(N_STEPS, 1.0)(theta, *sim.initial_state())
    return u.numpy(), c.numpy(), ok.numpy(), newton.numpy()


def _tables(sim):
    """Every table of the model's frozen state and of its theta planes."""
    theta = sim.make_theta(sim.params.as_dict())
    aux = sim.runtime_aux()
    return sim._augment_theta_with_operators({**theta, **aux})


def _same_on_every_rank(mesh, t):
    """Rank 0's ``t`` broadcast and compared bit for bit on every rank; True
    on every rank when they all hold the same bits."""
    got = mesh.broadcast(t.detach().clone(), 0)
    ok = torch.tensor([float(torch.equal(got, t))], dtype=torch.float64)
    return bool(mesh.all_reduce(ok).item() == mesh.world)


def forward_rank(mesh, quad):
    """One rank: an unsharded model and a sharded one on the same mesh
    object (the first caches the mesh's plans, the second shards them),
    each run N_STEPS; the sharded tables' shapes beside the unsharded
    ones, their bytes, the slab's block ranges, whether the mesh's plans
    stayed whole, and the coarse factors' agreement across ranks."""
    from glimslib_tpu_torch.ops import bell

    torch.set_num_threads(1)
    whole = port_sim(quad)
    sim = port_sim(quad, mesh=whole.mesh)
    whole_tables = _tables(whole)
    sim.use_sharding(mesh)
    out = dict(mode=sim.sharding_mode, sharded=_run(sim), whole=_run(whole))
    tables = _tables(sim)
    keys = sorted(k for k in set(BLOCK_AXIS) | set(ROW_AXIS) if k in tables)
    out["shapes"] = {k: (tuple(tables[k].shape), tuple(whole_tables[k].shape))
                     for k in keys}
    out["bytes"] = (sum(tables[k].numel() * tables[k].element_size() for k in keys),
                    sum(whole_tables[k].numel() * whole_tables[k].element_size()
                        for k in keys))
    plans = [(sim._get_bell_plan(), whole._get_bell_plan())]
    if quad:
        plans.append((sim._get_p2_plan(), whole._get_p2_plan()))
    out["slabs"] = [dict(slab=isinstance(s, bell.SlabPlan), b0=s.b0, b1=s.b1, nb=s.nb,
                         nb_total=s.nb_total, base_is_whole=s.base is w,
                         whole_is_plan=type(w) is bell.BellPlan and w.mesh is None,
                         ext=torch.equal(s.ext_idx, w.ext_idx[s.b0:s.b1]),
                         place=np.array_equal(s.place, w.place[s.b0 * s.s * s.Kh:
                                                               s.b1 * s.s * s.Kh]))
                    for s, w in plans]
    # the mesh's plans (supernode plans, and the node-adjacency plan of the
    # coarse build) stay whole: no slab among them
    cached = list(whole.mesh._plan_cache.values())
    out["mesh_plans_whole"] = (any(type(p) is bell.BellPlan for p in cached)
                               and not any(isinstance(p, bell.SlabPlan) for p in cached))
    # the coarse factors: built whole on every rank (bit-equal across the
    # ranks), kept as the rank's rows
    aux_w, aux_s = whole.runtime_aux(), sim.runtime_aux()
    coarse = {}
    for k in ("_TLCfac", "_TLCfacS", "_TLMt", "_TLMtS"):
        if k in aux_w:
            slab = sim._coarse_slab()
            per = aux_s[k].shape[0] // (slab.a1 - slab.a0)
            rows = aux_w[k][slab.a0 * per:slab.a1 * per]
            coarse[k] = (_same_on_every_rank(mesh, aux_w[k]), torch.equal(aux_s[k], rows))
    out["coarse"] = coarse
    return out


def p2stream_rank(mesh):
    """One rank, with GLIMS_P2STREAM=1 in the environment: the quad model
    unsharded and sharded on the same mesh, N_STEPS each; whether the
    sharded theta carries the streamed planes as the rank's slab (the
    mass plane's blocks against the whole one's) and the constant load."""
    torch.set_num_threads(1)
    whole = port_sim(True)
    sim = port_sim(True, mesh=whole.mesh)
    whole_tables = _tables(whole)
    sim.use_sharding(mesh)
    tables = _tables(sim)
    return dict(sharded=_run(sim), whole=_run(whole), p2_sharded=sim._p2_sharded,
                mass=(tuple(tables["_P2BMrd"].shape), tuple(whole_tables["_P2BMrd"].shape)),
                load="_P2B_rd_load" in tables and "_P2B_rd_load" in whole_tables)


def grad_rank(mesh, quad, targets, v0):
    """One rank: value_and_grad of type 2 (D_WM, rho_WM) on the sharded
    model at ``v0`` with ``targets``; J and the gradient, and whether every
    rank holds the same bits of both."""
    from glimslib_tpu_torch.optimize.adjoint import InverseProblem, param_map_for_type

    torch.set_num_threads(1)
    sim = port_sim(quad)
    sim.use_sharding(mesh)
    names, update = param_map_for_type(2)
    ip = InverseProblem(sim, names, targets, update_fn=update, n_steps=N_STEPS, dt=1.0)
    J, g = ip.value_and_grad(np.asarray(v0))
    Jg = torch.tensor([J, *g.tolist()], dtype=torch.float64)
    return dict(mode=sim.sharding_mode, J=J, g=g, same=_same_on_every_rank(mesh, Jg))


def bmv_rank(mesh, shapes, seed):
    """One rank on the card: at each (B, M, K) of ``shapes``, the sharded
    bmv (the rank's slab of a table and a vector that every rank draws
    whole from ``seed``, ``bell_bmv`` on it, the slabs' rows gathered)
    against the plain contraction of the whole; per shape the max rel
    error, the launches, the slab's shape and its launch plan's mode."""
    from glimslib_tpu_torch.ops import bell_kernels as bk
    from glimslib_tpu_torch.parallel import gather_rows

    out = []
    for B, M, K in shapes:
        gen = torch.Generator(device=mesh.device).manual_seed(seed)
        A = torch.randn((B, M, K), generator=gen, device=mesh.device)
        x = torch.randn((B, K), generator=gen, device=mesh.device)
        nbl = B // mesh.world
        b0 = mesh.rank * nbl
        A_s, x_s = A[b0:b0 + nbl].contiguous(), x[b0:b0 + nbl].contiguous()
        bk.batched_matvec.launches = 0
        y = gather_rows(mesh, bk.batched_matvec(A_s, x_s), b0, B)
        want = bk.batched_matvec_plain(A, x)
        out.append(dict(rel=float((y - want).abs().max() / want.abs().max()),
                        launches=bk.batched_matvec.launches, slab=tuple(A_s.shape),
                        mode=bk.plan_for(A_s).mode))
    return out
