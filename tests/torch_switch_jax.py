"""The JAX package's side of tests/test_torch_ell_lane.py and
tests/test_torch_switches.py: its models of tests/torch_switch_cases.py
and their runs, with the CG iterations of every solve."""

import numpy as np
import jax
import jax.numpy as jnp

import torch_switch_cases as cases
from __graft_entry__ import _brain_sim
from glimslib_tpu.core.mesh import Mesh as JaxMesh
from glimslib_tpu.core.mesh import box_mesh as jax_box_mesh
from glimslib_tpu.optimize.adjoint import param_map_for_type
from glimslib_tpu.solvers import coupled as jax_coupled
from glimslib_tpu.solvers.coupled import StepConfig as JaxStepConfig
from torch_jax_vg import value_and_grad_with_forward


def rel(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


def box_brain(n=4, quad=False, dtype=jnp.float64, tight=True):
    """cases.box_brain in the JAX package (``tight``: the TIGHT step, else
    the model's default)."""
    sim = _brain_sim(n=n, dims=3, dtype=dtype, quad=quad,
                     mesh_transform=lambda m: JaxMesh.from_arrays(
                         m.points, m.cells).reordered_morton())
    if tight:
        sim.step_config = JaxStepConfig(**cases.TIGHT)
    return sim


def ell_brain(n=6):
    """tests/test_ell.py's unstructured brain with the TIGHT step."""
    from glimslib_tpu.models.tumor_growth_brain import TumorGrowthBrain

    m0 = jax_box_mesh((0, 0, 0), (8, 8, 8), n, n, n)
    mesh = JaxMesh.from_arrays(m0.points, m0.cells).reordered_rcm()
    r = np.linalg.norm((mesh.points - 4.0) / 4.0, axis=1)
    labels = np.zeros(mesh.n_nodes)
    labels[r < 0.95] = 1
    labels[r < 0.8] = 2
    labels[r < 0.6] = 3
    labels[r < 0.2] = 4
    sim = TumorGrowthBrain(mesh, dtype=jnp.float64)
    sim.setup_global_parameters(
        label_function=labels,
        domain_names={0: "outside", 1: "CSF", 2: "GM", 3: "WM", 4: "Ventricles"},
        boundaries={"boundary_all": cases._Boundary()},
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
    sim.step_config = JaxStepConfig(**cases.TIGHT)
    return sim


def jax_run(sim, monkeypatch):
    """The JAX package's trajectory (its runtime_aux passed, initial values
    clamped as its run() does) with the CG iterations of its solves by
    block, sorted."""
    rec = []
    pcg = jax_coupled.pcg

    def counted(A, b, **kw):
        x, info = pcg(A, b, **kw)
        jax.debug.callback(lambda it, nd=b.ndim: rec.append((nd, int(it))), info["iters"])
        return x, info

    with monkeypatch.context() as m:
        m.setattr(jax_coupled, "pcg", counted)
        theta = sim.make_theta(sim.params.as_dict())
        iv = sim.params.create_initial_value_function()
        mask_u, mask_c, gu, gc = sim._bc_masks_and_values()
        u0 = jnp.where(mask_u, gu(0.0), jnp.asarray(iv[0]))
        c0 = jnp.where(mask_c, gc(0.0), jnp.asarray(iv[1]))
        aux = sim.runtime_aux()
        u, c, ok, newton = sim.build_simulate_fn(cases.N_STEPS, 1.0)(
            theta, u0, c0, aux or None)
        c = np.asarray(jax.block_until_ready(c))
        counts = {"rd": sorted(i for nd, i in rec if nd == 1),
                  "el": sorted(i for nd, i in rec if nd == 2)}
    assert bool(np.asarray(ok).all())
    return dict(u=np.asarray(u), c=c, newton=np.asarray(newton).tolist(), counts=counts,
                aux=sorted(aux))


def jax_vg(sim, monkeypatch, targets):
    """The JAX package's value_and_grad of type 2 at V0 on ``targets`` with
    the forward inside it and its frozen state's keys
    (tests/torch_jax_vg.py: one jitted program)."""
    names, update = param_map_for_type(2)
    out = value_and_grad_with_forward(sim, names, update, targets, cases.V0,
                                      cases.N_STEPS, monkeypatch)
    assert out["ok"]
    return out


def within_one(got, want):
    return (len(got) == len(want)
            and all(abs(a - b) <= 1 for a, b in zip(got, want))), (got, want)


def check_forward(out, want):
    """States within rel 1e-8, Newton counts equal, every CG count within
    one."""
    assert out["ok"] and out["newton"] == want["newton"], (out["newton"], want["newton"])
    assert rel(out["c"], want["c"]) <= 1e-8, rel(out["c"], want["c"])
    assert rel(out["u"], want["u"]) <= 1e-8, rel(out["u"], want["u"])
    for blk in ("rd", "el"):
        ok, why = within_one(out["counts"][blk], want["counts"][blk])
        assert ok, (blk, why)


def wire_rd_precond(sim, monkeypatch):
    """The JAX package's supernode lane builds ``rd_precond`` (supernode
    block-Jacobi, glimslib_tpu/models/base.py:1639-1681) and never hands
    it to ``make_step`` (:1693-1711), so its rd solves take Jacobi on
    ``rd_diag``; the port's take that preconditioner.  Hand it over, as
    written there (tests/test_torch_chebyshev.py), for CG counts to
    compare."""
    from glimslib_tpu.models import base as jax_base
    from glimslib_tpu.ops import bell as jax_bell

    quad = getattr(sim, "CONCENTRATION_DEGREE", 1) == 2
    plan = sim._get_p2_plan() if quad else sim._get_bell_plan()
    key = "_McSNP2" if quad else "_McSN"

    def rd_precond(theta):
        if isinstance(theta, dict) and key in theta:
            Minv = theta[key]
            return lambda r: jax_bell.apply_supernode_jacobi(plan, Minv, r)
        diag = sim.rd_diag(theta)
        return lambda r: r / diag

    make_step = jax_base.make_step
    monkeypatch.setattr(jax_base, "make_step",
                        lambda **kw: make_step(**kw, rd_precond=rd_precond))
