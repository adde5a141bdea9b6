"""Port parity of the factored frozen assembly
(``glimslib_tpu_torch/ops/bell_factored.py``), mirroring the JAX
package's ``tests/test_factored.py`` on the n=6 Morton brain box at f64.

The planes reduced from the per-class channel stacks equal the dense
``assemble_fused`` planes to re-association round-off (1e-13 of their
scale); trajectories (atol 1e-11), J (rtol 1e-10) and the gradient (rtol
1e-7) equal the dense path's; the channel stacks and the planes reduced
from them equal the JAX package's (1e-12), also when the JAX package's
own stacks are carried across with ``convert.aux_from_numpy``.
"""

import os
import sys

import numpy as np
import pytest
import jax.numpy as jnp
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from __graft_entry__ import _brain_sim as jax_brain_sim  # noqa: E402
from glimslib_tpu.core.mesh import Mesh as JaxMesh  # noqa: E402
from glimslib_tpu.ops import bell_factored as jax_bell_factored  # noqa: E402
from glimslib_tpu_torch import convert  # noqa: E402
from glimslib_tpu_torch.core.mesh import Mesh, box_mesh  # noqa: E402
from glimslib_tpu_torch.examples import brain_sim  # noqa: E402
from glimslib_tpu_torch.models.tumor_growth import TumorGrowth  # noqa: E402
from glimslib_tpu_torch.ops import bell_factored  # noqa: E402
from glimslib_tpu_torch.optimize.adjoint import (  # noqa: E402
    InverseProblem, param_map_for_type, thresh,
)
from torch_threads import one_torch_thread  # noqa: E402,F401

PLANES = ("_BellWel", "_BellCuc", "_BellWrdC", "_BellMrd")
STACKS = ("_FWel", "_FCuc", "_FWrd", "_FMrd")


def _sim():
    return brain_sim(n=6, dtype=torch.float64, device="cpu", unstructured=True)


def _augmented(sim):
    theta = sim.make_theta(sim.params.as_dict())
    return sim._augment_theta_with_operators({**theta, **sim.runtime_aux()})


def _max_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _dense_aux(sim):
    """The model's aux without the channel stacks: the planes are then
    assembled from the cells (``bell.assemble_fused``)."""
    return {k: v for k, v in sim.runtime_aux().items() if not k.startswith("_F")}


def test_factored_planes_match_dense():
    """The reduced planes equal the dense ones to 1e-13 of their scale."""
    sim = _sim()
    assert sim.theta_class_labels() is not None
    aux = sim.runtime_aux()
    assert all(k in aux for k in ("_FWel", "_FCuc", "_FWrd", "_FMrd", "_FReps"))
    fac = _augmented(sim)
    dense = sim._augment_theta_with_operators(
        {**sim.make_theta(sim.params.as_dict()), **_dense_aux(sim)})
    for key in PLANES:
        assert fac[key].shape == dense[key].shape, key
        assert _max_rel(fac[key], dense[key]) <= 1e-13, key


def test_factored_trajectory_and_gradient_match_dense():
    """2 steps and one value_and_grad (type 2) both ways: states to atol
    1e-11, J to rtol 1e-10, the gradient to rtol 1e-7."""
    def run_with(factored):
        sim = _sim()
        if not factored:
            sim._aux_cache = _dense_aux(sim)
        assert ("_FWel" in sim.runtime_aux()) == factored
        u_tr, c_tr, ok, _ = sim.build_simulate_fn(2, 1.0)(
            sim.make_theta(sim.params.as_dict()), *sim.initial_state())
        assert bool(ok.all())
        targets = {"conc_T2": thresh(c_tr[-1], 0.12), "disp": u_tr[-1]}
        names, update = param_map_for_type(2)
        ip = InverseProblem(sim, names, targets, update_fn=update, n_steps=2, dt=1.0)
        J, g = ip.value_and_grad(np.array([0.05, 0.05]))
        return (u_tr, c_tr), J, g

    out_f, J_f, g_f = run_with(True)
    out_d, J_d, g_d = run_with(False)
    for a, b in zip(out_d, out_f):
        assert float((a - b).abs().max()) <= 1e-11
    np.testing.assert_allclose(J_f, J_d, rtol=1e-10)
    np.testing.assert_allclose(g_f, g_d, rtol=1e-7, atol=1e-14)


def test_class_labels_gate():
    """Scalar and per-tissue parameters satisfy the contract, a raw
    per-cell array voids it (the model then assembles densely)."""
    m = box_mesh((0, 0, 0), (6, 6, 6), 4, 4, 4)
    mesh = Mesh.from_arrays(m.points, m.cells).reordered_morton()

    class Boundary:
        def inside(self, x, on_boundary):
            return on_boundary

    def build(diffusion):
        sim = TumorGrowth(mesh, dtype=torch.float64, device="cpu")
        sim.setup_global_parameters(
            boundaries={"boundary_all": Boundary()},
            dirichlet_bcs={"clamped": {"bc_value": np.zeros(3),
                                       "named_boundary": "boundary_all",
                                       "subspace_id": 0}},
        )
        sim.setup_model_parameters(
            iv_expression={0: np.zeros(3),
                           1: lambda x: np.exp(-((x - 3.0) ** 2).sum(axis=1))},
            diffusion=diffusion, coupling=0.1, proliferation=0.1, E=100.0,
            poisson=0.4, sim_time=2, sim_time_step=1,
        )
        return sim

    assert build(0.1).theta_class_labels() is not None
    per_cell = build(np.full(mesh.n_cells, 0.1))
    assert per_cell.theta_class_labels() is None
    assert "_FWel" not in per_cell.runtime_aux()


def _jax_sim():
    return jax_brain_sim(n=6, dims=3, dtype=jnp.float64, mesh_transform=lambda m: (
        JaxMesh.from_arrays(m.points, m.cells).reordered_morton()))


@pytest.mark.parametrize("stacks", ["own", "carried"])
def test_planes_from_theta_matches_jax(stacks):
    """The port's channel stacks equal the JAX package's, and its
    planes_from_theta gives the JAX planes (1e-12 of their scale) from
    its own stacks (``own``) and from the JAX package's carried across
    with convert (``carried``)."""
    sim_j = _jax_sim()
    aux_j = sim_j.runtime_aux()
    theta_j = sim_j.make_theta(sim_j.params.as_dict())
    want = jax_bell_factored.planes_from_theta(
        {**theta_j, **aux_j}, 3, jnp.float64, want_cuc=True, want_rd=True,
        want_mrd=True)
    sim_t = _sim()
    carried = convert.aux_from_numpy({k: np.asarray(v) for k, v in aux_j.items()})
    own = sim_t.runtime_aux()
    for key in STACKS + ("_FReps", "_FWrdRhoReps", "_FWrdDReps"):
        assert own[key].shape == carried[key].shape, key
        if own[key].is_floating_point():
            assert _max_rel(own[key], carried[key]) <= 1e-12, key
        else:
            assert torch.equal(own[key], carried[key]), key
    aux_t = own if stacks == "own" else carried
    theta_t = convert.theta_from_numpy({k: np.asarray(v) for k, v in theta_j.items()})
    got = bell_factored.planes_from_theta({**theta_t, **aux_t}, 3, want_cuc=True,
                                          want_rd=True, want_mrd=True)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        assert _max_rel(g, w) <= 1e-12
    # the carried stacks drive the model's own augmentation to the same planes
    aug = sim_t._augment_theta_with_operators({**theta_t, **aux_t})
    dense = _augmented_dense(theta_t)
    for key in PLANES:
        assert _max_rel(aug[key], dense[key]) <= 1e-13, key


def _augmented_dense(theta):
    sim = _sim()
    return sim._augment_theta_with_operators(dict(theta))
