"""Block sharding (``Simulation.use_sharding(mode="bell")``) of
glimslib_tpu_torch on ``torch.distributed``, at two gloo ranks on the CPU
(``parallel.run_ranks``; torch on one thread a rank), at f64, against the
JAX package.

The inputs are tests/test_bellshard.py's (``_sim``: the Morton n=6 box
with the two-level level on through ``GLIMS_TWOLEVEL_MIN_NODES=100``;
``_sim_quad``), built in the port by tests/torch_shard_cases.py.  The JAX
side is the JAX package's single-device run, which tests/test_bellshard.py
already holds equal to its 8-device sharded run at 1e-11 / 1e-12.  Held
here:

- the P1 and quad trajectories, 2 steps: the port sharded against JAX at
  rel-L2 1e-8 (the port's unstructured tolerance,
  tests/test_torch_unstructured.py), against the port unsharded at atol
  1e-11;
- every table on the supernode-block axis (operator planes, factored
  channel stacks, supernode inverses; the P2 tables of the quad model)
  holds nb / 2 blocks on each rank, the two-level factors and mode
  matrices their aggregates' rows, and the table bytes halve; the plans
  the mesh caches stay whole for the unsharded model beside it; the
  coarse factors are built bit-equal on both ranks;
- value_and_grad (type 2) against the JAX package's single-device
  gradient on the targets of the port's unsharded forward: J rtol 1e-10, gradient rtol 1e-8, J and gradient bit-equal on
  both ranks.  The quad gradient is held against JAX's single-device one
  only: the JAX package's own sharded quad adjoint aborts inside XLA's
  compile (tests/test_bellshard.py::test_quad_adjoint_gradient_matches_
  single_device, ROADMAP §3);
- ``use_sharding`` raising for the modes and meshes 'bell' does not
  take, and without a process group; 'cells' and 'nodes' on the
  unstructured mesh, and auto's fallback to 'cells' with its warning.
"""

import datetime
import os
import sys
import tempfile

import numpy as np
import pytest
import jax.numpy as jnp
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_shard_cases as cases  # noqa: E402
from test_bellshard import _run as jax_run  # noqa: E402
from test_bellshard import _sim as jax_sim  # noqa: E402
from test_bellshard import _sim_quad as jax_sim_quad  # noqa: E402
from glimslib_tpu_torch.parallel import DeviceMesh, make_device_mesh, run_ranks  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

WORLD = 2
V0 = np.array([0.05, 0.05])


@pytest.fixture
def twolevel_env(monkeypatch):
    # the ranks inherit the environment
    monkeypatch.setenv("GLIMS_TWOLEVEL_MIN_NODES", "100")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _jax_forward(quad):
    sim = jax_sim_quad() if quad else jax_sim()
    u, c, ok, _ = jax_run(sim, cases.N_STEPS)
    assert bool(np.asarray(ok).all())
    return sim, np.asarray(u), np.asarray(c)


@pytest.mark.parametrize("quad", [False, True], ids=["p1", "quad"])
def test_sharded_trajectory_and_slabs(twolevel_env, quad):
    _, u_j, c_j = _jax_forward(quad)
    ranks = run_ranks(cases.forward_rank, WORLD, "gloo", "cpu", args=(quad,))
    nb_seen = set()
    for rank, out in enumerate(ranks):
        assert out["mode"] == "bell"
        u, c, ok, newton = out["sharded"]
        uw, cw, okw, neww = out["whole"]
        assert ok.all() and okw.all() and newton.tolist() == neww.tolist()
        # against the JAX package and against the port unsharded
        assert _rel(c[-1], c_j[-1]) <= 1e-8 and _rel(u[-1], u_j[-1]) <= 1e-8
        np.testing.assert_allclose(c, cw, rtol=0, atol=1e-11)
        np.testing.assert_allclose(u, uw, rtol=0, atol=1e-11)
        # every block-axis table holds nb / 2 blocks, the coarse arrays
        # their aggregates' rows; the other axes are the whole table's
        want = set(cases.BLOCK_AXIS) - ({"_BellCuc", "_BellWrdC", "_BellMrd", "_McSN",
                                         "_FCuc", "_FWrd", "_FMrd"} if quad
                                        else {"_P2BWrdC", "_McSNP2", "_FP2Wrd"})
        assert want <= set(out["shapes"]), sorted(want - set(out["shapes"]))
        coarse = {"_TLCfac", "_TLMt"} | (set() if quad else {"_TLCfacS", "_TLMtS"})
        assert coarse <= set(out["shapes"])
        for k, (got, whole) in out["shapes"].items():
            ax = cases.BLOCK_AXIS.get(k, cases.ROW_AXIS.get(k))
            assert got[ax] * WORLD == whole[ax], (k, got, whole)
            assert got[:ax] + got[ax + 1:] == whole[:ax] + whole[ax + 1:], k
        assert out["bytes"][0] * WORLD == pytest.approx(out["bytes"][1], rel=0.01)
        for s in out["slabs"]:
            assert s["slab"] and s["base_is_whole"] and s["whole_is_plan"]
            assert s["nb"] * WORLD == s["nb_total"] and s["b1"] - s["b0"] == s["nb"]
            assert s["b0"] == rank * s["nb"] and s["ext"] and s["place"]
            nb_seen.add((s["b0"], s["nb_total"]))
        assert out["mesh_plans_whole"]
        for k, (same, rows) in out["coarse"].items():
            assert same and rows, k
    assert len(nb_seen) == WORLD * len(ranks[0]["slabs"])
    # the ranks hold the same replicated trajectory
    for i in (0, 1):
        assert np.array_equal(ranks[0]["sharded"][i], ranks[1]["sharded"][i])


def _jax_gradient(quad):
    """Targets from the port's unsharded forward at the set-up parameters,
    and the JAX package's single-device J and gradient on them."""
    from glimslib_tpu.optimize.adjoint import InverseProblem, param_map_for_type
    from glimslib_tpu_torch.optimize.adjoint import thresh

    u, c, ok, _ = cases._run(cases.port_sim(quad))
    assert ok.all()
    targets = {"conc_T2": thresh(torch.as_tensor(c[-1]), 0.12).numpy(), "disp": u[-1]}
    sim = jax_sim_quad() if quad else jax_sim()
    names, update = param_map_for_type(2)
    ip = InverseProblem(sim, names, targets, update_fn=update, n_steps=cases.N_STEPS,
                        dt=1.0)
    J, g = ip.value_and_grad(V0)
    return targets, float(J), np.asarray(g)


@pytest.mark.parametrize("quad", [False, True], ids=["p1", "quad"])
def test_sharded_gradient_matches_jax(twolevel_env, quad):
    """J rtol 1e-10, gradient rtol 1e-8 against the JAX package's
    single-device value_and_grad on the same targets; bit-equal on both
    ranks.  (quad: against single-device JAX only, module docstring.)"""
    targets, J_j, g_j = _jax_gradient(quad)
    ranks = run_ranks(cases.grad_rank, WORLD, "gloo", "cpu", args=(quad, targets, V0))
    for out in ranks:
        assert out["mode"] == "bell" and out["same"]
        np.testing.assert_allclose(out["J"], J_j, rtol=1e-10)
        np.testing.assert_allclose(out["g"], g_j, rtol=1e-8, atol=1e-14)
    assert ranks[0]["J"] == ranks[1]["J"]
    assert np.array_equal(ranks[0]["g"], ranks[1]["g"])


def test_use_sharding_needs_a_process_group():
    assert not dist.is_initialized()
    sim = cases.port_sim()
    with pytest.raises(RuntimeError, match="torchrun.*run_ranks"):
        sim.use_sharding()
    with pytest.raises(RuntimeError, match="torchrun"):
        make_device_mesh(device="cpu")
    assert sim.sharding_mode is None


@pytest.fixture
def one_rank():
    """A world of one gloo rank in this process, torn down after."""
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=0,
                                world_size=1, timeout=datetime.timedelta(seconds=60))
        try:
            yield make_device_mesh(device="cpu")
        finally:
            dist.destroy_process_group()


def test_use_sharding_raises_where_the_port_does_not_shard(one_rank, caplog):
    import logging

    from glimslib_tpu_torch.examples import brain_sim

    mesh = one_rank
    assert mesh.world == 1 and mesh.backend == "gloo"
    # a lattice mesh: auto takes the reference's 'nodes' (its own tests:
    # tests/test_torch_gspmd.py), and 'bell' is refused
    lat = brain_sim(n=4, dtype=torch.float64, device="cpu")
    nodes = brain_sim(n=4, dtype=torch.float64, device="cpu")
    assert nodes.use_sharding(mesh) is mesh and nodes.sharding_mode == "nodes"
    with pytest.raises(ValueError, match="needs the supernode halo-ELL path"):
        lat.use_sharding(mesh, mode="bell")
    uns = cases.port_sim()
    with pytest.raises(ValueError, match="unknown sharding mode"):
        uns.use_sharding(mesh, mode="rows")
    assert lat.sharding_mode is None and uns.sharding_mode is None
    # 'nodes' and 'cells' on the unstructured mesh swap its kernels (their
    # own tests: tests/test_torch_nodeshard.py)
    for mode, cls in (("nodes", "NodeShardedP1Kernels"), ("cells", "ShardedP1Kernels")):
        other = cases.port_sim()
        assert other.use_sharding(mesh, mode=mode) is mesh and other.sharding_mode == mode
        assert type(other.kernels).__name__ == cls and other.matrix_free
    # where the world divides neither the nodes nor the blocks, auto takes
    # the reference's 'cells' and says why
    three = DeviceMesh(None, 0, 3, torch.device("cpu"), "mesh_x", "gloo")
    for sim, why in ((brain_sim(n=4, dtype=torch.float64, device="cpu"),
                      "n_nodes=125 not divisible by 3 devices"),
                     (cases.port_sim(), "block count 16 not divisible by 3 devices")):
        with caplog.at_level(logging.WARNING):
            caplog.clear()
            assert sim.use_sharding(three) is three and sim.sharding_mode == "cells"
        assert any("fell back to the SLOW 'cells' lane" in r.getMessage()
                   and why in r.getMessage() for r in caplog.records), why
    with pytest.raises(ValueError, match="block count 16 not divisible by 3"):
        uns.use_sharding(three, mode="bell")
    with pytest.raises(ValueError, match="mesh of ranks is on meta, the model on cpu"):
        uns.use_sharding(three._replace(world=1, device=torch.device("meta")))
    assert lat.sharding_mode is None and uns.sharding_mode is None
    with pytest.raises(ValueError, match="n_devices=2"):
        make_device_mesh(2, device="cpu")
    # a world of one runs the same slab code: one slab of every block
    assert uns.use_sharding(mesh) is mesh and uns.sharding_mode == "bell"
    plan = uns._get_bell_plan()
    assert (plan.b0, plan.b1, plan.nb) == (0, plan.nb_total, plan.nb_total)
