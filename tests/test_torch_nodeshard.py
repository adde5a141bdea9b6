"""The ``cells`` mode and the unstructured ``nodes`` mode of
``Simulation.use_sharding`` in glimslib_tpu_torch (``parallel/partition.py``,
``parallel/shard.py ShardedP1Kernels``, ``parallel/nodeshard.py``, the
native mesh ops) at gloo ranks on the CPU (``parallel.run_ranks``, torch
on one thread a rank), against the JAX package on its virtual CPU
devices, at f64.

The model is the brain box of ``examples.brain_sim`` on the n=4 box mesh
made unstructured, Morton-ordered and padded to 128 nodes
(tests/torch_nodeshard_cases.py, which the spawned ranks import), 2
steps at tight tolerances.  Held here:

- (a) the copies: ``facets``, ``cell_adjacency``, ``partition_graph``
  (their code and their output), ``partition_cells`` and every
  ``NodeShardSpec`` table equal to the JAX package's at 2 and 4 parts;
- (b) every member of both sharded kernel classes at 2 and 4 ranks
  within 1e-12 of the JAX package's classes on 2 and 4 virtual devices
  and of the unsharded ``P1Kernels`` (the unstructured 'nodes' rows bit
  for bit: the same sums in the same order); ``cells`` has no
  ``elasticity_diag_blocks``, and its blocks come from the native graph
  partitioner;
- (f) ``torch.func.jvp`` of the sharded residuals equals the unsharded
  jvp, the sum over the ranks of their parts (the collectives carry the
  tangent);
- (c), (d) forward trajectories and ``value_and_grad`` of both modes at 2
  and 4 ranks, on the targets of the port's unsharded forward: 'cells'
  against the JAX package's 'cells' run (rel-L2 1e-8, the same Newton and
  CG counts: point-Jacobi on the elasticity block), 'nodes' (the forward
  inside value_and_grad, at V0) against the forward inside the JAX
  package's single-device matrix-free value_and_grad (the same counts:
  block-Jacobi; tests/torch_jax_vg.py, one jitted program); J and the
  gradient within rel 1e-8 of that value_and_grad and bit-equal on every
  rank; ``run()`` gives the trajectory's last state;
- (e) ``use_sharding()`` falls back to 'cells' where the JAX package's
  does, with its warning; quad models refuse, von Neumann conditions
  enter both modes;
- the lattice's 'nodes' mode on the matrix-free lane at 2 ranks against
  the JAX package's matrix-free value_and_grad (the forward inside it,
  J and gradient).
"""

import inspect
import logging
import os
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch_nodeshard_cases as cases  # noqa: E402
from __graft_entry__ import _brain_sim as jax_brain_sim  # noqa: E402
from glimslib_tpu.core.mesh import Mesh as JaxMesh  # noqa: E402
from glimslib_tpu.core.mesh import pad_mesh_nodes as jax_pad  # noqa: E402
from glimslib_tpu.core.mesh import rectangle_mesh as jax_rectangle_mesh  # noqa: E402
from glimslib_tpu.native import meshops as jax_meshops  # noqa: E402
from glimslib_tpu.ops.assembly import P1Kernels as JaxP1Kernels  # noqa: E402
from glimslib_tpu.parallel import nodeshard as jax_nodeshard  # noqa: E402
from glimslib_tpu.parallel import partition as jax_partition  # noqa: E402
from glimslib_tpu.parallel.shard import ShardedP1Kernels as JaxSharded  # noqa: E402
from glimslib_tpu.parallel.shard import make_device_mesh as jax_device_mesh  # noqa: E402
from glimslib_tpu.solvers import coupled as jax_coupled  # noqa: E402
from glimslib_tpu.optimize.adjoint import param_map_for_type as jax_param_map  # noqa: E402
from glimslib_tpu.solvers.coupled import StepConfig as JaxStepConfig  # noqa: E402
from glimslib_tpu_torch.core.mesh import rectangle_mesh  # noqa: E402
from glimslib_tpu_torch.native import meshops  # noqa: E402
from glimslib_tpu_torch.parallel import (  # noqa: E402
    DeviceMesh, NodeShardSpec, ShardedP1Kernels, partition_cells, run_ranks)
from glimslib_tpu_torch.parallel.partition import morton_order  # noqa: E402
from torch_once import once  # noqa: E402
from torch_jax_vg import value_and_grad_with_forward  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

WORLDS = (2, 4)
RANK_TIMEOUT = 300


def _rel(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


def _close(got, want, tol=1e-12):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max(initial=0.0)
    assert err <= tol * max(1.0, np.abs(want).max(initial=0.0)), err


def _jax_mesh(lattice=False, world=2):
    """The JAX package's mesh of :func:`cases.port_model`."""
    if lattice:
        return dict(pad_to=world)
    return dict(mesh_transform=lambda m: jax_pad(
        JaxMesh.from_arrays(m.points, m.cells).reordered_morton(), cases.PAD))


def _jax_model(lattice=False, world=2, matrix_free=True):
    sim = jax_brain_sim(n=cases.N, dims=3, dtype=jnp.float64, **_jax_mesh(lattice, world))
    sim.step_config = JaxStepConfig(**cases.TIGHT)
    if matrix_free:
        sim.operator_mode = "matrix-free"
    return sim


def _jax_trajectory(sim, monkeypatch):
    """The JAX package's N_STEPS trajectory (initial values clamped as its
    run() does), with the CG iterations of every solve by kind (its pcg
    reports them through a debug callback; unordered, so as sorted lists)."""
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
        u, c, ok, newton = sim.build_simulate_fn(cases.N_STEPS, 1.0)(theta, u0, c0)
        c = np.asarray(jax.block_until_ready(c))
    assert bool(np.asarray(ok).all())
    counts = {"rd": sorted(i for nd, i in rec if nd == 1),
              "el": sorted(i for nd, i in rec if nd == 2)}
    return dict(u=np.asarray(u), c=c, newton=np.asarray(newton).tolist(), counts=counts)


def _jax_value_and_grad(lattice=False, world=2, monkeypatch=None):
    """The JAX package's single-device matrix-free value_and_grad of type 2
    at V0 on the targets of the port's unsharded forward
    (:func:`cases.targets`), with the forward inside it
    (tests/torch_jax_vg.py: one jitted program)."""
    targets = cases.targets(lattice, world)
    names, update = jax_param_map(2)
    mp = monkeypatch or pytest.MonkeyPatch()
    try:
        out = value_and_grad_with_forward(_jax_model(lattice, world), names, update,
                                          targets, cases.V0, cases.N_STEPS, mp)
    finally:
        if monkeypatch is None:
            mp.undo()
    assert out["ok"]
    return dict(out, targets=targets)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    """:func:`_jax_value_and_grad` of the Morton box, computed once a
    session (tests/torch_once.py)."""
    return once(tmp_path_factory, "nodeshard-matrix-free", _jax_value_and_grad)


def _counts(out):
    return {"rd": sorted(out["rd_cg"]), "el": sorted(out["el_cg"])}


def _check_ranks(ranks, world, mode):
    """Every rank: the mode, converged, the same counts, and the
    trajectory, J and gradient bit-equal to rank 0's."""
    assert len(ranks) == world
    for out in ranks:
        assert out["mode"] == mode and out["ok"] and out["matrix_free"]
        for key in ("newton", "rd_cg", "el_cg", "adj", "aug", "kernels"):
            assert out[key] == ranks[0][key], key
        for key in ("u", "c", "g", "run_c", "run_u"):
            assert np.array_equal(out[key], ranks[0][key]), key
        assert out["J"] == ranks[0]["J"]
        for key in ("u", "c"):
            assert np.array_equal(out["v0"][key], ranks[0]["v0"][key]), key
        for key in ("newton", "rd_cg", "el_cg"):
            assert out["v0"][key] == ranks[0]["v0"][key], key
        # run() gives the trajectory's last state
        assert np.array_equal(out["run_c"], out["c"][-1])
        assert np.array_equal(out["run_u"], out["u"][-1])


# -- (a) the copies ---------------------------------------------------------------


def _code(fn, old, new):
    return inspect.getsource(fn).replace(old, new)


def test_meshops_copies_equal_jax():
    """The port's meshops.cpp is the JAX package's below its header, its
    Python functions the JAX package's apart from imports, and facets,
    cell adjacency and the greedy partition equal the JAX package's on a
    triangle and a tetrahedron mesh."""
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    read = lambda *p: open(os.path.join(here, *p)).read()  # noqa: E731
    ref = read("glimslib_tpu", "native", "meshops.cpp")
    got = read("glimslib_tpu_torch", "native", "meshops.cpp")
    assert got.split("#include <cstdint>", 1)[1] == ref.split("#include <cstdint>", 1)[1]
    for name in ("facets", "cell_adjacency", "partition_graph", "rcm_permutation",
                 "available"):
        assert (_code(getattr(meshops, name), "glimslib_tpu_torch.", "glimslib_tpu.")
                == inspect.getsource(getattr(jax_meshops, name))), name
    assert meshops.available() and jax_meshops.available()
    tri = rectangle_mesh((-1, -1), (1, 1), 9, 7)
    assert np.array_equal(tri.cells, jax_rectangle_mesh((-1, -1), (1, 1), 9, 7).cells)
    for cells in (tri.cells, cases.morton_mesh().cells):
        for a, b in zip(meshops.facets(cells), jax_meshops.facets(cells)):
            assert np.array_equal(a, b)
        for a, b in zip(meshops.cell_adjacency(cells), jax_meshops.cell_adjacency(cells)):
            assert np.array_equal(a, b)
        for parts in WORLDS:
            assert np.array_equal(meshops.partition_graph(cells, parts),
                                  jax_meshops.partition_graph(cells, parts))


@pytest.mark.parametrize("parts", WORLDS)
def test_partition_and_spec_tables_equal_jax(parts):
    """partition_cells (the native graph partitioner) and every
    NodeShardSpec table equal the JAX package's at ``parts`` parts, and
    morton_order its order."""
    mesh = cases.morton_mesh()
    jmesh = _jax_model(matrix_free=False).mesh
    assert np.array_equal(mesh.cells, jmesh.cells)
    assert np.array_equal(morton_order(mesh.cell_midpoints),
                          jax_partition.morton_order(jmesh.cell_midpoints))
    got, want = partition_cells(mesh, parts), jax_partition.partition_cells(jmesh, parts)
    assert got.method == "graph"
    for f in ("n_parts", "n_nodes", "npe"):
        assert getattr(got, f) == getattr(want, f)
    for f in ("cells", "vol", "grads", "cell_perm", "pad_mask", "sort_idx", "sorted_ids"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    spec, jspec = NodeShardSpec(mesh, parts), jax_nodeshard.NodeShardSpec(jmesh, parts)
    for f in ("n", "ndev", "nnl", "nc", "npe", "dim", "Cl", "G", "P"):
        assert getattr(spec, f) == getattr(jspec, f), f
    for f in ("pub_idx", "ghost_src", "cells_xb", "cell_ids", "grads_l", "vol_l",
              "cell_own", "res_pull"):
        a, b = getattr(spec, f), getattr(jspec, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    with pytest.raises(ValueError, match="pad_mesh_nodes"):
        NodeShardSpec(mesh, 3)


# -- (b), (f) the kernels -----------------------------------------------------------


def _jax_calls(k, x, nodes):
    """The JAX package's sharded kernels on the inputs ``x`` (numpy),
    named as cases.kernel_calls names them: one jitted program (one
    compile, where each eager member would compile its own)."""

    def calls(a):
        out = {
            "rd_residual": k.rd_residual(a["c"], a["cp"], a["D"], a["rho"], 0.7,
                                         source=a["src"]),
            "elasticity_residual": k.elasticity_residual(a["u"], a["c"], a["mu"], a["lam"],
                                                         0.15, body_force=a["bf"]),
            "rd_mass_stiffness_diag": k.rd_mass_stiffness_diag(a["D"], 0.0, 0.7),
            "elasticity_diag": k.elasticity_diag(a["mu"], a["lam"]),
            "mass_residual": k.mass_residual(a["c"]),
            "mass_vector_residual": k.mass_vector_residual(a["u"]),
            "integrate_p1": k.integrate_p1(a["c"]),
        }
        if nodes:
            B = k.elasticity_diag_blocks(a["mu"], a["lam"])
            unused = jnp.all(B.reshape(B.shape[0], -1) == 0, axis=1)
            Binv = k.block_jacobi_inverse_blocks(B, mask=jnp.repeat(unused[:, None], 3, 1))
            out.update(elasticity_diag_blocks=B, block_jacobi_inverse_blocks=Binv,
                       apply_block_jacobi=k.apply_block_jacobi(Binv, a["w"]),
                       lumped_mass=k.lumped_mass())
        return out

    got = jax.jit(calls)({key: jnp.asarray(v.numpy()) for key, v in x.items()})
    return {key: np.asarray(v) for key, v in got.items()}


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_kernels_match_jax_and_unsharded(world):
    """(b) and (f) at ``world`` gloo ranks (module docstring)."""
    ranks = run_ranks(cases.kernels_rank, world, "gloo", "cpu", args=(7,),
                      timeout=RANK_TIMEOUT)
    jmesh = _jax_model(matrix_free=False).mesh
    dmesh = jax_device_mesh(world)
    x = cases.random_inputs(cases.morton_mesh(), 7)
    want_cells = _jax_calls(JaxSharded(jmesh, dmesh), x, nodes=False)
    want_nodes = _jax_calls(jax_nodeshard.NodeShardedP1Kernels(jmesh, dmesh), x, nodes=True)
    # the JAX package's unsharded P1Kernels agrees with both
    jk = JaxP1Kernels(jmesh)
    _close(want_cells["rd_residual"], np.asarray(jk.rd_residual(
        *(jnp.asarray(x[k].numpy()) for k in ("c", "cp", "D", "rho")), 0.7,
        source=jnp.asarray(x["src"].numpy()))))
    n_own = 128 // world
    assert sum(r["block_cells"] for r in ranks) == jmesh.n_cells
    for r, out in enumerate(ranks):
        assert out["start"] == r * n_own and out["n_own"] == n_own
        assert out["method"] == "graph" and not out["has_blocks"]
        rows = slice(r * n_own, (r + 1) * n_own)
        whole = out["whole"]
        for name, got in out["cells"].items():
            want = whole[name]
            _close(got, want)
            if name in want_cells:
                _close(got, want_cells[name])
        for name, got in out["nodes"].items():
            want = whole[name] if name == "integrate_p1" else whole[name][rows]
            if name.startswith("jvp") or name == "integrate_p1":
                _close(got, want)
            else:
                # the same contributions summed in the same order
                assert np.array_equal(got, want), name
            if name in want_nodes:
                jw = want_nodes[name] if name == "integrate_p1" else want_nodes[name][rows]
                _close(got, jw)
        # (f): the jvp of the replicated residual is the unsharded one, not
        # this rank's part of it
        assert np.abs(whole["jvp_rd"]).max() > 0


# -- (e) the fallback and the refusals ----------------------------------------------


def test_auto_falls_back_to_cells_with_the_warning(caplog):
    """Where the JAX package's use_sharding() takes 'cells' (a world of 3
    that divides neither the lattice's nodes nor the supernode blocks, a
    matrix-free model), the port's does, with the same warning; the
    mode swaps the kernels for ShardedP1Kernels on the world's blocks.
    Quad models refuse under 'cells' and 'nodes'; a model with von Neumann
    conditions enters both."""
    from glimslib_tpu_torch.examples import brain_sim

    three = DeviceMesh(None, 0, 3, torch.device("cpu"), "mesh_x", "gloo")
    cases_ = {
        "unstructured": (lambda: brain_sim(n=4, dtype=torch.float64, device="cpu",
                                           unstructured=True),
                         lambda: jax_brain_sim(n=4, dims=3, dtype=jnp.float64,
                                               mesh_transform=lambda m: JaxMesh.from_arrays(
                                                   m.points, m.cells).reordered_morton()),
                         "not divisible by 3 devices"),
        "lattice": (lambda: brain_sim(n=4, dtype=torch.float64, device="cpu"),
                    lambda: jax_brain_sim(n=4, dims=3, dtype=jnp.float64),
                    "n_nodes=125 not divisible by 3"),
    }
    for name, (port, jax_sim, why) in cases_.items():
        jsim = jax_sim()
        with caplog.at_level(logging.WARNING):
            caplog.clear()
            jsim.use_sharding(jax_device_mesh(3))
            assert jsim.sharding_mode == "cells"
            assert any("fell back to the SLOW 'cells' lane" in r.getMessage()
                       for r in caplog.records)
            caplog.clear()
            sim = port()
            assert sim.use_sharding(three) is three and sim.sharding_mode == "cells"
        msgs = [r.getMessage() for r in caplog.records]
        assert any("fell back to the SLOW 'cells' lane" in m and why in m for m in msgs), msgs
        assert isinstance(sim.kernels, ShardedP1Kernels) and sim.matrix_free
        assert sim.kernels.part.n_parts == 3 and sim.runtime_aux() == {}
    mf = brain_sim(n=4, dtype=torch.float64, device="cpu")
    mf.operator_mode = "matrix-free"
    with caplog.at_level(logging.WARNING):
        caplog.clear()
        mf.use_sharding(three._replace(world=1))
    assert mf.sharding_mode == "cells"
    assert any("assembled operators are off" in r.getMessage() for r in caplog.records)
    quad = brain_sim(n=2, dtype=torch.float64, device="cpu", unstructured=True, quad=True)
    for mode in ("cells", "nodes"):
        with pytest.raises(NotImplementedError, match="elasticity_residual_cint"):
            quad.use_sharding(three._replace(world=1), mode=mode)
    from glimslib_tpu_torch.examples import influx_sim

    # von Neumann conditions enter both modes (their rank shares are held
    # in tests/test_torch_vn_shard.py)
    for mode in ("cells", "nodes"):
        vn = influx_sim(n=3, dtype=torch.float64, device="cpu", unstructured=True)
        vn.use_sharding(three._replace(world=1), mode=mode)
        assert vn.sharding_mode == mode and vn.matrix_free
    assert quad.sharding_mode is None


# -- (c), (d) forward, value_and_grad and run() ---------------------------------------


@pytest.mark.parametrize("mode", ["cells", "nodes"])
@pytest.mark.parametrize("world", WORLDS)
def test_forward_and_gradient_match_jax(mode, world, jax_ref, monkeypatch):
    """(c) and (d) at ``world`` gloo ranks (module docstring)."""
    ranks = run_ranks(cases.model_rank, world, "gloo", "cpu",
                      args=(mode, jax_ref["targets"]), timeout=RANK_TIMEOUT)
    _check_ranks(ranks, world, mode)
    out = ranks[0]
    if mode == "cells":
        jsim = _jax_model(matrix_free=False)
        jsim.use_sharding(jax_device_mesh(world), mode="cells")
        want, got = _jax_trajectory(jsim, monkeypatch), out
        # point-Jacobi on the elasticity block, as the reference's 'cells'
        assert out["kernels"] == "ShardedP1Kernels" and out["aug"] == []
    else:
        # the forward inside value_and_grad, at V0
        want, got = jax_ref, out["v0"]
        assert out["kernels"] == "NodeShardedP1Kernels" and out["aug"] == ["_BinvG"]
    assert got["newton"] == want["newton"] and _counts(got) == want["counts"]
    for k in range(cases.N_STEPS):
        assert _rel(got["c"][k], want["c"][k]) <= 1e-8
        assert _rel(got["u"][k], want["u"][k]) <= 1e-8
    assert abs(out["J"] - jax_ref["J"]) <= 1e-8 * abs(jax_ref["J"])
    assert _rel(out["g"], jax_ref["g"]) <= 1e-8, (out["g"], jax_ref["g"])
    assert all(len(v) == cases.N_STEPS for v in out["adj"].values())


def test_lattice_nodes_on_the_matrix_free_lane_matches_jax(monkeypatch):
    """The lattice's 'nodes' mode on the matrix-free lane (the gather
    residuals on the slab's cells after a halo exchange that carries the
    jvp's tangent) at 2 ranks on the box padded to 150 nodes, against the
    JAX package's single-device matrix-free value_and_grad on the targets
    of the port's unsharded forward: the forward inside it at rel-L2 1e-8
    with its Newton and CG counts, J and the gradient at rel 1e-8,
    bit-equal on both ranks."""
    want = _jax_value_and_grad(lattice=True, world=2, monkeypatch=monkeypatch)
    ranks = run_ranks(cases.model_rank, 2, "gloo", "cpu",
                      args=("nodes", want["targets"], True), timeout=RANK_TIMEOUT)
    _check_ranks(ranks, 2, "nodes")
    out = ranks[0]
    assert out["kernels"] == "P1Kernels" and out["aug"] == ["_BinvG"]
    got = out["v0"]
    assert got["newton"] == want["newton"] and _counts(got) == want["counts"]
    assert out["c"].shape[1] == got["c"].shape[1] == 150
    assert _rel(got["c"][-1], want["c"][-1]) <= 1e-8
    assert _rel(got["u"][-1], want["u"][-1]) <= 1e-8
    J, g = want["J"], want["g"]
    assert abs(out["J"] - J) <= 1e-8 * abs(J) and _rel(out["g"], g) <= 1e-8
