"""Von Neumann conditions under ``use_sharding(mode="cells")`` and
``mode="nodes"`` (lattice and unstructured) in glimslib_tpu_torch, at gloo
ranks on the CPU (``parallel.run_ranks``, torch on one thread a rank),
against the JAX package on its virtual CPU devices, at f64.

The model is ``examples.influx_sim`` (a von Neumann influx of c through
the whole boundary, scaled by the boundary cells' per-tissue D, and a
time-dependent source) with a traction through the whole boundary and the
displacement clamped on the boundary but its x = 10 face (a boundary
predicate), on the
n = 4 box: its lattice padded to 200 nodes (whole planes), or the same
box stripped of its lattice, Morton-ordered and padded to 128 nodes
(tests/torch_vn_shard_cases.py, which the spawned ranks import); 2 steps
at tight tolerances.  Held here:

- (a) each rank's share of the facets (the facets whose owning cell lies
  in its block under 'cells'; those with a node among its rows under
  'nodes', numbered in its rows) gives terms that sum (or, by rows,
  assemble) to the whole mesh's facet term within 1e-12 at 2 and 4
  ranks: an interior ``subdomain_boundary`` flux over the ``dS`` facets
  with a time-dependent value and per-tissue D, a constant influx and a
  time-dependent traction over the named boundary;
- (b) forward c and u, J and the gradient of a per-cell (D_WM, rho_WM)
  map at 2 and 4 ranks: 'cells' and 'nodes' on the stripped box, 'nodes'
  on the lattice, against the JAX package's run of the same mode on its
  virtual devices (forward, with Newton counts equal and CG counts within
  one) and against its unsharded value_and_grad at V0 on the targets of
  the port's unsharded forward (the forward inside it, J and the
  gradient), all within rel 1e-8, bit-equal on every rank; ``run()`` under 'cells' at
  2 ranks writes on rank 0 alone the unsharded run's files with its
  fields;
- (c) the 'bell' mode takes the same model at 2 ranks as the JAX
  package's 'bell' mode does.
"""

import os
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_vn_shard_cases as cases  # noqa: E402
from glimslib_tpu.core.mesh import Mesh as JaxMesh  # noqa: E402
from glimslib_tpu.core.mesh import box_mesh as jax_box_mesh  # noqa: E402
from glimslib_tpu.core.mesh import pad_mesh_nodes as jax_pad  # noqa: E402
from glimslib_tpu.models.tumor_growth import TumorGrowth as JaxTumorGrowth  # noqa: E402
from glimslib_tpu.parallel.shard import make_device_mesh as jax_device_mesh  # noqa: E402
from glimslib_tpu.solvers import coupled as jax_coupled  # noqa: E402
from glimslib_tpu.solvers.coupled import StepConfig as JaxStepConfig  # noqa: E402
from glimslib_tpu_torch import examples  # noqa: E402
from glimslib_tpu_torch.models.tumor_growth import TumorGrowth  # noqa: E402
from glimslib_tpu_torch.parallel import DeviceMesh, run_ranks  # noqa: E402
from torch_once import once  # noqa: E402
from torch_jax_vg import value_and_grad_with_forward  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

WORLDS = (2, 4)
CASES = [("cells", "stripped"), ("nodes", "stripped"), ("nodes", "lattice")]
RANK_TIMEOUT = 300
N_BOUNDARY_FACETS = 12 * cases.N * cases.N  # the box's triangles


def _rel(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


def _fake_mesh(rank, world):
    """A mesh of ranks for building a rank's share in this process (its
    tables need no collective)."""
    return DeviceMesh(None, rank, world, torch.device("cpu"), "mesh_x", "gloo")


# -- (a) the ranks' facet shares ---------------------------------------------------


def _ramp(x, t):
    return 0.3 * t * (1.0 + x[:, 0] / 10.0)


def _shear(x, t):
    return torch.stack([t * x[:, 1], torch.zeros_like(x[:, 0]), -0.5 * t * x[:, 2]], dim=1)


def _facet_model(kind):
    """influx_sim's box and tissues with three von Neumann entries: a
    time-dependent flux over the GM/WM interface's dS facets, a constant
    influx and a time-dependent traction over the whole boundary."""
    mesh = cases.box(kind)
    ref = examples.influx_sim(dtype=torch.float64, device="cpu", mesh=mesh)
    labels = np.zeros(mesh.n_nodes)
    r = np.linalg.norm((mesh.points - 5.0) / 5.0, axis=1)
    for lab, rad in ((1, 0.95), (2, 0.80), (3, 0.62), (4, 0.20)):
        labels[r < rad] = lab
    sim = TumorGrowth(mesh, dtype=torch.float64, device="cpu")
    sim.setup_global_parameters(
        label_function=labels, domain_names=examples.TISSUE_MAP,
        boundaries={"boundary_all": examples._Boundary()},
        dirichlet_bcs={"clamped": {"bc_value": np.zeros(3), "subspace_id": 0,
                                   "boundary": examples._OffFaceX10()}},
        von_neumann_bcs={
            "interface": {"bc_value": _ramp, "subdomain_boundary": "GM_WM",
                          "subspace_id": 1, "measure": "dS"},
            "influx": {"bc_value": examples.INFLUX_Q, "named_boundary": "boundary_all",
                       "subspace_id": 1},
            "traction": {"bc_value": _shear, "named_boundary": "boundary_all",
                         "subspace_id": 0}})
    sim.setup_model_parameters(**{k: ref.params.as_dict()[k] for k in (
        "diffusion", "proliferation", "E", "poisson", "coupling", "sim_time",
        "sim_time_step")}, iv_expression={0: np.zeros(3), 1: 0.0})
    return sim


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("mode,kind", CASES)
def test_rank_facet_shares_sum_to_the_whole(mode, kind, world):
    """(a) (module docstring)."""
    whole = _facet_model(kind)
    theta = whole.make_theta(whole.params.as_dict())
    assert len(whole.bcs.von_neumann_bcs["interface"]["facet_idx"]) > 0
    want = {"rd": whole._vn_rd_term(theta, 1.5), "el": whole._vn_el_term(1.5)}
    n = whole.mesh.n_nodes
    got = {"rd": torch.zeros(n, dtype=torch.float64),
           "el": torch.zeros((n, 3), dtype=torch.float64)}
    facets = {name: 0 for name in whole.bcs.von_neumann_bcs}
    for rank in range(world):
        sim = _facet_model(kind)
        sim.use_sharding(_fake_mesh(rank, world), mode=mode)
        th = dict(theta)
        if sim._node_slab is not None:
            # the lattice's slab takes its cells' coefficients
            th["D"] = theta["D"][torch.as_tensor(sim._node_slab.cell_ids)]
        rd, el = sim._vn_rd_term(th, 1.5), sim._vn_el_term(1.5)
        if mode == "cells":
            assert rd.shape == (n,) and el.shape == (n, 3)
            got["rd"] += rd
            got["el"] += el
        else:
            rows = slice(sim._node_rows.start, sim._node_rows.start + sim._node_rows.n_own)
            assert rd.shape == (n // world,) and el.shape == (n // world, 3)
            got["rd"][rows] = rd
            got["el"][rows] = el
        for name, bc in sim.bcs.von_neumann_bcs.items():
            facets[name] += len(sim._von_neumann_kernels(name, bc)[1])
    for key in ("rd", "el"):
        err = (got[key] - want[key]).abs().max()
        assert err <= 1e-12 * want[key].abs().max(), (key, float(err))
    for name, bc in whole.bcs.von_neumann_bcs.items():
        nf = len(bc["facet_cells"])
        # every facet on one rank under 'cells'; under 'nodes' on each rank
        # owning one of its nodes
        assert facets[name] == nf if mode == "cells" else nf <= facets[name] <= 3 * nf


# -- (b), (c) forward, value_and_grad and run() ---------------------------------------


def _jax_source(x, t):
    x0 = jnp.array([4.0, 5.0, 5.0])
    return examples.INFLUX_SOURCE * t * jnp.exp(-((x - x0) ** 2).sum(axis=1) / 2.0)


def _jax_model(kind):
    """The JAX package's TumorGrowth set up as cases.port_model's."""
    m = jax_box_mesh((0, 0, 0), (10, 10, 10), cases.N, cases.N, cases.N)
    if kind != "lattice":
        m = JaxMesh.from_arrays(m.points, m.cells).reordered_morton()
    mesh = jax_pad(m, cases.PAD)
    port = cases.port_model(kind)
    assert np.array_equal(mesh.cells, port.mesh.cells)
    labels = np.zeros(mesh.n_nodes)
    r = np.linalg.norm((mesh.points - 5.0) / 5.0, axis=1)
    for lab, rad in ((1, 0.95), (2, 0.80), (3, 0.62), (4, 0.20)):
        labels[r < rad] = lab
    sim = JaxTumorGrowth(mesh, dtype=jnp.float64)
    sim.setup_global_parameters(
        label_function=labels, domain_names=examples.TISSUE_MAP,
        boundaries={"boundary_all": examples._Boundary()},
        dirichlet_bcs={"clamped": {"bc_value": np.zeros(3), "subspace_id": 0,
                                   "boundary": examples._OffFaceX10()}},
        von_neumann_bcs={
            "influx": {"bc_value": examples.INFLUX_Q, "named_boundary": "boundary_all",
                       "subspace_id": 1},
            "traction": {"bc_value": np.asarray(cases.TRACTION),
                         "named_boundary": "boundary_all", "subspace_id": 0}})
    center = np.array([6.0, 5.0, 5.0])
    tissues = ("outside", "CSF", "GM", "WM", "Ventricles")
    sim.setup_model_parameters(
        iv_expression={0: np.zeros(3),
                       1: lambda x: np.exp(-((x - center) ** 2).sum(axis=1) / 0.5)},
        diffusion={**dict.fromkeys(tissues, 0.02), "WM": 0.1},
        proliferation={"GM": 0.02, "WM": 0.1},
        E={"outside": 10e3, "CSF": 1e3, "GM": 3e3, "WM": 3e3, "Ventricles": 1e3},
        poisson={**dict.fromkeys(tissues, 0.45), "Ventricles": 0.3},
        coupling=0.15, source_term=_jax_source, sim_time=2, sim_time_step=1)
    sim.step_config = JaxStepConfig(**cases.TIGHT)
    # its cell midpoints cached now, outside any trace: a first evaluation
    # under jit caches a tracer, which the next trace would read
    sim._midpoints()
    return sim


def _jax_trajectory(sim, monkeypatch):
    """The JAX package's trajectory (initial values clamped as its run()
    does) and the CG iterations of its solves by kind, sorted."""
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
    return dict(u=np.asarray(u), c=c, newton=np.asarray(newton).tolist(),
                rd=sorted(i for nd, i in rec if nd == 1),
                el=sorted(i for nd, i in rec if nd == 2))


def _jax_unsharded(kind):
    """The JAX package's unsharded value_and_grad at V0 on the targets of
    the port's unsharded forward (:func:`cases.targets`), with the forward
    inside it (tests/torch_jax_vg.py: one jitted program)."""
    targets = cases.targets(kind)
    sim = _jax_model(kind)
    wm, gm = (m.astype(np.float64) for m in cases.tissue_masks(sim))
    mp = pytest.MonkeyPatch()
    try:
        out = value_and_grad_with_forward(
            sim, ["D_WM", "rho_WM"], cases.update_fn(jnp.asarray(wm), jnp.asarray(gm)),
            targets, cases.V0, cases.N_STEPS, mp)
    finally:
        mp.undo()
    return dict(out, targets=targets)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    """kind -> :func:`_jax_unsharded`, computed once a session
    (tests/torch_once.py)."""
    got = {}

    def get(kind):
        if kind not in got:
            got[kind] = once(tmp_path_factory, f"vn_shard-{kind}",
                             lambda: _jax_unsharded(kind))
        return got[kind]

    return get


def _check_ranks(ranks, world, mode):
    """Every rank: the mode, converged, the same counts, and the
    trajectory, J and gradient bit-equal to rank 0's; run(), where it ran,
    gives the trajectory's last state."""
    assert len(ranks) == world
    for out in ranks:
        assert out["mode"] == mode and out["ok"]
        for key in ("newton", "rd_cg", "el_cg", "kernels"):
            assert out[key] == ranks[0][key], key
        for key in ("u", "c", "u_v0", "c_v0", "g"):
            assert np.array_equal(out[key], ranks[0][key]), key
        assert out["J"] == ranks[0]["J"]
        if "run_c" in out:
            assert np.array_equal(out["run_c"], out["c"][-1])
            assert np.array_equal(out["run_u"], out["u"][-1])


def _within_one(got, want):
    return len(got) == len(want) and all(abs(a - b) <= 1 for a, b in zip(sorted(got), want))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("mode,kind", CASES)
def test_forward_and_gradient_match_jax(mode, kind, world, jax_ref, monkeypatch,
                                        tmp_path):
    """(b) (module docstring)."""
    ref = jax_ref(kind)
    files = mode == "cells" and world == 2  # run() writes its files too
    ranks = run_ranks(cases.model_rank, world, "gloo", "cpu",
                      args=(mode, kind, ref["targets"], str(tmp_path) if files else None),
                      timeout=RANK_TIMEOUT)
    _check_ranks(ranks, world, mode)
    out = ranks[0]
    # the ranks' shares of a condition's facets are parts of it, covering it
    shares = [r["facets"]["influx"] for r in ranks]
    assert max(shares) < N_BOUNDARY_FACETS <= sum(shares)
    jsim = _jax_model(kind)
    jsim.use_sharding(jax_device_mesh(world), mode=mode)
    assert jsim.sharding_mode == mode
    same = _jax_trajectory(jsim, monkeypatch)
    assert out["newton"] == same["newton"]
    assert _within_one(out["rd_cg"], same["rd"]) and _within_one(out["el_cg"], same["el"])
    for k in range(cases.N_STEPS):
        assert _rel(out["c"][k], same["c"][k]) <= 1e-8
        assert _rel(out["u"][k], same["u"][k]) <= 1e-8
        assert _rel(out["c_v0"][k], ref["c"][k]) <= 1e-8
        assert _rel(out["u_v0"][k], ref["u"][k]) <= 1e-8
    assert abs(out["J"] - ref["J"]) <= 1e-8 * abs(ref["J"])
    assert _rel(out["g"], ref["g"]) <= 1e-8, (out["g"], ref["g"])
    if files:
        # rank 0 alone writes, the unsharded run's files with its fields
        whole = cases.port_model(kind)
        whole.run(save_method="vtk", output_dir=str(tmp_path / "whole"))
        names = sorted(os.listdir(tmp_path / "whole"))
        assert sorted(os.listdir(tmp_path)) == sorted(names + ["whole"])
        assert "solution.pvd" in names and "solution_timeseries.npz" in names
        got = np.load(tmp_path / "solution_timeseries.npz")
        want = np.load(tmp_path / "whole" / "solution_timeseries.npz")
        assert sorted(got.files) == sorted(want.files)
        for key in want.files:
            if want[key].dtype.kind == "f":
                assert _rel(got[key], want[key]) <= 1e-8, key
            else:
                assert np.array_equal(got[key], want[key]), key


def test_bell_mode_takes_the_influx_like_jax(jax_ref, monkeypatch):
    """(c): 'bell' at 2 ranks (the halo-ELL lane with the facet terms on
    replicated vectors) against the JAX package's 'bell' mode: forward
    within rel 1e-8, J and the gradient within rel 1e-8 of its unsharded
    value_and_grad, bit-equal on both ranks."""
    ref = jax_ref("stripped")
    ranks = run_ranks(cases.model_rank, 2, "gloo", "cpu",
                      args=("bell", "stripped", ref["targets"]), timeout=RANK_TIMEOUT)
    _check_ranks(ranks, 2, "bell")
    out = ranks[0]
    assert out["kernels"] == "P1Kernels"
    assert all(r["facets"]["influx"] == N_BOUNDARY_FACETS for r in ranks)
    jsim = _jax_model("stripped")
    jsim.use_sharding(jax_device_mesh(2), mode="bell")
    assert jsim.sharding_mode == "bell"
    same = _jax_trajectory(jsim, monkeypatch)
    for k in range(cases.N_STEPS):
        assert _rel(out["c"][k], same["c"][k]) <= 1e-8
        assert _rel(out["u"][k], same["u"][k]) <= 1e-8
    assert abs(out["J"] - ref["J"]) <= 1e-8 * abs(ref["J"])
    assert _rel(out["g"], ref["g"]) <= 1e-8
