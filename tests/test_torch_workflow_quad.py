"""Port parity for the quad (P2-concentration) model in the image-based
workflow, and for the workflow's and ``Simulation.run``'s repairs, at f64
on the CPU.

The atlas pipeline with ``model="quad"`` at the setup of the JAX
package's ``test_quad_model_workflow`` (``brain_labelmap_3d(20, 20, 8)``
sliced at z=4, type 2 from D_WM = rho_WM = 0.05, L-BFGS-B maxiter 3), tight
tolerances on both sides (newton_rtol 1e-10, cg_rtol 1e-12).  The port
runs the quad model on the slice's mesh with its lattice stripped (the
unstructured lane); the JAX package runs it on the lattice mesh (its
matrix-free lane): the same solution, since the P2 dofs are numbered by
their coordinates.  Tolerances: mesh, node order and P2 layout exact;
forward, targets, stored datasets, J and the gradient at v0, post_process
tables 1e-8; the parameters after L-BFGS-B, the optimized re-run, its
stored vertex-part c and the comparison 1e-6.  The JAX package's
``compare_original_optimized`` raises on a P2 concentration (it applies
the P1 mass to it), so the port's comparison is held against the P2
errornorms computed with the JAX package's own P2 mass.  Each pipeline
runs whole once a module (a fixture returning read-only arrays).

The 3D full lattice (10 x 10 x 8 labelmap) runs the quad model with its
cell-free P2 vertex dofs zero-Dirichlet; the JAX package gives NaN there,
so the yardstick is the port's own run on the mesh with those nodes
removed.
"""

import contextlib
import os
import sys

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from glimslib_tpu.ops.p2 import p2_dof_layout as jax_p2_dof_layout
from glimslib_tpu.optimize import adjoint as jax_adjoint
from glimslib_tpu.postprocess import Comparison as JaxComparison
from glimslib_tpu.solvers.coupled import StepConfig as JaxStepConfig
from glimslib_tpu.utils import data_io as jax_dio
from glimslib_tpu.utils import image_io as jax_image_io
from glimslib_tpu.utils import synthetic as jax_synthetic
from glimslib_tpu.workflow.image_based_optimization_atlas import (
    ImageBasedOptimizationAtlas as JaxAtlas,
)
from glimslib_tpu_torch import examples
from glimslib_tpu_torch.core.mesh import Mesh, rectangle_mesh
from glimslib_tpu_torch.models.tumor_growth_brain_quad import TumorGrowthBrain as BrainQuad
from glimslib_tpu_torch.ops.p2 import p2_dof_layout
from glimslib_tpu_torch.ops.stencil import StencilOperators
from glimslib_tpu_torch.solvers.coupled import StepConfig
from glimslib_tpu_torch.utils import data_io as dio
from glimslib_tpu_torch.workflow.image_based_optimization import TISSUE_MAP, BoundaryAll
from glimslib_tpu_torch.workflow.image_based_optimization_atlas import (
    ImageBasedOptimizationAtlas,
)
from glimslib_tpu_torch.workflow.image_based_optimization_patient import (
    ImageBasedOptimizationPatient,
)
from torch_once import once

TIGHT = dict(newton_rtol=1e-10, newton_atol=1e-14, cg_rtol=1e-12)
F64 = torch.float64
FIXED = dict(E_GM=3e3, E_WM=3e3, E_CSF=1e3, E_VENT=1e3,
             nu_GM=0.45, nu_WM=0.45, nu_CSF=0.45, nu_VENT=0.3)
VARYING = dict(D_WM=0.1, D_GM=0.02, rho_WM=0.1, rho_GM=0.02, coupling=0.15)
SIM = dict(sim_time=2, sim_time_step=1, seed_width=1.5)
START = dict(VARYING, D_WM=0.05, rho_WM=0.05)
V0 = np.array([0.05, 0.05])
SEED = [10.5, 10.5]
OPT = {"tol": 1e-8, "gtol": 1e-8, "maxiter": 3}


@contextlib.contextmanager
def _one_torch_thread():
    """torch's intra-op threads at 1 for a block: the port's many small CPU
    ops otherwise wait on thread pools that other test workers hold (the
    20 x 20 quad forward: 0.46 s alone on one thread, 0.36 s on all, and
    70 s on all with five more pipelines running beside it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _port_on_one_thread():
    with _one_torch_thread():
        yield


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


def _tight(sim, jax_side):
    sim.step_config = (JaxStepConfig(**TIGHT, rd_modified_newton=False)
                       if jax_side else StepConfig(**TIGHT))


def _write_labels(d, shape, name="atlas_labels.mha"):
    path = str(d / name)
    jax_image_io.write_mha(path, jax_image_io.Image(
        jax_synthetic.brain_labelmap_3d(*shape), origin=(0, 0, 0), spacing=(1, 1, 1)))
    return path


def _frozen(x):
    if isinstance(x, dict):
        return {k: _frozen(v) for k, v in x.items()}
    if isinstance(x, np.ndarray):
        x = x.copy()
        x.setflags(write=False)
    return x


def _recording_run(sim, out):
    """Keep what ``sim.run`` returns in ``out["run_return"]``."""
    run = sim.run

    def recorded(*args, **kwargs):
        out["run_return"] = run(*args, **kwargs)
        return out["run_return"]

    sim.run = recorded


def _p2_comparison(sim_a, sim_b):
    """The comparison table of two JAX quad runs with the concentration's
    errornorm under the JAX package's P2 mass (its own Comparison applies
    the P1 mass and raises)."""
    comp = JaxComparison(sim_a, sim_b)
    steps = comp._shared_steps()
    cols = {"recording_step": np.asarray(steps)}
    for sid, name in ((0, "displacement"), (1, "concentration")):
        pairs = [(np.asarray(sim_a.results.get_result(s)[sid], np.float64),
                  np.asarray(sim_b.results.get_result(s)[sid], np.float64)) for s in steps]
        if sid == 0:
            norms = [comp.errornorm(a, b) for a, b in pairs]
        else:
            norms = [float(jnp.sqrt(jnp.sum((a - b) * np.asarray(
                sim_a.p2.mass_residual(jnp.asarray(a - b)))))) for a, b in pairs]
        cols[f"errornorm_{name}"] = np.asarray(norms)
        cols[f"maxdiff_{name}"] = np.asarray([np.abs(a - b).max() for a, b in pairs])
    return cols


def _run_atlas_quad(wf, jax_side):
    """The atlas pipeline with the quad model; returns what the tests
    compare, as numpy values."""
    out = {}
    wf.prepare_domain()
    out["points"], out["cells"] = wf.mesh.points, wf.mesh.cells
    wf.init_forward_problem(SEED, VARYING, FIXED, SIM)
    sim = wf.sims["forward"]
    _tight(sim, jax_side)
    _recording_run(sim, out)
    wf.run_forward_sim(save_method=None)
    out["degree"] = sim.CONCENTRATION_DEGREE
    out["sim_points"], out["sim_cells"] = sim.mesh.points, sim.mesh.cells
    out["sim_lattice"] = sim.mesh.lattice_strides
    perm, rank, _ = (jax_p2_dof_layout if jax_side else p2_dof_layout)(sim.mesh)
    out["perm"], out["rank"] = np.asarray(perm), np.asarray(rank)
    out["newton_iters"] = np.asarray(sim.solver_info["newton_iters"])
    res = sim.results
    out["steps"] = res.get_recording_steps()
    out["series_c"] = np.stack([res.get_result(s)[1] for s in out["steps"]])
    out["series_u"] = np.stack([res.get_result(s)[0] for s in out["steps"]])
    wf.create_target_fields()
    out["targets"] = {k: np.asarray(v) for k, v in wf._load_target_fields().items()}
    wf.init_inverse_problem(SEED, START, SIM, optimization_type=2)
    _tight(wf.sims["inverse"], jax_side)
    if jax_side:
        names, update = jax_adjoint.param_map_for_type(2)
        ip = jax_adjoint.InverseProblem(wf.sims["inverse"], names,
                                        wf._load_target_fields(), update_fn=update)
    else:
        ip = wf.inverse_problem()
    J, g = ip.value_and_grad(V0)
    out["J"], out["g"] = float(J), np.asarray(g, np.float64)
    wf.run_inverse_problem(opt_params=OPT)
    out["opt"] = dict(wf.model_params_optimized)
    wf.init_optimized_problem()
    _tight(wf.sims["optimized"], jax_side)
    wf.run_optimized_sim(save_method=None)
    out["opt_c"] = np.asarray(wf.sims["optimized"].solution[1])
    out["opt_u"] = np.asarray(wf.sims["optimized"].solution[0])
    out["stored_opt_c"] = np.asarray(
        (jax_dio if jax_side else dio).load_function_mesh(wf.path_optimized_conc)[0])
    if not jax_side:
        sims = [wf.sims[k] for k in ("forward", "inverse", "optimized")]
        out["plans"] = [(s._get_bell_plan(), s._get_p2_plan()) for s in sims]
        out["plans_built"] = [sorted(s._plan_seconds) for s in sims]
    if jax_side:
        out["comparison"] = _p2_comparison(wf.sims["forward"], wf.sims["optimized"])
    else:
        comp = wf.compare_original_optimized()["field_errors"]
        out["comparison"] = {k: np.asarray(comp[k]) for k in comp}
    frames = wf.post_process()
    out["frames"] = {m: {k: np.asarray(f[k]) for k in f} for m, f in frames.items()}
    per_step = wf.compute_volume_com_per_step("forward")
    out["frames"]["per_step"] = {k: np.asarray(per_step[k]) for k in per_step}
    out["measures"] = dict(wf.measures)
    out["paths"] = {k: os.path.relpath(getattr(wf, k), wf.base_dir) for k in (
        "path_mesh_hdf5", "path_labelfunction", "path_conc_T2", "path_conc_T1",
        "path_displacement_reconstructed", "path_optimized_conc")}
    out["base_dir"] = wf.base_dir
    return _frozen(out)


@pytest.fixture(scope="module")
def atlas_quad(tmp_path_factory):
    """Both packages' quad atlas pipelines on the same labelmap: (port, jax),
    run once a session (tests/torch_once.py) in a directory its workers
    share."""

    def run():
        d = tmp_path_factory.mktemp("atlas_quad")
        path = _write_labels(d, (20, 20, 8))
        jax_out = _run_atlas_quad(JaxAtlas(str(d / "jax"), path_to_labels_atlas=path,
                                           image_z_slice=4, model="quad"), True)
        with _one_torch_thread():
            port_out = _run_atlas_quad(ImageBasedOptimizationAtlas(
                str(d / "port"), path_to_labels_atlas=path, image_z_slice=4, model="quad",
                device="cpu", dtype=F64), False)
        return port_out, jax_out

    port_out, jax_out = once(tmp_path_factory, "workflow-atlas-quad", run)
    return _frozen(port_out), _frozen(jax_out)


def test_quad_mesh_is_the_stripped_lattice_with_the_jax_p2_layout(atlas_quad):
    """The quad sims' mesh has no lattice, the workflow mesh's points,
    cells and node order; the P2 dof numbering equals the JAX package's
    exactly."""
    got, want = atlas_quad
    assert got["degree"] == want["degree"] == 2
    assert got["sim_lattice"] is None and want["sim_lattice"] is not None
    for k in ("points", "cells", "sim_points", "sim_cells"):
        np.testing.assert_array_equal(got[k], want["points" if "points" in k else "cells"])
    np.testing.assert_array_equal(got["perm"], want["perm"])
    np.testing.assert_array_equal(got["rank"], want["rank"])


def test_quad_sims_share_the_mesh_plans(atlas_quad):
    """The forward, inverse and optimized sims of the one stripped mesh
    share its P1 and P2 supernode plans: the forward builds them, the
    others find them cached on the mesh."""
    got, _ = atlas_quad
    first = got["plans"][0]
    assert all(p[0] is first[0] and p[1] is first[1] for p in got["plans"])
    assert got["plans_built"] == [["bell_plan", "p2_plan"], [], []]


def test_quad_forward_matches_jax(atlas_quad):
    """Every recorded step (t=0 first) of the forward: c (1,521 P2 dofs)
    and u at rel-L2 1e-8."""
    got, want = atlas_quad
    assert got["steps"] == want["steps"] == [0, 1, 2]
    assert got["series_c"].shape == want["series_c"].shape == (3, 1521)
    for s in range(3):
        assert _rel(got["series_c"][s], want["series_c"][s]) <= 1e-8
        assert _rel(got["series_u"][s], want["series_u"][s]) <= 1e-8
    assert got["measures"]["forward_final_max_conc"] == pytest.approx(
        want["measures"]["forward_final_max_conc"], rel=1e-8)


def test_run_returns_the_solution_like_jax(atlas_quad):
    """``Simulation.run`` returns ``sim.solution`` (the final state) and
    records the Newton iterations a step, as the JAX package's does; the
    returned state equals the JAX package's at 1e-8."""
    got, want = atlas_quad
    ret, ret_j = got["run_return"], want["run_return"]
    assert isinstance(ret, dict) and sorted(ret) == sorted(ret_j) == [0, 1]
    for sid in (0, 1):
        assert _rel(ret[sid], ret_j[sid]) <= 1e-8
    np.testing.assert_array_equal(ret[1], got["series_c"][-1])
    assert got["newton_iters"].shape == want["newton_iters"].shape == (2,)
    assert (got["newton_iters"] > 0).all()


def test_quad_targets_and_stored_datasets_match_jax(atlas_quad):
    """The P2 thresholded targets and the displacement target at 1e-8,
    read back from each store; every dataset of the port's archives equals
    the JAX package's HDF5 dataset of the same name."""
    got, want = atlas_quad
    for k in ("conc_T2", "conc_T1", "disp"):
        assert got["targets"][k].shape == want["targets"][k].shape
        assert _rel(got["targets"][k], want["targets"][k]) <= 1e-8, k
    import h5py

    for key in ("path_mesh_hdf5", "path_conc_T2", "path_conc_T1", "path_labelfunction"):
        jpath = os.path.join(want["base_dir"], want["paths"][key])
        ppath = os.path.join(got["base_dir"], got["paths"][key])
        assert got["paths"][key] == want["paths"][key][:-3] + ".npz"
        with h5py.File(jpath, "r") as f, np.load(ppath) as z:
            names = []
            f.visititems(lambda n, o: names.append(n)
                         if isinstance(o, h5py.Dataset) else None)
            attrs = {f"mesh/{a}": np.asarray(v) for a, v in f["mesh"].attrs.items()} \
                if "mesh" in f else {}
            assert sorted(z.files) == sorted(names + list(attrs)), key
            for n in names:
                np.testing.assert_allclose(z[n], f[n][...], rtol=1e-8, atol=1e-12)


def test_quad_value_and_grad_at_v0_matches_jax(atlas_quad):
    got, want = atlas_quad
    assert got["J"] == pytest.approx(want["J"], rel=1e-8)
    np.testing.assert_allclose(got["g"], want["g"], rtol=1e-8, atol=0)


def test_quad_lbfgsb_and_optimized_rerun_match_jax(atlas_quad):
    """L-BFGS-B from (0.05, 0.05), maxiter 3: the same parameters to 1e-6,
    nearer the truth (0.1, 0.1); the optimized re-run (P2 c) and its
    stored vertex-part c at 1e-6."""
    got, want = atlas_quad
    assert set(got["opt"]) == {"D_WM", "rho_WM"}
    for k, v in want["opt"].items():
        assert got["opt"][k] == pytest.approx(float(v), rel=1e-6), k
        assert abs(got["opt"][k] - 0.1) < abs(0.05 - 0.1)
    for k in ("optimization_nit", "number_iterations_optimization"):
        assert got["measures"][k] == want["measures"][k]
    assert _rel(got["opt_c"], want["opt_c"]) <= 1e-6
    assert _rel(got["opt_u"], want["opt_u"]) <= 1e-6
    assert got["stored_opt_c"].shape == want["stored_opt_c"].shape == (400,)
    assert _rel(got["stored_opt_c"], want["stored_opt_c"]) <= 1e-6
    np.testing.assert_array_equal(got["stored_opt_c"], got["opt_c"][got["rank"][:400]])


def test_quad_comparison_takes_the_p2_errornorm(atlas_quad):
    """The forward-vs-optimized table: the concentration's errornorm under
    the P2 mass (the JAX package's P2Kernels on its own runs) at 1e-6."""
    got, want = atlas_quad
    assert list(got["comparison"]) == list(want["comparison"])
    for k, col in want["comparison"].items():
        np.testing.assert_allclose(got["comparison"][k], col, rtol=1e-6, atol=1e-12)
    assert got["comparison"]["errornorm_concentration"][-1] > 0


ROUNDOFF_VOLUME = 1e-12


def test_quad_post_process_tables_match_jax(atlas_quad):
    """The merged volume and COM tables and the per-step table, integrated
    with the P2 kernels for P2 fields: the same columns in the same order,
    values within 1e-8, NaN exactly where JAX has NaN; the target-field
    measures alike (the optimized run's stored c at 1e-6).

    A P2 vertex basis function integrates to 0 on a triangle, so a tissue
    whose threshold indicator is set at vertex dofs only has a volume of
    quadrature round-off (~2e-17 here) in both packages, and its COM is
    the ratio of two round-off terms.  Those COM entries are not compared;
    their volumes are held below ROUNDOFF_VOLUME in both packages."""
    got, want = atlas_quad
    vol, vol_j = got["frames"]["volume"], want["frames"]["volume"]
    for m in ("volume", "com", "per_step"):
        assert list(got["frames"][m]) == list(want["frames"][m]), m
        for k, col in want["frames"][m].items():
            g = got["frames"][m][k]
            np.testing.assert_array_equal(np.isnan(g), np.isnan(col))
            defined = np.ones(len(col), bool)
            if m == "com" and k != "sim_time_step":
                vk = k.replace("_com_", "_volume_").rsplit("_", 1)[0]
                defined = ~(np.abs(vol_j[vk]) <= ROUNDOFF_VOLUME)
                assert (np.abs(vol[vk][~defined]) <= ROUNDOFF_VOLUME).all(), k
            np.testing.assert_allclose(g[defined], col[defined], rtol=1e-8, atol=1e-12,
                                       err_msg=k)
    for k, v in want["measures"].items():
        if k.startswith(("volume_threshold", "com_")):
            rel = 1e-6 if k.endswith("_inverse") else 1e-8
            assert got["measures"][k] == pytest.approx(v, rel=rel), k


def test_quad_state_reloads_the_quad_model(atlas_quad):
    """A fresh object reloads the pickled state and rebuilds the quad
    model on the stripped mesh, with the forward's recorded series
    exactly."""
    got, _ = atlas_quad
    wf = ImageBasedOptimizationAtlas(got["base_dir"], device="cpu", dtype=F64)
    wf.reload_state()
    assert wf.model == "quad" and wf.mesh.lattice_strides is not None
    sim = wf.reload_forward_sim()
    assert sim.quad and sim.mesh.lattice_strides is None
    np.testing.assert_array_equal(sim.mesh.cells, got["cells"])
    assert sim.results.get_recording_steps() == got["steps"]
    for s in got["steps"]:
        np.testing.assert_array_equal(sim.results.get_result(s)[1], got["series_c"][s])
        np.testing.assert_array_equal(sim.results.get_result(s)[0], got["series_u"][s])
    opt = wf.reload_optimized_sim()
    assert opt.quad and opt.mesh is sim.mesh
    np.testing.assert_array_equal(opt.results.get_result(2)[1], got["opt_c"])


# -- the 3D full lattice: cell-free P2 vertex dofs ------------------------------


def _compacted_quad(wf, seed):
    """The quad forward on the workflow mesh with its cell-free nodes
    removed and renumbered: (sim, node map old -> new)."""
    mesh = wf.mesh
    used = np.unique(mesh.cells)
    new = np.full(mesh.n_nodes, -1, np.int64)
    new[used] = np.arange(len(used))
    sim = BrainQuad(Mesh.from_arrays(mesh.points[used], new[mesh.cells]), dtype=F64,
                    device="cpu")
    sim.setup_global_parameters(
        label_function=np.asarray(wf.labelfunction)[used], domain_names=TISSUE_MAP,
        boundaries={"boundary_all": BoundaryAll()},
        dirichlet_bcs={"clamped_boundary": {"bc_value": np.zeros(3),
                                            "named_boundary": "boundary_all",
                                            "subspace_id": 0}})
    src = wf.sims["forward"]
    sim.setup_model_parameters(iv_expression=src.params._iv_expressions,
                               **src.params.as_dict())
    _tight(sim, False)
    sim.run(save_method=None)
    return sim, new


def test_quad_3d_full_lattice_runs_with_cell_free_dofs_at_zero(tmp_path):
    """A 10 x 10 x 8 labelmap's full lattice (11 x 11 x 9 corners), quad,
    2 steps: finite, the cell-free P2 vertex dofs and u there exactly 0,
    and every other dof within rel-L2 1e-10 of the same forward on the
    mesh with those nodes removed (the JAX package gives NaN here)."""
    path = _write_labels(tmp_path, (10, 10, 8), "atlas3d.mha")
    wf = ImageBasedOptimizationAtlas(str(tmp_path / "port"), path_to_labels_atlas=path,
                                     model="quad", device="cpu", dtype=F64)
    wf.prepare_domain()
    assert wf.mesh.lattice_strides is not None and wf.mesh.n_nodes == 11 * 11 * 9
    seed = [5.5, 5.0, 4.0]
    sim = wf.init_forward_problem(seed, VARYING, FIXED, SIM)
    _tight(sim, False)
    wf.run_forward_sim(save_method=None)
    assert sim.results.get_recording_steps() == [0, 1, 2]
    c, u = sim.solution[1], sim.solution[0]
    assert np.isfinite(c).all() and np.isfinite(u).all() and c.max() > 0.1
    unused = sim._unused_node_mask()
    assert unused.any()
    vdofs = sim.p2.vertex_dof_ids(np.flatnonzero(unused))
    assert not c[vdofs].any() and not u[unused].any()

    ref, new = _compacted_quad(wf, seed)
    used = np.flatnonzero(~unused)
    edges = sim.mesh.edges()[0]
    eid = ref.mesh.edge_ids_for_pairs(new[edges])
    dofs = np.concatenate([sim.p2.vertex_dof_ids(used), sim.p2.edge_dof_ids(
        np.arange(len(edges)))])
    dofs_ref = np.concatenate([ref.p2.vertex_dof_ids(new[used]), ref.p2.edge_dof_ids(eid)])
    assert len(dofs_ref) == ref.p2.n_dofs == sim.p2.n_dofs - unused.sum()
    assert _rel(c[dofs], ref.solution[1][dofs_ref]) <= 1e-10
    assert _rel(u[used], ref.solution[0][new[used]]) <= 1e-10


# -- the repairs ------------------------------------------------------------------


def test_xdmf_without_h5py_raises_before_the_simulate(monkeypatch, tmp_path):
    """``run(save_method="xdmf")`` where h5py does not import raises before
    any step runs, naming the other choices."""
    sim = examples.rect_sim(n=4, dtype=F64, device="cpu")
    built = []
    monkeypatch.setattr(sim, "build_simulate_fn", lambda *a, **k: built.append(a))
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match=r'save_method="vtk".* or None'):
        sim.run(save_method="xdmf", output_dir=str(tmp_path / "out"))
    assert not built


@pytest.mark.parametrize("stage", ["forward", "optimized"])
def test_frozen_workflow_run_raises_and_names_the_cap(tmp_path, stage):
    """A workflow run whose step did not converge (every CG solve capped
    at 2 iterations) raises, naming the step and step_config.cg_maxiter."""
    path = _write_labels(tmp_path, (20, 20, 8))
    wf = ImageBasedOptimizationAtlas(str(tmp_path / "wf"), path_to_labels_atlas=path,
                                     image_z_slice=4, device="cpu", dtype=F64)
    wf.prepare_domain()
    sim = wf.init_forward_problem(SEED, VARYING, FIXED, SIM)
    run = wf.run_forward_sim
    if stage == "optimized":
        wf.run_forward_sim(save_method=None)
        wf.init_inverse_problem(SEED, START, SIM, optimization_type=2)
        wf.model_params_optimized = {"D_WM": 0.1, "rho_WM": 0.1}
        sim = wf.init_optimized_problem()
        run = wf.run_optimized_sim
    sim.step_config = StepConfig(**TIGHT, cg_maxiter=2)
    with pytest.raises(RuntimeError, match=r"step 1 of 2.*cg_maxiter = 2"):
        run(save_method=None)


def test_stencil_operators_point_to_the_unstructured_lane():
    """A mesh without lattice structure: the message names ops/bell.py and
    no longer calls the unstructured lane unported."""
    m = rectangle_mesh((-5, -5), (5, 5), 4, 4)
    with pytest.raises(NotImplementedError) as err:
        StencilOperators(Mesh.from_arrays(m.points, m.cells))
    assert "ops/bell.py" in str(err.value) and "not ported" not in str(err.value)


def test_patient_pipeline_refuses_quad(tmp_path):
    """The patient's segmentation targets are P1 and the quad model's c is
    P2: the inverse problem is refused with a clear error (the JAX package
    fails there on the shapes)."""
    wf = ImageBasedOptimizationPatient(str(tmp_path / "wf"), device="cpu", dtype=F64)
    wf.model = "quad"
    with pytest.raises(NotImplementedError, match="model='linear'"):
        wf.init_inverse_problem(SEED, START, SIM, model_params_fixed=FIXED,
                                optimization_type=2)
