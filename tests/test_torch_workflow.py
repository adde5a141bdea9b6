"""Port parity for the image-based optimization workflow: the atlas
pipeline (2D slice and 3D full lattice) and the patient pipeline of
glimslib_tpu_torch against the JAX package's, at f64 on the CPU.

The JAX package's tests' sizes: ``brain_labelmap_3d(20, 20, 8)`` sliced at
z=4 (a 20 x 20 pixel lattice) and a 10 x 10 x 8 labelmap meshed as a full
lattice.  The simulations take tight tolerances on both sides
(newton_rtol 1e-10, cg_rtol 1e-12; the JAX package's exact Newton, as the
port's lattice lane runs it).  Tolerances: meshes, labels and paths
exact; the forward's c and u, the target fields and the stored datasets,
J and the gradient at v0 1e-8; the parameters after L-BFGS-B (maxiter 5),
the optimized re-run and the Comparison errornorms 1e-6; the post_process
tables the same column names, values within 1e-8 and NaN where JAX has
NaN.  Each pipeline runs whole once a module (a fixture returning
read-only arrays), so no test depends on another having run.
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import jax
import torch

from glimslib_tpu.optimize import adjoint as jax_adjoint
from glimslib_tpu.solvers.coupled import StepConfig as JaxStepConfig
from glimslib_tpu.utils import image_io as jax_image_io
from glimslib_tpu.utils import synthetic as jax_synthetic
from glimslib_tpu.workflow.image_based_optimization_atlas import (
    ImageBasedOptimizationAtlas as JaxAtlas,
)
from glimslib_tpu.workflow.image_based_optimization_patient import (
    ImageBasedOptimizationPatient as JaxPatient,
)
from glimslib_tpu_torch.solvers.coupled import StepConfig
from glimslib_tpu_torch.workflow.image_based_optimization_atlas import (
    ImageBasedOptimizationAtlas,
)
from glimslib_tpu_torch.workflow.image_based_optimization_patient import (
    ImageBasedOptimizationPatient,
)
from torch_once import once  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIGHT = dict(newton_rtol=1e-10, newton_atol=1e-14, cg_rtol=1e-12)
F64 = torch.float64
FIXED = dict(E_GM=3e3, E_WM=3e3, E_CSF=1e3, E_VENT=1e3,
             nu_GM=0.45, nu_WM=0.45, nu_CSF=0.45, nu_VENT=0.3)
VARYING = dict(D_WM=0.1, D_GM=0.02, rho_WM=0.1, rho_GM=0.02, coupling=0.15)
SIM = dict(sim_time=2, sim_time_step=1, seed_width=1.5)
START = dict(VARYING, D_WM=0.05, rho_WM=0.05)
V0 = np.array([0.05, 0.05])
SEED = [10.5, 10.5]
OPT = {"tol": 1e-8, "gtol": 1e-8, "maxiter": 5}


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


def _tight(sim, jax_side):
    sim.step_config = (JaxStepConfig(**TIGHT, rd_modified_newton=False)
                       if jax_side else StepConfig(**TIGHT))


def _write_atlas(d):
    lab = jax_synthetic.brain_labelmap_3d(20, 20, 8)
    t1 = jax_synthetic.t1_from_labels(lab)
    paths = {"labels": str(d / "atlas_labels.mha"), "t1": str(d / "atlas_t1.mha")}
    jax_image_io.write_mha(paths["labels"], jax_image_io.Image(
        lab, origin=(0, 0, 0), spacing=(1, 1, 1)))
    jax_image_io.write_mha(paths["t1"], jax_image_io.Image(
        np.asarray(t1, np.float32), origin=(0, 0, 0), spacing=(1, 1, 1)))
    return paths


def _frozen(x):
    if isinstance(x, dict):
        return {k: _frozen(v) for k, v in x.items()}
    if isinstance(x, np.ndarray):
        x = x.copy()
        x.setflags(write=False)
    return x


def _run_atlas(wf, jax_side):
    """The atlas pipeline at the JAX tests' settings; returns what the
    tests compare, as numpy values."""
    out = {}
    wf.prepare_domain()
    out["points"], out["cells"] = wf.mesh.points, wf.mesh.cells
    out["lattice"] = wf.mesh.lattice_strides
    out["labels"] = np.asarray(wf.labelfunction)
    wf.init_forward_problem(SEED, VARYING, FIXED, SIM)
    _tight(wf.sims["forward"], jax_side)
    wf.run_forward_sim(save_method=None)
    res = wf.sims["forward"].results
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
    comp = wf.compare_original_optimized()["field_errors"]
    out["comparison"] = {k: np.asarray(comp[k]) for k in comp}
    frames = wf.post_process()
    out["frames"] = {m: {k: np.asarray(f[k]) for k in f} for m, f in frames.items()}
    per_step = wf.compute_volume_com_per_step("forward")
    out["frames"]["per_step"] = {k: np.asarray(per_step[k]) for k in per_step}
    out["measures"] = dict(wf.measures)
    out["paths"] = {k: os.path.relpath(getattr(wf, k), wf.base_dir) for k in (
        "path_mesh_hdf5", "path_labelfunction", "path_conc_T2", "path_conc_T1",
        "path_displacement_reconstructed", "path_parameters_optimized",
        "path_optimized_conc", "path_optimized_disp")}
    out["base_dir"] = wf.base_dir
    return _frozen(out)


@pytest.fixture(scope="module")
def atlas(tmp_path_factory):
    """Both packages' atlas pipelines on the same labelmap: (port, jax), run
    once a session (tests/torch_once.py) in a directory its workers share."""

    def run():
        d = tmp_path_factory.mktemp("atlas")
        paths = _write_atlas(d)
        jax_out = _run_atlas(JaxAtlas(str(d / "jax"), path_to_labels_atlas=paths["labels"],
                                      image_z_slice=4), True)
        port_out = _run_atlas(ImageBasedOptimizationAtlas(
            str(d / "port"), path_to_labels_atlas=paths["labels"], image_z_slice=4,
            device="cpu", dtype=F64), False)
        return port_out, jax_out

    port_out, jax_out = once(tmp_path_factory, "workflow-atlas", run)
    return _frozen(port_out), _frozen(jax_out)


def test_domain_and_paths_equal_the_jax_packages(atlas):
    """The 20 x 20 pixel lattice, its labels (tissue 0 kept) and every
    path of the state, exactly; the port's store swaps .h5 for .npz."""
    got, want = atlas
    np.testing.assert_array_equal(got["points"], want["points"])
    np.testing.assert_array_equal(got["cells"], want["cells"])
    assert got["lattice"] == want["lattice"] is not None
    np.testing.assert_array_equal(got["labels"], want["labels"])
    assert 0 in set(np.unique(got["labels"]))
    for k, p in want["paths"].items():
        if p.endswith(".h5"):
            p = p[:-3] + ".npz"
        assert got["paths"][k] == p, k


def test_forward_matches_jax(atlas):
    """Every recorded step (t=0 first) of the forward at rel-L2 1e-8."""
    got, want = atlas
    assert got["steps"] == want["steps"] == [0, 1, 2]
    for s in range(3):
        assert _rel(got["series_c"][s], want["series_c"][s]) <= 1e-8
        assert _rel(got["series_u"][s], want["series_u"][s]) <= 1e-8
    assert got["measures"]["forward_final_max_conc"] == pytest.approx(
        want["measures"]["forward_final_max_conc"], rel=1e-8)


def test_target_fields_and_stored_datasets_match_jax(atlas):
    """The thresholded targets and the displacement target at 1e-8, read
    back from each package's store; every dataset of the port's archives
    equals the JAX package's HDF5 dataset of the same name."""
    got, want = atlas
    for k in ("conc_T2", "conc_T1", "disp"):
        assert _rel(got["targets"][k], want["targets"][k]) <= 1e-8, k
    import h5py

    for key in ("path_mesh_hdf5", "path_conc_T2", "path_labelfunction"):
        jpath = os.path.join(want["base_dir"], want["paths"][key])
        ppath = os.path.join(got["base_dir"], got["paths"][key])
        with h5py.File(jpath, "r") as f, np.load(ppath) as z:
            names = []
            f.visititems(lambda n, o: names.append(n)
                         if isinstance(o, h5py.Dataset) else None)
            attrs = {f"mesh/{a}": np.asarray(v) for a, v in f["mesh"].attrs.items()} \
                if "mesh" in f else {}
            assert sorted(z.files) == sorted(names + list(attrs)), key
            for n in names:
                np.testing.assert_allclose(z[n], f[n][...], rtol=1e-8, atol=1e-12)
            for n, v in attrs.items():
                np.testing.assert_array_equal(z[n], v)


def test_value_and_grad_at_v0_matches_jax(atlas):
    got, want = atlas
    assert got["J"] == pytest.approx(want["J"], rel=1e-8)
    np.testing.assert_allclose(got["g"], want["g"], rtol=1e-8, atol=0)


def test_lbfgsb_parameters_match_jax(atlas):
    """L-BFGS-B from (0.05, 0.05), maxiter 5: the same parameters to 1e-6,
    moved toward the truth (0.1, 0.1)."""
    got, want = atlas
    assert set(got["opt"]) == {"D_WM", "rho_WM"}
    for k, v in want["opt"].items():
        assert got["opt"][k] == pytest.approx(float(v), rel=1e-6), k
        assert abs(got["opt"][k] - 0.1) < abs(0.05 - 0.1)
    for k in ("optimization_nit", "number_iterations_optimization"):
        assert got["measures"][k] == want["measures"][k]


def test_optimized_rerun_and_comparison_match_jax(atlas):
    got, want = atlas
    assert _rel(got["opt_c"], want["opt_c"]) <= 1e-6
    assert _rel(got["opt_u"], want["opt_u"]) <= 1e-6
    assert list(got["comparison"]) == list(want["comparison"])
    for k, col in want["comparison"].items():
        np.testing.assert_allclose(got["comparison"][k], col, rtol=1e-6, atol=1e-12)
    for k, v in want["measures"]["param_relative_errors"].items():
        assert got["measures"]["param_relative_errors"][k] == pytest.approx(
            float(v), rel=1e-5)


def test_post_process_tables_match_jax(atlas):
    """The merged volume and COM tables (and the per-step convenience
    table): the same columns in the same order, values within 1e-8, NaN
    exactly where JAX has NaN (the empty tissues' COM); the target-field
    measures alike."""
    got, want = atlas
    for m in ("volume", "com", "per_step"):
        assert list(got["frames"][m]) == list(want["frames"][m]), m
        for k, col in want["frames"][m].items():
            g = got["frames"][m][k]
            np.testing.assert_array_equal(np.isnan(g), np.isnan(col))
            np.testing.assert_allclose(g, col, rtol=1e-8, atol=1e-12)
    assert np.isnan(got["frames"]["com"]["forward_com_0.12_outside_0"]).all()
    for k, v in want["measures"].items():
        if k.startswith(("volume_threshold", "com_")):
            assert got["measures"][k] == pytest.approx(v, rel=1e-8), k


def _plain_values(x):
    """True when ``x`` holds only Python and numpy values."""
    if isinstance(x, dict):
        return all(_plain_values(k) and _plain_values(v) for k, v in x.items())
    if isinstance(x, (list, tuple)):
        return all(_plain_values(v) for v in x)
    return x is None or isinstance(x, (str, bool, int, float, np.generic, np.ndarray))


def test_state_reloads_in_a_fresh_object(atlas):
    """The pickled state holds Python and numpy values only; a fresh
    object reloads it, the domain and the forward's recorded series,
    exactly, and the analysis files are where the reference writes
    them."""
    got, _ = atlas
    base = got["base_dir"]
    with open(os.path.join(base, "state.pkl"), "rb") as f:
        state = pickle.load(f)
    assert _plain_values(state), state
    wf = ImageBasedOptimizationAtlas(base, device="cpu", dtype=F64)
    wf.reload_state()
    assert wf.image_z_slice == 4 and wf.model_params_optimized == got["opt"]
    np.testing.assert_array_equal(wf.mesh.points, got["points"])
    assert wf.mesh.lattice_strides == got["lattice"]
    sim = wf.reload_forward_sim()
    assert sim.results.get_recording_steps() == got["steps"]
    for s in got["steps"]:
        np.testing.assert_array_equal(sim.results.get_result(s)[1], got["series_c"][s])
        np.testing.assert_array_equal(sim.results.get_result(s)[0], got["series_u"][s])
    for name in ("volume.pkl", "volume.csv", "com.pkl", "com.csv",
                 "02_forward_simulation/volume_0.12.pkl",
                 "02_inverse_simulation/optimization_progress_parameterset.csv",
                 "comparison/comparison.pkl"):
        assert os.path.exists(os.path.join(base, name)), name
    with open(os.path.join(base, "volume.pkl"), "rb") as f:
        vol = pickle.load(f)
    with open(os.path.join(base, "volume.csv")) as f:
        header = f.readline().strip().split(",")
    csv = np.loadtxt(os.path.join(base, "volume.csv"), delimiter=",", skiprows=1)
    assert header == list(vol)
    for j, name in enumerate(header):
        np.testing.assert_array_equal(csv[:, j], vol[name])


def test_reconstructed_displacement_targets_match_jax(tmp_path):
    """create_target_fields(reconstruct_displacement=True): the T1 image
    warped by the simulated displacement, registered back by the demons
    fallback and sampled at the nodes, against the JAX package's at
    1e-8."""
    paths = _write_atlas(tmp_path)
    varying = dict(VARYING, coupling=1.0, rho_WM=0.3, rho_GM=0.06)
    out = []
    for jax_side, wf in ((True, JaxAtlas(str(tmp_path / "jax"),
                                         path_to_labels_atlas=paths["labels"],
                                         path_to_image_atlas=paths["t1"],
                                         image_z_slice=4)),
                         (False, ImageBasedOptimizationAtlas(
                             str(tmp_path / "port"), path_to_labels_atlas=paths["labels"],
                             path_to_image_atlas=paths["t1"], image_z_slice=4,
                             device="cpu", dtype=F64))):
        wf.prepare_domain()
        wf.init_forward_problem(SEED, varying, FIXED, dict(SIM, sim_time=4))
        _tight(wf.sims["forward"], jax_side)
        wf.run_forward_sim(save_method=None)
        wf.create_target_fields(reconstruct_displacement=True)
        assert os.path.exists(os.path.join(wf.path_target_fields,
                                           "atlas_labels_deformed.mha"))
        out.append((wf._load_target_fields()["disp"],
                    np.asarray(wf.sims["forward"].solution[0]),
                    wf.compare_displacement_field_simulated_registered()))
    (disp_j, true_j, err_j), (disp_p, true_p, err_p) = out
    assert _rel(true_p, true_j) <= 1e-8
    assert _rel(disp_p, disp_j) <= 1e-8
    assert err_p == pytest.approx(err_j, rel=1e-8)
    assert np.corrcoef(disp_p.ravel(), true_p.ravel())[0, 1] > 0.5


def test_patient_targets_match_jax(tmp_path):
    """The patient pipeline as tests/test_workflow_patient.py builds it:
    registration fallback, the domain, and the T2 / T1 targets from the
    segmentation at 1e-8; a zero displacement target."""
    lab = jax_synthetic.brain_labelmap_3d(20, 20, 8)
    t1 = jax_synthetic.t1_from_labels(lab)
    seg = np.zeros_like(lab)
    seg[3:6, 8:14, 8:14] = 6
    seg[4:5, 10:12, 10:12] = 5
    paths = {}
    for name, arr in [("atlas_labels", lab), ("atlas_t1", t1),
                      ("patient_t1", t1), ("patient_seg", seg)]:
        paths[name] = str(tmp_path / f"{name}.mha")
        jax_image_io.write_mha(paths[name], jax_image_io.Image(
            np.ascontiguousarray(arr), origin=(0, 0, 0), spacing=(1, 1, 1)))
    kw = dict(path_to_labels_atlas=paths["atlas_labels"],
              path_to_image_atlas=paths["atlas_t1"],
              path_to_image_patient=paths["patient_t1"],
              path_to_labels_patient=paths["patient_seg"], image_z_slice=4)
    wf_j = JaxPatient(str(tmp_path / "jax"), **kw)
    wf_p = ImageBasedOptimizationPatient(str(tmp_path / "port"), device="cpu",
                                         dtype=F64, **kw)
    for wf in (wf_j, wf_p):
        wf.prepare_domain(use_registration=True)
    np.testing.assert_array_equal(wf_p.mesh.points, wf_j.mesh.points)
    np.testing.assert_array_equal(wf_p.labelfunction, wf_j.labelfunction)
    cT2_j, cT1_j = wf_j.create_target_fields()
    cT2_p, cT1_p = wf_p.create_target_fields()
    assert cT2_p.max() > 0.5 and cT1_p.sum() <= cT2_p.sum()
    assert _rel(cT2_p, cT2_j) <= 1e-8 and _rel(cT1_p, cT1_j) <= 1e-8
    t_p = wf_p._load_target_fields()
    assert _rel(t_p["conc_T2"], cT2_j) <= 1e-8
    assert not t_p["disp"].any() and t_p["disp"].shape == (400, 2)


def test_3d_full_lattice_forward_matches_jax(tmp_path):
    """A 10 x 10 x 8 labelmap meshed as a full lattice (11 x 11 x 9
    corners): the mesh and labels exactly, the corners no cell touches
    masked as the JAX package masks them, and a 2-step forward at
    rel-L2 1e-8."""
    lab = jax_synthetic.brain_labelmap_3d(10, 10, 8)
    path = str(tmp_path / "atlas3d.mha")
    jax_image_io.write_mha(path, jax_image_io.Image(lab, origin=(0, 0, 0),
                                                    spacing=(1, 1, 1)))
    sims = []
    for jax_side, wf in ((True, JaxAtlas(str(tmp_path / "jax"), path_to_labels_atlas=path)),
                         (False, ImageBasedOptimizationAtlas(
                             str(tmp_path / "port"), path_to_labels_atlas=path,
                             device="cpu", dtype=F64))):
        wf.prepare_domain()
        wf.init_forward_problem([5.5, 5.0, 4.0], VARYING, FIXED, SIM)
        _tight(wf.sims["forward"], jax_side)
        wf.run_forward_sim(save_method=None)
        sims.append(wf.sims["forward"])
    sj, sp = sims
    np.testing.assert_array_equal(sp.mesh.points, sj.mesh.points)
    np.testing.assert_array_equal(sp.mesh.cells, sj.mesh.cells)
    assert sp.mesh.lattice_strides == sj.mesh.lattice_strides
    assert sp.mesh.n_nodes == 11 * 11 * 9
    np.testing.assert_array_equal(sp.subdomains.cell_labels, sj.subdomains.cell_labels)
    masked = sp._unused_node_mask()
    assert masked.any()
    np.testing.assert_array_equal(masked, np.asarray(sj._unused_node_mask()))
    assert _rel(sp.solution[1], sj.solution[1]) <= 1e-8
    assert _rel(sp.solution[0], sj.solution[0]) <= 1e-8
    assert not sp.solution[1][masked].any() and not sp.solution[0][masked].any()


def test_workflow_needs_cuda_without_device(monkeypatch, tmp_path):
    """No device given: the card, which raises without CUDA."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        ImageBasedOptimizationAtlas(str(tmp_path))


_NO_H5_PANDAS = """
import sys, tempfile, os
sys.modules["h5py"] = None
sys.modules["pandas"] = None
import numpy as np, torch
from glimslib_tpu_torch.utils.image_io import Image, write_mha
from glimslib_tpu_torch.utils.synthetic import brain_labelmap_3d
from glimslib_tpu_torch.workflow.image_based_optimization_atlas import (
    ImageBasedOptimizationAtlas)
d = tempfile.mkdtemp()
p = os.path.join(d, "a.mha")
write_mha(p, Image(brain_labelmap_3d(12, 12, 4), origin=(0, 0, 0), spacing=(1, 1, 1)))
wf = ImageBasedOptimizationAtlas(os.path.join(d, "wf"), path_to_labels_atlas=p,
                                 image_z_slice=2, device="cpu", dtype=torch.float64)
wf.prepare_domain()
wf.init_forward_problem([6.0, 6.0], {VARYING}, {FIXED}, dict(sim_time=1, sim_time_step=1))
wf.run_forward_sim(save_method="vtk")
wf.create_target_fields()
wf.init_inverse_problem([6.0, 6.0], {VARYING}, dict(sim_time=1, sim_time_step=1),
                        optimization_type=2)
wf.run_inverse_problem(opt_params={{"maxiter": 1}})
wf.init_optimized_problem()
wf.run_optimized_sim(save_method="vtk")
wf.compare_original_optimized()
wf.post_process()
wf.sims["forward"].init_postprocess(os.path.join(d, "pp")).save_all()
print("OK")
"""


def test_workflow_path_imports_neither_h5py_nor_pandas():
    """The whole atlas pipeline, vtk output, analysis and save_all run in a
    process where importing h5py or pandas fails."""
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    script = _NO_H5_PANDAS.format(VARYING=VARYING, FIXED=FIXED)
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and "OK" in proc.stdout, proc.stdout + proc.stderr
