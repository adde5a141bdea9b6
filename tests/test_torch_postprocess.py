"""Port parity for post-processing: ``PostProcess``,
``PostProcessTumorGrowth``, ``PostProcessTumorGrowthBrain`` and
``Comparison`` of glimslib_tpu_torch against the JAX package's, on the
same loaded results, at f64 on the CPU.

Two loaded results: the JAX package's analytic state (a uniform strain
u = (a x, b y) and a linear concentration on a 6 x 6 rectangle,
tests/test_postprocess.py) and a 2-step brain-model forward on a 20 x 20
atlas slice (tissues 0-4).  Every derived field (strain, stress, pressure,
von Mises, traction, Jacobians, growth-induced strain and Jacobian, the
concentration in the deformed configuration, logistic growth, the
lumped projection to nodes) agrees to 1e-10, max abs relative to the
field's scale.
"""

import os

import numpy as np
import pytest
import jax
import torch

from glimslib_tpu.core.functionspace import FunctionSpace as JaxFunctionSpace
from glimslib_tpu.core.mesh import rectangle_mesh as jax_rectangle_mesh
from glimslib_tpu.core.results import Results as JaxResults
from glimslib_tpu.models.tumor_growth_brain import TumorGrowthBrain as JaxBrain
from glimslib_tpu.postprocess import Comparison as JaxComparison
from glimslib_tpu.postprocess import PostProcess as JaxPostProcess
from glimslib_tpu.postprocess import (
    PostProcessTumorGrowthBrain as JaxPostProcessBrain,
)
from glimslib_tpu_torch.core.functionspace import FunctionSpace
from glimslib_tpu_torch.core.mesh import rectangle_mesh
from glimslib_tpu_torch.core.results import Results
from glimslib_tpu_torch.postprocess import Comparison, PostProcess
from glimslib_tpu_torch.utils import vtk_utils
from glimslib_tpu_torch.utils.image_io import Image, write_mha
from glimslib_tpu_torch.utils.synthetic import brain_labelmap_3d
from glimslib_tpu_torch.workflow.image_based_optimization import BoundaryAll, TISSUE_MAP
from glimslib_tpu_torch.workflow.image_based_optimization_atlas import (
    ImageBasedOptimizationAtlas,
)
from torch_threads import one_torch_thread  # noqa: E402,F401

NAMES = {0: "displacement", 1: "concentration"}
FIXED = dict(E_GM=3e3, E_WM=3e3, E_CSF=1e3, E_VENT=1e3,
             nu_GM=0.45, nu_WM=0.45, nu_CSF=0.45, nu_VENT=0.3)
VARYING = dict(D_WM=0.1, D_GM=0.02, rho_WM=0.1, rho_GM=0.02, coupling=0.15)


def _close(got, want, tol=1e-10):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-300)
    assert float(np.abs(got - want).max()) <= tol * scale


def _analytic_pair(tmp_path):
    """Uniform strain and a linear concentration on a 6 x 6 rectangle,
    recorded at step 1 in both packages' Results."""
    a, b = 0.02, -0.01
    out = []
    for mk, FS, R in ((rectangle_mesh, FunctionSpace, Results),
                      (jax_rectangle_mesh, JaxFunctionSpace, JaxResults)):
        mesh = mk((0, 0), (2, 2), 6, 6)
        fs = FS(mesh)
        fs.init_function_space([(1, 1), (0, 1)], NAMES)
        res = R(fs, output_dir=str(tmp_path))
        u = np.stack([a * mesh.points[:, 0], b * mesh.points[:, 1]], axis=1)
        res.add_to_results(1.0, 1, 1, {0: u, 1: 0.25 * mesh.points[:, 0]})
        out.append(res)
    return out


_MU_LAM = (np.linspace(1.0, 2.0, 72), 2.0)
_ANALYTIC = {
    "get_strain_tensor": (),
    "get_stress_tensor": _MU_LAM,
    "get_pressure": _MU_LAM,
    "get_van_mises_stress": _MU_LAM,
    "get_total_jacobian": (),
    "get_traction_force": _MU_LAM,
    "get_displacement_norm": (),
}


@pytest.mark.parametrize("name", list(_ANALYTIC))
def test_postprocess_fields_equal_jax(tmp_path, name):
    res, res_j = _analytic_pair(tmp_path)
    pp, pp_j = PostProcess(res), JaxPostProcess(res_j)
    _close(getattr(pp, name)(1, *_ANALYTIC[name]),
           getattr(pp_j, name)(1, *_ANALYTIC[name]))


def test_cell_to_node_and_deformed_mesh_equal_jax(tmp_path):
    res, res_j = _analytic_pair(tmp_path)
    pp, pp_j = PostProcess(res), JaxPostProcess(res_j)
    eps = pp.get_strain_tensor(1)
    _close(pp.cell_to_node(eps), pp_j.cell_to_node(eps))
    _close(pp.cell_to_node(eps[:, 0, 0]), pp_j.cell_to_node(eps[:, 0, 0]))
    np.testing.assert_array_equal(pp.deformed_mesh(1).points, pp_j.deformed_mesh(1).points)
    pts = pp.mesh.points.copy()
    pp.update_mesh_displacement(1)
    assert not np.array_equal(pp.mesh.points, pts)
    pp.update_mesh_displacement(1, reverse=True)
    np.testing.assert_array_equal(pp.mesh.points, pts)


@pytest.fixture(scope="module")
def brain(tmp_path_factory):
    """A 2-step brain-model forward (f64, CPU) on the 20 x 20 slice of
    brain_labelmap_3d(20, 20, 8); the port's sim and postprocessor, and the
    JAX package's postprocessor on the same recorded fields and
    parameters."""
    d = tmp_path_factory.mktemp("brain")
    p = str(d / "atlas.mha")
    write_mha(p, Image(brain_labelmap_3d(20, 20, 8), origin=(0, 0, 0), spacing=(1, 1, 1)))
    wf = ImageBasedOptimizationAtlas(str(d / "wf"), path_to_labels_atlas=p,
                                     image_z_slice=4, device="cpu", dtype=torch.float64)
    wf.prepare_domain()
    wf.init_forward_problem([10.5, 10.5], VARYING, FIXED,
                            dict(sim_time=2, sim_time_step=1, seed_width=1.5))
    sim = wf.run_forward_sim(save_method=None)
    pp = sim.init_postprocess(str(d / "pp"))

    sim_j = JaxBrain(wf.mesh)
    sim_j.setup_global_parameters(
        label_function=wf.labelfunction, domain_names=TISSUE_MAP,
        boundaries={"boundary_all": BoundaryAll()},
        dirichlet_bcs={"clamped_boundary": {"bc_value": np.zeros(2),
                                            "named_boundary": "boundary_all",
                                            "subspace_id": 0}})
    sim_j.setup_model_parameters(iv_expression={0: np.zeros(2), 1: 0.0}, sim_time=2,
                                 sim_time_step=1, **FIXED, **VARYING)
    res_j = JaxResults(sim_j.functionspace, sim_j.subdomains)
    for rs in sim.results.get_recording_steps():
        obs = sim.results.data.get_time_series("solution").get_observation(rs)
        res_j.add_to_results(obs.time, obs.time_step, rs, obs.fields)
    return sim, pp, JaxPostProcessBrain(res_j, sim_j.params), res_j


@pytest.mark.parametrize("name", [
    "get_stress", "get_pressure_field", "get_van_mises", "get_growth_logistic",
    "get_growth_induced_strain", "get_growth_induced_jacobian",
    "get_concentration_deformed", "get_total_jacobian",
])
def test_brain_postprocess_fields_equal_jax(brain, name):
    """The brain model's per-tissue material (tissue 0's fixed E and nu
    included) and the growth fields at the last recorded step."""
    _, pp, pp_j, _ = brain
    _close(getattr(pp, name)(2), getattr(pp_j, name)(2))


def test_brain_save_all_and_comparison(brain, tmp_path):
    """save_all writes a VTU a step and the PVD series (the von Mises field
    equal to the JAX package's projection); Comparison's errornorms equal
    the JAX package's at 1e-10; plot_all and run(plot=True) write a PNG a
    field a step under the reference's names."""
    sim, pp, pp_j, res_j = brain
    out = pp.save_all(output_dir=str(tmp_path))
    steps = sim.results.get_recording_steps()
    assert sorted(os.listdir(out)) == ["postprocess.pvd"] + [
        f"postprocess_{rs:06d}.vtu" for rs in steps]
    _, _, pd, _ = vtk_utils.read_vtu(os.path.join(out, "postprocess_000002.vtu"))
    _close(pd["van_mises"], pp_j.cell_to_node(pp_j.get_van_mises(2)))
    shifted = Results(sim.functionspace, sim.subdomains)
    shifted_j = JaxResults(res_j._functionspace, res_j._subdomains)
    for rs in steps:
        u, c = sim.results.get_result(rs)[0], sim.results.get_result(rs)[1]
        for r in (shifted, shifted_j):
            r.add_to_results(float(rs), rs, rs, {0: 1.1 * u, 1: c ** 2})
    cols = Comparison(sim, shifted).compare()
    df = JaxComparison(res_j, shifted_j).compare()
    assert list(cols) == list(df.columns)
    for k in cols:
        _close(cols[k], df[k].to_numpy())
    plots = pp.plot_all(output_dir=str(tmp_path / "plots"))
    assert sorted(os.listdir(plots)) == sorted(
        f"{k}_reference_{rs:04d}.png" for k in ("conc", "disp") for rs in steps)
    assert all(os.path.getsize(os.path.join(plots, f)) > 0 for f in os.listdir(plots))
    saved = sim.results, sim.solution, sim.solver_info
    try:
        sim.run(save_method=None, plot=True, output_dir=str(tmp_path / "run"))
    finally:
        sim.results, sim.solution, sim.solver_info = saved
    plots = tmp_path / "run" / "plots"
    assert sorted(os.listdir(plots)) == sorted(
        f"{nm}_{rs:04d}.png" for nm in ("concentration", "displacement") for rs in steps)
    assert all(os.path.getsize(plots / f) > 0 for f in os.listdir(plots))
