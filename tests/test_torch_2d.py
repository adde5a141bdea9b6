"""Port parity for the 2D models: the rectangle lattice forward (d=2
stencils and solves), the scipy FEM, the copied image and mesh utilities,
and the reduced-domain 2D atlas inverse problem (the unstructured lane in
2D) of glimslib_tpu_torch against the JAX package, at f64 on the CPU.

Both packages converge the same discrete systems with tight tolerances
(newton_rtol 1e-10, cg_rtol 1e-12): 3-step forwards agree to rel-L2 1e-8
with equal Newton counts, the atlas problem's J and gradient to rel 1e-8.
The 50 x 50 uniform case agrees with the independent scipy FEM
(tests/reference_fem.py) to rel-L2 1e-6, as tests/test_northstar.py holds
the JAX package.  The copies of the JAX package's numpy utilities give
the same meshes and labels, exactly, and their code is the reference's,
byte for byte apart from imports.
"""

import inspect
import os
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from glimslib_tpu.core.mesh import rectangle_mesh as jax_rectangle_mesh  # noqa: E402
from glimslib_tpu.core.subdomains import SubDomains as JaxSubDomains  # noqa: E402
from glimslib_tpu.models.tumor_growth import TumorGrowth as JaxTumorGrowth  # noqa: E402
from glimslib_tpu.models.tumor_growth_brain import TumorGrowthBrain as JaxBrain  # noqa: E402
from glimslib_tpu.optimize import adjoint as jax_adjoint  # noqa: E402
from glimslib_tpu.solvers.coupled import StepConfig as JaxStepConfig  # noqa: E402
from glimslib_tpu.core import bcs as jax_bcs  # noqa: E402
from glimslib_tpu.core import results as jax_results  # noqa: E402
from glimslib_tpu.models import tumor_growth as jax_tg  # noqa: E402
from glimslib_tpu.models import tumor_growth_brain as jax_tgb  # noqa: E402
from glimslib_tpu.optimize import lbfgsb as jax_lbfgsb  # noqa: E402
from glimslib_tpu.utils import data_io as jax_dio  # noqa: E402
from glimslib_tpu.utils import file_utils as jax_file_utils  # noqa: E402
from glimslib_tpu.utils import image_io as jax_image_io  # noqa: E402
from glimslib_tpu.utils import image_registration_utils as jax_reg  # noqa: E402
from glimslib_tpu.utils import interpolation as jax_interp  # noqa: E402
from glimslib_tpu.utils import meshing as jax_meshing  # noqa: E402
from glimslib_tpu.utils import synthetic as jax_synthetic  # noqa: E402
from glimslib_tpu.utils import vtk_utils as jax_vtk  # noqa: E402
from glimslib_tpu.utils import profiling as jax_profiling  # noqa: E402
from glimslib_tpu.visualisation import helpers as jax_helpers  # noqa: E402
from glimslib_tpu.visualisation import plotting as jax_plotting  # noqa: E402
from glimslib_tpu import postprocess as jax_postprocess  # noqa: E402
from glimslib_tpu.workflow import path_io as jax_path_io  # noqa: E402
from glimslib_tpu_torch import examples  # noqa: E402
from glimslib_tpu_torch.core import bcs, results  # noqa: E402
from glimslib_tpu_torch.models import tumor_growth, tumor_growth_brain  # noqa: E402
from glimslib_tpu_torch.optimize import lbfgsb  # noqa: E402
from glimslib_tpu_torch.solvers.coupled import StepConfig  # noqa: E402
from glimslib_tpu_torch.utils import (  # noqa: E402
    data_io, file_utils, image_io, image_registration_utils, interpolation, meshing,
    synthetic, vtk_utils,
)
from glimslib_tpu_torch.workflow import path_io  # noqa: E402
from glimslib_tpu_torch import postprocess  # noqa: E402
from glimslib_tpu_torch.utils import profiling  # noqa: E402
from glimslib_tpu_torch.visualisation import helpers, plotting  # noqa: E402

from reference_fem import ReferenceFEM  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

TIGHT = dict(newton_rtol=1e-10, newton_atol=1e-14, cg_rtol=1e-12)
F64 = torch.float64


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


class Boundary:
    def inside(self, x, on_boundary):
        return on_boundary


def _jax_rect_sim(n, subdomains):
    """The JAX package's model of examples/tumor_growth_2D_uniform.py (or
    _subdomains.py), built from that script's settings."""
    mesh = jax_rectangle_mesh((-5, -5), (5, 5), n, n)
    sim = JaxTumorGrowth(mesh, dtype=jnp.float64)
    clamped = {"clamped_boundary": {"bc_value": np.zeros(2),
                                    "named_boundary": "boundary_all",
                                    "subspace_id": 0}}
    if not subdomains:
        sim.setup_global_parameters(boundaries={"boundary_all": Boundary()},
                                    dirichlet_bcs=clamped, von_neumann_bcs={})
        sim.setup_model_parameters(
            iv_expression={0: np.zeros(2), 1: lambda x: np.exp(-(x ** 2).sum(axis=1))},
            diffusion=0.1, coupling=1.0, proliferation=0.1, E=0.001, poisson=0.45,
            sim_time=5, sim_time_step=1)
        return sim
    labels = np.where(np.linalg.norm(mesh.points, axis=1) < 2.0, 2.0, 1.0)
    sim.setup_global_parameters(label_function=labels, domain_names={1: "out", 2: "in"},
                                boundaries={"boundary_all": Boundary()},
                                dirichlet_bcs=clamped)
    sim.setup_model_parameters(
        iv_expression={0: np.zeros(2),
                       1: lambda x: np.exp(-(x ** 2).sum(axis=1) / 2.0)},
        diffusion={"in": 0.2, "out": 0.05}, proliferation={"in": 0.2, "out": 0.05},
        coupling={"in": 0.2, "out": 0.05}, E={"in": 0.002, "out": 0.001},
        poisson={"in": 0.4, "out": 0.45}, sim_time=10, sim_time_step=1)
    return sim


@pytest.mark.parametrize("subdomains", [False, True], ids=["uniform", "subdomains"])
def test_rect_forward_matches_jax(subdomains):
    """rect_sim at n=8, 3 steps, f64: every step converges in both
    packages with the same Newton counts; final c and u to rel-L2 1e-8;
    the 2D lattice has the 7 offsets {0, ±1, ±(n+1), ±(n+2)}."""
    n, n_steps = 8, 3
    sim = examples.rect_sim(n=n, subdomains=subdomains, dtype=F64, device="cpu")
    sim.step_config = StepConfig(**TIGHT)
    u0, c0 = sim.initial_state()
    u, c, ok, newton = sim.build_simulate_fn(n_steps, 1.0)(
        sim.make_theta(sim.params.as_dict()), u0, c0)
    assert sorted(sim._stencil_ops.offsets) == sorted(
        [0, 1, -1, n + 1, -(n + 1), n + 2, -(n + 2)])

    sim_j = _jax_rect_sim(n, subdomains)
    # exact Newton, as the port's lattice lane runs it (the JAX package's
    # f64 lattice takes its pcg branch, whose default is the chord method)
    sim_j.step_config = JaxStepConfig(**TIGHT, rd_modified_newton=False)
    iv = sim_j.params.create_initial_value_function()
    u_j, c_j, ok_j, newton_j = jax.jit(sim_j.build_simulate_fn(n_steps, 1.0))(
        sim_j.make_theta(sim_j.params.as_dict()), jnp.asarray(iv[0], jnp.float64),
        jnp.asarray(iv[1], jnp.float64))

    assert ok.tolist() == np.asarray(ok_j).tolist() == [True] * n_steps
    assert newton.tolist() == np.asarray(newton_j).tolist()
    assert _rel(c0, iv[1]) <= 1e-10
    assert _rel(c[-1], c_j[-1]) <= 1e-8
    assert _rel(u[-1], u_j[-1]) <= 1e-8


def test_rect_uniform_matches_reference_fem():
    """rect_sim(50), the reference's own resolution and schedule (2,601
    nodes, 5 steps), f64 at the model's default tolerances, against the
    scipy FEM: rel-L2 1e-6 on c and u."""
    sim = examples.rect_sim(n=50, dtype=F64, device="cpu")
    sim.run(save_method=None)
    assert sim.results.get_recording_steps() == list(range(6))  # every step converged
    mesh = sim.mesh
    ref = ReferenceFEM(mesh)
    c = sim.params.create_initial_value_function()[1]  # the L2 projection
    u = np.zeros((mesh.n_nodes, 2))
    bn = mesh.boundary_nodes
    E, nu = 0.001, 0.45
    mu = E / (2 * (1 + nu))
    lam = E * nu / ((1 + nu) * (1 - 2 * nu))
    for _ in range(5):
        u, c = ref.solve_step(
            u.ravel(), c, D_cell=0.1, rho_cell=0.1, mu_cell=mu, lam_cell=lam,
            coupling=1.0, dt=1.0, dirichlet_disp_nodes=bn,
            dirichlet_disp_values=np.zeros((len(bn), 2)))
    assert _rel(sim.solution[1], c) <= 1e-6
    assert _rel(sim.solution[0], u) <= 1e-6


# -- the copied utilities -----------------------------------------------------


def _jax_atlas_mesh(tmp_path, nx, ny, nz, z_slice):
    """The reduced domain of examples/brain_2D_atlas_reduced_domain_adjoint.py
    through the JAX package's utilities."""
    path = str(tmp_path / "atlas.mha")
    jax_image_io.write_mha(path, jax_image_io.Image(
        jax_synthetic.brain_labelmap_3d(nx, ny, nz), origin=(0, 0, 0), spacing=(1, 1, 1)))
    mesh_full, labels_full = jax_dio.get_labelfunction_from_image(path, z_slice=z_slice)
    sd = JaxSubDomains(mesh_full)
    sd.setup_subdomains(label_function=labels_full)
    mesh, cell_labels = jax_dio.remove_mesh_subdomain(mesh_full, sd.cell_labels, 1, 4)
    labels = np.rint(jax_vtk.cell_to_point_data(mesh.n_nodes, mesh.cells, cell_labels))
    return mesh, labels, mesh_full, labels_full


def test_atlas_mesh_and_labels_equal_the_jax_packages(tmp_path):
    """A 20 x 18 x 6 labelmap, slice 3: the full pixel-lattice mesh, its
    labels, the reduced mesh (no lattice) and its nodal labels equal the
    JAX package's exactly; the image round-trips through both packages'
    MetaImage readers unchanged."""
    got = examples.atlas2d_mesh(20, 18, 6, 3)
    want = _jax_atlas_mesh(tmp_path, 20, 18, 6, 3)
    for g, w in zip(got, want):
        if isinstance(g, np.ndarray):
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_array_equal(g.points, w.points)
            np.testing.assert_array_equal(g.cells, w.cells)
            assert g.lattice_strides == w.lattice_strides
    mesh, labels, mesh_full, _ = got
    assert mesh_full.lattice_strides is not None and mesh.lattice_strides is None
    assert 0 < mesh.n_cells < mesh_full.n_cells and set(np.unique(labels)) <= {1, 2, 3, 4}
    lab = synthetic.brain_labelmap_3d(20, 18, 6)
    np.testing.assert_array_equal(lab, jax_synthetic.brain_labelmap_3d(20, 18, 6))
    path = str(tmp_path / "port.mha")
    image_io.write_mha(path, image_io.Image(lab, origin=(1.0, 2.0, 0.5), spacing=(0.5, 1, 2)))
    img, img_j = image_io.read_image(path), jax_image_io.read_image(path)
    np.testing.assert_array_equal(img.data, img_j.data)
    assert img.origin == img_j.origin and img.spacing == img_j.spacing
    sl, sl_j = img.slice_z(2), img_j.slice_z(2)
    np.testing.assert_array_equal(sl.data, sl_j.data)
    assert sl.origin == sl_j.origin and sl.spacing == sl_j.spacing


def _code_lines(obj):
    """Source lines of a module or function, its import lines dropped."""
    return [ln for ln in inspect.getsource(obj).splitlines()
            if not ln.strip().startswith(("import ", "from "))]


# lines of a copied member that the port adds to the reference's code:
# Results.save_solution_start refuses "xdmf" without h5py before a run;
# show_plot imports matplotlib when it draws (the reference at import)
PORT_LINES = {"Results.save_solution_start": {"        _refuse_unwritable(method)"},
              "show_plot": {"    matplotlib = config.require_matplotlib()"}}


def _member(module, dotted):
    obj = module
    for part in dotted.split("."):
        obj = getattr(obj, part)
    return obj.fget if isinstance(obj, property) else obj


@pytest.mark.parametrize("copy,ref,names", [
    (image_io, jax_image_io, None),
    (synthetic, jax_synthetic, None),
    (vtk_utils, jax_vtk, None),
    (file_utils, jax_file_utils, None),
    (interpolation, jax_interp, None),
    (meshing, jax_meshing, None),
    (image_registration_utils, jax_reg, None),
    (path_io, jax_path_io, None),
    (data_io, jax_dio, ["image2fct2D", "fct2image2D", "compute_spacing",
                        "get_measures_from_structured_mesh", "get_measures_from_image",
                        "create_image_from_fenics_function",
                        "create_fenics_function_from_image", "get_labelfunction_from_image",
                        "identify_orphaned_vertices", "remove_orphaned_vertices",
                        "read_vtk_convert_to_fenics", "convert_fenics_mesh_to_meshio",
                        "convert_meshio_to_fenics_mesh", "remove_mesh_subdomain",
                        "create_file_name", "merge_vtus_timestep", "merge_VTUs"]),
    (results, jax_results, [
        "TimeSeriesDataTimePoint", "TimeSeriesData",
        "TimeSeriesMultiData.register_time_series", "TimeSeriesMultiData.add_observation",
        "TimeSeriesMultiData.get_solution_function", "Results.add_to_results",
        "Results.mesh", "Results.save_solution_start", "Results.save_solution",
        "Results.save_solution_end", "Results.save_label_function"]),
    (lbfgsb, jax_lbfgsb, ["minimize_lbfgsb", "OptimizationProgress.record_eval",
                          "OptimizationProgress.record_grad",
                          "OptimizationProgress.total_time_seconds"]),
    (tumor_growth, jax_tg, ["TumorGrowth.run_for_adjoint", "TumorGrowth.run_for_adjoint2"]),
    (tumor_growth_brain, jax_tgb, [
        "TumorGrowthBrain._set_and_run", "TumorGrowthBrain.run_for_adjoint",
        "TumorGrowthBrain.run_for_adjoint_4params", "TumorGrowthBrain.run_for_adjoint_3params",
        "TumorGrowthBrain.run_for_adjoint_2params", "TumorGrowthBrain.init_postprocess"]),
    (plotting, jax_plotting, None),
    (helpers, jax_helpers, ["show_plot", "mesh_to_triangulation", "interpolate_to_grid",
                            "get_value_range"]),
    (profiling, jax_profiling, ["Tracer", "run_stats"]),
    (postprocess, jax_postprocess, ["PostProcessTumorGrowth.plot_all",
                                    "PostProcessTumorGrowth.plot_for_pub"]),
    (bcs, jax_bcs, ["_facet_edge_dofs", "BoundaryConditions._boundary_nodes_for",
                    "BoundaryConditions._boundary_facet_vertex_sets_for"]),
], ids=["image_io", "synthetic", "vtk_utils", "file_utils", "interpolation", "meshing",
        "image_registration_utils", "path_io", "data_io", "results", "lbfgsb",
        "tumor_growth", "tumor_growth_brain", "plotting", "visualisation_helpers",
        "profiling", "postprocess_plots", "bcs_facet_selection"])
def test_utils_copies_are_the_reference_code(copy, ref, names):
    """Each copied module (whole, past its copy header) or member is the
    JAX package's code byte for byte, import lines and the PORT_LINES of a
    member apart."""
    if names is None:
        src = inspect.getsource(copy)
        body = src[src.index('"""'):]
        want = [ln for ln in inspect.getsource(ref).splitlines()
                if not ln.strip().startswith(("import ", "from "))]
        assert [ln for ln in body.splitlines()
                if not ln.strip().startswith(("import ", "from "))] == want
        return
    for name in names:
        got = [ln for ln in _code_lines(_member(copy, name))
               if ln not in PORT_LINES.get(name, ())]
        assert got == _code_lines(_member(ref, name)), name


# -- the reduced-domain 2D atlas inverse problem --------------------------------


def test_atlas2d_value_and_grad_matches_jax(tmp_path):
    """atlas2d_problem on a 20 x 18 x 6 labelmap (slice 3): TumorGrowthBrain
    on the reduced mesh (the unstructured lane at d=2), targets from a
    forward run, 3 steps, type 2; J and both gradient components against
    the JAX package's inverse problem on its own mesh with the same
    targets, rel 1e-8."""
    sim = examples.atlas2d_sim(20, 18, 6, 3, dtype=F64, device="cpu")
    sim.step_config = StepConfig(**TIGHT)
    assert sim.mesh.lattice_strides is None
    ip, v0 = examples.atlas2d_problem(sim=sim)
    J, g = ip.value_and_grad(v0)
    assert ip.n_steps == 3 and set(ip.targets) == {"conc_T2", "conc_T1", "disp"}

    mesh, labels, _, _ = _jax_atlas_mesh(tmp_path, 20, 18, 6, 3)
    sim_j = JaxBrain(mesh, dtype=jnp.float64)
    sim_j.setup_global_parameters(
        label_function=labels, domain_names=examples.TISSUE_MAP,
        boundaries={"boundary_all": Boundary()},
        dirichlet_bcs={"clamped_boundary": {"bc_value": np.zeros(2),
                                            "named_boundary": "boundary_all",
                                            "subspace_id": 0}})
    seed = mesh.points.mean(axis=0) + np.array([4.0, 0.0])
    sim_j.setup_model_parameters(
        iv_expression={0: np.zeros(2),
                       1: lambda x: np.exp(-((x - seed) ** 2).sum(axis=1) / 8.0)},
        sim_time=3, sim_time_step=1, **examples.BRAIN_PARAMS_FIXED,
        **examples.BRAIN_PARAMS_VARYING)
    sim_j.step_config = JaxStepConfig(**TIGHT)
    names, update = jax_adjoint.param_map_for_type(2)
    ip_j = jax_adjoint.InverseProblem(
        sim_j, names, {k: v.numpy() for k, v in ip.targets.items()}, update_fn=update)
    J_j, g_j = ip_j.value_and_grad(v0)
    assert abs(J - J_j) <= 1e-8 * abs(J_j), (J, J_j)
    np.testing.assert_allclose(g, np.asarray(g_j), rtol=1e-8, atol=0)
    assert len(ip.sim.solver_info["el_adj_cg_iters"]) == 3
