"""Image-based inverse-problem workflow, base class (counterpart of
``glimslib_tpu/workflow/image_based_optimization.py``).

The end-to-end pipeline of the reference's
``optimization_workflow/image_based_optimization.py``

    image -> 2D slice / 3D mesh -> forward sim -> target fields ->
    adjoint optimization -> optimized re-simulation -> analysis

with its staged directory layout, pickled resumable state, Gaussian seed,
tissue map {0: outside, 1: CSF, 2: GM, 3: WM, 4: Ventricles},
clamped-everywhere Dirichlet condition, tanh-thresholded targets at
T2=0.12 / T1=0.80 and per-step, per-tissue volume and centre-of-mass
analysis.  Images are meshed as lattices (a 2D slice's pixel centres, a 3D
labelmap's full voxel-corner lattice), so every simulation of the P1
model (``model="linear"``) runs the lattice lane's CUDA kernels.  The quad
model (``model="quad"``, P2 concentration: the model the reference
workflow drives) runs on the same mesh with its lattice structure
stripped (``Mesh.from_arrays`` of the same points and cells, built once a
domain): the unstructured lane, every matvec and supernode block-Jacobi
apply through the batched-matvec kernel.  Its nodes keep the lattice
order, so every P1 nodal field (u, the label function, the store, VTUs,
images) needs no mapping, and its P2 dofs are numbered as the JAX
package numbers them.

What differs from the JAX package:

- ``device`` and ``dtype`` (default: the card and float32, as for every
  model of the port) go to every simulation the workflow builds; the
  analysis integrates at float64 on the same device with its own
  ``P1Kernels`` (``P2Kernels`` of the quad mesh for a P2 field), never a
  float32 model's.
- The pickled state holds Python and numpy values only (no tensor, no
  simulation, no device), so a state written on the card reloads on a
  host without CUDA.
- The mesh and function store is ``.npz`` (``utils/data_io.py``), and the
  analysis tables are dicts of numpy columns under the reference's column
  names, pickled and written as CSV: the card's host has no h5py, and the
  port's workflow path imports neither h5py nor pandas.
- ``compute_from_conc_for_each_time_step`` and ``post_process`` move a
  simulation's recorded concentrations to the device once and integrate
  every step and every tissue in one batched pass.
- ``model="quad"`` runs on the lattice-stripped mesh, where the JAX
  package runs its matrix-free lane on the lattice mesh (the same
  solution); on a full lattice the vertex dofs of nodes no cell touches
  are zero-Dirichlet, where the JAX package gives NaN.
- ``run_forward_sim`` and ``run_optimized_sim`` raise when a step did
  not converge (the JAX package records the steps before it and goes
  on); the error names ``step_config.cg_maxiter``.
"""

from __future__ import annotations

import logging
import os
import pickle
from datetime import datetime
from typing import Dict

import numpy as np
import torch

from glimslib_tpu_torch import config
from glimslib_tpu_torch.core.mesh import Mesh
from glimslib_tpu_torch.models.tumor_growth_brain import TumorGrowthBrain
from glimslib_tpu_torch.ops.assembly import P1Kernels
from glimslib_tpu_torch.ops.p2 import P2Kernels
from glimslib_tpu_torch.optimize.adjoint import (
    CONC_THRESHOLD_LEVELS,
    InverseProblem,
    param_map_for_type,
    thresh,
)
from glimslib_tpu_torch.utils import data_io as dio
from glimslib_tpu_torch.utils import file_utils as fu
from glimslib_tpu_torch.utils import image_registration_utils as reg
from glimslib_tpu_torch.utils.image_io import Image, read_image, write_image
from glimslib_tpu_torch.workflow.path_io import PathIO

# tissue id -> name map (reference l.391-394)
TISSUE_MAP = {0: "outside", 1: "CSF", 2: "GM", 3: "WM", 4: "Ventricles"}

F64 = torch.float64


class BoundaryAll:
    def inside(self, x, on_boundary):
        return on_boundary


class ImageBasedOptimizationBase:
    """Pipeline state machine (reference l.37-183)."""

    # staged processing dirs (reference l.74-82)
    steps_sub_path_map = {
        "domain_prep": "01_domain_preparation",
        "forward_sim": "02_forward_simulation",
        "target_fields": "03_target_fields",
        "inverse_sim": "02_inverse_simulation",
        "optimized_sim": "02_optimized_simulation",
        "summary": "summary",
        "comparison": "comparison",
    }

    def __init__(self, base_dir, path_to_labels_atlas=None,
                 path_to_image_atlas=None, image_z_slice=None, plot=False,
                 model="linear", device=None, dtype=None):
        self.model = model
        self.device = config.resolve_device(device)
        self.dtype = config.resolve_dtype(dtype)
        self.base_dir = base_dir
        self.data = PathIO(base_dir)
        self._setup_paths()
        self._setup_loggers()
        self.conc_threshold_levels = dict(CONC_THRESHOLD_LEVELS)
        self.measures: Dict = {}
        self.path_to_image_atlas_orig = path_to_image_atlas
        self.path_to_labels_atlas_orig = path_to_labels_atlas
        self.image_z_slice = image_z_slice
        self.plot = plot
        self.dim = 2 if image_z_slice is not None else 3
        self.sims: Dict[str, TumorGrowthBrain] = {}
        self._reset_domain_caches()
        self._traj = {}
        if path_to_labels_atlas:
            self._save_state()

    # -- paths / loggers / state (reference l.72-183) ------------------------

    def _setup_paths(self):
        for key, sub in self.steps_sub_path_map.items():
            path = os.path.join(self.base_dir, sub)
            setattr(self, f"path_{key}", path)
        self.path_to_state = os.path.join(self.base_dir, "state.pkl")
        self.path_to_summary = os.path.join(self.path_summary, "measures.pkl")
        fu.ensure_dir_exists(self.base_dir)

    def _setup_loggers(self):
        self.logger = logging.getLogger(type(self).__name__)
        fu.ensure_dir_exists(self.base_dir)
        logfile = os.path.join(
            self.base_dir, f"logger_{datetime.now():%Y-%m-%d_%H-%M-%S}.log"
        )
        fh = logging.FileHandler(logfile)
        fh.setLevel(logging.INFO)
        fh.setFormatter(logging.Formatter("%(asctime)s %(name)s %(message)s"))
        self.logger.addHandler(fh)

    _STATE_ATTRS = [
        "model",
        "path_to_image_atlas_orig", "path_to_labels_atlas_orig",
        "image_z_slice", "dim", "conc_threshold_levels", "measures",
        "params_forward", "params_inverse", "model_params_optimized",
        "path_mesh_hdf5", "path_labelfunction",
        "path_conc_T2", "path_conc_T1", "path_displacement_reconstructed",
        "path_parameters_optimized", "path_optimized_conc",
        "path_optimized_disp",
    ]

    def _save_state(self):
        state = {
            k: getattr(self, k) for k in self._STATE_ATTRS if hasattr(self, k)
        }
        with open(self.path_to_state, "wb") as f:
            pickle.dump(state, f, protocol=pickle.HIGHEST_PROTOCOL)

    def _reset_domain_caches(self):
        """Drop what is built from the mesh: the f64 analysis kernels and
        the quad model's lattice-stripped mesh."""
        self._kernels64 = None
        self._p2_kernels64 = None
        self._mesh_quad = None

    def _load_state(self):
        with open(self.path_to_state, "rb") as f:
            state = pickle.load(f)
        for k, v in state.items():
            setattr(self, k, v)

    def reload_state(self):
        """Resume a pipeline in a fresh process (reference l.867-874)."""
        self._load_state()
        if hasattr(self, "path_mesh_hdf5") and os.path.exists(self.path_mesh_hdf5):
            self._load_domain()

    # -- simulation reloads (reference l.824-865) ----------------------------

    def _reload_sim(self, name, pipeline_params, output_path):
        """Rebuild a simulation from the pickled parameters and reload its
        recorded series from the series store."""
        if name == "optimized":
            sim = self.init_optimized_problem()
        else:
            sim = self._init_problem(
                name,
                pipeline_params["seed_position"],
                pipeline_params["sim_params"],
                pipeline_params["model_params_varying"],
                pipeline_params["model_params_fixed"],
            )
        series = dio.store_path(os.path.join(output_path, "solution_timeseries.h5"))
        if os.path.exists(series):
            sim.reload_from_hdf5(series, output_dir=output_path)
        return sim

    def reload_forward_sim(self):
        return self._reload_sim("forward", self.params_forward,
                                self.path_forward_sim)

    def reload_inverse_sim(self):
        return self._reload_sim("inverse", self.params_inverse,
                                self.path_inverse_sim)

    def reload_optimized_sim(self):
        return self._reload_sim("optimized", self.params_inverse,
                                self.path_optimized_sim)

    # -- domain preparation (reference l.187-356) ----------------------------

    def mesh_domain(self):
        if self.dim == 2:
            self._extract_2d_domain()
        else:
            self._mesh_3d_domain()
        self._reset_domain_caches()
        self._save_state()

    def _extract_2d_domain(self):
        """3D labelmap -> z-slice -> pixel-lattice mesh + label function ->
        store (reference l.187-249)."""
        self.logger.info("-- extracting 2D domain at z=%s", self.image_z_slice)
        mesh, labels = dio.get_labelfunction_from_image(
            self.path_to_labels_atlas_orig, self.image_z_slice
        )
        self.mesh = mesh
        self.labelfunction = labels
        from glimslib_tpu_torch.core.subdomains import SubDomains

        sd = SubDomains(mesh)
        sd.setup_subdomains(label_function=labels)
        self.path_mesh_hdf5 = dio.save_mesh_hdf5(
            mesh, self.data.create_fenics_path(
                processing=self.steps_sub_path_map["domain_prep"],
                datasource="domain", dim=self.dim,
            ), subdomains=sd.cell_labels)
        self.path_labelfunction = dio.save_function_mesh(
            labels, self.data.create_fenics_path(
                processing=self.steps_sub_path_map["domain_prep"],
                datasource="domain", content="labels", dim=self.dim,
            ), mesh=mesh)

    def _mesh_3d_domain(self):
        """3D labelmap -> full-lattice tet mesh (MeshTool's first-party
        fallback) -> store (reference l.259-279, 336-351)."""
        self.logger.info("-- meshing 3D domain")
        from glimslib_tpu_torch.utils import meshing
        from glimslib_tpu_torch.utils.vtk_utils import cell_to_point_data

        img = read_image(self.path_to_labels_atlas_orig)
        # the full lattice keeps the offset-stencil lane; corners no cell
        # touches are zero-Dirichlet dofs (models/base.py _unused_node_mask)
        mesh, cell_labels = meshing.mesh_image_labels(img, full_lattice=True)
        self.mesh = mesh
        # nodal label function from cell labels (majority vote via averaging)
        self.labelfunction = np.rint(
            cell_to_point_data(mesh.n_nodes, mesh.cells, cell_labels)
        )
        self.path_mesh_hdf5 = dio.save_mesh_hdf5(
            mesh, self.data.create_fenics_path(
                processing=self.steps_sub_path_map["domain_prep"],
                datasource="domain", dim=self.dim,
            ), subdomains=cell_labels)
        self.path_labelfunction = dio.save_function_mesh(
            self.labelfunction, self.data.create_fenics_path(
                processing=self.steps_sub_path_map["domain_prep"],
                datasource="domain", content="labels", dim=self.dim,
            ), mesh=mesh)

    def _load_domain(self):
        mesh, _, _ = dio.read_mesh_hdf5(self.path_mesh_hdf5)
        self.mesh = mesh
        self._reset_domain_caches()
        lab, _, _, _ = dio.load_function_mesh(self.path_labelfunction)
        self.labelfunction = lab

    # -- problem init (reference l.377-422) ----------------------------------

    def _quad_mesh(self):
        """The domain's mesh without its lattice structure, for the quad
        model (same points, cells and node order), built once a domain:
        ``Mesh.from_arrays`` of a 3D lattice's tets takes seconds."""
        if self._mesh_quad is None:
            self._mesh_quad = Mesh.from_arrays(self.mesh.points, self.mesh.cells)
        return self._mesh_quad

    def _init_problem(self, name, seed_position, sim_params: Dict,
                      model_params_varying: Dict, model_params_fixed: Dict,
                      output_dir=None):
        """A TumorGrowthBrain on the prepared domain with a Gaussian seed
        (reference l.377-422), on the workflow's device and dtype; the quad
        model on :meth:`_quad_mesh`."""
        if self.model == "quad":
            from glimslib_tpu_torch.models.tumor_growth_brain_quad import (
                TumorGrowthBrain as BrainQuad,
            )

            sim = BrainQuad(self._quad_mesh(), dtype=self.dtype, device=self.device)
        else:
            sim = TumorGrowthBrain(self.mesh, dtype=self.dtype, device=self.device)
        sim.setup_global_parameters(
            label_function=self.labelfunction,
            domain_names=TISSUE_MAP,
            boundaries={"boundary_all": BoundaryAll()},
            dirichlet_bcs={
                "clamped_boundary": {
                    "bc_value": np.zeros(self.mesh.dim),
                    "named_boundary": "boundary_all",
                    "subspace_id": 0,
                }
            },
        )
        seed = np.asarray(seed_position, dtype=np.float64)
        width = sim_params.get("seed_width", 1.0)

        def iv_conc(x):
            return np.exp(-((x - seed) ** 2).sum(axis=1) / (2 * width**2))

        params = dict(model_params_fixed)
        params.update(model_params_varying)
        sim.setup_model_parameters(
            iv_expression={0: np.zeros(self.mesh.dim), 1: iv_conc},
            sim_time=sim_params["sim_time"],
            sim_time_step=sim_params["sim_time_step"],
            **params,
        )
        self.sims[name] = sim
        return sim

    # -- forward simulation (reference l.483-564) ----------------------------

    def init_forward_problem(self, seed_position, model_params_varying,
                             model_params_fixed, sim_params):
        self.params_forward = {
            "seed_position": [float(x) for x in seed_position],
            "model_params_varying": dict(model_params_varying),
            "model_params_fixed": dict(model_params_fixed),
            "sim_params": dict(sim_params),
        }
        self._save_state()
        return self._init_problem(
            "forward", seed_position, sim_params, model_params_varying,
            model_params_fixed,
        )

    @staticmethod
    def _demand_every_step(name, sim):
        """Raise when ``sim.run`` recorded fewer steps than its schedule: a
        step did not converge and the state froze there."""
        n_steps = int(round(float(sim.params.sim_time)
                            / float(sim.params.sim_time_step) + 1e-9))
        n_ok = len(sim.results.get_recording_steps()) - 1
        if n_ok < n_steps:
            raise RuntimeError(
                f"the {name} simulation did not converge at step {n_ok + 1} of "
                f"{n_steps} and froze there; a linear solve may have stopped at "
                f"step_config.cg_maxiter = {sim.step_config.cg_maxiter} iterations: "
                f"raise it after init_{name}_problem (sim.step_config = "
                f"sim.step_config._replace(cg_maxiter=...))")

    def run_forward_sim(self, plot=None, save_method=None):
        sim = self.sims["forward"]
        sim.run(
            keep_nth=1, save_method=save_method,
            plot=self.plot if plot is None else plot,
            output_dir=self.path_forward_sim,
        )
        self._demand_every_step("forward", sim)
        self.measures["forward_final_max_conc"] = float(
            np.max(sim.solution[1])
        )
        self._save_state()
        return sim

    # -- target fields (reference l.876-1163) --------------------------------

    def create_thresholded_conc_fields(self, conc_field, subdir="target_fields"):
        """tanh-thresholded concentration target fields at the T2/T1
        levels (reference l.1057-1132), saved to the store."""
        c = torch.as_tensor(np.asarray(conc_field, dtype=np.float64))
        cT2 = thresh(c, self.conc_threshold_levels["T2"]).numpy()
        cT1 = thresh(c, self.conc_threshold_levels["T1"]).numpy()
        path_T2 = self.data.create_fenics_path(
            processing=self.steps_sub_path_map[subdir],
            datasource="simulation", content="conc", frame="deformed",
            extension="h5", datatype="fenics", domain="full",
        ).replace("conc", "conc-T2")
        self.path_conc_T2 = dio.save_function_mesh(cT2, path_T2, mesh=self.mesh)
        self.path_conc_T1 = dio.save_function_mesh(
            cT1, path_T2.replace("T2", "T1"), mesh=self.mesh)
        self._save_state()
        return cT2, cT1

    def save_displacement_target(self, disp_field, subdir="target_fields"):
        self.path_displacement_reconstructed = dio.save_function_mesh(
            np.asarray(disp_field), self.data.create_fenics_path(
                processing=self.steps_sub_path_map[subdir],
                datasource="registration", content="disp", frame="def2ref",
                extension="h5", datatype="fenics", domain="full",
            ), mesh=self.mesh)
        self._save_state()

    def _create_deformed_image(self, labelmap_img: Image, disp_field,
                               out_prefix):
        """Warp the source image by the simulated displacement and write it
        and the displacement channels (reference l.876-941).  Integer-valued
        sources (labelmaps) are rounded back to labels; float sources (T1
        intensities, the reference's registration input) keep their
        values."""
        disp_on_grid = self._sample_field_on_image_grid(disp_field, labelmap_img)
        warped = reg.apply_displacement(
            labelmap_img, labelmap_img, -disp_on_grid
        )  # pull-back with inverse ~ -u for small deformations
        path_img = f"{out_prefix}_labels_deformed.mha"
        src = np.asarray(labelmap_img.data)
        is_labels = np.issubdtype(src.dtype, np.integer) or np.allclose(
            src, np.rint(src)
        )
        if is_labels:
            data = np.rint(warped.data).astype(np.int16)
        else:
            data = np.asarray(warped.data, dtype=np.float32)
        write_image(path_img, Image(data, warped.origin, warped.spacing))
        path_disp = f"{out_prefix}_displacement.mha"
        write_image(path_disp, Image(
            disp_on_grid.astype(np.float32), labelmap_img.origin,
            labelmap_img.spacing, is_vector=True,
        ))
        return path_img, path_disp

    def _sample_field_on_image_grid(self, nodal_field, image: Image):
        from glimslib_tpu_torch.utils.vtk_utils import resample_to_image

        dim = self.mesh.dim
        shape_xyz = image.size[:dim]
        origin = image.origin[:dim]
        spacing = image.spacing[:dim]
        out = resample_to_image(
            self.mesh.points, self.mesh.cells, {"f": np.asarray(nodal_field)},
            origin, spacing, shape_xyz,
        )["f"]
        axes = tuple(reversed(range(dim)))
        if out.ndim > dim:
            return np.transpose(out, axes + (dim,))
        return np.transpose(out, axes)

    def _reconstruct_deformation_field(self, reference_img_path,
                                       deformed_img_path, out_prefix):
        """Estimate the displacement from the image pair (ANTs SyN when
        installed, the demons fallback otherwise; reference l.943-978) and
        sample it at the mesh nodes."""
        prefix = reg.register_ants(
            reference_img_path, deformed_img_path, out_prefix,
            registration_type="Syn", image_ext="mha", dim=self.dim,
        )
        warp = read_image(f"{prefix}1Warp.mha")
        return dio.create_fenics_function_from_image(warp, self.mesh)

    # -- inverse problem (reference l.565-822) -------------------------------

    def init_inverse_problem(self, seed_position, model_params_varying,
                             sim_params, model_params_fixed=None,
                             optimization_type=5, target_weights=None, **kw):
        self.params_inverse = {
            "seed_position": [float(x) for x in seed_position],
            "model_params_varying": dict(model_params_varying),
            "model_params_fixed": dict(
                model_params_fixed
                if model_params_fixed is not None
                else self.params_forward["model_params_fixed"]
            ),
            "sim_params": dict(sim_params),
            "optimization_type": optimization_type,
            # per-target misfit multipliers (e.g. down-weight 'disp' when
            # the displacement target is registration-reconstructed)
            "target_weights": dict(target_weights or {}),
        }
        self._save_state()
        return self._init_problem(
            "inverse", seed_position, sim_params,
            self.params_inverse["model_params_varying"],
            self.params_inverse["model_params_fixed"],
        )

    def _load_target_fields(self):
        cT2, _, _, _ = dio.load_function_mesh(self.path_conc_T2)
        cT1, _, _, _ = dio.load_function_mesh(self.path_conc_T1)
        disp, _, _, _ = dio.load_function_mesh(
            self.path_displacement_reconstructed
        )
        return {"conc_T2": cT2, "conc_T1": cT1, "disp": disp}

    def inverse_problem(self, params_names=None, update_fn=None):
        """The InverseProblem of the inverse simulation on the saved
        targets (default parameters: the optimization type's)."""
        if params_names is None:
            params_names, update_fn = param_map_for_type(
                self.params_inverse["optimization_type"])
        return InverseProblem(
            self.sims["inverse"], params_names, self._load_target_fields(),
            update_fn=update_fn, threshold_levels=self.conc_threshold_levels,
            target_weights=self.params_inverse.get("target_weights"),
        )

    def run_inverse_problem(self, opt_params=None):
        """Dispatch by optimization type (reference l.770-793)."""
        optimization_type = self.params_inverse["optimization_type"]
        params_names, update_fn = param_map_for_type(optimization_type)
        params_init = [
            self.params_inverse["model_params_varying"][n] for n in params_names
        ]
        return self.run_inverse_problem_n_params(
            params_init, params_names, update_fn, opt_params=opt_params
        )

    def run_inverse_problem_n_params(self, params_init_values, params_names,
                                     update_fn, opt_params=None):
        """The adjoint optimization core (reference l.660-767)."""
        ip = self.inverse_problem(params_names, update_fn)
        self.logger.info("== Start Optimization")
        x_opt, progress, res = ip.minimize(
            np.asarray(params_init_values, dtype=np.float64),
            opt_params=opt_params,
        )
        self.optimization_result = res
        self.model_params_optimized = {n: float(x) for n, x in zip(params_names, x_opt)}
        # persist like the reference (l.736-762)
        self.path_parameters_optimized = self.data.create_params_path(
            processing=self.steps_sub_path_map["inverse_sim"],
            datasource="optimization",
        )
        with open(self.path_parameters_optimized, "wb") as f:
            pickle.dump(self.model_params_optimized, f,
                        protocol=pickle.HIGHEST_PROTOCOL)
        pkl = self.data.create_params_path(
            processing=self.steps_sub_path_map["inverse_sim"],
            datasource="optimization_progress",
        )
        xls = pkl.replace(".pkl", ".xls")
        self.optimization_progress = progress.save(path_pkl=pkl, path_xls=xls)
        self.measures["optimization_success"] = bool(res.success)
        self.measures["optimization_nit"] = int(res.nit)
        self.measures["optimization_fun"] = float(res.fun)
        self.measures["total_time_optimization_seconds"] = (
            progress.total_time_seconds
        )
        self.measures["number_iterations_optimization"] = (
            progress.number_iterations
        )
        self._save_state()
        return self.model_params_optimized

    # -- optimized re-simulation (reference l.517-612) -----------------------

    def init_optimized_problem(self):
        params_opt = dict(self.params_inverse["model_params_varying"])
        names, update_fn = param_map_for_type(
            self.params_inverse["optimization_type"]
        )
        v = np.array([self.model_params_optimized[n] for n in names])
        params_opt.update({k: float(x) for k, x in update_fn(v).items()})
        return self._init_problem(
            "optimized",
            self.params_inverse["seed_position"],
            self.params_inverse["sim_params"],
            params_opt,
            self.params_inverse["model_params_fixed"],
        )

    def run_optimized_sim(self, plot=None, save_method=None):
        sim = self.sims["optimized"]
        sim.run(
            keep_nth=1, save_method=save_method,
            plot=self.plot if plot is None else plot,
            output_dir=self.path_optimized_sim,
        )
        self._demand_every_step("optimized", sim)
        # the final concentration (a P2 one's vertex part) and displacement,
        # as the reference saves them (l.584-596); compute_com_all reads them
        path_conc = self.data.create_fenics_path(
            processing=self.steps_sub_path_map["optimized_sim"],
            datasource="simulation", content="conc", frame="reference",
            extension="h5", domain="full",
        )
        conc = np.asarray(sim.solution[1])
        if sim.quad:
            conc = conc[sim.p2.dof_rank[: self.mesh.n_nodes]]
        self.path_optimized_conc = dio.save_function_mesh(
            conc, path_conc, mesh=self.mesh)
        self.path_optimized_disp = dio.save_function_mesh(
            np.asarray(sim.solution[0]), path_conc.replace("conc", "disp"),
            mesh=self.mesh)
        self._save_state()
        return sim

    # -- analysis (reference l.1241-1430) ------------------------------------

    @staticmethod
    def _save_table(cols, path_base):
        """A table of numpy columns to ``path_base``.pkl and .csv (the
        reference's pickle and xls-or-csv)."""
        dio.save_columns(cols, path_pkl=path_base + ".pkl",
                         path_csv=path_base + ".csv")

    def _kernels(self, n=None):
        """f64 kernels on the workflow's device for fields of ``n`` dofs:
        the quad model's ``P2Kernels`` of :meth:`_quad_mesh` when ``n`` is
        its P2 dof count, else ``P1Kernels`` of the mesh (the reference's
        ``_conc_kernels``, l.545-551; the integrals never use a float32
        model's kernels)."""
        if self.model == "quad" and n is not None and n != self.mesh.n_nodes:
            if self._p2_kernels64 is None:
                self._p2_kernels64 = P2Kernels(self._quad_mesh(), dtype=F64,
                                               device=self.device)
            if n == self._p2_kernels64.n_dofs:
                return self._p2_kernels64
        if self._kernels64 is None:
            self._kernels64 = P1Kernels(self.mesh, dtype=F64, device=self.device)
        return self._kernels64

    def _cell_integral(self, f):
        """Per-cell integrals ∫_e f dx of fields (..., n) -> (..., n_cells)
        of a tensor on the device, by the kernels of their dof count."""
        return self._kernels(f.shape[-1]).cell_integral(f)

    def _cell_integrals(self, sim, field):
        """Per-cell integrals ∫_e f dx of nodal (or P2) fields, (..., n) ->
        (..., n_cells), on the device at f64."""
        return self._cell_integral(
            torch.as_tensor(np.asarray(field, np.float64), device=self.device))

    def _dof_coordinates(self, n):
        """(n, d) coordinates of a field's dofs: the P2 dof coordinates for
        a quad model's P2 field, else the mesh's nodes (reference l.573)."""
        return getattr(self._kernels(n), "dof_coords", self.mesh.points)

    def compute_volume(self, sim, field, cell_mask=None):
        """∫ f dx over the full domain or a subdomain cell mask (reference
        compute_volume / dx(i) measures, l.1403-1413)."""
        ci = self._cell_integrals(sim, field)
        if cell_mask is not None:
            ci = ci[torch.as_tensor(cell_mask, device=self.device)]
        return float(ci.sum())

    def compute_com(self, sim, field, cell_mask=None):
        """Centre of mass [∫ x_a f dx / ∫ f dx]; NaN components when the
        masked volume vanishes (reference compute_com, l.1415-1430)."""
        f = np.asarray(field, np.float64)
        fx = np.concatenate([f[None], (f[:, None] * self._dof_coordinates(len(f))).T],
                            axis=0)
        ci = self._cell_integrals(sim, fx)  # (1 + d, n_cells)
        if cell_mask is not None:
            ci = ci[:, torch.as_tensor(cell_mask, device=self.device)]
        sums = ci.sum(dim=1).cpu().numpy()
        vol = float(sums[0])
        return [float(s) / vol if vol > 0 else float("nan") for s in sums[1:]]

    def _recorded_conc(self, problem_type, sim):
        """(steps, C): the recording steps and their concentrations as one
        (n_steps, n) f64 tensor on the device (n: the P2 dof count for a
        quad model), moved there once a recorded series."""
        cached = self._traj.get(problem_type)
        if cached is None or cached[0] is not sim.results:
            steps = sim.results.get_recording_steps()
            c = np.stack([np.asarray(sim.results.get_result(s)[1], np.float64)
                          for s in steps])
            cached = (sim.results, steps, torch.as_tensor(c, device=self.device))
            self._traj[problem_type] = cached
        return cached[1], cached[2]

    def compute_from_conc_for_each_time_step(self, threshold=None,
                                             problem_type="forward",
                                             computation="volume"):
        """Per-recorded-step, per-tissue-subdomain tumor ``volume`` or
        ``com`` of the threshold indicator (c >= threshold), in the
        reference configuration (reference l.1336-1401).

        Columns: ``sim_time_step``, ``all`` (or ``all_0..all_{d-1}`` for
        COM), then one column (or d columns) per tissue name, lowercased.
        Every step and tissue in one batched pass on the device.  Saved to
        ``<sim dir>/{computation}_{threshold}.pkl`` and ``.csv``."""
        if not threshold:
            threshold = self.conc_threshold_levels["T2"]
        if problem_type not in self.sims:
            self.logger.warning(
                "Cannot compute '%s' for '%s': no such simulation instance",
                computation, problem_type,
            )
            return None
        sim = self.sims[problem_type]
        if getattr(sim, "results", None) is None:
            # e.g. the inverse sim: InverseProblem records nothing
            self.logger.warning(
                "Cannot compute '%s' for '%s': no recorded results",
                computation, problem_type,
            )
            return None
        if computation not in ("volume", "com"):
            self.logger.warning("Cannot compute '%s' -- undefined", computation)
            return None
        steps, C = self._recorded_conc(problem_type, sim)
        names = ["all"] + [name.lower() for name in
                           sim.subdomains.tissue_id_name_map.values()]
        M = torch.as_tensor(np.stack(
            [np.ones(self.mesh.n_cells, bool)]
            + [sim.subdomains.cell_mask(tid)
               for tid in sim.subdomains.tissue_id_name_map]
        ), dtype=F64, device=self.device)  # (n_masks, n_cells)
        # hard indicator at the dofs; the reference projects
        # fenics.conditional(ge(conc, threshold)) (l.1358-1360)
        q = (C >= threshold).to(F64)
        vol = (self._cell_integral(q) @ M.T).cpu().numpy()  # (S, m)
        cols = {"sim_time_step": np.asarray(steps, dtype=np.int64)}
        if computation == "volume":
            for j, name in enumerate(names):
                cols[name] = vol[:, j]
        else:
            X = torch.as_tensor(self._dof_coordinates(q.shape[-1]).T, dtype=F64,
                                device=self.device)
            num = (self._cell_integral(q[:, None, :] * X) @ M.T)
            num = num.cpu().numpy()  # (S, d, m)
            with np.errstate(divide="ignore", invalid="ignore"):
                com = np.where(vol[:, None, :] > 0, num / vol[:, None, :], np.nan)
            for j, name in enumerate(names):
                for a in range(self.mesh.dim):
                    cols[f"{name}_{a}"] = com[:, a, j]
        base_path = getattr(self, f"path_{problem_type}_sim")
        fu.ensure_dir_exists(base_path)
        self._save_table(cols, os.path.join(base_path, f"{computation}_{threshold}"))
        return cols

    def compute_volume_thresholded(self):
        """Volumes of the saved T2/T1 target fields -> measures dict
        (reference l.1262-1277)."""
        sim = self.sims.get("inverse") or self.sims.get("forward")
        if sim is None:
            self.logger.warning("Cannot compute volume: no simulation instance")
            return
        vol_dict = {
            "volume_threshold_T2_target": getattr(self, "path_conc_T2", None),
            "volume_threshold_T1_target": getattr(self, "path_conc_T1", None),
        }
        for name, path in vol_dict.items():
            if path and os.path.exists(path):
                conc, _, _, _ = dio.load_function_mesh(path)
                self.measures[name] = self.compute_volume(sim, conc)
            else:
                self.logger.warning(
                    "Cannot compute volume: '%s' does not exist", path
                )
        self._save_state()

    def compute_com_all(self, conc_dict=None):
        """COMs of the target fields and the optimized final concentration
        -> measures dict as ``com_{i}_{name}`` (reference l.1279-1304)."""
        sim = self.sims.get("inverse") or self.sims.get("forward")
        if sim is None:
            self.logger.warning("Cannot compute com: no simulation instance")
            return
        field_dict = {
            "threshold_T2_target": getattr(self, "path_conc_T2", None),
            "threshold_T1_target": getattr(self, "path_conc_T1", None),
            "inverse": getattr(self, "path_optimized_conc", None),
        }
        if conc_dict is not None:
            field_dict.update(conc_dict)
        for name, path in field_dict.items():
            if path and os.path.exists(path):
                conc, _, _, _ = dio.load_function_mesh(path)
                for i, coord in enumerate(self.compute_com(sim, conc)):
                    self.measures[f"com_{i}_{name}"] = coord
            else:
                self.logger.warning("Cannot compute COM: '%s' does not exist",
                                    path)
        self._save_state()

    def post_process(self, sim_list=None, threshold_list=None):
        """The analysis stage (reference post_process, l.1306-1333):
        target-field volumes and COMs into the measures dict, then per-step
        per-tissue volume and COM tables for every (simulation, threshold)
        pair, merged on ``sim_time_step`` (a left merge) with columns
        renamed ``{problem_type}_{measure}_{threshold}_{name}`` and saved to
        ``<base_dir>/{volume,com}.pkl`` and ``.csv``."""
        if sim_list is None:
            sim_list = [n for n in ("forward", "inverse", "optimized")
                        if n in self.sims]
        if threshold_list is None:
            threshold_list = [self.conc_threshold_levels["T2"],
                              self.conc_threshold_levels["T1"]]
        self.compute_volume_thresholded()
        self.compute_com_all()
        frames = {}
        for measure in ("volume", "com"):
            merged = {}
            for problem_type in sim_list:
                for threshold in threshold_list:
                    tmp = self.compute_from_conc_for_each_time_step(
                        threshold=threshold, problem_type=problem_type,
                        computation=measure,
                    )
                    if tmp is None:
                        continue
                    steps = tmp.pop("sim_time_step")
                    if not merged:
                        merged["sim_time_step"] = steps
                    row = {int(s): i for i, s in enumerate(steps)}
                    at = np.asarray([row.get(int(s), -1)
                                     for s in merged["sim_time_step"]])
                    for n, col in tmp.items():
                        key = "_".join([problem_type, measure, str(threshold), n])
                        merged[key] = np.where(at >= 0, col[at], np.nan)
            self._save_table(merged, os.path.join(self.base_dir, measure))
            frames[measure] = merged
        self._save_state()
        return frames

    def compute_volume_com_per_step(self, sim_name="forward"):
        """Convenience table: the T2-threshold volume and the
        unthresholded concentration's COM per recorded step (the per-tissue
        tables are :meth:`post_process`'s)."""
        sim = self.sims[sim_name]
        rows = {"recording_step": [], "volume_T2": []}
        for rs in sim.results.get_recording_steps():
            c = np.asarray(sim.results.get_result(rs)[1], np.float64)
            thr = (c > self.conc_threshold_levels["T2"]).astype(np.float64)
            rows["recording_step"].append(rs)
            rows["volume_T2"].append(self.compute_volume(sim, thr))
            for a, x in enumerate(self.compute_com(sim, c)):
                rows.setdefault(f"com_{'xyz'[a]}", []).append(x)
        return {k: np.asarray(v) for k, v in rows.items()}

    def write_analysis_summary(self, add_info=None):
        """Persist the measures dict (reference l.1241-1260)."""
        if add_info:
            self.measures.update(add_info)
        fu.ensure_dir_exists(self.path_summary)
        with open(self.path_to_summary, "wb") as f:
            pickle.dump(self.measures, f, protocol=pickle.HIGHEST_PROTOCOL)
        return self.path_to_summary
