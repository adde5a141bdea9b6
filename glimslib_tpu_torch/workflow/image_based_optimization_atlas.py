"""Atlas workflow: synthetic ground truth from the atlas's own forward
simulation (counterpart of
``glimslib_tpu/workflow/image_based_optimization_atlas.py``, reference
``optimization_workflow/image_based_optimization_atlas.py``).

The forward simulation on the atlas is the synthetic "patient"; the
targets are its thresholded final concentration and its displacement,
directly or reconstructed through the image pipeline;
``compare_original_optimized`` reports field errornorms and the
parameters' relative errors (reference atlas.py:80-151).  The errornorms
run in torch at f64 on the workflow's device; the comparison table is a
dict of numpy columns.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict

import numpy as np
import torch

from glimslib_tpu_torch.utils import data_io as dio
from glimslib_tpu_torch.utils import file_utils as fu
from glimslib_tpu_torch.utils.image_io import read_image, write_image
from glimslib_tpu_torch.workflow.image_based_optimization import (
    ImageBasedOptimizationBase,
)


class ImageBasedOptimizationAtlas(ImageBasedOptimizationBase):
    # -- pipeline stages (reference atlas.py:15-43) --------------------------

    def prepare_domain(self):
        self.mesh_domain()

    def create_target_fields(self, reconstruct_displacement=False):
        """Targets from the atlas forward simulation (reference
        atlas.py:20-43): the thresholded final concentration and the
        displacement.

        ``reconstruct_displacement=True`` runs the image loop: warp the
        source image by the simulated displacement, estimate the
        displacement again by registration (ANTs, or the demons fallback)
        and use that as the target (reference l.876-978).  By default the
        simulated displacement is the target."""
        sim = self.sims["forward"]
        c_final = np.asarray(sim.solution[1])
        u_final = np.asarray(sim.solution[0])
        self.create_thresholded_conc_fields(c_final)
        if reconstruct_displacement:
            # the reference warps and registers the textured T1 image
            # (atlas.py:23-38); the labelmap when no intensity atlas is given
            src_path = (self.path_to_image_atlas_orig
                        or self.path_to_labels_atlas_orig)
            src_img = read_image(src_path)
            if self.dim == 2:
                src_img = src_img.slice_z(self.image_z_slice)
            prefix = os.path.join(self.path_target_fields, "atlas")
            fu.ensure_dir_exists(self.path_target_fields)
            path_def, _ = self._create_deformed_image(src_img, u_final, prefix)
            ref_path = os.path.join(self.path_target_fields, "labels_ref.mha")
            write_image(ref_path, src_img.astype(np.float32))
            # fixed = reference (undeformed) image, moving = deformed image
            # (reference atlas.py:36-38): registering deformed -> reference
            # recovers +u on the reference grid
            disp_nodal = self._reconstruct_deformation_field(
                ref_path, path_def, prefix + "_reg"
            )
            self.save_displacement_target(disp_nodal)
        else:
            self.save_displacement_target(u_final)
        self._save_state()

    def compare_displacement_field_simulated_registered(self):
        """Errornorm of the registration-reconstructed displacement against
        the simulated one -> measures dict (reference atlas.py:45-78)."""
        disp_sim = np.asarray(self.sims["forward"].solution[0])
        disp_est, _, _, _ = dio.load_function_mesh(
            self.path_displacement_reconstructed
        )
        diff = torch.as_tensor(disp_sim - np.asarray(disp_est), dtype=torch.float64,
                               device=self.device)
        err = float(torch.sqrt(torch.sum(
            diff * self._kernels().mass_vector_residual(diff))))
        self.measures["errornorm_displacement_simulated_vs_registered"] = err
        self._save_state()
        return err

    # -- comparison (reference atlas.py:80-151) ------------------------------

    def compare_original_optimized(self) -> Dict:
        """Errornorms forward against optimized at the shared steps, and
        the parameters' relative errors (reference atlas.py:80-137)."""
        from glimslib_tpu_torch.postprocess import Comparison

        cols = Comparison(self.sims["forward"], self.sims["optimized"]).compare()
        self.comparison_df = cols
        fu.ensure_dir_exists(self.path_comparison)
        with open(os.path.join(self.path_comparison, "comparison.pkl"), "wb") as f:
            pickle.dump(cols, f, protocol=pickle.HIGHEST_PROTOCOL)

        rel_errors = {}
        true_params = self.params_forward["model_params_varying"]
        for name, opt_val in self.model_params_optimized.items():
            if name in true_params:
                true = float(true_params[name])
                rel_errors[name] = abs(opt_val - true) / max(abs(true), 1e-30)
        self.measures["param_relative_errors"] = rel_errors
        for sid_name in ("concentration", "displacement"):
            col = f"errornorm_{sid_name}"
            if col in cols:
                self.measures[f"final_errornorm_{sid_name}"] = float(cols[col][-1])
        self._save_state()
        return {"field_errors": cols, "param_relative_errors": rel_errors}
