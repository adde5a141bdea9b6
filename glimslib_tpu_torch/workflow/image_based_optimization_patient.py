"""Patient workflow: targets from a patient's tumour segmentation on an
atlas-derived domain (counterpart of
``glimslib_tpu/workflow/image_based_optimization_patient.py``, reference
``optimization_workflow/image_based_optimization_patient.py``).

Affine registration of the atlas to the patient gives the patient's
simulation domain (reference patient.py:34-92); the target concentration
fields come from the tumour segmentation (T1 and T2 label values, default
5 and 6) in the reference frame (patient.py:94-195).  Registration runs
through the ANTs drivers with the first-party fallbacks of
``utils/image_registration_utils.py``.  The class is the JAX package's,
apart from ``device`` and ``dtype``, the ``.npz`` store, and the refusal
of ``model="quad"`` at the inverse problem: the segmentation's targets
are P1 nodal fields and the quad model's concentration is P2, so the
misfit is undefined (the JAX package fails there on the shapes).
"""

from __future__ import annotations

import os
import numpy as np

from glimslib_tpu_torch.utils import data_io as dio
from glimslib_tpu_torch.utils import file_utils as fu
from glimslib_tpu_torch.utils import image_registration_utils as reg
from glimslib_tpu_torch.utils.image_io import Image, read_image
from glimslib_tpu_torch.workflow.image_based_optimization import (
    ImageBasedOptimizationBase,
)


class ImageBasedOptimizationPatient(ImageBasedOptimizationBase):
    def __init__(self, base_dir, path_to_labels_atlas=None,
                 path_to_image_atlas=None, path_to_image_patient=None,
                 path_to_labels_patient=None, image_z_slice=None, plot=False,
                 t1_label=5, t2_label=6, device=None, dtype=None):
        super().__init__(
            base_dir,
            path_to_labels_atlas=path_to_labels_atlas,
            path_to_image_atlas=path_to_image_atlas,
            image_z_slice=image_z_slice,
            plot=plot,
            device=device,
            dtype=dtype,
        )
        self.path_to_image_patient_orig = path_to_image_patient
        self.path_to_labels_patient_orig = path_to_labels_patient
        # patient segmentation label values (reference patient.py tumor
        # labels: T1 'label-5', T2 'label-6')
        self.t1_label = t1_label
        self.t2_label = t2_label
        if path_to_labels_atlas:
            self._save_state()

    # -- patient-specific domain (reference patient.py:34-92) ----------------

    def register_atlas_to_patient(self):
        """Affine atlas->patient registration; the warped atlas labelmap
        becomes the simulation domain."""
        fu.ensure_dir_exists(self.path_domain_prep)
        prefix = os.path.join(self.path_domain_prep, "atlas2patient_")
        reg.register_ants(
            self.path_to_image_patient_orig,
            self.path_to_image_atlas_orig,
            prefix,
            registration_type="Affine",
            image_ext="mha",
            dim=3,
        )
        warped_labels = os.path.join(
            self.path_domain_prep, "atlas_labels_in_patient.mha"
        )
        reg.ants_apply_transforms(
            self.path_to_labels_atlas_orig,
            self.path_to_image_patient_orig,
            warped_labels,
            transforms=[f"{prefix}0GenericAffine.mat"],
            interpolation="NearestNeighbor",
            dim=3,
        )
        self.path_to_labels_atlas_registered = warped_labels
        self._save_state()
        return warped_labels

    def prepare_domain(self, use_registration=True):
        if use_registration and self.path_to_image_patient_orig:
            registered = self.register_atlas_to_patient()
            self.path_to_labels_atlas_orig = registered
        self.mesh_domain()

    def init_inverse_problem(self, *args, **kwargs):
        if self.model == "quad":
            raise NotImplementedError(
                "the patient pipeline's targets are P1 nodal fields from the "
                "segmentation, and model='quad' has a P2 concentration: their "
                "misfit is not defined; run the patient pipeline with "
                "model='linear'")
        return super().init_inverse_problem(*args, **kwargs)

    # -- patient-derived targets (reference patient.py:94-195) ---------------

    def create_target_fields(self):
        """Thresholded target concentration fields from the patient tumor
        segmentation: inside T1 label -> c >= 0.80, inside T2 label ->
        c >= 0.12 (reference patient.py:94-195); displacement target is zero
        unless a reconstructed field is provided."""
        seg = read_image(self.path_to_labels_patient_orig)
        if self.dim == 2 and seg.ndim == 3:
            seg = seg.slice_z(self.image_z_slice)
        seg_data = np.asarray(seg.data)
        t1_mask = Image((seg_data == self.t1_label).astype(np.float32),
                        seg.origin, seg.spacing)
        t2_mask = Image(
            np.logical_or(seg_data == self.t1_label,
                          seg_data == self.t2_label).astype(np.float32),
            seg.origin, seg.spacing,
        )
        cT1 = dio.create_fenics_function_from_image(t1_mask, self.mesh)
        cT2 = dio.create_fenics_function_from_image(t2_mask, self.mesh)
        path_T2 = self.data.create_fenics_path(
            processing=self.steps_sub_path_map["target_fields"],
            datasource="patient", content="conc", frame="reference",
            extension="h5", datatype="fenics", domain="full",
        ).replace("conc", "conc-T2")
        self.path_conc_T2 = dio.save_function_mesh(cT2, path_T2, mesh=self.mesh)
        self.path_conc_T1 = dio.save_function_mesh(
            cT1, path_T2.replace("T2", "T1"), mesh=self.mesh)
        self.save_displacement_target(
            np.zeros((self.mesh.n_nodes, self.mesh.dim))
        )
        self._save_state()
        return cT2, cT1
