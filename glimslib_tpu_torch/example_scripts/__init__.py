"""The reference's example scripts on the port (counterparts of
``examples/*.py``, one module each under the same base name).

Each runs as ``python -m glimslib_tpu_torch.example_scripts.<name>`` and
exposes ``main(argv=None, device=None, dtype=None, plot=True,
out_dir=None)``, which returns what the script checks, so that tests and
``chip_smoke.py`` call it in-process; it runs on the card (float32)
unless ``device`` (``--device``) says otherwise.
``python -m glimslib_tpu_torch.example_scripts`` runs them all in order
(the counterpart of ``examples/run_all_examples.sh``);
``tumor_growth_3D_atlas_sharded`` runs there at two gloo ranks (on the
card, two processes sharing it) and writes VTUs (the reference's XDMF
needs h5py).
"""

# (module, argv) in the order of examples/run_all_examples.sh, with its
# argument sets and the adjoint script's default; convert_vtu_mesh_to_hdf5
# converts a VTU of an atlas slice that the runner writes
RUNS = [
    ("example_config", []),
    ("tumor_growth_2D_uniform", []),
    ("tumor_growth_2D_uniform_adjoint", []),
    ("tumor_growth_2D_uniform_adjoint", ["--n", "15"]),
    ("tumor_growth_2D_uniform_adjoint", ["--n", "12", "--noise", "0.02", "--params", "2"]),
    ("tumor_growth_2D_uniform_adjoint_noise", []),
    ("tumor_growth_2D_uniform_adjoint_reloaded", []),
    ("tumor_growth_2D_uniform_adjoint_custom_minimizer", ["--n", "15"]),
    ("tumor_growth_2D_uniform_reload", []),
    ("tumor_growth_2D_subdomains", []),
    ("comparison_2D_atlas", []),
    ("comparison_3D_atlas", []),
    ("tumor_growth_3D_atlas_sharded", ["--ranks", "2", "--backend", "gloo",
                                       "--save-method", "vtk"]),
    ("brain_2D_atlas_reduced_domain_adjoint", []),
    ("atlas_optimization_workflow", []),
    ("patient_optimization_workflow", []),
    ("convert_vtu_mesh_to_hdf5", None),
]
