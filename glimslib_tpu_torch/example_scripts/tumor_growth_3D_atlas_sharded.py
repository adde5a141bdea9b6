"""3D brain-atlas forward solve, block-sharded over the ranks of a process group.

Counterpart of ``examples/tumor_growth_3D_atlas_sharded.py`` (reference
``test_case_simulation_tumor_growth_3D_atlas_mpi.py``, run with ``mpirun
-np 4``): the synthetic 3D atlas labelmap is meshed (image -> tets), the
mesh store is written and read back (the reference pre-converts the mesh
for parallel load), and the forward solve runs on every rank under
``sim.use_sharding()`` (the ``mpirun`` analogue: the supernode tables as
each rank's slab of blocks, node vectors replicated).  Rank 0 writes the
files; after the run it reloads the series store serially and
postprocesses it (reference script l.145-151).

Run: ``python -m glimslib_tpu_torch.example_scripts.tumor_growth_3D_atlas_sharded
--ranks 2 --backend gloo`` (``--device cpu`` on the CPU; ``--backend
nccl`` takes one card a rank; ``--atlas NX NY NZ`` sets the synthetic
atlas, ``--save-method`` the per-step files: the reference's ``xdmf``
needs h5py), or under ``torchrun --nproc-per-node N -m ...`` with the
same arguments but ``--ranks``: a rank then joins the group it is given.
"""

import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from glimslib_tpu_torch.example_scripts.example_config import (
    BRAIN_PARAMS_FIXED, BRAIN_PARAMS_VARYING, TISSUE_MAP, BoundaryAll, example_out,
    gaussian_iv, parser, resolve, synthetic_atlas_path,
)
from glimslib_tpu_torch.parallel import make_device_mesh, run_ranks
from glimslib_tpu_torch.utils import data_io as dio
from glimslib_tpu_torch.utils.image_io import read_image
from glimslib_tpu_torch.utils.meshing import mesh_image_labels


def _mesh_store(out, atlas_dir, atlas):
    """1. image -> tet mesh, written to the mesh store; returns its path."""
    img = read_image(synthetic_atlas_path(atlas_dir, *atlas))
    mesh, cell_labels = mesh_image_labels(img)
    return dio.save_mesh_hdf5(mesh, os.path.join(out, "brain_atlas_mesh_3d.h5"),
                              subdomains=cell_labels)


def build_model(path_h5, dtype, device, plain=False):
    """2. the model on the mesh store's mesh, set up as the reference's
    (``plain``: on the plain torch path)."""
    from glimslib_tpu_torch.models.tumor_growth_brain import TumorGrowthBrain
    from glimslib_tpu_torch.utils.vtk_utils import cell_to_point_data

    mesh, cell_labels, _ = dio.read_mesh_hdf5(path_h5)
    labels = np.rint(cell_to_point_data(mesh.n_nodes, mesh.cells, cell_labels))
    sim = TumorGrowthBrain(mesh, dtype=dtype, device=device, plain=plain)
    sim.setup_global_parameters(
        label_function=labels,
        domain_names=TISSUE_MAP,
        boundaries={"boundary_all": BoundaryAll()},
        dirichlet_bcs={
            "clamped_boundary": {
                "bc_value": np.zeros(3),
                "named_boundary": "boundary_all",
                "subspace_id": 0,
            }
        },
    )
    seed = mesh.points.mean(axis=0) + np.array([4.0, 0.0, 0.0])
    sim.setup_model_parameters(
        iv_expression={0: np.zeros(3), 1: gaussian_iv(seed, width=2.0)},
        sim_time=5, sim_time_step=1,
        **BRAIN_PARAMS_FIXED, **BRAIN_PARAMS_VARYING,
    )
    return sim


def _rank(dmesh, path_h5, out, dtype, save_method):
    """Steps 2-4 on one rank; returns the rank's final fields and numbers."""
    from glimslib_tpu_torch.ops import bell_kernels as bk

    t0 = time.perf_counter()
    sim = build_model(path_h5, dtype, dmesh.device)
    mesh = sim.mesh
    if dmesh.rank == 0:
        print(f"mesh: {mesh.n_nodes} nodes, {mesh.n_cells} tets")

    # 3. shard over every rank (the mpirun analogue) and run
    sim.use_sharding(dmesh)
    if dmesh.rank == 0:
        print(f"sharded over {dmesh.world} ranks ({dmesh.backend}, mode "
              f"{sim.sharding_mode})")
    setup_s = time.perf_counter() - t0
    bk.batched_matvec.launches = 0
    bk.batched_matvec.launches_by_shape = {}
    t0 = time.perf_counter()
    sim.run(save_method=save_method, plot=False, output_dir=out)
    run_s = time.perf_counter() - t0
    launches = dict(bk.batched_matvec.launches_by_shape)
    final_max_c = float(np.max(sim.solution[1]))

    # 4. serial post-hoc reload + postprocess on rank 0 (reference l.145-151)
    post_s = 0.0
    if dmesh.rank == 0:
        t0 = time.perf_counter()
        sim.reload_from_hdf5(os.path.join(out, "solution_timeseries.h5"), output_dir=out)
        sim.init_postprocess(os.path.join(out, "postprocess"))
        sim.postprocess.save_all(save_method="vtk")
        post_s = time.perf_counter() - t0
        print("final max concentration:", final_max_c)
        print("outputs in", out)
    return dict(rank=dmesh.rank, world=dmesh.world, sharding_mode=sim.sharding_mode,
                final_max_c=final_max_c, u=sim.solution[0], c=sim.solution[1],
                newton_iters=np.asarray(sim.solver_info["newton_iters"]),
                bell_bmv_launches=launches, n_nodes=mesh.n_nodes, n_cells=mesh.n_cells,
                blocks=(sim._get_bell_plan().nb, sim._get_bell_plan().nb_total),
                seconds=dict(setup=setup_s, run=run_s, postprocess=post_s))


def main(argv=None, device=None, dtype=None, plot=True, out_dir=None):
    """Run the script; returns rank 0's numbers (final fields ``u`` and
    ``c``, ``final_max_c``, Newton iterations, bell_bmv launches by shape
    on the card, the slab's and the plan's block counts, seconds by
    stage) with every rank's under ``ranks`` and the mesh store's path.  ``plot`` is
    unused (the reference plots nothing in 3D)."""
    p = parser(__doc__)
    p.add_argument("--atlas", type=int, nargs=3, default=(32, 32, 16),
                   metavar=("NX", "NY", "NZ"))
    p.add_argument("--ranks", type=int, default=1,
                   help="processes to spawn (not under torchrun)")
    p.add_argument("--backend", choices=("gloo", "nccl"), default="gloo")
    p.add_argument("--save-method", choices=("xdmf", "vtk"), default="xdmf")
    args = p.parse_args([] if argv is None else argv)
    device, dtype, plot = resolve(args, device, dtype, plot)
    save_method = args.save_method

    out = example_out("tumor_growth_3D_atlas_sharded", out_dir)
    atlas_dir = example_out("data", out_dir)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        # under torchrun: join the group it gives; rank 0 writes the store
        dist.init_process_group(args.backend)
        try:
            if device.type == "cuda" and args.backend == "nccl":
                device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
                torch.cuda.set_device(device)
            path = os.path.join(out, "brain_atlas_mesh_3d.h5")
            if dist.get_rank() == 0:
                path = _mesh_store(out, atlas_dir, args.atlas)
            dist.barrier()
            ranks = [_rank(make_device_mesh(device=device), path, out, dtype,
                           save_method)]
        finally:
            dist.destroy_process_group()
    else:
        path = _mesh_store(out, atlas_dir, args.atlas)
        ranks = run_ranks(_rank, args.ranks, args.backend, device,
                          args=(path, out, dtype, save_method))
    return dict(ranks[0], ranks=ranks, store=path)


if __name__ == "__main__":
    main(sys.argv[1:])
