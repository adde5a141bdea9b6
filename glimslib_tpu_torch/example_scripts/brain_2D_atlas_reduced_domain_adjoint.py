"""Reduced-domain brain adjoint: cut the domain down to the tissues of
interest, then estimate parameters on the reduced mesh.

Counterpart of ``examples/brain_2D_atlas_reduced_domain_adjoint.py``
(reference ``test_case_simulation_tumor_growth_brain_2D_atlas_reduced_domain_adjoint_mpi_separated_functional.py``
and the workflow's ``_reduce_2d_domain``,
image_based_optimization.py:251-257): the 'outside' subdomain is removed
with a threshold round-trip (utils.data_io.remove_mesh_subdomain), the
brain model runs on the reduced mesh (no lattice left: the unstructured
lane), and a 2-parameter inverse problem recovers (D_WM, rho_WM).
The mesh, the model and the problem are ``glimslib_tpu_torch.examples``'
``atlas2d_mesh``, ``atlas2d_sim`` and ``atlas2d_problem``.

Run: ``python -m glimslib_tpu_torch.example_scripts.brain_2D_atlas_reduced_domain_adjoint``
(``--atlas NX NY NZ --z`` set the synthetic atlas and its slice).
"""

import os
import sys

import numpy as np

from glimslib_tpu_torch.example_scripts._adjoint import first_call
from glimslib_tpu_torch.example_scripts.example_config import (
    BRAIN_PARAMS_VARYING, example_out, parser, resolve,
)
from glimslib_tpu_torch.examples import atlas2d_mesh, atlas2d_problem, atlas2d_sim
from glimslib_tpu_torch.utils.profiling import Tracer


def main(argv=None, device=None, dtype=None, plot=True, out_dir=None):
    """Run the script; returns the parameter names, true and recovered
    values, their relative errors, J and the gradient at x0, the final
    J, the number of calls, the mesh sizes, the model and the seconds by
    stage.  ``plot`` is unused."""
    p = parser(__doc__)
    p.add_argument("--atlas", type=int, nargs=3, default=(64, 64, 24),
                   metavar=("NX", "NY", "NZ"))
    p.add_argument("--z", type=int, default=12, help="the atlas slice")
    args = p.parse_args([] if argv is None else argv)
    device, dtype, plot = resolve(args, device, dtype, plot)
    tracer = Tracer()

    out = example_out("brain_2D_atlas_reduced_domain_adjoint", out_dir)

    # 1-2. atlas slice -> full-domain mesh + labels -> the 'outside'
    # subdomain (id 0) removed: the reduced mesh
    with tracer.scope("domain"):
        domain = atlas2d_mesh(*args.atlas, z_slice=args.z)
    mesh, _, mesh_full, _ = domain
    print(f"reduced domain: {mesh_full.n_cells} -> {mesh.n_cells} cells")

    # 3. synthesize targets with the true parameters (c_T thresholded at
    # 0.12 and 0.80, u_T)
    with tracer.scope("targets"):
        sim = atlas2d_sim(dtype=dtype, device=device, domain=domain)
        ip, x0 = atlas2d_problem(sim=sim)

    # 4. 2-parameter estimation from a perturbed start (D_GM tied = 0.2 D_WM)
    names = ip.param_names
    with tracer.scope("inverse"):
        x_opt, progress, res = ip.minimize(
            x0=x0, opt_params={"tol": 1e-10, "gtol": 1e-8},
        )
    v_true = np.array([BRAIN_PARAMS_VARYING["D_WM"], BRAIN_PARAMS_VARYING["rho_WM"]])
    print("true:", v_true.tolist())
    print("recovered:", dict(zip(names, x_opt)))
    print("iterations:", progress.number_iterations, "J:", res.fun)
    progress.save(path_pkl=os.path.join(out, "optimization_progress.pkl"))
    print("->", out)
    J0, g0 = first_call(progress)
    return dict(names=names, v_true=v_true, x_opt=np.asarray(x_opt),
                rel_errors=np.abs(x_opt - v_true) / v_true, J0=J0, grad0=g0,
                J=float(res.fun), calls=progress.number_iterations,
                nodes=mesh.n_nodes, cells=(mesh_full.n_cells, mesh.n_cells),
                sim=sim, stages=tracer.summary())


if __name__ == "__main__":
    main(sys.argv[1:])
