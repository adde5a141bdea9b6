"""Adjoint parameter estimation from NOISY targets, 2D uniform domain.

Counterpart of ``examples/tumor_growth_2D_uniform_adjoint_noise.py``
(reference ``test_case_simulation_tumor_growth_2D_uniform_adjoint_noise.py``):
the target concentration/displacement fields are perturbed with Gaussian
noise before inversion, and a Tikhonov term ``alpha * inner(u, u) * dx``
stabilizes the functional (reference l.98-135; the shipped case uses
conc noise 0.1, disp noise 0.05, alpha 0.5).

Run: ``python -m glimslib_tpu_torch.example_scripts.tumor_growth_2D_uniform_adjoint_noise``
"""

import os
import sys

import numpy as np

from glimslib_tpu_torch.example_scripts._adjoint import first_call, simulate, uniform_sim
from glimslib_tpu_torch.example_scripts.example_config import example_out, parser, resolve
from glimslib_tpu_torch.optimize.adjoint import InverseProblem, tumor_growth_param_map
from glimslib_tpu_torch.utils.profiling import Tracer


def main(argv=None, device=None, dtype=None, plot=True, out_dir=None):
    """Run the script; returns what ``tumor_growth_2D_uniform_adjoint``
    returns and the limit the relative errors were held to.  ``plot`` is
    unused."""
    p = parser(__doc__)
    p.add_argument("--n", type=int, default=25, help="mesh resolution")
    p.add_argument("--conc-noise", type=float, default=0.1)
    p.add_argument("--disp-noise", type=float, default=0.05)
    p.add_argument("--alpha", type=float, default=1e-4,
                   help="Tikhonov weight (reference uses 0.5 on a "
                        "different normalization; keep it small enough "
                        "not to bias the recovered parameters)")
    args = p.parse_args([] if argv is None else argv)
    device, dtype, plot = resolve(args, device, dtype, plot)
    tracer = Tracer()

    with tracer.scope("setup"):
        sim = uniform_sim(args.n, device, dtype)
    names, update = tumor_growth_param_map(3)
    v_true = np.array([0.05, 0.05, 0.1])  # reference targets (l.79-81)

    with tracer.scope("targets"):
        u_traj, c_traj = simulate(sim, {**sim.params.as_dict(), **update(v_true)},
                                  5, 1.0)

    # perturb the targets (reference add_noise, l.98-103)
    rng = np.random.default_rng(0)
    c_target = c_traj[-1] + args.conc_noise * rng.standard_normal(
        c_traj[-1].shape
    )
    u_target = u_traj[-1] + args.disp_noise * rng.standard_normal(
        u_traj[-1].shape
    )

    ip = InverseProblem(
        sim, names, {"conc": c_target, "disp": u_target}, update_fn=update,
        reg_alpha=args.alpha,
    )
    x0 = np.array([0.1, 0.01, 0.05])  # reference initial guesses (l.88-90)
    with tracer.scope("inverse"):
        x_opt, progress, res = ip.minimize(
            x0, bounds=[(0.005, 0.5)] * len(names),
            opt_params={"tol": 1e-10, "gtol": 1e-8},
        )
    out = example_out("tumor_growth_2D_uniform_adjoint_noise", out_dir)
    progress.save(path_pkl=os.path.join(out, "optimization_progress.pkl"),
                  path_xls=os.path.join(out, "optimization_progress.xls"))
    rel = np.abs(x_opt - v_true) / v_true
    print("true:", dict(zip(names, v_true)))
    print("recovered:", dict(zip(names, x_opt)))
    print("relative errors:", dict(zip(names, rel)))
    print("iterations:", progress.number_iterations, "J:", res.fun, "->", out)
    # noise-robustness: parameters still recovered to a few percent at the
    # default resolution; coarse meshes average over fewer noisy samples, so
    # the acceptance band widens accordingly
    tol = 0.2 if args.n >= 25 else 0.5
    if not (rel < tol).all():
        raise AssertionError(f"relative errors {rel} (limit {tol})")
    J0, g0 = first_call(progress)
    return dict(names=names, v_true=v_true, x_opt=np.asarray(x_opt), rel_errors=rel,
                rtol=tol, J0=J0, grad0=g0, J=float(res.fun),
                calls=progress.number_iterations, sim=sim, stages=tracer.summary())


if __name__ == "__main__":
    main(sys.argv[1:])
