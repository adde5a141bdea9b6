"""Adjoint parameter estimation, 2D uniform domain.

Counterpart of ``examples/tumor_growth_2D_uniform_adjoint.py`` (reference
``test_case_simulation_tumor_growth_2D_uniform_adjoint.py``, l.33-104):
forward-simulate with known (D, rho, coupling), build the misfit
functional on the final state, recover the parameters with bounded
L-BFGS-B.  The dolfin-adjoint ReducedFunctional machinery becomes
``InverseProblem.value_and_grad``: autograd through the time loop, each
step's implicit-function-theorem adjoint.

Variants covered by flags:
  --noise 0.05       noisy targets (…_adjoint_noise.py)
  --params 2         2-parameter estimation (run_for_adjoint2)
"""

import os
import sys

import numpy as np

from glimslib_tpu_torch.example_scripts._adjoint import first_call, simulate, uniform_sim
from glimslib_tpu_torch.example_scripts.example_config import example_out, parser, resolve
from glimslib_tpu_torch.optimize.adjoint import InverseProblem, tumor_growth_param_map
from glimslib_tpu_torch.utils.profiling import Tracer


def main(argv=None, device=None, dtype=None, plot=True, out_dir=None):
    """Run the script; returns the parameter names, true and recovered
    values, their relative errors, J and the gradient at x0 (L-BFGS-B's
    first call), the final J, the number of calls, the model and the
    seconds by stage.  ``plot`` is unused (the script draws nothing)."""
    p = parser(__doc__)
    p.add_argument("--noise", type=float, default=0.0)
    p.add_argument("--params", type=int, default=3, choices=[2, 3])
    p.add_argument("--n", type=int, default=25, help="mesh resolution")
    args = p.parse_args([] if argv is None else argv)
    device, dtype, plot = resolve(args, device, dtype, plot)
    tracer = Tracer()

    with tracer.scope("setup"):
        sim = uniform_sim(args.n, device, dtype)
    names, update = tumor_growth_param_map(args.params)
    v_true = {3: np.array([0.1, 0.1, 0.2]), 2: np.array([0.1, 0.1])}[args.params]

    # synthesize targets with the true parameters (reference l.70-90)
    with tracer.scope("targets"):
        u_traj, c_traj = simulate(sim, {**sim.params.as_dict(), **update(v_true)},
                                  5, 1.0)
    rng = np.random.default_rng(0)
    c_target = c_traj[-1]
    u_target = u_traj[-1]
    if args.noise > 0:
        c_target = c_target + args.noise * rng.standard_normal(c_target.shape)
        u_target = u_target + args.noise * np.abs(u_target).max() * rng.standard_normal(
            u_target.shape
        )

    ip = InverseProblem(
        sim, names, {"conc": c_target, "disp": u_target}, update_fn=update
    )
    x0 = np.full(len(names), 0.05)
    with tracer.scope("inverse"):
        x_opt, progress, res = ip.minimize(
            x0, bounds=[(0.005, 0.5)] * len(names),
            opt_params={"tol": 1e-10, "gtol": 1e-8},
        )
    out = example_out("tumor_growth_2D_uniform_adjoint", out_dir)
    progress.save(path_pkl=os.path.join(out, "optimization_progress.pkl"),
                  path_xls=os.path.join(out, "optimization_progress.xls"))
    print("true:", dict(zip(names, v_true)))
    print("recovered:", dict(zip(names, x_opt)))
    print("iterations:", progress.number_iterations,
          "J:", res.fun, "->", out)
    J0, g0 = first_call(progress)
    return dict(names=names, v_true=v_true, x_opt=np.asarray(x_opt),
                rel_errors=np.abs(x_opt - v_true) / v_true, J0=J0, grad0=g0,
                J=float(res.fun), calls=progress.number_iterations,
                noise=args.noise, sim=sim, stages=tracer.summary())


if __name__ == "__main__":
    main(sys.argv[1:])
