"""Adjoint parameter estimation with a USER-SUPPLIED minimizer.

Counterpart of
``examples/tumor_growth_2D_uniform_adjoint_custom_minimizer.py``
(reference ``test_case_simulation_tumor_growth_2D_uniform_adjoint_custom_minimizer.py``
+ the pluggable ``custom_optimizer`` hook,
image_based_optimization.py:646-658): the optimization algorithm is a
user callable ``algorithm(J, x0, dJ, H, bounds, **kw)`` handed to the
driver instead of the built-in L-BFGS-B.  Here the custom algorithm wraps
scipy's TNC, like the reference's wraps ``scipy.optimize.minimize``.

Run: ``python -m glimslib_tpu_torch.example_scripts.tumor_growth_2D_uniform_adjoint_custom_minimizer``
"""

import os
import sys

import numpy as np

from glimslib_tpu_torch.example_scripts._adjoint import first_call, simulate, uniform_sim
from glimslib_tpu_torch.example_scripts.example_config import example_out, parser, resolve
from glimslib_tpu_torch.optimize.adjoint import InverseProblem, tumor_growth_param_map
from glimslib_tpu_torch.utils.profiling import Tracer

# the reference script's limit on each recovered parameter's relative
# error, held at both dtypes
RECOVERY_RTOL = 1e-2


def custom_optimizer(J, m_global, dJ, H, bounds, **kwargs):
    """Reference custom_optimizer signature
    (image_based_optimization.py:646-658): wrap any scipy method."""
    from scipy.optimize import minimize as scipy_minimize

    opt_res = scipy_minimize(J, m_global, jac=dJ, method="TNC",
                             bounds=bounds, **kwargs)
    print("-- custom optimizer finished:", opt_res.message)
    return np.array(opt_res["x"])


def main(argv=None, device=None, dtype=None, plot=True, out_dir=None):
    """Run the script; returns what ``tumor_growth_2D_uniform_adjoint``
    returns and the limit the relative errors were held to.  ``plot`` is
    unused."""
    p = parser(__doc__)
    p.add_argument("--n", type=int, default=25, help="mesh resolution")
    args = p.parse_args([] if argv is None else argv)
    device, dtype, plot = resolve(args, device, dtype, plot)
    tracer = Tracer()

    with tracer.scope("setup"):
        sim = uniform_sim(args.n, device, dtype)
    names, update = tumor_growth_param_map(3)
    v_true = np.array([0.05, 0.05, 0.1])

    with tracer.scope("targets"):
        u_traj, c_traj = simulate(sim, {**sim.params.as_dict(), **update(v_true)},
                                  5, 1.0)

    ip = InverseProblem(
        sim, names,
        {"conc": c_traj[-1], "disp": u_traj[-1]},
        update_fn=update,
    )
    x0 = np.array([0.1, 0.01, 0.05])
    with tracer.scope("inverse"):
        x_opt, progress, res = ip.minimize(
            x0, bounds=[(0.005, 0.5)] * len(names),
            opt_params={"algorithm": custom_optimizer, "tol": 1e-12},
        )
    out = example_out("tumor_growth_2D_uniform_adjoint_custom_minimizer", out_dir)
    progress.save(path_pkl=os.path.join(out, "optimization_progress.pkl"),
                  path_xls=os.path.join(out, "optimization_progress.xls"))
    rel = np.abs(x_opt - v_true) / v_true
    print("true:", dict(zip(names, v_true)))
    print("recovered:", dict(zip(names, x_opt)))
    print("evals:", progress.number_iterations, "J:", res.fun, "->", out)
    if not (rel < RECOVERY_RTOL).all():
        raise AssertionError(f"relative errors {rel} (limit {RECOVERY_RTOL})")
    J0, g0 = first_call(progress)
    return dict(names=names, v_true=v_true, x_opt=np.asarray(x_opt), rel_errors=rel,
                rtol=RECOVERY_RTOL, J0=J0, grad0=g0, J=float(res.fun),
                calls=progress.number_iterations, sim=sim,
                stages=tracer.summary())


if __name__ == "__main__":
    main(sys.argv[1:])
