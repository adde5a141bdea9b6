"""Adjoint parameter estimation against RELOADED targets, 2D uniform domain.

Counterpart of ``examples/tumor_growth_2D_uniform_adjoint_reloaded.py``
(reference ``test_case_simulation_tumor_growth_2D_uniform_adjoint_reloaded.py``):
the target fields are written to disk (XDMF checkpoint there, the
whole-series ``.npz`` store here), read back into a *fresh* simulation
instance, and the inverse problem is solved against the reloaded fields
— the round-trip the reference uses to decouple target generation from
inversion.

Run: ``python -m glimslib_tpu_torch.example_scripts.tumor_growth_2D_uniform_adjoint_reloaded``
"""

import os
import sys

import numpy as np

from glimslib_tpu_torch.example_scripts._adjoint import first_call, uniform_sim
from glimslib_tpu_torch.example_scripts.example_config import example_out, parser, resolve
from glimslib_tpu_torch.optimize.adjoint import InverseProblem, tumor_growth_param_map
from glimslib_tpu_torch.utils.data_io import store_path
from glimslib_tpu_torch.utils.profiling import Tracer

# the reference script's limit on each recovered parameter's relative
# error, held at both dtypes
RECOVERY_RTOL = 1e-3


def main(argv=None, device=None, dtype=None, plot=True, out_dir=None):
    """Run the script; returns what ``tumor_growth_2D_uniform_adjoint``
    returns and the limit the relative errors were held to.  ``plot`` is
    unused."""
    p = parser(__doc__)
    p.add_argument("--n", type=int, default=25, help="mesh resolution")
    args = p.parse_args([] if argv is None else argv)
    device, dtype, plot = resolve(args, device, dtype, plot)
    tracer = Tracer()

    out = example_out("tumor_growth_2D_uniform_adjoint_reloaded", out_dir)

    def build(**param_overrides):
        # seed off-center like the reference reloaded case (x0=y0=2.5)
        return uniform_sim(args.n, device, dtype, seed=(2.5, 2.5), **param_overrides)

    # 1. forward-simulate the target trajectory with the TRUE parameters and
    #    checkpoint the whole series (reference l.99-124 writes XDMF)
    names, update = tumor_growth_param_map(3)
    v_true = np.array([0.05, 0.05, 0.1])  # reference targets (l.96-98)
    with tracer.scope("targets"):
        sim_target = build(**update(v_true))
        sim_target.run(keep_nth=1, save_method=None, plot=False, output_dir=out)
    ckpt = store_path(os.path.join(out, "solution_timeseries.h5"))
    if not os.path.exists(ckpt):
        raise AssertionError(f"no checkpoint at {ckpt}")
    print("target checkpoint:", ckpt)

    # 2. fresh instance: reload the targets from disk (reference l.140-150)
    with tracer.scope("reload"):
        sim = build()
        sim.reload_from_hdf5(ckpt, output_dir=out)
    last = sim.results.get_recording_steps()[-1]
    fields = sim.results.get_result(last)
    u_target = np.asarray(fields[0])
    c_target = np.asarray(fields[1])
    print("reloaded target fields from step", last)

    # 3. invert against the reloaded fields (reference J at l.178-180)
    ip = InverseProblem(
        sim, names, {"conc": c_target, "disp": u_target}, update_fn=update
    )
    x0 = np.array([0.1, 0.1, 0.2])  # reference initial guesses (l.131-133)
    with tracer.scope("inverse"):
        x_opt, progress, res = ip.minimize(
            x0, bounds=[(0.005, 0.5)] * len(names),
            opt_params={"tol": 1e-10, "gtol": 1e-8},
        )
    progress.save(path_pkl=os.path.join(out, "optimization_progress.pkl"),
                  path_xls=os.path.join(out, "optimization_progress.xls"))
    rel = np.abs(x_opt - v_true) / v_true
    print("true:", dict(zip(names, v_true)))
    print("recovered:", dict(zip(names, x_opt)))
    print("iterations:", progress.number_iterations, "J:", res.fun, "->", out)
    if not (rel < RECOVERY_RTOL).all():
        raise AssertionError(f"relative errors {rel} (limit {RECOVERY_RTOL})")
    J0, g0 = first_call(progress)
    return dict(names=names, v_true=v_true, x_opt=np.asarray(x_opt), rel_errors=rel,
                rtol=RECOVERY_RTOL, J0=J0, grad0=g0, J=float(res.fun),
                calls=progress.number_iterations, sim=sim, stages=tracer.summary())


if __name__ == "__main__":
    main(sys.argv[1:])
