"""The JAX package's ``value_and_grad`` together with the forward that runs
inside it, as one jitted program: the port's parity tests compare their
forward, J and gradient with it at the gradient's point instead of
tracing and compiling the JAX forward a second time on its own.

``value_and_grad_with_forward(sim, names, update, targets, v, n_steps,
monkeypatch)`` wraps the model's simulate so that a debug callback hands
out its trajectory, and the solvers' ``pcg`` so that each solve hands out
its CG iterations, tagged ``"forward"`` when it is traced in the
forward's trace and ``"adjoint"`` when it is traced after it (the IFT
backward's solves).  Returns J, the gradient, the trajectory (u, c, ok,
newton), the CG counts of the forward's solves and of all of them, by
block ("rd": scalar, "el": vector), sorted (the callbacks run unordered),
and the keys of the frozen state (``runtime_aux``) the problem took.
"""

import jax
import numpy as np

from glimslib_tpu.optimize.adjoint import InverseProblem
from glimslib_tpu.solvers import coupled


def value_and_grad_with_forward(sim, names, update, targets, v, n_steps, monkeypatch,
                                **ip_kw):
    rec, traj, phase = [], {}, ["forward"]
    pcg = coupled.pcg

    def counted(A, b, **kw):
        x, info = pcg(A, b, **kw)
        jax.debug.callback(lambda it, nd=b.ndim, ph=phase[0]: rec.append((ph, nd, int(it))),
                           info["iters"])
        return x, info

    build = sim.build_simulate_fn

    def build_recorded(n, dt):
        simulate = build(n, dt)

        def recorded(theta, u0, c0, aux=None):
            out = simulate(theta, u0, c0, aux)
            phase[0] = "adjoint"
            jax.debug.callback(lambda *o: traj.update(zip(
                ("u", "c", "ok", "newton"), (np.asarray(a) for a in o))), *out)
            return out
        return recorded

    def counts(phases):
        return {"rd": sorted(i for ph, nd, i in rec if nd == 1 and ph in phases),
                "el": sorted(i for ph, nd, i in rec if nd == 2 and ph in phases)}

    aux, runtime_aux = [], sim.runtime_aux
    with monkeypatch.context() as m:
        m.setattr(coupled, "pcg", counted)
        m.setattr(sim, "build_simulate_fn", build_recorded)
        m.setattr(sim, "runtime_aux", lambda: aux.append(runtime_aux()) or aux[-1])
        J, g = InverseProblem(sim, names, targets, update_fn=update, n_steps=n_steps,
                              dt=1.0, **ip_kw).value_and_grad(np.asarray(v))
    return dict(J=float(J), g=np.asarray(g, np.float64), u=traj["u"], c=traj["c"],
                ok=bool(traj["ok"].all()), newton=traj["newton"].tolist(),
                counts=counts(("forward",)), vg_counts=counts(("forward", "adjoint")),
                aux=sorted(aux[-1]))
