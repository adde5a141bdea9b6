"""The port's ``InverseProblem.value_and_grad`` together with the forward
that runs inside it, for the parity tests that hold both against the JAX
package's (tests/torch_jax_vg.py).  Imports no JAX: the ranks that
``run_ranks`` spawns import it."""

import numpy as np


def value_and_grad_with_forward(ip, v):
    """(J, gradient, (u, c, ok, newton)) of ``ip`` at ``v``: the trajectory
    is the one its simulate returned inside value_and_grad, detached."""
    simulate, seen = ip._simulate, []
    ip._simulate = lambda *a: seen.append(simulate(*a)) or seen[-1]
    try:
        J, g = ip.value_and_grad(np.asarray(v))
    finally:
        ip._simulate = simulate
    return J, g, tuple(t.detach() for t in seen[-1])
