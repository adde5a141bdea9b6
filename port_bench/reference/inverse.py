"""The inverse problem's objective and its gradient, plainly:

    J(v) = int (thresh(c_T) - target_T2)^2 dx + int |u_T - target_u|^2 dx

(upstream image_based_optimization.py:687-698), thresh(f) = (tanh((f -
level) / smooth) + 1) / 2 (l.1403-1407), the model parameters a linear
map of v.  The gradient is a central difference of J in each component,
each J from a whole reference simulation solved to the reference's
tolerances.
"""

from __future__ import annotations

import torch

# central-difference step: this share of each component of v
FD_REL_STEP = 1e-4


def model_params(base, parameter_map, v):
    """The model parameters at v: ``base`` with each mapped name set to
    sum over its terms [k, a] of a v[k]."""
    p = dict(base)
    for name, terms in parameter_map.items():
        p[name] = sum(a * float(v[k]) for k, a in terms)
    return p


def objective(ref, problem, v):
    """J at v (a sequence of floats)."""
    p = model_params(problem["base"], problem["parameter_map"], v)
    u, c = ref.simulate(p, problem["c0"], problem["n_steps"], problem["dt"])
    t = 0.5 * (torch.tanh((c - problem["level"]) / problem["smooth"]) + 1.0)
    return (ref.mass_norm2(t - problem["target_T2"])
            + ref.mass_norm2(u - problem["target_u"], vector=True))


def value_and_grad(ref, problem, v):
    """(J, [dJ/dv_k]) at v by central differences."""
    v = [float(x) for x in v]
    J = objective(ref, problem, v)
    g = []
    for k in range(len(v)):
        h = FD_REL_STEP * abs(v[k])
        up, dn = list(v), list(v)
        up[k] += h
        dn[k] -= h
        g.append((objective(ref, problem, up) - objective(ref, problem, dn)) / (2 * h))
    return J, g
