"""Carry coefficients, state and frozen preconditioner arrays from the
JAX package into the port.

The JAX package's ``make_theta`` output, initial state and
``runtime_aux()``, taken as numpy arrays (``np.asarray`` of each leaf),
become the port's tensors, so both packages can run the same problem from
the same inputs.
"""

from __future__ import annotations

import numpy as np
import torch


def theta_from_numpy(theta_np, *, device="cpu", dtype=torch.float64):
    """{name: array} (physical coefficients only, no underscore keys) ->
    {name: tensor} on ``device`` in ``dtype``."""
    derived = [k for k in theta_np if k.startswith("_")]
    if derived:
        raise ValueError(
            f"theta carries derived operator state {derived}; pass the "
            "physical coefficients only (simulate derives the planes)"
        )
    return {
        k: torch.as_tensor(np.array(v), dtype=dtype, device=device)
        for k, v in theta_np.items()
    }


def state_from_numpy(u0, c0, *, device="cpu", dtype=torch.float64):
    """Displacement (n, d) and concentration (n,) arrays -> tensors."""
    return (
        torch.as_tensor(np.array(u0), dtype=dtype, device=device),
        torch.as_tensor(np.array(c0), dtype=dtype, device=device),
    )


# the reference's runtime_aux keys the port reads, and their layouts
_AUX_FLOAT = ("_BinvSN", "_McSN", "_TLCfac", "_TLCfacS")
_AUX_NODE_LAST = {"_TLMt": (2, 0, 1), "_TLMtS": (1, 0)}  # -> node axis first
# plan tables: the port's BellPlan holds its own, equal copies
_AUX_PLAN_TABLES = ("_BellDiagPull", "_BellOffPull", "_BellPlace", "_BellHalo")


def aux_from_numpy(aux_np, *, device="cpu", dtype=torch.float64):
    """The JAX package's ``runtime_aux()`` arrays (numpy) -> the port's
    ``simulate(..., aux=...)`` dict, so both packages precondition with
    identical frozen arrays.

    Supernode inverses and coarse factors keep their layout; the mode
    matrices arrive node-axis-last (``_TLMt`` (d, q, n_pad), ``_TLMtS``
    (qs, n_pad)) and are transposed back to (n_pad, d, q) and (n_pad, qs);
    plan tables are dropped.  Anything else (the factored channel stacks
    ``_F*``, the block-lanes kernel layouts ``*T``) has no counterpart in
    the port and raises."""
    out = {}
    unknown = []
    for k, v in aux_np.items():
        if k in _AUX_PLAN_TABLES:
            continue
        a = np.asarray(v)
        if k in _AUX_NODE_LAST:
            a = np.ascontiguousarray(np.transpose(a, _AUX_NODE_LAST[k]))
        elif k not in _AUX_FLOAT:
            unknown.append(k)
            continue
        out[k] = torch.as_tensor(a.astype(np.float64), dtype=dtype, device=device)
    if unknown:
        raise ValueError(
            f"aux keys without a counterpart in the port: {sorted(unknown)} "
            "(build the reference's aux with GLIMS_FACTORED=0 on a "
            "canonical-layout path)"
        )
    return out
