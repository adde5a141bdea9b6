"""Carry coefficients and state from the JAX package into the port.

The JAX package's ``make_theta`` output and initial state, taken as numpy
arrays (``np.asarray`` of each leaf), become the port's tensors, so both
packages can run the same problem from the same inputs.
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
