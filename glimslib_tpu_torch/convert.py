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
_AUX_FLOAT = ("_BinvSN", "_McSN", "_TLCfac", "_TLCfacS",
              # the P2 supernode block-Jacobi (nb, s, s): its blocks do not
              # depend on the halo layout
              "_McSNP2",
              # the factored channel stacks (ops/bell_factored.py), raw
              # BellPlan.assemble layouts on both sides
              "_FWel", "_FCuc", "_FWrd", "_FMrd")
# the factored P2 channels, (ch, nb, s, Kh) in the P2 plan's halo layout
_AUX_P2_PLANES = ("_FP2Wrd",)
_AUX_INDEX = ("_FReps", "_FWrdRhoReps", "_FWrdDReps",  # representative cells
              "_FP2RhoReps", "_FP2DReps")
_AUX_NODE_LAST = {"_TLMt": (2, 0, 1), "_TLMtS": (1, 0)}  # -> node axis first
# plan tables: the port's plans hold their own, equal copies
_AUX_PLAN_TABLES = ("_BellDiagPull", "_BellOffPull", "_BellPlace", "_BellHalo",
                    "_P2BDiagPull", "_P2BOffPull", "_P2BPlace", "_P2BHalo")


def _bf16_tensor(a, device):
    """A bfloat16 numpy array (``ml_dtypes``) -> a torch.bfloat16 tensor
    with the same bits."""
    bits = np.ascontiguousarray(a).view(np.int16)
    return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)


def _check_p2_layout(aux_np, a):
    """A factored P2 stack carries over only in the port's flat halo
    layout: the reference's chunk-aligned halo (``GLIMS_P2_HALO_CHUNK`` >
    1, its default 4) rounds each block's external slots up to whole
    chunks, so its Kh and slot order differ."""
    halo = aux_np.get("_P2BHalo")
    place = aux_np.get("_P2BPlace")
    if halo is None or place is None:
        raise ValueError("_FP2Wrd without the reference's P2 plan tables "
                         "(_P2BHalo, _P2BPlace): its halo layout is unknown")
    nb, khe_rows = np.shape(halo)
    s = a.shape[2]
    if a.shape[3] != s + khe_rows or np.size(place) != nb * s * a.shape[3]:
        raise ValueError(
            f"_FP2Wrd {a.shape} is in a chunk-aligned halo layout ({khe_rows} "
            f"gathered rows a block for {a.shape[3] - s} external slots); the "
            "port's P2 plan has a flat halo: build the reference's aux with "
            "GLIMS_P2_HALO_CHUNK=1")


def aux_from_numpy(aux_np, *, device="cpu", dtype=torch.float64):
    """The JAX package's ``runtime_aux()`` arrays (numpy) -> the port's
    ``simulate(..., aux=...)`` dict, so both packages precondition with
    identical frozen arrays.

    Supernode inverses (``_McSNP2`` too), coarse factors and the factored
    channel stacks ``_F*`` keep their layout (a bf16 coarse factor stays
    bf16, the representative-cell indices become int64); the mode
    matrices arrive node-axis-last (``_TLMt`` (d, q, n_pad), ``_TLMtS``
    (qs, n_pad)) and are transposed back to (n_pad, d, q) and (n_pad, qs);
    plan tables (``_Bell*``, ``_P2B*``) are dropped.  The factored P2
    stack ``_FP2Wrd`` carries over when the reference built its P2 plan
    with a flat halo (``GLIMS_P2_HALO_CHUNK=1``) and raises otherwise.
    Anything else (the TPU's block-lanes kernel layouts ``*T``, the
    streamed P2 mass ``_FP2Mrd``) has no counterpart in the port and
    raises."""
    out = {}
    unknown = []
    for k, v in aux_np.items():
        if k in _AUX_PLAN_TABLES:
            continue
        a = np.asarray(v)
        if k in _AUX_P2_PLANES:
            _check_p2_layout(aux_np, a)
            out[k] = torch.as_tensor(a.astype(np.float64), dtype=dtype, device=device)
            continue
        if k in _AUX_INDEX:
            out[k] = torch.as_tensor(a.astype(np.int64), device=device)
            continue
        if k in _AUX_NODE_LAST:
            a = np.ascontiguousarray(np.transpose(a, _AUX_NODE_LAST[k]))
        elif k not in _AUX_FLOAT:
            unknown.append(k)
            continue
        if a.dtype.name == "bfloat16":
            out[k] = _bf16_tensor(a, device)
        else:
            out[k] = torch.as_tensor(a.astype(np.float64), dtype=dtype, device=device)
    if unknown:
        raise ValueError(
            f"aux keys without a counterpart in the port: {sorted(unknown)} "
            "(build the reference's aux on a canonical-layout path)"
        )
    return out
