"""Global configuration of the PyTorch port.

Counterpart of ``glimslib_tpu/config.py``.  What differs:

- Precision is pinned here, at import: float32 matrix products and
  convolutions run in full float32, never TF32.  TF32 keeps about three
  decimal digits, the Hopper counterpart of the TPU's silent bf16 element
  contractions, and would stall Newton and CG short of their tolerances.
- There is no global device and no global default dtype.  Models run on
  the card (``cuda``) unless the caller asks for the CPU;
  :func:`resolve_device` raises when CUDA is absent instead of moving the
  work to the CPU.
- Mixed-precision refinement (``refine_f64``) is not ported yet, so
  :func:`resolve_refine_f64` resolves "auto" to False for every dtype.
"""

import os

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

# -- numerics ---------------------------------------------------------------

# Solver operating-point profile, read at model build time
# (glimslib_tpu/config.py:40-65 describes the two points):
#   'accurate' (default) - elasticity cg_rtol 1e-7 at f32;
#   'reference' - the reference's PETSc point: elasticity cg_rtol 1e-5 and
#     inexact-Newton forcing 1e-3 on the concentration block.
profile_default = os.environ.get("GLIMS_PROFILE", "accurate")


def resolve_profile():
    """Current solver profile ('accurate' | 'reference'); the environment
    wins so the flag can be flipped per model construction."""
    p = os.environ.get("GLIMS_PROFILE", profile_default).strip().lower()
    if p not in ("accurate", "reference"):
        raise ValueError(f"GLIMS_PROFILE={p!r}: use 'accurate' or 'reference'")
    return p


# Chebyshev preconditioning degree (0/1 = Jacobi/block-Jacobi alone).  The
# port runs degree <= 1 only; a larger value raises at model build.
precond_degree = int(os.environ.get("GLIMS_PRECOND_DEGREE", "0"))

# Mixed-precision refinement tri-state: "auto", "1", "0".
refine_f64 = os.environ.get("GLIMS_REFINE_F64", "auto")


def resolve_refine_f64(dtype=None):
    """Resolve the refine_f64 tri-state for a working dtype.

    Explicit GLIMS_REFINE_F64=0/1 wins ("1" then raises NotImplementedError
    when a step is built: refinement is not ported).  "auto" is False for
    every dtype, so the f32 default runs without refinement; that is a
    deliberate gap until refinement is ported."""
    if refine_f64 in ("0", "1"):
        return refine_f64 == "1"
    return False


# -- device and dtype --------------------------------------------------------


def resolve_device(device=None) -> torch.device:
    """The device a model runs on (default: ``cuda``; pass ``"cpu"`` for
    the CPU).

    A CUDA device without CUDA raises: the port never moves work to the
    CPU behind the caller's back."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            "is False"
        )
    return dev


def resolve_dtype(dtype=None) -> torch.dtype:
    """Working floating dtype: float32 (the card's) unless given."""
    dtype = torch.float32 if dtype is None else dtype
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"unsupported working dtype {dtype}")
    return dtype
