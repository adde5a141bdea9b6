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
- Mixed-precision refinement (``refine_f64``): "auto" resolves to True
  for an f32 working dtype and to False for f64.  The reference's "auto"
  also asks for f64 kernels (``jax_enable_x64``); torch always has them,
  so the port resolves as the reference does under x64.
"""

import os

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

# -- paths (glimslib_tpu/config.py:15-21) ------------------------------------
base_dir = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
output_dir = os.environ.get("GLIMS_OUTPUT_DIR", os.path.join(base_dir, "output"))
output_dir_simulation_tmp = os.path.join(output_dir, "simulation_tmp")
output_dir_testing = os.path.join(output_dir, "testing")
test_data_dir = os.environ.get("GLIMS_TEST_DATA_DIR", os.path.join(base_dir, "test_data"))

# -- external tool locations (glimslib_tpu/config.py:23-28) ------------------
# Optional binaries: utils/meshing.py and utils/image_registration_utils.py
# gate on their presence and fall back to first-party implementations.
path_to_meshtool_bin = os.environ.get("GLIMS_MESHTOOL_BIN", "meshtool")
path_to_meshtool_xsd = os.environ.get("GLIMS_MESHTOOL_XSD", "")
path_to_ants_bin = os.environ.get("GLIMS_ANTS_BIN_DIR", "")

# -- adjoint compatibility flag (glimslib_tpu/config.py:30-33) ---------------
# The reference selects plain FEniCS or FEniCS + dolfin-adjoint at import;
# here every model is differentiable, so the flag exists for the API only.
USE_ADJOINT = False

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


# Chebyshev preconditioning degree (0/1 = the blocks' preconditioners
# alone; > 1 wraps them in the Chebyshev polynomial of that degree, an
# even one rounded up to odd), read into every model's default StepConfig.
precond_degree = int(os.environ.get("GLIMS_PRECOND_DEGREE", "0"))

# Mixed-precision refinement tri-state: "auto", "1", "0".
refine_f64 = os.environ.get("GLIMS_REFINE_F64", "auto")


def resolve_refine_f64(dtype=None):
    """Resolve the refine_f64 tri-state for a working dtype.

    Explicit GLIMS_REFINE_F64=0/1 wins; "auto" refines exactly an f32
    working dtype (f64 residuals around f32 solves), never f64; with no
    dtype given it is True, as the reference's is under x64."""
    if refine_f64 in ("0", "1"):
        return refine_f64 == "1"
    return dtype is None or dtype == torch.float32


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
