"""Batched dense matvec of the supernode halo-ELL operators: the CUDA
kernel ``bell_bmv`` and its plain torch version (counterpart of
``glimslib_tpu/ops/bell_pallas.py``).

    y[b, m] = sum_k A[b, m, k] x[b, k],   A (B, M, K), x (B, K) -> (B, M)

Every halo-ELL matvec and every supernode block-Jacobi apply of the
unstructured path (``ops/bell.py``) is one such contraction.  The TPU
package kept three layouts of it (K4a canonical, K4b chunked
(B/128, M, K, 128), K4c block-lanes (M, K, B)) to put the block axis on
its lanes; the port keeps the canonical layout and one kernel.

:func:`batched_matvec` given CPU tensors runs the plain version; given
CUDA tensors it launches ``bell_bmv`` (``csrc/bell.cu``) or raises.  It
counts its kernel launches in its ``launches`` attribute.
"""

from __future__ import annotations

import torch

from glimslib_tpu_torch import _build
from glimslib_tpu_torch.ops.stencil_kernels import _check_cuda


def batched_matvec_plain(A, x):
    """Plain torch batched matvec (the reference's own fallback,
    ``bell_pallas.py:99``)."""
    return (A * x[:, None, :]).sum(dim=-1)


def batched_matvec_cuda(A, x):
    """Launch ``bell_bmv`` on the current stream."""
    B, M, K = A.shape
    _check_cuda("A", A, (B, M, K), A.device)
    _check_cuda("x", x, (B, K), A.device)
    y = torch.empty((B, M), dtype=torch.float32, device=A.device)
    lib = _build.load("bell")
    _build.check(lib.glims_bell_bmv(
        A.data_ptr(), x.data_ptr(), y.data_ptr(), B, M, K,
        torch.cuda.current_stream(A.device).cuda_stream,
    ), "bell_bmv launch")
    return y


def batched_matvec(A, x):
    """y[b] = A[b] @ x[b]; A (B, M, K), x (B, K)."""
    if A.device.type == "cpu" and x.device.type == "cpu":
        return batched_matvec_plain(A, x)
    if A.device.type != "cuda":
        raise ValueError(f"unsupported device {A.device}")
    y = batched_matvec_cuda(A, x)
    batched_matvec.launches += 1
    return y


batched_matvec.launches = 0
