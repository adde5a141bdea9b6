"""Offset-stencil matvecs: the CUDA kernel ``stencil_apply`` and its plain
torch version (counterpart of ``glimslib_tpu/ops/stencil_pallas.py``).

Three wrappers, one per shape the lattice step applies:

- :func:`apply_scalar`   W (n_off, n),       v (n,)   -> (n,)    [K1]
- :func:`apply_vector`   W (n_off, d, d, n), u (n, d) -> (n, d)  [K2]
- :func:`apply_coupling` C (n_off, d, n),    c (n,)   -> (n, d)  [K2, d_in=1]

all computing ``y[i, a] = sum_o sum_b W[o, a, b, i] v[(i + off_o) mod n, b]``.
A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches ``stencil_apply<d_out, d_in>`` (``csrc/stencil.cu``) or raises.
Each wrapper counts its kernel launches in its ``launches`` attribute.
"""

from __future__ import annotations

import torch

from glimslib_tpu_torch import _build

# (d_out, d_in) instantiated in csrc/stencil.cu
KERNEL_SHAPES = ((1, 1), (3, 3), (3, 1))


def stencil_apply_plain(offsets, W, v):
    """Plain torch stencil apply: W (n_off, d_out, d_in, n), v (n, d_in) ->
    (n, d_out).  Sums over offsets, then input components, in order."""
    n_off, d_out, d_in, n = W.shape
    acc = torch.zeros((d_out, n), dtype=v.dtype, device=v.device)
    for o, off in enumerate(offsets):
        sh = v if off == 0 else torch.roll(v, -int(off), dims=0)
        for b in range(d_in):
            acc = acc + W[o, :, b] * sh[:, b]
    return acc.T.contiguous()


def _check_cuda(name, t, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32 on CUDA, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def stencil_apply_cuda(offsets, W, v):
    """Launch ``stencil_apply<d_out, d_in>`` on the current stream."""
    n_off, d_out, d_in, n = W.shape
    if (d_out, d_in) not in KERNEL_SHAPES:
        raise NotImplementedError(
            f"stencil_apply has no kernel for (d_out, d_in)={(d_out, d_in)}"
        )
    if len(offsets) != n_off:
        raise ValueError(f"{len(offsets)} offsets for {n_off} planes")
    _check_cuda("W", W, (n_off, d_out, d_in, n), W.device)
    _check_cuda("v", v, (n, d_in), W.device)
    y = torch.empty((n, d_out), dtype=torch.float32, device=W.device)
    lib = _build.load()
    _build.check(lib.glims_stencil_apply(
        d_out, d_in, W.data_ptr(), v.data_ptr(), y.data_ptr(), n,
        _build.offsets_array(offsets), n_off,
        torch.cuda.current_stream(W.device).cuda_stream,
    ), "stencil_apply launch")
    return y


def _dispatch(wrapper, offsets, W4, v2):
    if W4.device.type == "cpu" and v2.device.type == "cpu":
        return stencil_apply_plain(offsets, W4, v2)
    if W4.device.type != "cuda":
        raise ValueError(f"unsupported device {W4.device}")
    y = stencil_apply_cuda(offsets, W4, v2)
    wrapper.launches += 1
    return y


def apply_scalar_plain(offsets, W, v):
    return stencil_apply_plain(offsets, W[:, None, None, :], v[:, None])[:, 0]


def apply_scalar(offsets, W, v):
    """(A v)[i] = sum_o W[o, i] v[i + off_o]; W (n_off, n), v (n,)."""
    return _dispatch(apply_scalar, offsets, W[:, None, None, :], v[:, None])[:, 0]


def apply_vector_plain(offsets, W, u):
    return stencil_apply_plain(offsets, W, u)


def apply_vector(offsets, W, u):
    """(A u)[i, a] = sum_o sum_b W[o, a, b, i] u[i + off_o, b]."""
    return _dispatch(apply_vector, offsets, W, u)


def apply_coupling_plain(offsets, C, c):
    return stencil_apply_plain(offsets, C[:, :, None, :], c[:, None])


def apply_coupling(offsets, C, c):
    """(C c)[i, a] = sum_o C[o, a, i] c[i + off_o]; returns (n, d)."""
    return _dispatch(apply_coupling, offsets, C[:, :, None, :], c[:, None])


apply_scalar.launches = 0
apply_vector.launches = 0
apply_coupling.launches = 0
