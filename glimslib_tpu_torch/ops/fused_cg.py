"""Whole-solve stencil PCG: the CUDA kernel ``stencil_pcg`` and its plain
torch version (counterpart of ``glimslib_tpu/ops/pallas_cg.py``).

Dirichlet masking is folded into the operator before the solve: the
masked CG operator

    A''(v) = m * v + (1-m) * A((1-m) * v)

is itself an offset-stencil operator with planes
``W''[o,a,b,i] = (1-m[i,a]) W[o,a,b,i] (1-m[i+off_o,b])`` plus +1 on the
zero-offset diagonal of masked dofs, so the kernel applies no masks.

- :func:`cg_scalar`  Jacobi PCG on W'' (n_off, n), invd (n,), b (n,)      [K3a]
- :func:`cg_vector`  block-Jacobi PCG on W'' (n_off, d, d, n),
  Binv'' (d, d, n), b (n, d)                                               [K3b]

Both start from x0 = 0 and follow ``solvers/cg.py:pcg`` (same update order,
same stopping rule) and return ``(x, {"iters", "resnorm"})`` with the info
as 0-d tensors on the input's device.  Given CPU tensors they run the plain
version; given CUDA tensors they launch ``stencil_pcg<d>`` (one cooperative
launch per solve, ``csrc/stencil.cu``) or raise.  Each wrapper counts its
kernel launches in its ``launches`` attribute.
"""

from __future__ import annotations

import torch

from glimslib_tpu_torch import _build
from glimslib_tpu_torch.ops.stencil import apply_block_jacobi
from glimslib_tpu_torch.ops.stencil_kernels import _check_cuda, stencil_apply_plain
from glimslib_tpu_torch.solvers.cg import pcg

_PCG_BLOCK = 256  # GLIMS_PCG_BLOCK in csrc/stencil.cu


# -- mask folding (torch, once per theta or per Newton iteration) -----------


def fold_mask_scalar(offsets, W, mask):
    """Masked scalar planes: W''[o,i] = f[i] W[o,i] f[i+off], f = 1-mask,
    plus +1 on the zero-offset plane at masked nodes."""
    f = 1.0 - mask.to(W.dtype)
    planes = []
    for o, off in enumerate(offsets):
        fs = f if off == 0 else torch.roll(f, -off)
        planes.append(W[o] * f * fs)
    Wm = torch.stack(planes)
    Wm[list(offsets).index(0)] += mask.to(W.dtype)
    return Wm


def fold_mask_vector(offsets, W, mask):
    """Masked vector planes (mask (n, d), W (n_off, d, d, n)):
    W''[o,a,b,i] = f[i,a] W[o,a,b,i] f[i+off,b], +1 on (o0,a,a) at masked
    dofs."""
    d = W.shape[1]
    fT = (1.0 - mask.to(W.dtype)).T  # (d, n)
    planes = []
    for o, off in enumerate(offsets):
        fsT = fT if off == 0 else torch.roll(fT, -off, dims=1)
        planes.append(W[o] * fT[:, None, :] * fsT[None, :, :])
    Wm = torch.stack(planes)
    eye = torch.eye(d, dtype=W.dtype, device=W.device)
    Wm[list(offsets).index(0)] += eye[:, :, None] * mask.to(W.dtype).T[None, :, :]
    return Wm


def fold_mask_binv(Binv, mask):
    """Masked block-Jacobi inverse (Binv (d,d,n), mask (n,d)):
    B''[a,b,i] = f[i,a] Binv[a,b,i] f[i,b], +1 on (a,a) at masked dofs."""
    d = Binv.shape[0]
    f = (1.0 - mask.to(Binv.dtype)).T  # (d, n)
    eye = torch.eye(d, dtype=Binv.dtype, device=Binv.device)
    return (Binv * f[:, None, :] * f[None, :, :]
            + eye[:, :, None] * mask.to(Binv.dtype).T[None, :, :])


def fold_mask_invdiag(diag, mask):
    """Masked inverse diagonal: 1 on masked dofs, 1/diag elsewhere."""
    return torch.where(mask, torch.ones_like(diag), 1.0 / diag)


# -- plain versions ----------------------------------------------------------


def cg_scalar_plain(offsets, Wm, invd, b, rtol, atol, maxiter):
    W4 = Wm[:, None, None, :]
    return pcg(lambda v: stencil_apply_plain(offsets, W4, v[:, None])[:, 0],
               b, M=lambda r: invd * r, rtol=rtol, atol=atol, maxiter=maxiter)


def cg_vector_plain(offsets, Wm, Binv, b, rtol, atol, maxiter):
    return pcg(lambda v: stencil_apply_plain(offsets, Wm, v), b,
               M=lambda r: apply_block_jacobi(Binv, r),
               rtol=rtol, atol=atol, maxiter=maxiter)


# -- kernel wrappers ---------------------------------------------------------


def _pcg_cuda(d, offsets, W4, Minv, b, rtol, atol, maxiter):
    n_off, n = W4.shape[0], W4.shape[-1]
    if d not in (1, 3):
        raise NotImplementedError(f"stencil_pcg has no kernel for d={d}")
    if len(offsets) != n_off:
        raise ValueError(f"{len(offsets)} offsets for {n_off} planes")
    dev = W4.device
    _check_cuda("W", W4, (n_off, d, d, n), dev)
    _check_cuda("M", Minv, (n,) if d == 1 else (d, d, n), dev)
    _check_cuda("b", b, (n,) if d == 1 else (n, d), dev)
    x = torch.empty_like(b)
    iters = torch.empty((), dtype=torch.int32, device=dev)
    resnorm = torch.empty((), dtype=torch.float32, device=dev)
    nd = n * d
    scratch = torch.empty(4 * nd + 3 * (-(-nd // _PCG_BLOCK)),
                          dtype=torch.float32, device=dev)
    lib = _build.load("stencil")
    _build.check(lib.glims_stencil_pcg(
        d, W4.data_ptr(), Minv.data_ptr(), b.data_ptr(), x.data_ptr(),
        iters.data_ptr(), resnorm.data_ptr(), scratch.data_ptr(), n,
        _build.offsets_array(offsets), n_off, float(rtol), float(atol),
        int(maxiter), torch.cuda.current_stream(dev).cuda_stream,
    ), f"stencil_pcg<{d}> launch")
    return x, {"iters": iters, "resnorm": resnorm}


def _dispatch(wrapper, plain, d, offsets, W, W4, Minv, b, rtol, atol, maxiter):
    if all(t.device.type == "cpu" for t in (W, Minv, b)):
        return plain(offsets, W, Minv, b, rtol, atol, maxiter)
    if W.device.type != "cuda":
        raise ValueError(f"unsupported device {W.device}")
    out = _pcg_cuda(d, offsets, W4, Minv, b, rtol, atol, maxiter)
    wrapper.launches += 1
    return out


def cg_scalar(offsets, Wm, invd, b, rtol, atol, maxiter):
    """Solve W'' x = b with Jacobi PCG; ``Wm`` mask-folded (n_off, n),
    ``invd`` masked inverse diagonal (n,), ``b`` (n,)."""
    return _dispatch(cg_scalar, cg_scalar_plain, 1, offsets, Wm,
                     Wm[:, None, None, :], invd, b, rtol, atol, maxiter)


def cg_vector(offsets, Wm, Binv, b, rtol, atol, maxiter):
    """Solve W'' x = b with block-Jacobi PCG; ``Wm`` mask-folded
    (n_off, d, d, n), ``Binv`` masked block inverse (d, d, n), ``b`` (n, d)."""
    return _dispatch(cg_vector, cg_vector_plain, Wm.shape[1], offsets, Wm, Wm,
                     Binv, b, rtol, atol, maxiter)


cg_scalar.launches = 0
cg_vector.launches = 0
