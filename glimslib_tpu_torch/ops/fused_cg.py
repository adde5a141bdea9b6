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
  Binv'' (d, d, n), b (n, d), d = 2 (rectangle lattices) or 3 (box
  lattices)                                                           [K3b, K3c]

Both start from x0 = 0 and follow ``solvers/cg.py:pcg`` (same update order,
same stopping rule) and return ``(x, {"iters", "resnorm"})`` with the info
as 0-d tensors on the input's device.  Given CPU tensors they run the plain
version; given CUDA tensors they launch ``stencil_pcg<d>`` (d = 1, 2 or
3; one cooperative launch per solve, ``csrc/stencil.cu``) or raise.
:func:`launch_plan` chooses the kernel's mode from the bytes per SM: ``resident`` (the owned
planes in shared memory; the TPU's VMEM-resident kernels K3a/K3b),
``streamed`` (planes streamed through a ring of shared-memory stages; the
TPU's streamed kernel K3c), or ``streamed_global`` (the same with x, r and
Ap in global memory, where they do not fit beside two stages), and sizes
the kernel's shared memory.  Each wrapper counts its kernel launches in
its ``launches`` attribute and keeps the plan of its last launch in
``last_plan``.
"""

from __future__ import annotations

import dataclasses

import torch

from glimslib_tpu_torch import _build
from glimslib_tpu_torch.ops.stencil import apply_block_jacobi
from glimslib_tpu_torch.ops.stencil_kernels import _check_cuda, stencil_apply_plain
from glimslib_tpu_torch.solvers.cg import pcg

# the kernel's compile-time geometry (GLIMS_PCG_* in csrc/stencil.cu); the
# shared-memory layout is sized here only, and the kernel traps if a size
# is short of what it lays out
PCG_ROW = 128            # T: nodes a thread row, nodes of a streamed chunk
PCG_GROUPS = 3           # G: threads a node (offset groups)
# nodes a thread per resident chunk, by d (GLIMS_PCG_U_RESIDENT): the
# kernels stencil_pcg has; a thread holds U * 5 * d gathered floats
PCG_RESIDENT_U = {1: 4, 2: 4, 3: 3}
PCG_MAX_OFF = 15
PCG_MAX_STAGES = 4
# dynamic shared memory a block may take: the card's 232,448-byte opt-in
# limit less room for the kernel's static shared memory
SMEM_BYTES = 232_448 - 1024
MODES = {"resident": 0, "streamed": 1, "streamed_global": 2}


@dataclasses.dataclass(frozen=True)
class PcgPlan:
    """One launch of ``stencil_pcg``: mode, blocks (one an SM), nodes a
    block owns, ring stages (streamed), dynamic shared memory a block,
    floats of scratch (z, p, four partials a block; when streamed also a
    copy of the planes with 16-byte aligned rows in front; in
    ``streamed_global`` also r and Ap behind)."""

    mode: str
    blocks: int
    nloc: int
    stages: int
    smem_bytes: int
    scratch_floats: int

    def ranges(self, n):
        """The node range [i0, i1) each block owns."""
        return [(min(n, b * self.nloc), min(n, (b + 1) * self.nloc))
                for b in range(self.blocks)]


def launch_plan(n, d, n_off, blocks, mode=None):
    """The launch of ``stencil_pcg<d>`` on ``n`` nodes in ``blocks`` blocks:
    resident when the owned range's planes, preconditioner and vectors fit
    a block's shared memory; else streamed with as many ring stages (2..4)
    as fit beside x, r and Ap; else streamed_global, those three in global
    memory.  ``mode`` forces one; raises if it does not fit."""
    if d not in PCG_RESIDENT_U:
        raise NotImplementedError(f"stencil_pcg has no kernel for d={d}")
    if n_off > PCG_MAX_OFF:
        raise NotImplementedError(f"stencil_pcg takes at most {PCG_MAX_OFF} offsets")
    if mode is not None and mode not in MODES:
        raise ValueError(f"unknown stencil_pcg mode {mode!r}")
    nloc = (-(-n // blocks) + 3) // 4 * 4  # ceil(n / blocks), up to a multiple of 4
    planes = n_off * d * d
    cred = 2 * PCG_GROUPS * d * PCG_ROW  # the partial sums of two chunks
    vectors = 3 * d * nloc  # x, r, Ap

    def smem_of(m):
        """(floats, stages) of mode m's layout in a block's shared memory."""
        if m == "resident":
            u = PCG_RESIDENT_U[d]
            return vectors + u * cred + (planes + d * d) * nloc, 1
        fixed = cred + (vectors if m == "streamed" else 0)
        stages = max(0, min(PCG_MAX_STAGES, (SMEM_BYTES // 4 - fixed) // (planes * PCG_ROW)))
        return fixed + stages * planes * PCG_ROW, stages

    def fits(m):
        floats, stages = smem_of(m)
        return 4 * floats <= SMEM_BYTES and (m == "resident" or stages >= 2)

    if mode is None:
        mode = next(m for m in MODES if fits(m))
    elif not fits(mode):
        raise ValueError(f"stencil_pcg {mode}: the layout of n={n}, d={d} on "
                         f"{blocks} blocks does not fit {SMEM_BYTES} bytes of "
                         "shared memory a block")
    floats, stages = smem_of(mode)
    scratch = 2 * n * d + 4 * blocks
    if mode != "resident":  # the planes with rows padded to 16 bytes
        scratch += planes * (-(-n // 4) * 4)
    if mode == "streamed_global":  # r and Ap
        scratch += 2 * n * d
    return PcgPlan(mode, blocks, nloc, stages, 4 * floats, scratch)


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


def _pcg_cuda(d, offsets, W4, Minv, b, rtol, atol, maxiter, mode=None,
              blocks=None):
    """Launch ``stencil_pcg<d>`` on the current stream; ``mode`` and
    ``blocks`` force the launch plan's mode and grid (by default the plan
    chooses the mode, and the grid is one block an SM).  Returns x, the
    info and the plan."""
    n_off, n = W4.shape[0], W4.shape[-1]
    if len(offsets) != n_off:
        raise ValueError(f"{len(offsets)} offsets for {n_off} planes")
    dev = W4.device
    _check_cuda("W", W4, (n_off, d, d, n), dev)
    _check_cuda("M", Minv, (n,) if d == 1 else (d, d, n), dev)
    _check_cuda("b", b, (n,) if d == 1 else (n, d), dev)
    if blocks is None:
        blocks = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = launch_plan(n, d, n_off, blocks, mode)
    x = torch.empty_like(b)
    iters = torch.empty((), dtype=torch.int32, device=dev)
    resnorm = torch.empty((), dtype=torch.float32, device=dev)
    scratch = torch.empty(plan.scratch_floats, dtype=torch.float32, device=dev)
    lib = _build.load("stencil")
    _build.check(lib.glims_stencil_pcg(
        d, W4.data_ptr(), Minv.data_ptr(), b.data_ptr(), x.data_ptr(),
        iters.data_ptr(), resnorm.data_ptr(), scratch.data_ptr(), n,
        _build.pack_offsets(offsets, n)[1], float(rtol), float(atol),
        int(maxiter), torch.cuda.current_stream(dev).cuda_stream,
        MODES[plan.mode], plan.blocks, plan.stages, plan.smem_bytes,
    ), f"stencil_pcg<{d}> {plan.mode} launch")
    return x, {"iters": iters, "resnorm": resnorm}, plan


def _dispatch(wrapper, plain, d, offsets, W, W4, Minv, b, rtol, atol, maxiter):
    if all(t.device.type == "cpu" for t in (W, Minv, b)):
        return plain(offsets, W, Minv, b, rtol, atol, maxiter)
    if W.device.type != "cuda":
        raise ValueError(f"unsupported device {W.device}")
    x, info, wrapper.last_plan = _pcg_cuda(d, offsets, W4, Minv, b, rtol, atol,
                                           maxiter)
    wrapper.launches += 1
    return x, info


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


cg_scalar.launches = cg_vector.launches = 0
cg_scalar.last_plan = cg_vector.last_plan = None
