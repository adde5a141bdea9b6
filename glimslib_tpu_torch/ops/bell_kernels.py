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
CUDA tensors it launches ``bell_bmv`` (``csrc/bell.cu``) by the launch
plan of :func:`plan_for`, or raises.  It counts its kernel launches in
its ``launches`` attribute, and by the shape of A in
``launches_by_shape``.  Where grad is enabled and an input
requires it, the call goes through a ``torch.autograd.Function`` whose
VJP is the reference's XLA one (``bell_pallas.py:103-114``), in plain
torch: ``dA = y_bar x^T`` and ``dx = sum_m A y_bar``.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch
from torch.autograd.function import once_differentiable

from glimslib_tpu_torch import _build
from glimslib_tpu_torch.ops.stencil_kernels import _check_cuda


def batched_matvec_plain(A, x):
    """Plain torch batched matvec (the reference's own fallback,
    ``bell_pallas.py:99``)."""
    return (A * x[:, None, :]).sum(dim=-1)


# csrc/bell.cu's layout: consumer threads a block (12 warps, beside one
# producer warp), stages at most, bytes of the mbarriers before the ring,
# shared memory a block may have
BMV_CONSUMERS = 384
BMV_MAX_STAGES = 8
BMV_BAR_BYTES = 128
BMV_SMEM_BLOCK = 232448
# bytes of A a span aims at
BMV_SPAN_BYTES = 32 << 10


class BmvPlan(NamedTuple):
    rows_per_span: int  # R
    spans: int
    mode: str  # "bulk": TMA bulk copies; "ragged": 4-byte cp.async
    stages: int  # S
    a_floats: int  # a stage's room for A (R K, up to a multiple of 4)
    x_floats: int  # a stage's room for the b-vectors a span touches
    group: int  # G lanes a row
    blocks: int  # one an SM, or one a span where there are fewer spans
    smem_bytes: int
    in_flight: int  # bytes of A a block (an SM) has requested at once


def _up(n, m):
    return -(-n // m) * m


def _fit(B, M, K, sms, mode):
    """The plan of one staging mode, or None where a stage does not fit."""
    rows = B * M
    unit = 4 // math.gcd(K, 4) if mode == "bulk" else 1
    group = 8 if K % 4 == 0 or K < 256 else 16
    groups = BMV_CONSUMERS // group  # rows the consumers take at once
    per_block = max(1, -(-4 * rows * K // (sms * BMV_SPAN_BYTES)))
    R = _up(-(-rows // (sms * per_block)), unit)
    if K % 4 and R >= groups:  # whole passes of the scalar path's groups
        R = max(groups, round(R / groups) * groups)
    R = min(R, _up(rows, unit))
    spans = -(-rows // R)
    blocks = min(spans, sms)
    mine = -(-spans // blocks)  # the most spans a block takes
    a_floats = _up(R * K, 4)
    # b-vectors a span touches: R / M where spans start on b boundaries
    nbx = R // M if R % M == 0 else min(B, (R + M - 2) // M + 1)
    x_floats = _up(nbx * K, 4)
    stage = 4 * (a_floats + x_floats)
    stages = min((BMV_SMEM_BLOCK - BMV_BAR_BYTES) // stage, BMV_MAX_STAGES, mine)
    if stages < 1:
        return None
    # the consumers compute on one stage while the others load, unless the
    # ring holds every span the block has
    in_flight = 4 * R * K * (stages if stages >= mine else stages - 1)
    return BmvPlan(R, spans, mode, stages, a_floats, x_floats, group, blocks,
                   BMV_BAR_BYTES + stages * stage, in_flight)


@functools.lru_cache(maxsize=256)
def bmv_plan(B, M, K, sms, aligned=True):
    """The launch of ``bell_bmv`` for A (B, M, K) on ``sms`` SMs, with A
    starting on a 16-byte boundary where ``aligned``.

    The flat (B M, K) table is cut into spans of R rows.  In the bulk mode
    R K and B M K are multiples of 4 floats, so every span of an aligned
    A starts and ends on a 16-byte boundary and is staged by TMA bulk
    copies; the ragged mode stages spans by 4-byte copies.  The plan is
    bulk where A is aligned and B M K a multiple of 4 (and a bulk span
    fits), else ragged.  R is chosen so that the spans come to about
    ``BMV_SPAN_BYTES`` and split evenly over one block an SM; where K is
    not a multiple of 4 (the scalar path, whose passes over a span's rows
    cost the most) it is rounded to whole passes of the consumers' lane
    groups if a span has more rows than they take at once.  The ring has
    as many stages (1 to ``BMV_MAX_STAGES``) as fit a block's shared
    memory and the block has spans.  A group of G lanes takes a row: 8
    where K is a multiple of 4 (float4 loads) or under 256, else 16.
    Raises where a span of one row and its x do not fit a block's shared
    memory."""
    if min(B, M, K, sms) < 1:
        raise ValueError(f"bell_bmv: no plan for (B, M, K) = {(B, M, K)} on {sms} SMs")
    modes = ["bulk", "ragged"] if aligned and B * M * K % 4 == 0 else ["ragged"]
    for m in modes:
        plan = _fit(B, M, K, sms, m)
        if plan is not None:
            return plan
    raise ValueError(f"bell_bmv: a span of (B, M, K) = {(B, M, K)} does not fit "
                     f"{BMV_SMEM_BLOCK} bytes of shared memory")


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def plan_for(A):
    """:func:`bmv_plan` for the table A (B, M, K) where it lies: its
    card's SMs and whether it starts on 16 bytes."""
    return bmv_plan(*A.shape, _sm_count(A.device.index), A.data_ptr() % 16 == 0)


def batched_matvec_cuda(A, x):
    """Launch ``bell_bmv`` on the current stream by :func:`plan_for`."""
    B, M, K = A.shape
    _check_cuda("A", A, (B, M, K), A.device)
    _check_cuda("x", x, (B, K), A.device)
    plan = plan_for(A)
    y = torch.empty((B, M), dtype=torch.float32, device=A.device)
    lib = _build.load("bell")
    _build.check(lib.glims_bell_bmv(
        A.data_ptr(), x.data_ptr(), y.data_ptr(), B, M, K, plan.rows_per_span,
        plan.stages, plan.a_floats, plan.x_floats, plan.group, int(plan.mode == "bulk"),
        plan.blocks, plan.smem_bytes, torch.cuda.current_stream(A.device).cuda_stream,
    ), "bell_bmv launch")
    return y


def _bmv_raw(A, x):
    if A.device.type == "cpu" and x.device.type == "cpu":
        return batched_matvec_plain(A, x)
    if A.device.type != "cuda":
        raise ValueError(f"unsupported device {A.device}")
    y = batched_matvec_cuda(A, x)
    batched_matvec.launches += 1
    shape = tuple(A.shape)
    batched_matvec.launches_by_shape[shape] = (
        batched_matvec.launches_by_shape.get(shape, 0) + 1)
    return y


class _BatchedMatvec(torch.autograd.Function):
    @staticmethod
    def forward(ctx, A, x):
        ctx.save_for_backward(A, x)
        return _bmv_raw(A, x)

    @staticmethod
    @once_differentiable
    def backward(ctx, gy):
        A, x = ctx.saved_tensors
        dA = dx = None
        if ctx.needs_input_grad[0]:
            dA = gy[:, :, None] * x[:, None, :]
        if ctx.needs_input_grad[1]:
            dx = (A * gy[:, :, None]).sum(1)
        return dA, dx


def batched_matvec(A, x):
    """y[b] = A[b] @ x[b]; A (B, M, K), x (B, K)."""
    if torch.is_grad_enabled() and (A.requires_grad or x.requires_grad):
        return _BatchedMatvec.apply(A, x)
    return _bmv_raw(A, x)


batched_matvec.launches = 0
# the same launches split by (B, M, K); reset together with ``launches``
batched_matvec.launches_by_shape = {}
