"""The launch plan of ``bell_bmv`` (``glimslib_tpu_torch/ops/bell_kernels.py
bmv_plan``), on the CPU: no card is needed.

At the twelve (B, M, K) shapes the unstructured paths give the kernel, the
seventeen the reference's switches give it, and at ragged ones, on 132
and 114 SMs: the persistent blocks' static schedule covers every row of
the flat (B M, K) table exactly once; every
bulk span's source offset and size is a multiple of 16 bytes; a stage
holds its span's rows and the b-vectors they touch; shared memory fits a
block; an SM keeps at least 64 KB of A in flight wherever the table gives
every SM that much.  What the kernel cannot take raises.  A table that
starts off 16 bytes (a view) gets the ragged plan.  The k each lane
of a row's group reads (float4 chunks where K is a multiple of 4, else
floats from the group's first chunk on) cover every k of the row once,
and a numpy walk of the kernel's index arithmetic (spans, the staged x,
those lanes) under each plan equals the plain version to f32 rounding
(rel 1e-5).
"""

import numpy as np
import pytest
import torch

from glimslib_tpu_torch.ops import bell_kernels as bk

REPO_SHAPES = [
    (1152, 96, 474), (1152, 96, 158), (1152, 96, 96), (1152, 32, 158),
    (1152, 32, 32), (4352, 64, 353), (4352, 64, 64), (88, 64, 200),
    (88, 64, 64), (88, 32, 100), (88, 32, 32), (88, 64, 100),
]
# the shapes the reference's switches give the kernel (chip_smoke.py [19]):
# GLIMS_BELL_S=16 and 64 on the n=32 box, GLIMS_P2_S=32 and
# GLIMS_P2_HALO_CHUNK=4 on the quad flagship, the n=16 quad box with
# GLIMS_P2_INTERLEAVE=0 and at its defaults
SWITCH_SHAPES = [
    (2304, 48, 306), (2304, 48, 48), (2304, 48, 102), (2304, 16, 102), (2304, 16, 16),
    (568, 192, 750), (568, 192, 192), (568, 192, 250), (568, 64, 250), (568, 64, 64),
    (8704, 32, 240), (8704, 32, 32), (4352, 64, 652), (160, 96, 474), (160, 96, 96),
    (568, 64, 353), (568, 64, 1374),
]
RAGGED_SHAPES = [(1, 1, 1), (3, 5, 7), (7, 13, 1001), (2, 3, 16384), (5, 3, 6)]
IN_FLIGHT_MIN = 64 << 10


def _spans(plan, rows):
    """Each block's spans in the order it takes them: (first row, rows)."""
    R = plan.rows_per_span
    return [[(j * R, min(R, rows - j * R))
             for j in range(b, plan.spans, plan.blocks)]
            for b in range(plan.blocks)]


def _check_plan(plan, B, M, K, sms):
    rows = B * M
    R = plan.rows_per_span
    assert plan.spans == -(-rows // R) and plan.blocks == min(plan.spans, sms)
    seen = np.zeros(rows, np.int64)
    for block in _spans(plan, rows):
        for r0, nr in block:
            assert nr >= 1
            seen[r0:r0 + nr] += 1
            if plan.mode == "bulk":
                assert (4 * r0 * K) % 16 == 0 and (4 * nr * K) % 16 == 0
            b0, b1 = r0 // M, (r0 + nr - 1) // M
            assert (b1 - b0 + 1) * K <= plan.x_floats
    assert (seen == 1).all()
    assert plan.a_floats >= R * K and plan.a_floats % 4 == 0 and plan.x_floats % 4 == 0
    assert 1 <= plan.stages <= bk.BMV_MAX_STAGES
    assert plan.smem_bytes == bk.BMV_BAR_BYTES + 4 * plan.stages * (
        plan.a_floats + plan.x_floats)
    assert plan.smem_bytes <= bk.BMV_SMEM_BLOCK
    assert plan.group in (8, 16)
    if 4 * rows * K >= IN_FLIGHT_MIN * sms:
        assert plan.in_flight >= IN_FLIGHT_MIN


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("shape", REPO_SHAPES + SWITCH_SHAPES)
def test_bmv_plan_at_the_repo_shapes(shape, sms):
    plan = bk.bmv_plan(*shape, sms)
    # M K is a multiple of 4 at every repo shape: every span is staged by TMA
    assert plan.mode == "bulk"
    _check_plan(plan, *shape, sms)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("shape", RAGGED_SHAPES + [(4352, 64, 64)])
def test_bmv_plan_at_ragged_shapes(shape, aligned):
    plan = bk.bmv_plan(*shape, 114, aligned)
    assert plan.mode == ("bulk" if aligned and np.prod(shape) % 4 == 0 else "ragged")
    _check_plan(plan, *shape, 114)


def test_bmv_plan_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError):
        bk.bmv_plan(8, 1, 29041, 132)  # a row and its x exceed a block
    with pytest.raises(ValueError):
        bk.bmv_plan(8, 1, 29041, 132, False)
    with pytest.raises(ValueError):
        bk.bmv_plan(0, 4, 4, 132)
    # the longest row that fits, and a K the kernel must take
    assert bk.bmv_plan(1, 1, 29040, 132).stages == 1
    assert bk.bmv_plan(4, 1, 16383, 132).mode == "ragged"


@pytest.mark.parametrize("offset", [0, 1, 2, 3, 4])
def test_plan_for_stages_a_table_off_16_bytes_ragged(monkeypatch, offset):
    """The wrapper's plan of a table: bulk where it starts on 16 bytes (and
    B M K is a multiple of 4), ragged where a view starts it off them."""
    monkeypatch.setattr(bk, "_sm_count", lambda index: 132)
    shape = (96, 64, 64)
    flat = torch.zeros(int(np.prod(shape)) + 8)
    base = flat[(-flat.data_ptr() // 4) % 4:]  # on 16 bytes
    A = base[offset:offset + int(np.prod(shape))].view(shape)
    plan = bk.plan_for(A)
    assert plan == bk.bmv_plan(*shape, 132, offset % 4 == 0)
    assert plan.mode == ("bulk" if offset % 4 == 0 else "ragged")
    _check_plan(plan, *shape, 132)


def _lane_ks(K, G, l, first):
    """The k lane l of a row's group reads, in its order (csrc/bell.cu
    ``row_dot``): float4s at 4 (c G + l) where K is a multiple of 4; else
    the last chunk's k, then chunks [first, last) and [0, first)."""
    if K % 4 == 0:
        return [k + j for k in range(4 * l, K, 4 * G) for j in range(4)]
    last = -(-K // G) - 1
    ks = [last * G + l] if last * G + l < K else []
    for c in list(range(first, last)) + list(range(first)):
        ks.append(c * G + l)
    return ks


@pytest.mark.parametrize("K", [1, 3, 7, 8, 32, 64, 96, 100, 158, 353, 474, 1001])
def test_row_lanes_cover_every_k_once(K):
    G = bk.bmv_plan(1, 1, K, 132).group
    for first in range(min(32 // G, -(-K // G))):
        ks = sorted(k for l in range(G) for k in _lane_ks(K, G, l, first))
        assert ks == list(range(K))


def _walk(plan, A, x):
    """The kernel's arithmetic under ``plan``, in numpy: each span's rows
    read their b-vector from the span's staged x at (m0 + r) // M, each
    lane of a row's group its k (:func:`_lane_ks`, the group starting at
    chunk (lane // G) mod n_chunks)."""
    B, M, K = A.shape
    G = plan.group
    flat = A.reshape(B * M, K).astype(np.float64)
    y = np.full(B * M, np.nan)
    groups = bk.BMV_CONSUMERS // G
    for block in _spans(plan, B * M):
        for r0, nr in block:
            b0 = r0 // M
            m0 = r0 - b0 * M
            nx = ((r0 + nr - 1) // M - b0 + 1) * K
            sx = x.reshape(-1)[b0 * K:b0 * K + nx]
            for r in range(nr):
                first = (((r % groups) * G % 32) // G) % -(-K // G)
                xb = sx[((m0 + r) // M) * K:][:K]
                ks = np.array([k for l in range(G) for k in _lane_ks(K, G, l, first)])
                y[r0 + r] = (flat[r0 + r, ks] * xb[ks]).sum()
    return y.reshape(B, M)


@pytest.mark.parametrize("shape", [(88, 32, 32), (88, 64, 100), (24, 96, 474),
                                   (3, 5, 7), (7, 13, 101), (40, 1, 9)])
def test_kernel_index_walk_equals_plain(shape):
    rng = np.random.default_rng(13)
    A = rng.standard_normal(shape).astype(np.float32)
    x = rng.standard_normal(shape[::2]).astype(np.float32)
    want = (A.astype(np.float64) * x[:, None, :]).sum(-1)
    for sms in (132, 3):
        got = _walk(bk.bmv_plan(*shape, sms), A, x)
        assert np.isfinite(got).all()
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
