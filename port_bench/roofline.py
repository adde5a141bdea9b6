"""The yardstick's arithmetic: published peaks, the least time a piece of
work needs on them, the work of the port's operations from their shapes,
and sums over the profiler's device records.

Frozen copies of ``chip_smoke.py``'s ``HBM_BPS`` / ``F32_FLOPS``
(l.561-562), ``_bound`` (l.576-579), ``_pcg_work`` (l.1023-1030), the
block-matvec bytes and operations of ``_bmv_check`` (l.1485) and the
device-record sums of ``_device_kernels`` / ``_device_busy_ms``
(l.599-617); the benchmark keeps its own so that a change to the
program's tools cannot move its numbers.
"""

from __future__ import annotations

# published H100 SXM peaks (NVIDIA data sheet, 700 W): HBM bytes/s and
# float32 operations/s outside the tensor cores
HBM_BPS = 3.35e12
F32_FLOPS = 67e12


def bound_s(nbytes, flops):
    """(least seconds, 'bytes' | 'operations') of work on the peaks."""
    tb, to = nbytes / HBM_BPS, flops / F32_FLOPS
    return (tb, "bytes") if tb >= to else (to, "operations")


def pcg_work(n_off, d, n, iters):
    """(bytes once, operations) of a whole-solve stencil PCG of ``iters``
    iterations on n nodes, ``n_off`` stencil offsets, d components: the
    planes, the preconditioner, b and x read once; per iteration one plane
    apply, one preconditioner apply and ~12 n d vector operations."""
    m_len = d * d * n if d > 1 else n
    nbytes = 4 * (n_off * d * d * n + m_len + 2 * n * d)
    flops = (iters + 1) * (2 * n_off * d * d * n + 2 * m_len + 12 * n * d)
    return nbytes, flops


def bmv_work(B, M, K):
    """(bytes, operations) of one float32 block matvec y_b = A_b x_b of
    A (B, M, K): A, x and y once, 2 B M K operations."""
    return 4 * (B * M * K + B * K + B * M), 2 * B * M * K


def kernel_seconds(records, pattern):
    """Device seconds of the records whose name matches ``pattern`` (a
    compiled regex) and their count."""
    hits = [r for r in records if pattern.search(r[0])]
    return sum(r[2] - r[1] for r in hits) / 1e9, len(hits)


def lattice_solves(ctx, n_offsets):
    """(bytes, operations) of each whole-solve PCG of the traced units on
    a lattice of ``n_offsets`` stencil offsets: the rd solves scalar (d =
    1), the elasticity and correction solves vectors (d = 3), each at the
    iterations it reports."""
    for r in ctx.traced:
        for d, keys in ((1, ("rd_cg_iters",)), (3, ("el_cg_iters", "el_refine_cg_iters"))):
            for it in ctx.iters(r, keys):
                yield pcg_work(n_offsets, d, ctx.n_nodes, it)


def block_matvecs(ctx):
    """((bytes, operations), launches) of each block-matvec shape of the
    traced units, from the port's launch counter by (B, M, K)."""
    for shape, count in (ctx.counters or {}).get("bell_bmv_by_shape", {}).items():
        yield bmv_work(*shape), count
