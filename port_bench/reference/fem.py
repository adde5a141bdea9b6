"""Element-by-element assembly into CSR matrices, applied by
``torch.sparse`` (cuSPARSE on the card), all in float64.

``Pattern`` holds the sparsity of a scalar space: the unique (row, col)
pairs of every cell's dofs and, for each element entry, its slot in the
value array, so that a matrix is one ``index_add_`` of its element
matrices.  ``vector_csr`` expands a pattern of 3 x 3 node blocks into the
scalar CSR of a vector field (dof 3 i + a).
"""

from __future__ import annotations

import warnings

import torch

# torch.sparse_csr_tensor warns that CSR support is in beta on every call
warnings.filterwarnings("ignore", message="Sparse CSR tensor support is in beta")


class Pattern:
    """CSR sparsity of the matrices over ``cell_dofs`` (nc, m) on n dofs."""

    def __init__(self, cell_dofs, n):
        nc, m = cell_dofs.shape
        rows = cell_dofs[:, :, None].expand(nc, m, m)
        cols = cell_dofs[:, None, :].expand(nc, m, m)
        keys = (rows * n + cols).reshape(-1)
        uniq, self.slot = torch.unique(keys, sorted=True, return_inverse=True)
        self.rows = uniq // n
        self.cols = uniq % n
        self.n, self.nnz, self.m = n, uniq.shape[0], m
        counts = torch.bincount(self.rows, minlength=n)
        self.crow = torch.zeros(n + 1, dtype=torch.int64, device=cell_dofs.device)
        self.crow[1:] = torch.cumsum(counts, 0)
        self.diag_slot = torch.nonzero(self.rows == self.cols).reshape(-1)

    def values(self, local):
        """Sum the element matrices ``local`` (nc, m, m) into the pattern."""
        out = torch.zeros(self.nnz, dtype=local.dtype, device=local.device)
        return out.index_add_(0, self.slot, local.reshape(-1))

    def csr(self, values):
        return torch.sparse_csr_tensor(
            self.crow.to(torch.int32), self.cols.to(torch.int32), values,
            (self.n, self.n))


def vector_csr(pat, blocks):
    """The scalar CSR (3n, 3n) of node blocks ``blocks`` (nnz, 3, 3) on
    ``pat``: row 3 i + a holds, for each neighbour j of i in order, the
    entries (3 j + b, blocks[ij, a, b]) for b = 0, 1, 2."""
    dev = blocks.device
    deg = pat.crow[1:] - pat.crow[:-1]
    row_of = pat.rows
    k = torch.arange(pat.nnz, device=dev) - pat.crow[row_of]
    base = 9 * pat.crow[row_of] + 3 * k
    a = torch.arange(3, device=dev)
    # position of (ij, a, b): 9 crow_i + 3 a deg_i + 3 k + b
    pos = (base[:, None, None] + 3 * a[None, :, None] * deg[row_of][:, None, None]
           + a[None, None, :])
    vals = torch.empty(9 * pat.nnz, dtype=blocks.dtype, device=dev)
    vals[pos.reshape(-1)] = blocks.reshape(-1)
    cols = torch.empty(9 * pat.nnz, dtype=torch.int64, device=dev)
    cols[pos.reshape(-1)] = (3 * pat.cols[:, None, None] + a[None, None, :]).expand(
        pat.nnz, 3, 3).reshape(-1)
    crow = torch.zeros(3 * pat.n + 1, dtype=torch.int64, device=dev)
    crow[1:] = torch.cumsum(torch.repeat_interleave(3 * deg, 3), 0)
    return torch.sparse_csr_tensor(crow.to(torch.int32), cols.to(torch.int32), vals,
                                   (3 * pat.n, 3 * pat.n))


def scatter(cell_dofs, local, n):
    """Sum the element vectors ``local`` (nc, m[, k]) into n dofs."""
    tail = local.shape[2:]
    out = torch.zeros((n,) + tail, dtype=local.dtype, device=local.device)
    return out.index_add_(0, cell_dofs.reshape(-1), local.reshape((-1,) + tail))


def cg(apply, b, x0, precond, rtol, maxiter, check_every=20):
    """Preconditioned conjugate gradients from ``x0`` until the residual
    norm is at most ``rtol`` times that of ``b`` (tested every
    ``check_every`` iterations); returns (x, iterations, relative residual)."""
    x = x0.clone()
    r = b - apply(x)
    z = precond(r)
    p = z.clone()
    rz = torch.dot(r, z)
    bnorm = float(torch.linalg.vector_norm(b))
    if bnorm == 0.0:
        return torch.zeros_like(b), 0, 0.0
    rel = float(torch.linalg.vector_norm(r)) / bnorm
    k = 0
    while k < maxiter and rel > rtol:
        Ap = apply(p)
        alpha = rz / torch.dot(p, Ap)
        x += alpha * p
        r -= alpha * Ap
        z = precond(r)
        rz_new = torch.dot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
        k += 1
        if k % check_every == 0:
            rel = float(torch.linalg.vector_norm(r)) / bnorm
    if rel > rtol:
        raise RuntimeError(f"reference CG stopped at {rel:.3e} after {k} iterations")
    return x, k, rel
