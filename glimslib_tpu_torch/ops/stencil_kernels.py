"""Offset-stencil matvecs: the CUDA kernel ``stencil_apply`` and its plain
torch version (counterpart of ``glimslib_tpu/ops/stencil_pallas.py``).

Four wrappers, one per form the lattice step applies:

- :func:`apply_scalar`     W (n_off, n),       v (n,)   -> (n,)    [K1]
- :func:`apply_vector`     W (n_off, d, d, n), u (n, d) -> (n, d)  [K2]
- :func:`apply_coupling`   C (n_off, d, n),    c (n,)   -> (n, d)  [K2, d_in=1]
- :func:`apply_scalar_sum` 2 or 3 terms (W_k (n_off, n), v_k (n,), s_k) and
  b (n,) -> sum_k s_k W_k v_k - b                            [K1, one launch]

all built on ``y[i, a] = sum_o sum_b W[o, a, b, i] v[(i + off_o) mod n, b]``,
with d = 2 (rectangle lattices) or 3 (box lattices) in the vector forms.
:func:`apply_scalar_sum` is the lattice rd residual
``W_const c + wc c / 2 - M c_prev - load`` in one launch of the same kernel.

Halo form (``halo=h > 0``, the node-sharded lattice of
``parallel/gspmd.py``): W, b and the output hold a rank's n owned rows,
the input vectors those rows with h rows of the neighbours on either side
(n + 2h rows), and ``y[i] = sum_o W[o, i] v[i + h + off_o]``, with no
wrap; every offset must lie within the halo.  Its plain version reads
narrow slices of the padded input.
A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches ``stencil_apply<d_out, d_in, terms>`` (``csrc/stencil.cu``) or
raises, also for a d the kernel has no form for.  The launch path is
lean: the offsets are packed once per (offsets, n)
(``_build.pack_offsets``), the C entry points are bound once, and the
wrappers reach them without views.  Each wrapper counts its
kernel launches in its ``launches`` attribute.

Differentiation.  Where grad is enabled and an input requires it, a
wrapper goes through a ``torch.autograd.Function`` (otherwise it launches
directly, with no autograd overhead).  Its VJP is the reference's XLA
transpose of the same stencil:

- dv = A^T y, ``(A^T y)[j, b] = sum_o sum_a W[o, a, b, j - off_o] y[j - off_o, a]``,
  is the same kernel launched on mirrored planes (:func:`mirror_planes`:
  offset -off_o, the plane shifted by off_o, the a/b axes swapped), so the
  offset set must be symmetric; the coupling's transpose (d -> 1) is one
  d-term launch of :func:`apply_scalar_sum`.  These launches count on
  the wrapper of the form they launch (``apply_scalar``, ``apply_vector``,
  ``apply_scalar_sum``).
- dW[o, a, b, i] = y[i, a] v[i + off_o, b], in plain torch.
- The halo form's dv is the cotangent of the whole padded input, n + 2h
  rows, built from the rank's own planes alone: the planes zero-extended
  by h rows on either side are mirrored (the wrap of the shift reads
  only those zeros), and the halo form launches on them with n + 2h
  output rows over y zero-padded by 2h rows on either side.  The halo
  rows of dv belong to the neighbours' rows: the exchange's transpose
  (``parallel/gspmd.py``) adds them there.  dW reads the padded input's
  slices, so it holds the own rows only.

The same Functions run on both devices: on CPU tensors the forward and
the transposed applies are the plain versions.  A :class:`MirrorCache`
keeps the mirrored planes of planes that stay fixed over a simulate (by
halo: the halo form's are the extended planes').
"""

from __future__ import annotations

import functools

import torch
from torch.autograd.function import once_differentiable

from glimslib_tpu_torch import _build


def stencil_apply_plain(offsets, W, v, halo=0):
    """Plain torch stencil apply: W (n_off, d_out, d_in, n), v (n + 2 halo,
    d_in) -> (n, d_out).  Sums over offsets, then input components, in
    order; ``halo`` > 0 reads the slices ``v[halo + off : halo + off + n]``
    (the halo form), else rolls ``v``."""
    n_off, d_out, d_in, n = W.shape
    acc = torch.zeros((d_out, n), dtype=v.dtype, device=v.device)
    if halo:
        _check_halo(offsets, halo, n, v)
    for o, off in enumerate(offsets):
        if halo:
            sh = v[halo + int(off):halo + int(off) + n]
        else:
            sh = v if off == 0 else torch.roll(v, -int(off), dims=0)
        for b in range(d_in):
            acc = acc + W[o, :, b] * sh[:, b]
    return acc.T.contiguous()


def _check_halo(offsets, halo, n, v):
    """Raise unless every offset lies within ``halo`` and ``v`` holds the
    n + 2 halo rows of the halo form."""
    if max(abs(int(o)) for o in offsets) > halo:
        raise ValueError(f"stencil offsets reach past a halo of {halo} rows")
    if v.shape[0] != n + 2 * halo:
        raise ValueError(f"the halo form takes {n} + 2 x {halo} input rows, got "
                         f"{v.shape[0]}")


def _check_cuda(name, t, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32 on CUDA, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _plain_here(*tensors):
    """True where every tensor lies on the CPU (the plain version runs),
    False where the first lies on a CUDA device (the kernel launches);
    raises for any other device."""
    if tensors[0].is_cuda:
        return False
    if all(t.device.type == "cpu" for t in tensors):
        return True
    raise ValueError(f"unsupported devices {[str(t.device) for t in tensors]}")


_entries = {}


def _entry(name):
    """The C entry point ``name`` of the stencil library, bound once."""
    fn = _entries.get(name)
    if fn is None:
        fn = _entries[name] = getattr(_build.load("stencil"), name)
    return fn


def _check(name, t, shape, dev):
    """Raise unless t is float32, contiguous, of this shape and on dev: one
    fast test, and _check_cuda's precise error where it fails."""
    if not (t.dtype is torch.float32 and t.shape == shape
            and t.is_contiguous() and t.device == dev):
        _check_cuda(name, t, shape, dev)


def _launch(offsets, d_out, d_in, W, v, y, halo=0):
    """Launch ``stencil_apply<d_out, d_in>`` on the current stream."""
    n = y.shape[0]
    err = _entry("glims_stencil_apply")(
        d_out, d_in, W.data_ptr(), v.data_ptr(), y.data_ptr(), n, halo,
        _build.pack_offsets(offsets, n, halo)[1],
        torch._C._cuda_getCurrentRawStream(y.get_device()))
    if err:
        _build.check(err, "stencil_apply launch")
    return y


def apply_scalar_plain(offsets, W, v, halo=0):
    return stencil_apply_plain(offsets, W[:, None, None, :], v[:, None], halo)[:, 0]


def _scalar_raw(offsets, W, v, halo=0):
    if _plain_here(W, v):
        return apply_scalar_plain(offsets, W, v, halo)
    n = W.shape[-1]
    _check("W", W, (len(offsets), n), W.device)
    _check("v", v, (n + 2 * halo,), W.device)
    y = _launch(offsets, 1, 1, W, v, W.new_empty(n), halo)
    apply_scalar.launches += 1
    return y


def apply_scalar(offsets, W, v, cache=None, halo=0):
    """(A v)[i] = sum_o W[o, i] v[i + off_o]; W (n_off, n), v (n,), or in
    the halo form (n + 2 halo,).  ``cache``: a :class:`MirrorCache` for the
    backward's transposed planes."""
    if _needs_grad(W, v):
        return _Apply.apply("scalar", offsets, cache, halo, W, v)
    return _scalar_raw(offsets, W, v, halo)


def apply_vector_plain(offsets, W, u, halo=0):
    return stencil_apply_plain(offsets, W, u, halo)


# the d of the vector forms the kernel has (stencil_apply<d, d>, <d, 1>)
VECTOR_DIMS = (2, 3)


def _vector_dim(name, W):
    """d of vector planes W (n_off, d, ...) on the card; raises unless the
    kernel has a form for it."""
    d = W.shape[1] if W.dim() > 2 else 0
    if d not in VECTOR_DIMS:
        raise ValueError(f"{name} has shape {tuple(W.shape)}: stencil_apply has "
                         f"vector forms for d in {VECTOR_DIMS} only")
    return d


def _vector_raw(offsets, W, u, halo=0):
    if _plain_here(W, u):
        return apply_vector_plain(offsets, W, u, halo)
    n, d = W.shape[-1], _vector_dim("W", W)
    _check("W", W, (len(offsets), d, d, n), W.device)
    _check("u", u, (n + 2 * halo, d), W.device)
    y = _launch(offsets, d, d, W, u, u.new_empty((n, d)), halo)
    apply_vector.launches += 1
    return y


def apply_vector(offsets, W, u, cache=None, halo=0):
    """(A u)[i, a] = sum_o sum_b W[o, a, b, i] u[i + off_o, b]."""
    if _needs_grad(W, u):
        return _Apply.apply("vector", offsets, cache, halo, W, u)
    return _vector_raw(offsets, W, u, halo)


def apply_coupling_plain(offsets, C, c, halo=0):
    return stencil_apply_plain(offsets, C[:, :, None, :], c[:, None], halo)


def _coupling_raw(offsets, C, c, halo=0):
    if _plain_here(C, c):
        return apply_coupling_plain(offsets, C, c, halo)
    n, d = C.shape[-1], _vector_dim("C", C)
    _check("C", C, (len(offsets), d, n), C.device)
    _check("c", c, (n + 2 * halo,), C.device)
    y = _launch(offsets, d, 1, C, c, c.new_empty((n, d)), halo)
    apply_coupling.launches += 1
    return y


def apply_coupling(offsets, C, c, cache=None, halo=0):
    """(C c)[i, a] = sum_o C[o, a, i] c[i + off_o]; returns (n, d)."""
    if _needs_grad(C, c):
        return _Apply.apply("coupling", offsets, cache, halo, C, c)
    return _coupling_raw(offsets, C, c, halo)


def apply_scalar_sum_plain(offsets, terms, b, halo=0):
    """sum_k s_k (W_k v_k) - b, summed left to right, each term a plain
    scalar apply.  With s = (1, 0.5, -1) this is exactly the lattice rd
    residual's A1 c + 0.5 A2 c - A3 c_prev - load (1 x and -1 x are exact)."""
    acc = None
    for W, v, s in terms:
        t = s * apply_scalar_plain(offsets, W, v, halo)
        acc = t if acc is None else acc + t
    return acc - b


def _sum_raw(offsets, terms, b, halo=0):
    if not b.is_cuda and _plain_here(b, *(t for W, v, _ in terms for t in (W, v))):
        return apply_scalar_sum_plain(offsets, terms, b, halo)
    if len(terms) not in (2, 3):
        raise ValueError(f"apply_scalar_sum takes 2 or 3 terms, got {len(terms)}")
    n, dev = b.shape[0], b.device
    _check("b", b, (n,), dev)
    args = []
    for W, v, s in terms:
        _check("W", W, (len(offsets), n), dev)
        _check("v", v, (n + 2 * halo,), dev)
        args += (W.data_ptr(), v.data_ptr(), float(s))
    args += (None, None, 0.0) * (3 - len(terms))
    y = torch.empty_like(b)
    err = _entry("glims_stencil_apply_sum")(
        len(terms), *args, b.data_ptr(), y.data_ptr(), n, halo,
        _build.pack_offsets(offsets, n, halo)[1],
        torch._C._cuda_getCurrentRawStream(y.get_device()))
    if err:
        _build.check(err, "stencil_apply_sum launch")
    apply_scalar_sum.launches += 1
    return y


def apply_scalar_sum(offsets, terms, b, cache=None, halo=0):
    """y = s_1 W_1 v_1 + ... + s_k W_k v_k - b for k = 2 or 3 terms
    ``(W_k (n_off, n), v_k (n,) or (n + 2 halo,), s_k float)`` on one
    offset set, in one launch."""
    flat = [t for W, v, _ in terms for t in (W, v)]
    if _needs_grad(b, *flat):
        return _ApplySum.apply(offsets, tuple(float(s) for _, _, s in terms),
                               cache, halo, b, *flat)
    return _sum_raw(offsets, terms, b, halo)


# -- differentiation ----------------------------------------------------------


def _needs_grad(*tensors):
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


@functools.lru_cache(maxsize=64)
def _shift_table(offsets, n, device, halo):
    off = torch.as_tensor(offsets, dtype=torch.int64, device=device)
    idx = off[:, None] + torch.arange(n, device=device)[None, :]
    return idx + halo if halo else torch.remainder(idx, n)


def _shift_index(offsets, n, device, halo=0):
    """(n_off, n) int64 ``idx[o, i] = (i + off_o) mod n``, or in the halo
    form ``i + halo + off_o``, built once per (offsets, n, device, halo);
    read-only."""
    return _shift_table(tuple(int(o) for o in offsets), n, torch.device(device),
                        int(halo))


@functools.lru_cache(maxsize=64)
def _mirror_perm(offsets):
    slot = {off: o for o, off in enumerate(offsets)}
    missing = [off for off in offsets if -off not in slot]
    if missing:
        raise ValueError("the transposed stencil needs a symmetric offset set; no "
                         f"mirror for offsets {missing}")
    return tuple(slot[-off] for off in offsets)


def mirror_perm(offsets):
    """``perm[o]`` = the slot of -off_o; raises ValueError unless the offset
    set is symmetric (the transposed stencil then stays inside it)."""
    return list(_mirror_perm(tuple(int(o) for o in offsets)))


def mirror_planes(offsets, W4):
    """Planes of A^T from those of A: W4 (n_off, d_out, d_in, n) ->
    WT (n_off, d_in, d_out, n), ``WT[o', b, a, j] = W4[o, a, b, j - off_o]``
    with off_o' = -off_o, so that ``stencil_apply(offsets, WT, y) = A^T y``."""
    perm = mirror_perm(offsets)
    idx = _shift_index(offsets, W4.shape[-1], W4.device)
    Wp = W4[perm].transpose(1, 2)
    return torch.gather(Wp, 3, idx[:, None, None, :].expand(Wp.shape)).contiguous()


def _transposed(offsets, W, form, halo=0):
    """Mirrored planes of ``W`` in the layout the transposed launch takes:
    scalar (n_off, n), vector (n_off, d, d, n), coupling (d, n_off, n)
    (one scalar plane set per displacement component); ``halo`` > 0: of
    ``W`` zero-extended by ``halo`` rows on either side (n + 2 halo)."""
    if halo:
        W = torch.nn.functional.pad(W, (halo, halo))
    if form == "scalar":
        return mirror_planes(offsets, W[:, None, None, :])[:, 0, 0]
    if form == "vector":
        return mirror_planes(offsets, W)
    return mirror_planes(offsets, W[:, :, None, :])[:, 0].transpose(0, 1).contiguous()


def _key(W):
    return (W.data_ptr(), tuple(W.shape), W.dtype, W.device)


class MirrorCache:
    """The mirrored planes of fixed planes (one simulate's theta-only
    planes), built on first use and kept.  Planes are matched by storage
    and shape, so detached copies of them hit too; other planes are
    mirrored afresh at every call."""

    def __init__(self, planes):
        # holding each plane keeps its storage, and so its key, unique
        self._planes = {_key(W): W for W in planes}
        self._built = {}

    def transposed(self, offsets, W, form, halo=0):
        key = _key(W)
        if key not in self._planes:
            return _transposed(offsets, W, form, halo)
        hit = self._built.get((key, form, halo))
        if hit is None:
            hit = self._built[(key, form, halo)] = _transposed(offsets, W.detach(), form,
                                                               halo)
        return hit


def _mirror(offsets, W, form, cache, halo=0):
    if cache is None:
        return _transposed(offsets, W, form, halo)
    return cache.transposed(offsets, W, form, halo)


def plane_grad(offsets, y, v, halo=0):
    """dW of ``y = A v``: ``dW[o, a, b, i] = y[i, a] v[i + off_o, b]``,
    (n_off, d_out, d_in, n), for y (n,) or (n, d_out), v (n,) or (n, d_in)
    (the halo form: (n + 2 halo,) or (n + 2 halo, d_in), read at ``i +
    halo + off_o``)."""
    n = y.shape[0]
    y2, v2 = y.reshape(n, -1), v.reshape(v.shape[0], -1)
    vs = v2[_shift_index(offsets, n, v.device, halo)]  # (n_off, n, d_in)
    return y2.T[None, :, None, :] * vs.permute(0, 2, 1)[:, None, :, :]


def _transposed_apply(form, offsets, WT, y, halo=0, plain=False):
    """A^T y through one launch of the kernel (its plain version on the
    CPU, or with ``plain``).  ``halo`` > 0: ``WT`` the mirrored extended
    planes (n + 2 halo rows), and the halo form's launch on them over y
    zero-padded by 2 halo rows on either side gives the cotangent of all
    n + 2 halo rows of the padded input."""
    scalar, vector, total = ((apply_scalar_plain, apply_vector_plain, apply_scalar_sum_plain)
                             if plain else (_scalar_raw, _vector_raw, _sum_raw))
    n, lo = y.shape[0], 2 * halo
    if form == "coupling":
        # y's components as rows, each zero-padded by 2 halo rows
        cols = y.new_zeros((y.shape[1], n + 2 * lo)) if halo else y.T.contiguous()
        if halo:
            cols[:, lo:lo + n] = y.T
        terms = [(WT[a], cols[a], 1.0) for a in range(WT.shape[0])]
        return total(offsets, terms, y.new_zeros(WT.shape[-1]), halo)
    if halo:
        y_pad = y.new_zeros((n + 2 * lo,) + tuple(y.shape[1:]))
        y_pad[lo:lo + n] = y
        y = y_pad
    if form == "scalar":
        return scalar(offsets, WT, y, halo)
    return vector(offsets, WT, y, halo)


def transposed_apply_plain(form, offsets, WT, y, halo=0):
    """The plain version of the backward's transposed launch (on any
    device): the plain forms on the same mirrored planes and padded y."""
    return _transposed_apply(form, offsets, WT, y, halo, plain=True)


_FORWARD = {"scalar": _scalar_raw, "vector": _vector_raw, "coupling": _coupling_raw}


class _Apply(torch.autograd.Function):
    """One stencil form, ``y = A v``, with its VJP (module docstring)."""

    @staticmethod
    def forward(ctx, form, offsets, cache, halo, W, v):
        ctx.form, ctx.offsets, ctx.cache, ctx.halo = form, offsets, cache, halo
        ctx.save_for_backward(W, v)
        return _FORWARD[form](offsets, W, v, halo)

    @staticmethod
    @once_differentiable
    def backward(ctx, gy):
        W, v = ctx.saved_tensors
        gy = gy.contiguous()
        dW = dv = None
        if ctx.needs_input_grad[4]:
            dW = plane_grad(ctx.offsets, gy, v, ctx.halo).reshape(W.shape)
        if ctx.needs_input_grad[5]:
            WT = _mirror(ctx.offsets, W, ctx.form, ctx.cache, ctx.halo)
            dv = _transposed_apply(ctx.form, ctx.offsets, WT, gy, ctx.halo)
        return None, None, None, None, dW, dv


class _ApplySum(torch.autograd.Function):
    """``y = sum_k s_k W_k v_k - b`` with its VJP: db = -y, and per term
    dW_k = s_k (y outer shifted v_k), dv_k = s_k W_k^T y."""

    @staticmethod
    def forward(ctx, offsets, scales, cache, halo, b, *flat):
        ctx.offsets, ctx.scales, ctx.cache, ctx.halo = offsets, scales, cache, halo
        ctx.save_for_backward(*flat)
        terms = [(flat[2 * k], flat[2 * k + 1], s) for k, s in enumerate(scales)]
        return _sum_raw(offsets, terms, b, halo)

    @staticmethod
    @once_differentiable
    def backward(ctx, gy):
        flat = ctx.saved_tensors
        need = ctx.needs_input_grad
        gy = gy.contiguous()
        grads = []
        for k, s in enumerate(ctx.scales):
            W, v = flat[2 * k], flat[2 * k + 1]
            dW = dv = None
            if need[5 + 2 * k]:
                dW = s * plane_grad(ctx.offsets, gy, v, ctx.halo).reshape(W.shape)
            if need[6 + 2 * k]:
                WT = _mirror(ctx.offsets, W, "scalar", ctx.cache, ctx.halo)
                dv = _transposed_apply("scalar", ctx.offsets, WT, gy, ctx.halo)
                dv = dv if s == 1.0 else s * dv
            grads += (dW, dv)
        return (None, None, None, None, -gy if need[4] else None, *grads)


apply_scalar.launches = 0
apply_vector.launches = 0
apply_coupling.launches = 0
apply_scalar_sum.launches = 0
