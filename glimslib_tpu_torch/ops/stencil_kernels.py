"""Offset-stencil matvecs: the CUDA kernel ``stencil_apply`` and its plain
torch version (counterpart of ``glimslib_tpu/ops/stencil_pallas.py``).

Four wrappers, one per form the lattice step applies:

- :func:`apply_scalar`     W (n_off, n),       v (n,)   -> (n,)    [K1]
- :func:`apply_vector`     W (n_off, d, d, n), u (n, d) -> (n, d)  [K2]
- :func:`apply_coupling`   C (n_off, d, n),    c (n,)   -> (n, d)  [K2, d_in=1]
- :func:`apply_scalar_sum` 2 or 3 terms (W_k (n_off, n), v_k (n,), s_k) and
  b (n,) -> sum_k s_k W_k v_k - b                            [K1, one launch]

all built on ``y[i, a] = sum_o sum_b W[o, a, b, i] v[(i + off_o) mod n, b]``.
:func:`apply_scalar_sum` is the lattice rd residual
``W_const c + wc c / 2 - M c_prev - load`` in one launch of the same kernel.
A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches ``stencil_apply<d_out, d_in, terms>`` (``csrc/stencil.cu``) or
raises.  The launch path is lean: the offsets are packed once per
(offsets, n) (``_build.pack_offsets``), the C entry points are bound once,
and the wrappers reach them without views.  Each wrapper counts its
kernel launches in its ``launches`` attribute.
"""

from __future__ import annotations

import torch

from glimslib_tpu_torch import _build


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


def _launch(offsets, d_out, d_in, W, v, y):
    """Launch ``stencil_apply<d_out, d_in>`` on the current stream."""
    n = y.shape[0]
    err = _entry("glims_stencil_apply")(
        d_out, d_in, W.data_ptr(), v.data_ptr(), y.data_ptr(), n,
        _build.pack_offsets(offsets, n)[1],
        torch._C._cuda_getCurrentRawStream(y.get_device()))
    if err:
        _build.check(err, "stencil_apply launch")
    return y


def apply_scalar_plain(offsets, W, v):
    return stencil_apply_plain(offsets, W[:, None, None, :], v[:, None])[:, 0]


def apply_scalar(offsets, W, v):
    """(A v)[i] = sum_o W[o, i] v[i + off_o]; W (n_off, n), v (n,)."""
    if _plain_here(W, v):
        return apply_scalar_plain(offsets, W, v)
    n = W.shape[-1]
    _check("W", W, (len(offsets), n), W.device)
    _check("v", v, (n,), W.device)
    y = _launch(offsets, 1, 1, W, v, torch.empty_like(v))
    apply_scalar.launches += 1
    return y


def apply_vector_plain(offsets, W, u):
    return stencil_apply_plain(offsets, W, u)


def apply_vector(offsets, W, u):
    """(A u)[i, a] = sum_o sum_b W[o, a, b, i] u[i + off_o, b]."""
    if _plain_here(W, u):
        return apply_vector_plain(offsets, W, u)
    n = W.shape[-1]
    _check("W", W, (len(offsets), 3, 3, n), W.device)
    _check("u", u, (n, 3), W.device)
    y = _launch(offsets, 3, 3, W, u, torch.empty_like(u))
    apply_vector.launches += 1
    return y


def apply_coupling_plain(offsets, C, c):
    return stencil_apply_plain(offsets, C[:, :, None, :], c[:, None])


def apply_coupling(offsets, C, c):
    """(C c)[i, a] = sum_o C[o, a, i] c[i + off_o]; returns (n, d)."""
    if _plain_here(C, c):
        return apply_coupling_plain(offsets, C, c)
    n = C.shape[-1]
    _check("C", C, (len(offsets), 3, n), C.device)
    _check("c", c, (n,), C.device)
    y = _launch(offsets, 3, 1, C, c, c.new_empty((n, 3)))
    apply_coupling.launches += 1
    return y


def apply_scalar_sum_plain(offsets, terms, b):
    """sum_k s_k (W_k v_k) - b, summed left to right, each term a plain
    scalar apply.  With s = (1, 0.5, -1) this is exactly the lattice rd
    residual's A1 c + 0.5 A2 c - A3 c_prev - load (1 x and -1 x are exact)."""
    acc = None
    for W, v, s in terms:
        t = s * apply_scalar_plain(offsets, W, v)
        acc = t if acc is None else acc + t
    return acc - b


def apply_scalar_sum(offsets, terms, b):
    """y = s_1 W_1 v_1 + ... + s_k W_k v_k - b for k = 2 or 3 terms
    ``(W_k (n_off, n), v_k (n,), s_k float)`` on one offset set, in one
    launch."""
    if not b.is_cuda and _plain_here(b, *(t for W, v, _ in terms for t in (W, v))):
        return apply_scalar_sum_plain(offsets, terms, b)
    if len(terms) not in (2, 3):
        raise ValueError(f"apply_scalar_sum takes 2 or 3 terms, got {len(terms)}")
    n, dev = b.shape[0], b.device
    _check("b", b, (n,), dev)
    args = []
    for W, v, s in terms:
        _check("W", W, (len(offsets), n), dev)
        _check("v", v, (n,), dev)
        args += (W.data_ptr(), v.data_ptr(), float(s))
    args += (None, None, 0.0) * (3 - len(terms))
    y = torch.empty_like(b)
    err = _entry("glims_stencil_apply_sum")(
        len(terms), *args, b.data_ptr(), y.data_ptr(), n,
        _build.pack_offsets(offsets, n)[1],
        torch._C._cuda_getCurrentRawStream(y.get_device()))
    if err:
        _build.check(err, "stencil_apply_sum launch")
    apply_scalar_sum.launches += 1
    return y


apply_scalar.launches = 0
apply_vector.launches = 0
apply_coupling.launches = 0
apply_scalar_sum.launches = 0
