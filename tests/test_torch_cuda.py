"""The port's CUDA kernels against their plain torch versions, on the card.

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is
False (the decision is taken inside the fixture, never at import).  The
file imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

The vector forms run at d=3 (the brain box) and d=2 (the 50 x 50
rectangle lattice of ``examples.rect_sim``; the reduced 2D atlas on the
unstructured lane).  Tolerances: stencil applies (and the rd residual's
one-launch sum) and batched matvecs max rel 1e-5 (f32 summation order),
forward and backward (against torch's autograd of the plain versions);
whole solves, in every mode of ``stencil_pcg``, |Δiters| <= 3 and max rel
1e-4 (reductions re-associate near the stopping tolerance); the slices
against their plain paths rel-L2 1e-4 (f32 operators, Newton and CG
stopped at 1e-4 and 1e-7).
"""

import numpy as np
import pytest
import torch

from glimslib_tpu_torch.examples import (
    BENCH_STEP_CONFIG, UNSTRUCT_STEP_CONFIG, brain_sim, rect_sim,
)
from glimslib_tpu_torch.ops import bell_kernels as bk
from glimslib_tpu_torch.ops import fused_cg as fc
from glimslib_tpu_torch.ops import stencil_kernels as sk

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def lattice():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    sim = brain_sim(n=12, dtype=torch.float32, device=dev)
    sim.step_config = BENCH_STEP_CONFIG
    sim._build_step()
    theta = sim._augment_theta_with_operators(sim.make_theta(sim.params.as_dict()))
    rng = np.random.default_rng(3)
    n = sim.mesh.n_nodes
    v = torch.as_tensor(rng.standard_normal(n), dtype=torch.float32, device=dev)
    u = torch.as_tensor(rng.standard_normal((n, 3)), dtype=torch.float32, device=dev)
    return sim, theta, v, u


def _rel_max(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("shape", ["scalar", "vector", "coupling"])
def test_stencil_apply_kernel_matches_plain(lattice, shape):
    sim, theta, v, u = lattice
    offs = sim._stencil_ops.offsets
    kern, plain, W, x = {
        "scalar": (sk.apply_scalar, sk.apply_scalar_plain, theta["_Wrd_const"], v),
        "vector": (sk.apply_vector, sk.apply_vector_plain, theta["_Wel"], u),
        "coupling": (sk.apply_coupling, sk.apply_coupling_plain, theta["_Cuc"], v),
    }[shape]
    before = kern.launches
    got = kern(offs, W, x)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    assert _rel_max(got, plain(offs, W, x)) <= 1e-5


@pytest.mark.parametrize("n_terms", [2, 3])
def test_stencil_apply_sum_kernel_matches_plain_applies(lattice, n_terms):
    """The rd residual's one launch against the plain applies it replaces,
    summed in the same order (1 x and -1 x are exact)."""
    sim, theta, v, _ = lattice
    offs = sim._stencil_ops.offsets
    wc = sim._stencil_ops.build_rd_wc(v.abs(), theta["rho"], theta["dt"])
    v2 = torch.flip(v, (0,)).contiguous()
    terms = ((theta["_Wrd_const"], v, 1.0), (wc, v, 0.5),
             (theta["_Mst"], v2, -1.0))[:n_terms]
    before = sk.apply_scalar_sum.launches
    got = sk.apply_scalar_sum(offs, terms, theta["_rd_load"])
    torch.cuda.synchronize()
    assert sk.apply_scalar_sum.launches == before + 1
    want = sum(s * sk.apply_scalar_plain(offs, W, x) for W, x, s in terms)
    assert _rel_max(got, want - theta["_rd_load"]) <= 1e-5


@pytest.mark.parametrize("shape", ["scalar", "vector", "coupling", "sum",
                                   "vector2", "coupling2"])
def test_stencil_apply_kernel_at_odd_n(shape):
    """Random planes at n = 1001 (odd, not a multiple of the 128-node
    block) and 15 offsets drawn at random, negative and past n included;
    the vector forms at d=3 and (``vector2``, ``coupling2``) d=2, each
    launching its kernel once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(9)
    n = 1001
    offs = [0] + [int(o) for o in rng.integers(-2 * n, 2 * n, 14)]
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device="cuda")  # noqa: E731
    v = f32(rng.standard_normal(n))
    if shape == "sum":
        terms = tuple((f32(rng.standard_normal((15, n))), f32(rng.standard_normal(n)), s)
                      for s in (1.0, 0.5, -1.0))
        b = f32(rng.standard_normal(n))
        got = sk.apply_scalar_sum(offs, terms, b)
        want = sk.apply_scalar_sum_plain(offs, terms, b)
    else:
        kern, plain, W, x = {
            "scalar": (sk.apply_scalar, sk.apply_scalar_plain,
                       f32(rng.standard_normal((15, n))), v),
            "vector": (sk.apply_vector, sk.apply_vector_plain,
                       f32(rng.standard_normal((15, 3, 3, n))),
                       f32(rng.standard_normal((n, 3)))),
            "coupling": (sk.apply_coupling, sk.apply_coupling_plain,
                         f32(rng.standard_normal((15, 3, n))), v),
            "vector2": (sk.apply_vector, sk.apply_vector_plain,
                        f32(rng.standard_normal((15, 2, 2, n))),
                        f32(rng.standard_normal((n, 2)))),
            "coupling2": (sk.apply_coupling, sk.apply_coupling_plain,
                          f32(rng.standard_normal((15, 2, n))), v),
        }[shape]
        before = kern.launches
        got = kern(offs, W, x)
        assert kern.launches == before + 1
        want = plain(offs, W, x)
    torch.cuda.synchronize()
    assert got.shape == want.shape
    assert _rel_max(got, want) <= 1e-5


def _system_fixture(request, d):
    """The 3D brain lattice for d = 1 and 3, the 2D rectangle for d = 2."""
    return request.getfixturevalue("rect" if d == 2 else "lattice")


@pytest.mark.parametrize("d", [1, 2, 3])
def test_stencil_pcg_kernel_matches_plain(request, d):
    sim, theta, v, u = _system_fixture(request, d)
    offs = sim._stencil_ops.offsets
    mask_u, mask_c, _, _ = sim._bc_masks_and_values()
    if d == 1:
        kern, plain = fc.cg_scalar, fc.cg_scalar_plain
        args = (offs, fc.fold_mask_scalar(offs, theta["_Wrd_const"], mask_c),
                theta["_invdM"], torch.where(mask_c, 0.0, v))
    else:
        kern, plain = fc.cg_vector, fc.cg_vector_plain
        args = (offs, theta["_WelM"], theta["_BinvM"], torch.where(mask_u, 0.0, u))
    x_k, info_k = kern(*args, 1e-7, 0.0, 800)
    x_p, info_p = plain(*args, 1e-7, 0.0, 800)
    torch.cuda.synchronize()
    assert abs(int(info_k["iters"]) - int(info_p["iters"])) <= 3
    assert _rel_max(x_k, x_p) <= 1e-4


def _pcg_system(sim, theta, v, u, d):
    offs = sim._stencil_ops.offsets
    mask_u, mask_c, _, _ = sim._bc_masks_and_values()
    if d == 1:
        Wm = fc.fold_mask_scalar(offs, theta["_Wrd_const"], mask_c)
        return fc.cg_scalar_plain, Wm[:, None, None, :], (
            offs, Wm, theta["_invdM"], torch.where(mask_c, 0.0, v))
    return fc.cg_vector_plain, theta["_WelM"], (
        offs, theta["_WelM"], theta["_BinvM"], torch.where(mask_u, 0.0, u))


@pytest.mark.parametrize("mode,blocks", [
    ("resident", None), ("streamed", None), ("streamed_global", None),
    ("resident", 16), ("streamed", 4), ("streamed_global", 4)])
@pytest.mark.parametrize("d", [1, 2, 3])
def test_stencil_pcg_modes_match_plain(request, d, mode, blocks):
    """Every kernel mode, forced through the C entry point's mode argument,
    on one block an SM and on fewer blocks (several chunks a block; on 4
    blocks the streamed ring cycles through all its stages); d = 2 on the
    50 x 50 rectangle's elasticity system."""
    sim, theta, v, u = _system_fixture(request, d)
    plain, W4, args = _pcg_system(sim, theta, v, u, d)
    offs, _, M, b = args
    x_k, info_k, plan = fc._pcg_cuda(d, offs, W4, M, b, 1e-7, 0.0, 800,
                                     mode, blocks)
    x_p, info_p = plain(*args, 1e-7, 0.0, 800)
    torch.cuda.synchronize()
    assert plan.mode == mode
    if blocks is not None:
        assert plan.blocks == blocks and plan.nloc > fc.PCG_ROW
    assert abs(int(info_k["iters"]) - int(info_p["iters"])) <= 3
    assert _rel_max(x_k, x_p) <= 1e-4


def test_stencil_pcg_wrapper_counts_and_keeps_its_plan(lattice):
    sim, theta, v, u = lattice
    _, _, args = _pcg_system(sim, theta, v, u, 3)
    before = fc.cg_vector.launches
    fc.cg_vector(*args, 1e-7, 0.0, 800)
    torch.cuda.synchronize()
    assert fc.cg_vector.launches == before + 1
    assert fc.cg_vector.last_plan.mode == "resident"


def test_stencil_pcg_refused_launch_raises(lattice):
    """A launch the card refuses (more blocks than can be co-resident)
    raises; nothing falls back to another route."""
    sim, theta, v, u = lattice
    _, W4, (offs, _, M, b) = _pcg_system(sim, theta, v, u, 3)
    with pytest.raises(RuntimeError, match="stencil_pcg<3> resident launch"):
        fc._pcg_cuda(3, offs, W4, M, b, 1e-7, 0.0, 800, "resident", 100_000)


def test_wrappers_reject_what_the_kernels_do_not_take(lattice):
    sim, theta, v, u = lattice
    offs = sim._stencil_ops.offsets
    with pytest.raises(TypeError):
        sk.apply_vector(offs, theta["_Wel"].double(), u.double())
    with pytest.raises(ValueError):
        sk.apply_vector(offs, theta["_Wel"], u.T.contiguous().T)
    with pytest.raises(ValueError):
        sk.apply_vector(offs[:-1], theta["_Wel"], u)


def test_slice_runs_through_the_kernels(lattice):
    sim, _, _, _ = lattice
    wrappers = (sk.apply_scalar_sum, sk.apply_vector, sk.apply_coupling,
                fc.cg_scalar, fc.cg_vector)
    for w in wrappers:
        w.launches = 0
    u_tr, c_tr, ok, _ = sim.run()
    torch.cuda.synchronize()
    assert bool(ok.all())
    assert bool(torch.isfinite(c_tr).all()) and bool(torch.isfinite(u_tr).all())
    assert all(w.launches > 0 for w in wrappers)


@pytest.fixture
def unstructured(monkeypatch):
    """The n=12 Morton brain box on the card, f32, with the two-level
    level on (it is off below 4000 nodes by default)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setenv("GLIMS_TWOLEVEL_MIN_NODES", "100")
    dev = torch.device("cuda", 0)
    sim = brain_sim(n=12, dtype=torch.float32, device=dev, unstructured=True)
    sim.step_config = UNSTRUCT_STEP_CONFIG
    sim._build_step()
    aux = sim.runtime_aux()
    theta = sim._augment_theta_with_operators(
        {**sim.make_theta(sim.params.as_dict()), **aux})
    return sim, aux, theta


@pytest.mark.parametrize("role", ["_BellWel", "_BellCuc", "_BinvSN",
                                  "_BellWrdC", "_McSN"])
def test_bell_bmv_kernel_matches_plain(unstructured, role):
    sim, _, theta = unstructured
    A = theta[role]
    A = A.reshape(A.shape[0], A.shape[1] * (A.shape[2] if A.dim() > 3 else 1), -1)
    x = torch.as_tensor(np.random.default_rng(5).standard_normal(
        (A.shape[0], A.shape[2])), dtype=torch.float32, device=A.device)
    before = bk.batched_matvec.launches
    by_shape = bk.batched_matvec.launches_by_shape.get(tuple(A.shape), 0)
    got = bk.batched_matvec(A, x)
    torch.cuda.synchronize()
    assert bk.batched_matvec.launches == before + 1
    assert bk.batched_matvec.launches_by_shape[tuple(A.shape)] == by_shape + 1
    assert _rel_max(got, bk.batched_matvec_plain(A, x)) <= 1e-5


def test_bell_bmv_rejects_what_the_kernel_does_not_take(unstructured):
    _, _, theta = unstructured
    A = theta["_BellWrdC"]
    x = torch.zeros(A.shape[0], A.shape[2], device=A.device)
    with pytest.raises(TypeError):
        bk.batched_matvec(A.double(), x.double())
    with pytest.raises(ValueError):
        bk.batched_matvec(A, x[:, :-1])


BMV_SHAPES = [
    (1152, 96, 474), (1152, 96, 158), (1152, 96, 96), (1152, 32, 158),
    (1152, 32, 32), (4352, 64, 353), (4352, 64, 64), (88, 64, 200),
    (88, 64, 64), (88, 32, 100), (88, 32, 32), (88, 64, 100),
    (1, 1, 1), (3, 5, 7), (7, 13, 1001), (2, 3, 16384), (5, 3, 6),
]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("start", ["aligned", "off 16 bytes"])
@pytest.mark.parametrize("shape", BMV_SHAPES)
def test_bell_bmv_plan_modes_match_plain(card, shape, start):
    """bell_bmv in each staging mode of its launch plan against the plain
    version (max rel 1e-5), bit-equal across two launches (the persistent
    blocks' schedule is static): a table on 16 bytes is staged by TMA
    where B M K is a multiple of 4 floats, a view that starts off 16 bytes
    by the ragged mode.  Each call of ``batched_matvec`` counts one
    launch, by shape."""
    rng = np.random.default_rng(17)
    n = int(np.prod(shape))
    flat = torch.as_tensor(rng.standard_normal(n + 1), dtype=torch.float32, device=card)
    A = (flat[:n] if start == "aligned" else flat[1:]).view(shape)
    x = torch.as_tensor(rng.standard_normal(shape[::2]), dtype=torch.float32,
                        device=card)
    bulk = start == "aligned" and n % 4 == 0
    assert bk.plan_for(A).mode == ("bulk" if bulk else "ragged")
    want = bk.batched_matvec_plain(A, x)
    before = bk.batched_matvec.launches
    by_shape = bk.batched_matvec.launches_by_shape.get(shape, 0)
    y1 = bk.batched_matvec(A, x)
    y2 = bk.batched_matvec(A, x)
    torch.cuda.synchronize()
    assert bk.batched_matvec.launches == before + 2
    assert bk.batched_matvec.launches_by_shape[shape] == by_shape + 2
    assert torch.equal(y1, y2)
    assert _rel_max(y1, want) <= 1e-5


def test_bell_bmv_off_16_bytes_and_refused_shapes(card):
    """A table that starts off a 16-byte boundary is staged by the ragged
    mode; a row the plan cannot stage raises before any launch."""
    rng = np.random.default_rng(19)
    flat = torch.as_tensor(rng.standard_normal(96 * 64 * 64 + 1), dtype=torch.float32,
                           device=card)
    A = flat[1:].view(96, 64, 64)
    x = torch.as_tensor(rng.standard_normal((96, 64)), dtype=torch.float32, device=card)
    assert A.data_ptr() % 16 and A.is_contiguous()
    y = bk.batched_matvec(A, x)
    torch.cuda.synchronize()
    assert _rel_max(y, bk.batched_matvec_plain(A, x)) <= 1e-5
    before = bk.batched_matvec.launches
    with pytest.raises(ValueError):
        bk.batched_matvec(torch.zeros((8, 1, 29041), device=card),
                          torch.zeros((8, 29041), device=card))
    assert bk.batched_matvec.launches == before


def test_unstructured_slice_runs_through_the_kernel(unstructured):
    """5 steps through bell_bmv against the same model's plain path with
    the same frozen preconditioners."""
    sim, aux, _ = unstructured
    theta = sim.make_theta(sim.params.as_dict())
    u0, c0 = sim.initial_state()
    bk.batched_matvec.launches = 0
    u_k, c_k, ok_k, _ = sim.build_simulate_fn(5, 1.0)(theta, u0, c0)
    torch.cuda.synchronize()
    assert bool(ok_k.all()) and bk.batched_matvec.launches > 0
    ref = brain_sim(n=12, dtype=torch.float32, device=u0.device,
                    unstructured=True, plain=True)
    ref.step_config = UNSTRUCT_STEP_CONFIG
    launches = bk.batched_matvec.launches
    u_p, c_p, ok_p, _ = ref.build_simulate_fn(5, 1.0)(theta, u0, c0, aux)
    assert bool(ok_p.all()) and bk.batched_matvec.launches == launches
    for got, want in ((u_k[-1], u_p[-1]), (c_k[-1], c_p[-1])):
        assert float((got - want).norm() / want.norm()) <= 1e-4


# -- the backward of each wrapper, and the adjoint step ------------------------


def _grads(fn, inputs, gy):
    ins = [x.detach().clone().requires_grad_() for x in inputs]
    y = fn(*ins)
    return torch.autograd.grad(y, ins, gy)


@pytest.mark.parametrize("form", ["scalar", "vector", "coupling", "sum", "bmv",
                                  "vector2", "coupling2"])
def test_backward_on_the_card_matches_plain_autograd(form):
    """dv and dW of each wrapper's autograd Function on the card (the
    transposed apply a launch of the kernel on mirrored planes) against
    torch's own autograd of the plain version, max rel 1e-5, at an odd
    n = 1001 with 15 symmetric offsets, some past n; the vector forms at
    d=3 and d=2 (whose coupling transpose is a two-term sum)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(13)
    n = 1001
    half = [int(o) for o in rng.choice(np.arange(1, 3 * n), 7, replace=False)]
    offs = sorted([0] + half + [-o for o in half])
    f32 = lambda *s: torch.as_tensor(rng.standard_normal(s), dtype=torch.float32,  # noqa: E731
                                     device="cuda")
    if form == "bmv":
        ins = (f32(64, 96, 160), f32(64, 160))
        kern, plain, gy = bk.batched_matvec, bk.batched_matvec_plain, f32(64, 96)
    elif form == "sum":
        ins = (f32(15, n), f32(15, n), f32(15, n), f32(n), f32(n), f32(n))

        def kern(W1, W2, W3, v, v2, b, f=sk.apply_scalar_sum):
            return f(offs, ((W1, v, 1.0), (W2, v, 0.5), (W3, v2, -1.0)), b)

        def plain(*a):
            return kern(*a, f=sk.apply_scalar_sum_plain)
        gy = f32(n)
    else:
        fn, pl, ins, gy = {
            "scalar": (sk.apply_scalar, sk.apply_scalar_plain, (f32(15, n), f32(n)),
                       f32(n)),
            "vector": (sk.apply_vector, sk.apply_vector_plain,
                       (f32(15, 3, 3, n), f32(n, 3)), f32(n, 3)),
            "coupling": (sk.apply_coupling, sk.apply_coupling_plain,
                         (f32(15, 3, n), f32(n)), f32(n, 3)),
            "vector2": (sk.apply_vector, sk.apply_vector_plain,
                        (f32(15, 2, 2, n), f32(n, 2)), f32(n, 2)),
            "coupling2": (sk.apply_coupling, sk.apply_coupling_plain,
                          (f32(15, 2, n), f32(n)), f32(n, 2)),
        }[form]
        kern = lambda W, x, fn=fn: fn(offs, W, x)  # noqa: E731
        plain = lambda W, x, pl=pl: pl(offs, W, x)  # noqa: E731
    counted = (sk.apply_scalar, sk.apply_vector, sk.apply_coupling,
               sk.apply_scalar_sum, bk.batched_matvec)
    before = [w.launches for w in counted]
    got = _grads(kern, ins, gy)
    torch.cuda.synchronize()
    # the forward's launch and the backward's transposed launches (bmv's
    # VJP is plain torch), by wrapper in the order of ``counted``
    assert [w.launches - b for w, b in zip(counted, before)] == {
        "scalar": [2, 0, 0, 0, 0], "vector": [0, 2, 0, 0, 0],
        "coupling": [0, 0, 1, 1, 0], "sum": [3, 0, 0, 1, 0],
        "bmv": [0, 0, 0, 0, 1], "vector2": [0, 2, 0, 0, 0],
        "coupling2": [0, 0, 1, 1, 0]}[form]
    want = _grads(plain, ins, gy)
    for g, w in zip(got, want):
        assert g.device.type == "cuda" and g.shape == w.shape
        assert _rel_max(g, w) <= 1e-5


def test_transposed_apply_raises_on_asymmetric_offsets():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    n = 101
    offs = list(range(-7, 8))
    offs[-1] = 9  # no -9
    W = torch.ones((15, n), device="cuda")
    v = torch.ones(n, device="cuda", requires_grad=True)
    y = sk.apply_scalar(offs, W, v)
    with pytest.raises(ValueError, match="symmetric"):
        y.sum().backward()


def test_adjoint_step_on_the_card_keeps_its_gradients_there():
    """value_and_grad through the IFT step on the card (n=8 brain, f32, both
    lanes): every cotangent lands on the card, the backward launches the
    lane's kernels, and J and the gradient agree with the plain path's at
    f64: J to rel 1e-4 on the lattice and 5e-4 on the unstructured lane
    (whose f32 operating point leaves c at ~6e-5, carried into J by the
    threshold's slope), the gradient to rel-L2 1e-3 on the lattice and 1e-2
    on the unstructured lane, the limits of the smoke run's adjoint phase."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from glimslib_tpu_torch.examples import adjoint_problem

    for unstructured in (False, True):
        ip, v0 = adjoint_problem(n=8, unstructured=unstructured,
                                 dtype=torch.float32, device="cuda")
        sim = ip.sim
        vt = torch.tensor(v0, dtype=torch.float32, device="cuda", requires_grad=True)
        p = dict(sim.params.as_dict())
        p.update(ip.update_fn(vt))
        theta = sim.make_theta(p)
        u0, c0 = sim.initial_state()
        c0 = c0.clone().requires_grad_()
        wrappers = (bk.batched_matvec,) if unstructured else (
            sk.apply_scalar, fc.cg_scalar, fc.cg_vector)
        _, c_tr, ok, _ = sim.build_simulate_fn(2, 1.0)(theta, u0, c0)
        before = [w.launches for w in wrappers]
        g_v, g_c0 = torch.autograd.grad(c_tr[-1].sum(), (vt, c0))
        torch.cuda.synchronize()
        assert bool(ok.all())
        assert g_v.device.type == "cuda" and g_c0.device.type == "cuda"
        assert all(w.launches > b for w, b in zip(wrappers, before))
        J, g = ip.value_and_grad(v0)
        ref = brain_sim(n=8, dtype=torch.float64, device="cuda", plain=True,
                        unstructured=unstructured)
        ip64 = type(ip)(ref, ip.param_names, ip.targets, update_fn=ip.update_fn,
                        n_steps=ip.n_steps, dt=1.0)
        J64, g64 = ip64.value_and_grad(v0)
        assert abs(J - J64) <= (5e-4 if unstructured else 1e-4) * abs(J64)
        assert np.linalg.norm(g - g64) <= (1e-2 if unstructured else 1e-3) * np.linalg.norm(g64)


# -- d=2: the rectangle lattice and the reduced 2D atlas -------------------------


@pytest.fixture(scope="module")
def rect():
    """rect_sim(50) on the card, f32: 2,601 nodes, 7 offsets."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    sim = rect_sim(n=50, dtype=torch.float32, device=dev)
    sim._build_step()
    theta = sim._augment_theta_with_operators(sim.make_theta(sim.params.as_dict()))
    rng = np.random.default_rng(21)
    n = sim.mesh.n_nodes
    v = torch.as_tensor(rng.standard_normal(n), dtype=torch.float32, device=dev)
    u = torch.as_tensor(rng.standard_normal((n, 2)), dtype=torch.float32, device=dev)
    return sim, theta, v, u


def test_rect_slice_runs_through_the_kernels(rect):
    """The 2D lattice path (5 steps, the f32 default step, which refines)
    launches both solves of the lane, stencil_pcg<2> resident, and agrees
    with its plain path at f32 to rel-L2 1e-4.  Its forward measures the
    f64 gather residuals, so stencil_apply stays idle there (the adjoint
    test below runs it)."""
    sim, _, _, _ = rect
    assert sim.step_config.refine_f64
    wrappers = (fc.cg_scalar, fc.cg_vector)
    applies = (sk.apply_scalar_sum, sk.apply_vector, sk.apply_coupling)
    for w in wrappers + applies:
        w.launches = 0
    u_tr, c_tr, ok, _ = sim.run()
    torch.cuda.synchronize()
    assert bool(ok.all()) and all(w.launches > 0 for w in wrappers)
    assert all(w.launches == 0 for w in applies)
    assert len(sim.solver_info["el_refine_cg_iters"]) == 5
    assert fc.cg_vector.last_plan.mode == "resident"
    ref = rect_sim(n=50, dtype=torch.float32, device=sim.device, plain=True)
    u_p, c_p, ok_p, _ = ref.run()
    assert bool(ok_p.all())
    for got, want in ((u_tr[-1], u_p[-1]), (c_tr[-1], c_p[-1])):
        assert float((got - want).norm() / want.norm()) <= 1e-4


def test_wrappers_raise_for_a_d_without_a_kernel():
    """d=4 planes on the card: stencil_apply has no (4, 4) or (4, 1) form
    and stencil_pcg no d=4 kernel; each wrapper raises and launches
    nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    n, offs = 101, [-1, 0, 1]
    f32 = lambda *s: torch.ones(s, dtype=torch.float32, device="cuda")  # noqa: E731
    before = (sk.apply_vector.launches, sk.apply_coupling.launches)
    with pytest.raises(ValueError, match="d in"):
        sk.apply_vector(offs, f32(3, 4, 4, n), f32(n, 4))
    with pytest.raises(ValueError, match="d in"):
        sk.apply_coupling(offs, f32(3, 4, n), f32(n))
    assert (sk.apply_vector.launches, sk.apply_coupling.launches) == before
    with pytest.raises(NotImplementedError, match="d=4"):
        fc._pcg_cuda(4, offs, f32(3, 4, 4, n), f32(4, 4, n), f32(n, 4), 1e-7, 0.0, 10)


def test_2d_adjoint_on_the_card():
    """value_and_grad on the card, f32, of the 2D lattice problem
    (rect_adjoint_problem at n=12, 3 parameters) and of the reduced 2D
    atlas (atlas2d_problem on a 24 x 24 x 8 labelmap, the unstructured
    lane): the backward launches every kernel of its lane, and J and the
    gradient agree with the plain path at f64, J to rel 1e-4 (lattice) and
    5e-4 (unstructured), the gradient to rel-L2 1e-3 and 1e-2."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from glimslib_tpu_torch.examples import (
        atlas2d_problem, atlas2d_sim, rect_adjoint_problem, rect_adjoint_sim,
    )

    cases = (
        ("lattice", lambda **k: rect_adjoint_sim(n=12, **k),
         lambda sim: rect_adjoint_problem(sim=sim),
         (sk.apply_scalar, sk.apply_scalar_sum, sk.apply_vector, sk.apply_coupling,
          fc.cg_scalar, fc.cg_vector), 1e-4, 1e-3),
        ("unstructured", lambda **k: atlas2d_sim(24, 24, 8, 4, **k),
         lambda sim: atlas2d_problem(sim=sim), (bk.batched_matvec,), 5e-4, 1e-2),
    )
    for lane, make, problem, wrappers, j_tol, g_tol in cases:
        ip, v0 = problem(make(dtype=torch.float32, device="cuda"))
        vt = ip._param(v0, True)
        with torch.enable_grad():
            J_t = ip._objective(vt)
        before = [w.launches for w in wrappers]
        (g_t,) = torch.autograd.grad(J_t, vt)
        torch.cuda.synchronize()
        assert g_t.device.type == "cuda", lane
        assert all(w.launches > b for w, b in zip(wrappers, before)), lane
        J, g = ip.value_and_grad(v0)
        ref = make(dtype=torch.float64, device="cuda", plain=True)
        ip64 = type(ip)(ref, ip.param_names, ip.targets, update_fn=ip.update_fn)
        J64, g64 = ip64.value_and_grad(v0)
        assert abs(J - J64) <= j_tol * abs(J64), (lane, J, J64)
        assert np.linalg.norm(g - g64) <= g_tol * np.linalg.norm(g64), (lane, g, g64)


# -- the reference's defaults: refinement, bf16 coarse factors ----------------


def test_bf16_coarse_apply_on_the_card_matches_cpu_upcast():
    """The bf16 coarse term B Bᵀ rc on the card (torch.mm with out_dtype
    float32) against its CPU version (the bf16 factor upcast to f32), at
    the n=32 vector factor's shape: float32 out, rel 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from glimslib_tpu_torch.solvers import twolevel as tl

    rng = np.random.default_rng(17)
    B = torch.as_tensor(rng.standard_normal((6744, 4046)), dtype=torch.float32)
    B = B.to(torch.bfloat16)
    rc = torch.as_tensor(rng.standard_normal(6744), dtype=torch.float32)
    got = tl._coarse_apply(B.cuda(), rc.cuda())
    want = tl._coarse_apply(B, rc)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == torch.float32 and got.is_cuda
    assert _rel_max(got.cpu(), want) <= 1e-5


@pytest.mark.parametrize("unstructured", [False, True], ids=["lattice", "unstructured"])
def test_refined_steps_on_the_card(unstructured, monkeypatch):
    """REFINED_STEP_CONFIG at n=8 on the card, 2 steps: every step
    converges with one correction solve, and the state is within rel-L2
    1e-5 of the plain f64 path with tight tolerances."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from glimslib_tpu_torch.examples import REFINED_STEP_CONFIG
    from glimslib_tpu_torch.solvers.coupled import StepConfig

    monkeypatch.setenv("GLIMS_TWOLEVEL_MIN_NODES", "100")
    sim = brain_sim(n=8, dtype=torch.float32, device="cuda", unstructured=unstructured)
    sim.step_config = REFINED_STEP_CONFIG
    u, c, ok, _ = sim.build_simulate_fn(2, 1.0)(sim.make_theta(sim.params.as_dict()),
                                                *sim.initial_state())
    torch.cuda.synchronize()
    assert bool(ok.all()) and len(sim.solver_info["el_refine_cg_iters"]) == 2
    ref = brain_sim(n=8, dtype=torch.float64, device="cuda", unstructured=unstructured,
                    plain=True)
    ref.step_config = StepConfig(newton_rtol=1e-10, newton_atol=1e-14, cg_rtol=1e-12,
                                 cg_maxiter=4000)
    u_r, c_r, ok_r, _ = ref.build_simulate_fn(2, 1.0)(ref.make_theta(ref.params.as_dict()),
                                                      *ref.initial_state())
    assert bool(ok_r.all())
    for got, want in ((u[-1], u_r[-1]), (c[-1], c_r[-1])):
        assert float((got.double() - want).norm() / want.norm()) <= 1e-5


# -- the quad (P2-concentration) model ----------------------------------------


@pytest.fixture
def quad(monkeypatch):
    """The quad brain model on the n=8 Morton box on the card, f32, the
    benchmark's unstructured StepConfig, two-level level on."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setenv("GLIMS_TWOLEVEL_MIN_NODES", "100")
    sim = brain_sim(n=8, dtype=torch.float32, device="cuda", unstructured=True,
                    quad=True)
    assert sim.step_config == UNSTRUCT_STEP_CONFIG
    sim._build_step()
    aux = sim.runtime_aux()
    theta = sim._augment_theta_with_operators(
        {**sim.make_theta(sim.params.as_dict()), **aux})
    return sim, aux, theta


@pytest.mark.parametrize("role", ["_P2BWrdC", "_McSNP2"])
def test_bell_bmv_at_p2_plan_shapes(quad, role):
    """bell_bmv at the P2 plan's shapes (the rd constant plane (nb, 64,
    Kh) and its supernode block-Jacobi (nb, 64, 64)) against its plain
    version, max rel 1e-5, counted by shape."""
    sim, _, theta = quad
    A = theta[role]
    plan = sim._get_p2_plan()
    assert A.shape[:2] == (plan.nb, 64)
    x = torch.as_tensor(np.random.default_rng(7).standard_normal(
        (A.shape[0], A.shape[2])), dtype=torch.float32, device=A.device)
    by_shape = bk.batched_matvec.launches_by_shape.get(tuple(A.shape), 0)
    got = bk.batched_matvec(A, x)
    torch.cuda.synchronize()
    assert bk.batched_matvec.launches_by_shape[tuple(A.shape)] == by_shape + 1
    assert _rel_max(got, bk.batched_matvec_plain(A, x)) <= 1e-5


def test_quad_forward_on_the_card_matches_plain_f64(quad):
    """3 steps of the quad model through bell_bmv (launched at the P2
    shapes) against the plain f64 path on the card with tight
    tolerances: rel-L2 of c and u <= 1e-4."""
    from glimslib_tpu_torch.solvers.coupled import StepConfig

    sim, aux, _ = quad
    plan = sim._get_p2_plan()
    bk.batched_matvec.launches_by_shape = {}
    u, c, ok, _ = sim.build_simulate_fn(3, 1.0)(sim.make_theta(sim.params.as_dict()),
                                                *sim.initial_state())
    torch.cuda.synchronize()
    assert bool(ok.all())
    assert bk.batched_matvec.launches_by_shape.get((plan.nb, plan.s, plan.Kh), 0) > 0
    assert bk.batched_matvec.launches_by_shape.get((plan.nb, plan.s, plan.s), 0) > 0
    ref = brain_sim(n=8, dtype=torch.float64, device="cuda", unstructured=True,
                    quad=True, plain=True)
    ref.step_config = StepConfig(newton_rtol=1e-10, newton_atol=1e-14, cg_rtol=1e-12,
                                 cg_maxiter=4000)
    u_r, c_r, ok_r, _ = ref.build_simulate_fn(3, 1.0)(
        ref.make_theta(ref.params.as_dict()), *ref.initial_state())
    assert bool(ok_r.all())
    for got, want in ((u[-1], u_r[-1]), (c[-1], c_r[-1])):
        assert float((got.double() - want).norm() / want.norm()) <= 1e-4
