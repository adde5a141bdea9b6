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


def _trajectory(sim):
    """(u_traj, c_traj, ok, newton_iters) of the model's configured
    schedule, through build_simulate_fn (``run`` returns the final state)."""
    dt = float(sim.params.sim_time_step)
    n = int(round(float(sim.params.sim_time) / dt))
    return sim.build_simulate_fn(n, dt)(sim.make_theta(sim.params.as_dict()),
                                        *sim.initial_state())


def test_slice_runs_through_the_kernels(lattice):
    sim, _, _, _ = lattice
    wrappers = (sk.apply_scalar_sum, sk.apply_vector, sk.apply_coupling,
                fc.cg_scalar, fc.cg_vector)
    for w in wrappers:
        w.launches = 0
    u_tr, c_tr, ok, _ = _trajectory(sim)
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
    # the quad model in the workflow on a 256 x 256 slice: the P1 plan's
    # elasticity table and supernode Jacobi, the P2 plan's rd plane and
    # supernode Jacobi
    (2048, 64, 200), (2048, 64, 64), (4096, 64, 159), (4096, 64, 64),
    # the quad model on a 32^3 labelmap's full lattice: the P1 plan's
    # elasticity table, the P2 plan's rd plane (their Jacobis are above)
    (1152, 96, 624), (2048, 64, 352),
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
    u_tr, c_tr, ok, _ = _trajectory(sim)
    torch.cuda.synchronize()
    assert bool(ok.all()) and all(w.launches > 0 for w in wrappers)
    assert all(w.launches == 0 for w in applies)
    assert len(sim.solver_info["el_refine_cg_iters"]) == 5
    assert fc.cg_vector.last_plan.mode == "resident"
    ref = rect_sim(n=50, dtype=torch.float32, device=sim.device, plain=True)
    u_p, c_p, ok_p, _ = _trajectory(ref)
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


# -- the workflow on the card -------------------------------------------------


@pytest.fixture(scope="module")
def workflow_64(tmp_path_factory):
    """The 2D atlas pipeline on the card at f32 (the workflow's default) on
    a 64 x 64 slice of brain_labelmap_3d(64, 64, 8), 3 steps, up to the
    inverse problem; and the plain f64 model of its forward and inverse
    simulations on the card (the f64 default tolerances)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from glimslib_tpu_torch.examples import (
        BRAIN_PARAMS_FIXED, BRAIN_PARAMS_VARYING, TISSUE_MAP,
    )
    from glimslib_tpu_torch.models.tumor_growth_brain import TumorGrowthBrain
    from glimslib_tpu_torch.utils.image_io import Image, write_mha
    from glimslib_tpu_torch.utils.synthetic import brain_labelmap_3d
    from glimslib_tpu_torch.workflow.image_based_optimization import BoundaryAll
    from glimslib_tpu_torch.workflow.image_based_optimization_atlas import (
        ImageBasedOptimizationAtlas,
    )

    d = tmp_path_factory.mktemp("workflow_64")
    path = str(d / "atlas.mha")
    write_mha(path, Image(brain_labelmap_3d(64, 64, 8), origin=(0, 0, 0),
                          spacing=(1, 1, 1)))
    wf = ImageBasedOptimizationAtlas(str(d / "wf"), path_to_labels_atlas=path,
                                     image_z_slice=4)
    assert wf.device.type == "cuda" and wf.dtype == torch.float32
    wf.prepare_domain()
    sim_params = dict(sim_time=3, sim_time_step=1, seed_width=3.0)
    seed = [32.0, 32.0]
    wf.init_forward_problem(seed, BRAIN_PARAMS_VARYING, BRAIN_PARAMS_FIXED, sim_params)
    wf.run_forward_sim(save_method="vtk")
    wf.create_target_fields()
    wf.init_inverse_problem(seed, dict(BRAIN_PARAMS_VARYING, D_WM=0.05, rho_WM=0.05),
                            sim_params, optimization_type=2)

    def plain(sim):
        ref = TumorGrowthBrain(wf.mesh, dtype=torch.float64, device="cuda", plain=True)
        ref.setup_global_parameters(
            label_function=wf.labelfunction, domain_names=TISSUE_MAP,
            boundaries={"boundary_all": BoundaryAll()},
            dirichlet_bcs={"clamped_boundary": {"bc_value": np.zeros(2),
                                                "named_boundary": "boundary_all",
                                                "subspace_id": 0}})
        ref.setup_model_parameters(iv_expression=sim.params._iv_expressions,
                                   **sim.params.as_dict())
        return ref

    return wf, plain


def test_workflow_2d_on_the_card_matches_plain_f64(workflow_64):
    """The forward's final c and u within rel-L2 5e-5 of the plain f64
    path, and J at v0 within 1e-4 of the plain f64 inverse problem's, the
    stencil kernels launching in both."""
    from glimslib_tpu_torch.optimize.adjoint import InverseProblem, param_map_for_type

    wf, plain = workflow_64
    sim = wf.sims["forward"]
    ref = plain(sim)
    u_r, c_r, ok, _ = ref.build_simulate_fn(3, 1.0)(
        ref.make_theta(ref.params.as_dict()), *ref.initial_state())
    assert bool(ok.all())
    for got, want in ((sim.solution[1], c_r[-1]), (sim.solution[0], u_r[-1])):
        want = want.cpu().numpy()
        assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 5e-5
    fc.cg_vector.launches = sk.apply_vector.launches = 0
    J, g = wf.inverse_problem().value_and_grad(np.array([0.05, 0.05]))
    assert fc.cg_vector.launches > 0 and sk.apply_vector.launches > 0
    names, update = param_map_for_type(2)
    J_r, g_r = InverseProblem(plain(wf.sims["inverse"]), names, wf._load_target_fields(),
                              update_fn=update).value_and_grad(np.array([0.05, 0.05]))
    assert abs(J - J_r) <= 1e-4 * abs(J_r)
    assert np.linalg.norm(g - g_r) <= 1e-3 * np.linalg.norm(g_r)


def test_workflow_state_from_the_card_reloads_on_the_cpu(workflow_64):
    """The state and series written by the card's pipeline reload in a
    fresh workflow on the CPU: the domain and every recorded step equal."""
    from glimslib_tpu_torch.workflow.image_based_optimization_atlas import (
        ImageBasedOptimizationAtlas,
    )

    wf, _ = workflow_64
    wf2 = ImageBasedOptimizationAtlas(wf.base_dir, device="cpu")
    wf2.reload_state()
    np.testing.assert_array_equal(wf2.mesh.points, wf.mesh.points)
    sim = wf2.reload_forward_sim()
    assert sim.device.type == "cpu"
    res = wf.sims["forward"].results
    assert sim.results.get_recording_steps() == res.get_recording_steps() == [0, 1, 2, 3]
    for s in res.get_recording_steps():
        for i in (0, 1):
            np.testing.assert_array_equal(sim.results.get_result(s)[i], res.get_result(s)[i])


@pytest.mark.parametrize("world, backend", [(1, "nccl"), (2, "gloo")],
                         ids=["nccl_world1", "gloo_world2"])
def test_sharded_bmv_matches_the_plain_contraction(world, backend):
    """The sharded bmv (``use_sharding(mode="bell")``'s contraction: each
    rank's slab through bell_bmv, the slabs' rows gathered) at the P1 and
    P2 flagship tables' shapes, against the plain contraction of the
    whole: max rel 1e-5 on every rank, one launch a rank at the slab's
    shape, the bulk (TMA) mode where the slab's B M K is a multiple of 4.
    World 1 over NCCL; two ranks sharing the card over gloo."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch_shard_cases as cases
    from glimslib_tpu_torch.parallel import run_ranks

    shapes = [(1152, 96, 474), (1152, 96, 96), (4352, 64, 353), (4352, 64, 64)]
    ranks = run_ranks(cases.bmv_rank, world, backend, "cuda", args=(shapes, 7))
    for per_shape in ranks:
        for (B, M, K), got in zip(shapes, per_shape):
            assert got["slab"] == (B // world, M, K)
            assert got["launches"] == 1 and got["rel"] <= 1e-5, got
            assert got["mode"] == ("bulk" if (B // world) * M * K % 4 == 0 else "ragged")


@pytest.mark.parametrize("form", ["scalar", "vector", "coupling", "vector2", "coupling2",
                                  "sum2", "sum3"])
def test_stencil_apply_halo_form_matches_plain(form):
    """The halo form (the node-sharded lattice's) at n = 1001 owned rows
    and a halo of 60, 15 offsets drawn in [-60, 60] (both ends included):
    the kernel against the plain halo form, max rel 1e-5, one launch; and
    halo 0 (today's form) on the same planes against its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(11)
    n, h = 1001, 60
    offs = [0, -h, h] + [int(o) for o in rng.integers(-h, h + 1, 12)]
    f32 = lambda *s: torch.as_tensor(rng.standard_normal(s), dtype=torch.float32,  # noqa: E731
                                     device="cuda")
    if form.startswith("sum"):
        k = int(form[-1])
        terms = [(f32(15, n), f32(n + 2 * h), s) for s in (1.0, 0.5, -1.0)[:k]]
        b = f32(n)
        before = sk.apply_scalar_sum.launches
        got = sk.apply_scalar_sum(offs, terms, b, halo=h)
        assert sk.apply_scalar_sum.launches == before + 1
        want = sk.apply_scalar_sum_plain(offs, terms, b, halo=h)
    else:
        d = 2 if form.endswith("2") else 3
        kern, plain, W, x = {
            "scalar": (sk.apply_scalar, sk.apply_scalar_plain, f32(15, n), f32(n + 2 * h)),
            "vector": (sk.apply_vector, sk.apply_vector_plain, f32(15, d, d, n),
                       f32(n + 2 * h, d)),
            "coupling": (sk.apply_coupling, sk.apply_coupling_plain, f32(15, d, n),
                         f32(n + 2 * h)),
        }[form.rstrip("2")]
        before = kern.launches
        got = kern(offs, W, x, halo=h)
        assert kern.launches == before + 1
        want = plain(offs, W, x, halo=h)
        x0 = x[h:h + n].contiguous()
        torch.cuda.synchronize()
        assert _rel_max(kern(offs, W, x0), plain(offs, W, x0)) <= 1e-5
    torch.cuda.synchronize()
    assert got.shape == want.shape
    assert _rel_max(got, want) <= 1e-5
    with pytest.raises(ValueError, match="past a halo"):
        sk.apply_scalar(offs, f32(15, n), f32(n + 2 * h - 2), halo=h - 1)


@pytest.mark.parametrize("world, backend", [(1, "nccl"), (2, "gloo")],
                         ids=["nccl_world1", "gloo_world2"])
def test_nodes_mode_runs_through_the_halo_forms(world, backend):
    """use_sharding() on the padded 9^3 box (an 8-element box padded to
    10 planes) at f32: mode 'nodes', 2 converged steps, every halo form's
    wrapper launching and neither stencil_pcg, the same Newton and CG
    counts on every rank, final c and u within rel-L2 1e-4 of the plain
    f64 path unsharded.  World 1 over NCCL; two ranks sharing the card
    over gloo."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch_gspmd_cases as cases
    from glimslib_tpu_torch.core.mesh import box_mesh, pad_mesh_nodes
    from glimslib_tpu_torch.parallel import run_ranks
    from glimslib_tpu_torch.solvers.coupled import StepConfig

    ranks = run_ranks(cases.card_rank, world, backend, "cuda", args=(8, 2, 2))
    ref = brain_sim(dtype=torch.float64, device="cuda", plain=True, mesh=pad_mesh_nodes(
        box_mesh((0, 0, 0), (10, 10, 10), 8, 8, 8), 2))
    ref.step_config = StepConfig(newton_rtol=1e-10, newton_atol=1e-14, cg_rtol=1e-12)
    u_r, c_r, ok, _ = ref.build_simulate_fn(2, 1.0)(
        ref.make_theta(ref.params.as_dict()), *ref.initial_state())
    assert bool(ok.all())
    for out in ranks:
        assert out["mode"] == "nodes" and out["ok"].all() and out["n_total"] == 810
        assert np.array_equal(out["newton"], ranks[0]["newton"])
        assert out["el_cg"] == ranks[0]["el_cg"]
        got = out["launches"]
        assert got["cg_scalar"] == got["cg_vector"] == 0, got
        assert min(got[k] for k in ("apply_scalar", "apply_scalar_sum", "apply_vector",
                                    "apply_coupling")) > 0, got
        for x, want in ((out["c"], c_r[-1]), (out["u"], u_r[-1])):
            want = want.cpu().numpy()
            assert np.linalg.norm(x - want) / np.linalg.norm(want) <= 1e-4


@pytest.mark.parametrize("form", ["scalar", "vector", "coupling", "vector2", "coupling2",
                                  "sum3"])
def test_stencil_apply_halo_form_backward_matches_plain(form):
    """The halo form's backward at n = 1001 owned rows and a halo of 60,
    15 offsets symmetric in [-60, 60]: dW and dv (all n + 2h padded rows)
    through the wrappers, whose dv is one transposed launch of the halo
    form on mirrored extended planes (counted on the wrapper of the form it
    launches), against torch's autograd of the plain halo form, max rel
    1e-5; and the transposed launch alone against its plain version on
    the same planes, max rel 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(13)
    n, h = 1001, 60
    half = sorted({h} | {int(o) for o in rng.choice(np.arange(1, h), 6, replace=False)})
    offs = sorted([0] + half + [-o for o in half])
    assert len(offs) == 15
    f32 = lambda *s: torch.as_tensor(rng.standard_normal(s), dtype=torch.float32,  # noqa: E731
                                     device="cuda").requires_grad_()
    d = 2 if form.endswith("2") else 3
    if form == "sum3":
        args = [f32(15, n), f32(n + 2 * h), f32(15, n), f32(n + 2 * h), f32(15, n),
                f32(n + 2 * h), f32(n)]

        def call(fn, W1, v1, W2, v2, W3, v3, b):
            return fn(offs, ((W1, v1, 1.0), (W2, v2, 0.5), (W3, v3, -1.0)), b, halo=h)
        kern, plain, launched = sk.apply_scalar_sum, sk.apply_scalar_sum_plain, sk.apply_scalar
        n_launch, planes = 3, [("scalar", 0), ("scalar", 2), ("scalar", 4)]
    else:
        base = form.rstrip("2")
        kern, plain, W, x, launched = {
            "scalar": (sk.apply_scalar, sk.apply_scalar_plain, f32(15, n), f32(n + 2 * h),
                       sk.apply_scalar),
            "vector": (sk.apply_vector, sk.apply_vector_plain, f32(15, d, d, n),
                       f32(n + 2 * h, d), sk.apply_vector),
            "coupling": (sk.apply_coupling, sk.apply_coupling_plain, f32(15, d, n),
                         f32(n + 2 * h), sk.apply_scalar_sum),
        }[base]
        args = [W, x]

        def call(fn, W, x):
            return fn(offs, W, x, halo=h)
        n_launch, planes = 1, [(base, 0)]
    got = call(kern, *args)
    gy = torch.as_tensor(rng.standard_normal(tuple(got.shape)), dtype=torch.float32,
                         device="cuda")
    before = launched.launches
    g_kern = torch.autograd.grad(got, args, gy)
    torch.cuda.synchronize()
    assert launched.launches - before == n_launch
    g_plain = torch.autograd.grad(call(plain, *args), args, gy)
    for a, b in zip(g_kern, g_plain):
        assert a.shape == b.shape and _rel_max(a, b) <= 1e-5
    with torch.no_grad():
        for tform, iw in planes:
            WT = sk._transposed(offs, args[iw], tform, h)
            assert WT.shape[-1] == n + 2 * h
            k_out = sk._transposed_apply(tform, offs, WT, gy.contiguous(), h)
            p_out = sk.transposed_apply_plain(tform, offs, WT, gy.contiguous(), h)
            torch.cuda.synchronize()
            assert k_out.shape[0] == n + 2 * h and _rel_max(k_out, p_out) <= 1e-5


@pytest.mark.parametrize("world, backend", [(1, "nccl"), (2, "gloo")],
                         ids=["nccl_world1", "gloo_world2"])
def test_nodes_mode_value_and_grad_against_plain_f64(world, backend):
    """value_and_grad (type 2, 2 steps, conc_T2 and displacement targets
    from the plain f64 forward) on the padded 9^3 box at f32 refined under
    use_sharding() ('nodes'), world 1 over NCCL and two ranks sharing the
    card over gloo: J within 1e-4 and the gradient within rel-L2 1e-3 of
    the plain f64 path unsharded (the lattice limits); J and the gradient
    bit-equal on every rank; the halo forms launch in the backward (the
    transposed launches) and stencil_pcg never."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch_gspmd_cases as cases
    from glimslib_tpu_torch.core.mesh import box_mesh, pad_mesh_nodes
    from glimslib_tpu_torch.optimize.adjoint import (
        InverseProblem, param_map_for_type, thresh,
    )
    from glimslib_tpu_torch.parallel import run_ranks
    from glimslib_tpu_torch.solvers.coupled import StepConfig

    ref = brain_sim(dtype=torch.float64, device="cuda", plain=True, mesh=pad_mesh_nodes(
        box_mesh((0, 0, 0), (10, 10, 10), 8, 8, 8), 2))
    ref.step_config = StepConfig(newton_rtol=1e-10, newton_atol=1e-14, cg_rtol=1e-12)
    u, c, ok, _ = ref.build_simulate_fn(cases.N_STEPS, 1.0)(
        ref.make_theta(ref.params.as_dict()), *ref.initial_state())
    assert bool(ok.all())
    targets = {"conc_T2": thresh(c[-1], 0.12).cpu().numpy(), "disp": u[-1].cpu().numpy()}
    v0 = np.array([0.05, 0.05])
    names, update = param_map_for_type(2)
    J64, g64 = InverseProblem(ref, names, targets, update_fn=update, n_steps=cases.N_STEPS,
                              dt=1.0).value_and_grad(v0)
    ranks = run_ranks(cases.card_grad_rank, world, backend, "cuda",
                      args=(8, 2, targets, v0))
    for out in ranks:
        assert out["mode"] == "nodes"
        assert out["J"] == ranks[0]["J"] and np.array_equal(out["g"], ranks[0]["g"])
        assert out["adj"] == ranks[0]["adj"]
        assert abs(out["J"] - J64) / abs(J64) <= 1e-4
        assert np.linalg.norm(out["g"] - g64) / np.linalg.norm(g64) <= 1e-3
        bwd = out["backward"]
        assert bwd["cg_scalar"] == bwd["cg_vector"] == 0, bwd
        assert min(bwd[k] for k in ("apply_scalar", "apply_vector",
                                    "apply_scalar_sum")) > 0, bwd


# -- the gather residuals around the lanes' kernels; the matrix-free lane -------


def _trajectory(sim, n_steps):
    theta = sim.make_theta(sim.params.as_dict())
    u, c, ok, _ = sim.build_simulate_fn(n_steps, 1.0)(theta, *sim.initial_state())
    assert bool(ok.all())
    return u[-1], c[-1]


def _rel_l2(got, want):
    return float(torch.linalg.vector_norm(got.double().cpu() - want.double().cpu())
                 / torch.linalg.vector_norm(want.double().cpu()))


@pytest.mark.parametrize("unstructured", [False, True], ids=["lattice", "unstructured"])
def test_influx_and_time_dependent_source_on_the_card(unstructured):
    """examples.influx_sim (a von Neumann influx of c, a time-dependent
    source) at f32 refined, 2 steps: the solves launch the lane's kernels
    (stencil_pcg<1>, <3>; bell_bmv) while the rd residual takes the gather
    form; c and u within rel-L2 1e-4 of the plain path at f64."""
    from glimslib_tpu_torch.examples import influx_sim
    from glimslib_tpu_torch.solvers.coupled import StepConfig

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    sim = influx_sim(n=8, dtype=torch.float32, device=dev, unstructured=unstructured)
    wrappers = (fc.cg_scalar, fc.cg_vector, bk.batched_matvec, sk.apply_scalar_sum)
    for w in wrappers:
        w.launches = 0
    u, c = _trajectory(sim, 2)
    torch.cuda.synchronize()
    if unstructured:
        assert bk.batched_matvec.launches > 0
    else:
        assert fc.cg_scalar.launches > 0 and fc.cg_vector.launches > 0
    assert sk.apply_scalar_sum.launches == 0
    ref = influx_sim(dtype=torch.float64, device=dev, plain=True, mesh=sim.mesh)
    ref.step_config = StepConfig(newton_rtol=1e-10, newton_atol=1e-14, cg_rtol=1e-12)
    u_r, c_r = _trajectory(ref, 2)
    assert _rel_l2(c, c_r) <= 1e-4 and _rel_l2(u, u_r) <= 1e-4


@pytest.mark.parametrize("quad", [False, True], ids=["p1", "quad"])
def test_matrix_free_lane_on_the_card(quad):
    """The jvp lane on the card (operator_mode "matrix-free"; the quad
    model on a lattice mesh), f32 refined, 2 steps: no kernel launches,
    c and u within rel-L2 1e-4 of the plain path at f64."""
    from glimslib_tpu_torch.models.base import default_step_config
    from glimslib_tpu_torch.solvers.coupled import StepConfig

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    sims = []
    for dtype, plain in ((torch.float32, False), (torch.float64, True)):
        sim = brain_sim(n=6, dtype=dtype, device=dev, plain=plain, quad=quad)
        sim.operator_mode = "matrix-free"
        sim.step_config = (default_step_config(dtype) if not plain else StepConfig(
            newton_rtol=1e-10, newton_atol=1e-14, cg_rtol=1e-12))
        sims.append(sim)
    wrappers = (fc.cg_scalar, fc.cg_vector, bk.batched_matvec, sk.apply_scalar,
                sk.apply_scalar_sum, sk.apply_vector, sk.apply_coupling)
    for w in wrappers:
        w.launches = 0
    u, c = _trajectory(sims[0], 2)
    torch.cuda.synchronize()
    assert sum(w.launches for w in wrappers) == 0 and u.is_cuda
    u_r, c_r = _trajectory(sims[1], 2)
    assert _rel_l2(c, c_r) <= 1e-4 and _rel_l2(u, u_r) <= 1e-4


@pytest.mark.parametrize("table", ["mass", "coupling"])
def test_bell_mass_and_coupling_tables_through_the_kernel(unstructured, table):
    """``build_bell_mass`` / ``build_bell_coupling_uc`` on the card, equal
    to the model's ``_BellMrd`` / ``_BellCuc`` to 1e-6, applied through
    bell_bmv (one launch) against the plain apply (max rel 1e-5)."""
    from glimslib_tpu_torch.ops import bell

    sim, _, theta = unstructured
    plan, arrays = sim._get_bell_plan(), sim._mesh_arrays()
    th = sim.make_theta(sim.params.as_dict())
    if table == "mass":
        W, key, apply = (bell.build_bell_mass(plan, arrays, sim.kernels._m0), "_BellMrd",
                         bell.apply_bell_scalar)
    else:
        W, key, apply = (bell.build_bell_coupling_uc(plan, arrays, th["mu"], th["lam"],
                                                     th["coupling"]),
                         "_BellCuc", bell.apply_bell_coupling)
    assert W.is_cuda and _rel_max(W, theta[key]) <= 1e-6
    c = torch.as_tensor(np.random.default_rng(9).random(sim.mesh.n_nodes),
                        dtype=torch.float32, device=W.device)
    before = bk.batched_matvec.launches
    got = apply(plan, W, c, bk.batched_matvec)
    torch.cuda.synchronize()
    assert bk.batched_matvec.launches == before + 1
    assert _rel_max(got, apply(plan, W, c, bk.batched_matvec_plain)) <= 1e-5


def test_cg_fixed_iters_through_stencil_apply_value_and_gradient(lattice):
    """``cg_fixed_iters`` (30 iterations, Jacobi) on the rd planes through
    stencil_apply, and the gradient of |x|^2 wrt b through the kernel's
    autograd rule (transposed launches), against the same solve on the
    plain apply: max rel 1e-5 both."""
    from glimslib_tpu_torch.solvers.cg import cg_fixed_iters

    sim, theta, v, _ = lattice
    offs = sim._stencil_ops.offsets
    W = theta["_Wrd_const"].detach()
    diag = W[list(offs).index(0)]
    out = {}
    for way, apply in (("kernel", lambda x: sk.apply_scalar(offs, W, x)),
                       ("plain", lambda x: sk.apply_scalar_plain(offs, W, x))):
        before = sk.apply_scalar.launches
        b = v.clone().requires_grad_(True)
        x = cg_fixed_iters(apply, b, M=lambda r: r / diag, iters=30)
        (g,) = torch.autograd.grad(torch.sum(x * x), b)
        torch.cuda.synchronize()
        out[way] = x.detach(), g, sk.apply_scalar.launches - before
    assert out["kernel"][2] == 31 + 30 and out["plain"][2] == 0
    for i in range(2):
        assert _rel_max(out["kernel"][i], out["plain"][i]) <= 1e-5
