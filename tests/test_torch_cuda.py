"""The port's CUDA kernels against their plain torch versions, on the card.

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is
False (the decision is taken inside the fixture, never at import).  The
file imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: stencil applies and batched matvecs max rel 1e-5 (f32
summation order); whole solves |Δiters| <= 3 and max rel 1e-4
(reductions re-associate near the stopping tolerance); the unstructured
slice against its plain path rel-L2 1e-4 (f32 operators, Newton and CG
stopped at 1e-4 and 1e-7).
"""

import numpy as np
import pytest
import torch

from glimslib_tpu_torch.examples import (
    BENCH_STEP_CONFIG, UNSTRUCT_STEP_CONFIG, brain_sim,
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


@pytest.mark.parametrize("d", [1, 3])
def test_stencil_pcg_kernel_matches_plain(lattice, d):
    sim, theta, v, u = lattice
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
    wrappers = (sk.apply_scalar, sk.apply_vector, sk.apply_coupling,
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
    got = bk.batched_matvec(A, x)
    torch.cuda.synchronize()
    assert bk.batched_matvec.launches == before + 1
    assert _rel_max(got, bk.batched_matvec_plain(A, x)) <= 1e-5


def test_bell_bmv_rejects_what_the_kernel_does_not_take(unstructured):
    _, _, theta = unstructured
    A = theta["_BellWrdC"]
    x = torch.zeros(A.shape[0], A.shape[2], device=A.device)
    with pytest.raises(TypeError):
        bk.batched_matvec(A.double(), x.double())
    with pytest.raises(ValueError):
        bk.batched_matvec(A, x[:, :-1])


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
