"""The port's CUDA kernels against their plain torch versions, on the card.

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is
False (the decision is taken inside the fixture, never at import).  The
file imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: stencil applies max rel 1e-5 (f32 summation order); whole
solves |Δiters| <= 3 and max rel 1e-4 (reductions re-associate near the
stopping tolerance).
"""

import numpy as np
import pytest
import torch

from glimslib_tpu_torch.examples import BENCH_STEP_CONFIG, brain_sim
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
