"""Node sharding of the lattice (``Simulation.use_sharding(mode="nodes")``,
``parallel/gspmd.py``) of glimslib_tpu_torch on ``torch.distributed``, at
gloo ranks on the CPU (``parallel.run_ranks``; torch on one thread a
rank), against the JAX package.

The inputs are tests/test_gspmd.py's (``_brain(n)``, padded with
``pad_mesh_nodes`` where the world does not divide the nodes), built in
the port by tests/torch_gspmd_cases.py.  The JAX side is the JAX
package's single-device run of the unpadded box, which tests/test_gspmd.py
holds equal to its 8-device node-sharded run at 1e-12.  Both packages
take the pcg branch there (the reference turns its whole-solve kernels
off under node sharding) with tight tolerances, so they agree to rel-L2
1e-8 (tests/test_torch_slice.py's limit).  Held here:

- (a) the plain halo form of every stencil_apply form equals the same
  rows of the wrapped apply on the whole vector, bit for bit;
- (b) two ranks on the 7^3 box padded to 392 nodes: the real nodes
  against JAX (rel-L2 1e-8), the whole trajectory against the port at
  world 1 (atol 1e-11), padding dofs exactly 0, every plane and state
  tensor n / world rows, the plane bytes half of world 1's;
- (c) four ranks on the 4^3 box, a halo of 21 rows against 16 owned:
  the halo reaches past the neighbour; the same limits;
- (d) use_sharding() picks 'nodes' on a padded lattice and run() at two
  ranks: rank 0 alone writes, the fields equal the unsharded run()'s;
- (e) the 2D subdomains rectangle (the <2,2> and <2,1> halo forms) at two
  ranks against the JAX package's 2D model;
- (f) f32 with refine_f64 at two ranks against the JAX f32 run and the
  port's f64 run, within the lattice limit 5e-5;
- (g) at world 1, InverseProblem on a 'nodes' model gives the unsharded
  model's J and gradient (to the solvers' tolerance) and simulate gives
  a gradient (the adjoint itself: tests/test_torch_gspmd_adjoint.py); the
  divisibility error names pad_mesh_nodes.
"""

import datetime
import os
import sys
import tempfile

import numpy as np
import pytest
import jax.numpy as jnp
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch_gspmd_cases as cases  # noqa: E402
from __graft_entry__ import _brain_sim as jax_brain_sim  # noqa: E402
from glimslib_tpu.solvers.coupled import StepConfig as JaxStepConfig  # noqa: E402
from glimslib_tpu_torch.core.mesh import box_mesh, rectangle_mesh  # noqa: E402
from glimslib_tpu_torch.ops import stencil_kernels as sk  # noqa: E402
from glimslib_tpu_torch.ops.stencil import stencil_offsets  # noqa: E402
from glimslib_tpu_torch.parallel import make_device_mesh, run_ranks  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

LATTICE_RTOL = 5e-5  # the f32 lattice limit (chip_smoke.py SLICE_RTOL)
# every plane and load a 'nodes' model builds, by its node axis
NODE_AXIS = {"_Wel": -1, "_Binv": -1, "_Wrd_const": -1, "_Mst": -1, "_Cuc": -1,
             "_rd_diag": 0, "_rd_load": 0, "_el_load": 0}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _jax_run(n, dims=3, dtype=jnp.float64, tight=True):
    """The JAX package's single-device trajectory of the unpadded model
    (``_brain(n)``, or the 2D subdomains rectangle), N_STEPS steps."""
    if dims == 3:
        sim = jax_brain_sim(n=n, dims=3, dtype=dtype)
    else:
        from test_torch_2d import _jax_rect_sim

        sim = _jax_rect_sim(n, subdomains=True)
    if tight:
        sim.step_config = JaxStepConfig(**cases.TIGHT)
    theta = sim.make_theta(sim.params.as_dict())
    iv = sim.params.create_initial_value_function()
    u, c, ok, _ = sim.build_simulate_fn(cases.N_STEPS, 1.0)(
        theta, jnp.asarray(iv[0], dtype), jnp.asarray(iv[1], dtype))
    assert bool(np.asarray(ok).all())
    return np.asarray(u), np.asarray(c)


def _check_ranks(ranks, world, n_real, jax_uc, rtol=1e-8):
    """Every rank: mode 'nodes', converged, the same Newton and CG counts
    on every rank, the real nodes within ``rtol`` of JAX, padding dofs
    exactly 0, every plane and state tensor n / world rows."""
    u_j, c_j = jax_uc
    for out in ranks:
        assert out["mode"] == "nodes" and out["world"] == world
        assert out["ok"].all()
        for key in ("newton", "rd_cg", "el_cg"):
            assert np.array_equal(out[key], ranks[0][key]), key
        n_own = out["n_total"] // world
        assert out["n_own"] == n_own and out["start"] == out["rank"] * n_own
        assert set(out["planes"]) == set(NODE_AXIS)
        for k, shape in out["planes"].items():
            assert shape[NODE_AXIS[k]] == n_own, (k, shape)
        assert out["state"][0][0] == n_own and out["state"][1] == (n_own,)
        assert out["state"][2][:2] == (cases.N_STEPS, n_own)
        assert out["state"][3] == (cases.N_STEPS, n_own)
        assert [m[0] for m in out["mask_rows"]] == [n_own, n_own]
        assert _rel(out["c"][-1, :n_real], c_j[-1]) <= rtol
        assert _rel(out["u"][-1, :n_real], u_j[-1]) <= rtol
        assert np.abs(out["c"][:, n_real:]).max(initial=0.0) == 0.0
        assert np.abs(out["u"][:, n_real:]).max(initial=0.0) == 0.0
    for key in ("u", "c"):
        assert np.array_equal(ranks[0][key], ranks[-1][key])


def test_pad_mesh_nodes_is_the_reference_code():
    """The port's pad_mesh_nodes is the JAX package's code byte for byte
    (imports apart), and pads the 7^3 box to the same mesh: 8 planes of 49
    nodes, every rank owning whole planes at world 2."""
    import inspect

    from glimslib_tpu.core import mesh as jax_mesh
    from glimslib_tpu_torch.core import mesh as port_mesh

    lines = lambda f: [ln for ln in inspect.getsource(f).splitlines()  # noqa: E731
                       if not ln.strip().startswith(("import ", "from "))]
    assert lines(port_mesh.pad_mesh_nodes) == lines(jax_mesh.pad_mesh_nodes)
    got = port_mesh.pad_mesh_nodes(box_mesh((0, 0, 0), (10, 10, 10), 6, 6, 6), 2)
    want = jax_mesh.pad_mesh_nodes(
        jax_mesh.box_mesh((0, 0, 0), (10, 10, 10), 6, 6, 6), 2)
    np.testing.assert_array_equal(got.points, want.points)
    np.testing.assert_array_equal(got.cells, want.cells)
    assert got.lattice_shape == want.lattice_shape and got.n_nodes == 392


# -- (a) the halo form's plain version ----------------------------------------

FORMS = ("scalar", "vector2", "vector3", "coupling2", "coupling3", "sum2", "sum3")


def _lattice_offsets(d):
    m = box_mesh((0, 0, 0), (1, 1, 1), 5, 5, 5) if d == 3 else rectangle_mesh(
        (0, 0), (1, 1), 8, 8)
    return [int(o) for o in stencil_offsets(m.cells)]


@pytest.mark.parametrize("form", FORMS)
def test_halo_form_plain_equals_the_whole_apply_rows(form):
    """Random planes and vectors (f64, seed 0) on N = 300 rows: the halo
    form on the planes' rows [s, s + n) and the vector's rows [s - h, s +
    n + h) equals rows [s, s + n) of the wrapped apply on the whole
    vector, bit for bit, through every wrapper (the plain versions on CPU
    tensors)."""
    d = 2 if form.endswith("2") and not form.startswith("sum") else 3
    offs = _lattice_offsets(d)
    h = max(abs(o) for o in offs)
    N, s, n = 300, 100, 64
    rng = np.random.default_rng(0)
    t = lambda *shape: torch.as_tensor(rng.standard_normal(shape))  # noqa: E731
    own = lambda W: W[..., s:s + n].contiguous()  # noqa: E731
    pad = lambda v: v[s - h:s + n + h].contiguous()  # noqa: E731
    if form == "scalar":
        W, v = t(len(offs), N), t(N)
        whole = sk.apply_scalar(offs, W, v)
        got = sk.apply_scalar(offs, own(W), pad(v), halo=h)
    elif form.startswith("vector"):
        W, u = t(len(offs), d, d, N), t(N, d)
        whole = sk.apply_vector(offs, W, u)
        got = sk.apply_vector(offs, own(W), pad(u), halo=h)
    elif form.startswith("coupling"):
        C, c = t(len(offs), d, N), t(N)
        whole = sk.apply_coupling(offs, C, c)
        got = sk.apply_coupling(offs, own(C), pad(c), halo=h)
    else:
        k = int(form[-1])
        terms = [(t(len(offs), N), t(N), sc) for sc in (1.0, 0.5, -1.0)[:k]]
        b = t(N)
        whole = sk.apply_scalar_sum(offs, terms, b)
        got = sk.apply_scalar_sum(offs, [(own(W), pad(v), sc) for W, v, sc in terms],
                                  b[s:s + n].contiguous(), halo=h)
    assert got.shape == whole[s:s + n].shape
    assert torch.equal(got, whole[s:s + n])


def test_halo_form_refuses_what_it_cannot_read():
    """An offset past the halo and a vector of the wrong row count raise;
    a gradient runs the halo form's backward (dW on the owned rows, dv on
    all n + 2h padded rows)."""
    offs = _lattice_offsets(3)
    h = max(abs(o) for o in offs)
    W, v = torch.ones((len(offs), 10), dtype=torch.float64), torch.ones(10 + 2 * h)
    assert sk.apply_scalar(offs, W, v.double(), halo=h).shape == (10,)
    with pytest.raises(ValueError, match="past a halo of"):
        sk.apply_scalar(offs, W, v.double(), halo=h - 1)
    with pytest.raises(ValueError, match="input rows"):
        sk.apply_scalar(offs, W, v.double()[1:], halo=h)
    Wg, vg = W.clone().requires_grad_(), v.double().requires_grad_()
    sk.apply_scalar(offs, Wg, vg, halo=h).sum().backward()
    assert Wg.grad.shape == W.shape and vg.grad.shape == (10 + 2 * h,)
    # dv of the sum is the column sums of A: each padded row's weight
    assert float(vg.grad.sum()) == pytest.approx(float(W.sum()))
    from glimslib_tpu_torch import _build

    with pytest.raises(ValueError, match="past a halo of"):
        _build.pack_offsets(offs, 10, h - 1)
    assert list(_build.pack_offsets(offs, 10, h)[0].v)[:len(offs)] == [o + h for o in offs]


# -- (b)-(f) ranks -------------------------------------------------------------


def test_two_ranks_padded_box_matches_jax_and_world_one():
    """(b): the 7^3 box padded to 392 nodes at two ranks (196 owned, a
    halo of 57 rows): JAX's single-device run of the unpadded box at
    rel-L2 1e-8 on the real nodes, the port at world 1 at atol 1e-11,
    padding dofs 0, n / 2 rows of every plane and state tensor, half the
    plane bytes."""
    spec = dict(kind="brain", n=6, pad_to=2)
    jax_uc = _jax_run(6)
    ranks = run_ranks(cases.forward_rank, 2, "gloo", "cpu", args=(spec, "nodes"))
    one = run_ranks(cases.forward_rank, 1, "gloo", "cpu", args=(spec, "nodes"))[0]
    assert ranks[0]["n_total"] == 392 and ranks[0]["halo"] == 57
    _check_ranks(ranks, 2, 343, jax_uc)
    _check_ranks([one], 1, 343, jax_uc)
    for out in ranks:
        np.testing.assert_allclose(out["c"], one["c"], rtol=0, atol=1e-11)
        np.testing.assert_allclose(out["u"], one["u"], rtol=0, atol=1e-11)
        assert out["planes"].keys() == one["planes"].keys()
        assert out["plane_bytes"] * 2 == one["plane_bytes"]


def test_four_ranks_halo_past_the_neighbour():
    """(c): the 4^3 box (4 planes of 16 nodes, no padding) at four ranks:
    a halo of 21 rows reaches past each neighbour's 16; against JAX at
    1e-8 and the port at world 1 at atol 1e-11."""
    spec = dict(kind="brain", n=3)
    jax_uc = _jax_run(3)
    ranks = run_ranks(cases.forward_rank, 4, "gloo", "cpu", args=(spec,))
    one = run_ranks(cases.forward_rank, 1, "gloo", "cpu", args=(spec,))[0]
    assert ranks[0]["n_own"] == 16 and ranks[0]["halo"] == 21
    _check_ranks(ranks, 4, 64, jax_uc)
    for out in ranks:
        np.testing.assert_allclose(out["c"], one["c"], rtol=0, atol=1e-11)
        np.testing.assert_allclose(out["u"], one["u"], rtol=0, atol=1e-11)
        assert out["plane_bytes"] * 4 == one["plane_bytes"]


def test_auto_picks_nodes_and_run_writes_on_rank_zero(tmp_path):
    """(d): use_sharding() takes 'nodes' on the padded box; run() at two
    ranks: rank 0 alone writes its files, and both ranks' fields equal the
    unsharded model's run() at rel-L2 1e-8 (real nodes; padding 0)."""
    spec = dict(kind="brain", n=6, pad_to=2)
    ranks = run_ranks(cases.run_rank, 2, "gloo", "cpu", args=(spec, str(tmp_path)))
    whole = cases.port_model(dict(kind="brain", n=6))
    sol = whole.run(save_method=None, output_dir=str(tmp_path / "whole"))
    for out in ranks:
        assert out["mode"] == "nodes"
        assert _rel(out["c"][:343], sol[1]) <= 1e-8
        assert _rel(out["u"][:343], sol[0]) <= 1e-8
        assert np.abs(out["c"][343:]).max() == 0.0
    assert "solution.pvd" in ranks[0]["files"] and any(
        f.endswith(".vtu") for f in ranks[0]["files"])
    assert "solution_timeseries.npz" in ranks[0]["files"]
    assert ranks[1]["files"] == []
    assert np.array_equal(ranks[0]["c"], ranks[1]["c"])


def test_two_ranks_rectangle_matches_jax_2d():
    """(e): the 2D subdomains rectangle at n=8 (81 nodes, padded to 90;
    the <2,2> and <2,1> halo forms) at two ranks against the JAX
    package's 2D model at rel-L2 1e-8."""
    spec = dict(kind="rect", n=8, pad_to=2)
    jax_uc = _jax_run(8, dims=2)
    ranks = run_ranks(cases.forward_rank, 2, "gloo", "cpu", args=(spec,))
    assert ranks[0]["n_total"] == 90 and ranks[0]["halo"] == 10
    assert ranks[0]["planes"]["_Wel"][1:3] == (2, 2)
    _check_ranks(ranks, 2, 81, jax_uc)


def test_two_ranks_f32_refined_within_the_lattice_limit():
    """(f): f32 with the default step (refine_f64: f64 gather residuals on
    the slab's cells, the halo exchanged in f64) at two ranks: every step
    converges with one correction solve, the real nodes within 5e-5 of
    the JAX package's f32 run and of the port's f64 run."""
    spec = dict(kind="brain", n=6, pad_to=2, dtype="float32", config="default")
    u32, c32 = _jax_run(6, dtype=jnp.float32, tight=False)
    ranks = run_ranks(cases.forward_rank, 2, "gloo", "cpu", args=(spec,))
    ref = cases.port_model(dict(kind="brain", n=6))
    _, _, (u64, c64, ok, _) = cases._trajectory(ref)
    for out in ranks:
        assert out["mode"] == "nodes" and out["ok"].all()
        assert out["c"].dtype == np.float32
        for got, want in ((out["c"][-1, :343], c32[-1]), (out["u"][-1, :343], u32[-1]),
                          (out["c"][-1, :343], c64[-1]), (out["u"][-1, :343], u64[-1])):
            assert _rel(got, want) <= LATTICE_RTOL
        assert np.abs(out["c"][:, 343:]).max() == 0.0
    assert np.array_equal(ranks[0]["newton"], ranks[1]["newton"])


# -- (g) world 1: gradients; what the mode refuses ------------------------------


@pytest.fixture
def one_rank():
    """A world of one gloo rank in this process, torn down after."""
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=0,
                                world_size=1, timeout=datetime.timedelta(seconds=60))
        try:
            yield make_device_mesh(device="cpu")
        finally:
            dist.destroy_process_group()


def test_nodes_model_refuses_gradients(one_rank):
    """(g): at world 1, InverseProblem on a 'nodes' model gives J and the
    gradient of the unsharded model (rel 1e-8: the two take other solver
    paths, stopped at TIGHT's tolerances), and a gradient through its
    simulate equals the unsharded one; a world that does not divide the
    nodes raises the reference's divisibility error."""
    from glimslib_tpu_torch.optimize.adjoint import InverseProblem, param_map_for_type
    from glimslib_tpu_torch.parallel import shard_simulate

    sim = cases.port_model(dict(kind="brain", n=3))
    whole = cases.port_model(dict(kind="brain", n=3))
    names, update = param_map_for_type(2)
    simulate, prepare = shard_simulate(sim, 1, 1.0, one_rank)
    assert sim.sharding_mode == "nodes"
    rng = np.random.default_rng(1)
    targets = {"conc": rng.uniform(0, 0.5, 64), "disp": np.zeros((64, 3))}
    v0 = np.array([0.08, 0.05])
    got = InverseProblem(sim, names, targets, update_fn=update).value_and_grad(v0)
    want = InverseProblem(whole, names, targets, update_fn=update).value_and_grad(v0)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-8)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-8)
    grads = []
    for model, fn in ((sim, simulate), (whole, whole.build_simulate_fn(1, 1.0))):
        theta = model.make_theta(model.params.as_dict())
        D = theta["D"] = theta["D"].clone().requires_grad_()
        u, c, ok, _ = fn(theta, *model.initial_state())
        grads.append(torch.autograd.grad((c ** 2).sum() + (u ** 2).sum(), D)[0])
    assert grads[0].abs().max() > 0
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-8, atol=1e-14)
    # prepare takes the whole state: the rank's rows of it (all at world 1)
    iv = sim.params.create_initial_value_function()
    _, u0p, c0p = prepare(theta, iv[0], iv[1])
    assert u0p.shape == (64, 3) and c0p.shape == (64,)
    three = one_rank._replace(world=3)
    with pytest.raises(ValueError, match="not divisible by 3 devices.*pad_mesh_nodes"):
        cases.port_model(dict(kind="brain", n=3)).use_sharding(three, mode="nodes")
    with pytest.raises(ValueError, match="not divisible by 3 devices.*pad_mesh_nodes"):
        shard_simulate(cases.port_model(dict(kind="brain", n=3)), 1, 1.0, three)
