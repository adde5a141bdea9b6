"""The JAX package's size and gate switches in glimslib_tpu_torch, each set
for both packages (``monkeypatch.setenv``, fresh meshes), on the CPU at
f64 (the TIGHT step, 2 steps, tests/torch_switch_cases.py):

- ``GLIMS_BELL_S`` 16 and 64 (the Morton n = 4 box) and ``GLIMS_P2_S`` 32
  (the quad model on the n = 3 box): the plans' tables equal the JAX
  package's (a quad model's P2 plan takes ``GLIMS_BELL_S`` where
  ``GLIMS_P2_S`` is unset, as there); c and u within rel 1e-8.
- ``GLIMS_TWOLEVEL=0`` (with ``GLIMS_TWOLEVEL_MIN_NODES=100``): no ``_TL*``
  in runtime_aux, Newton and CG counts equal to the JAX package's (its rd
  preconditioner wired as in tests/test_torch_chebyshev.py).
- ``GLIMS_TWOLEVEL_AGG=32``: the AggPlan equal; ``GLIMS_COARSE_K`` 0 and
  10 (below the coarse dimension): the factors' width equal;
  ``GLIMS_TWOLEVEL_BF16=0`` at f32: f32 factors on both sides (bf16 where
  unset).
- ``GLIMS_FACTORED=0``: no ``_F*`` in runtime_aux; forward, J and the
  gradient within 1e-10 of the factored run and 1e-8 of the JAX
  package's (tests/test_factored.py:102).
- ``GLIMS_P2BELL=0``: the quad model's rd block on the jvp lane beside
  the supernode elasticity block, forward and value_and_grad within 1e-8
  of the JAX package's, and the f32 default refined step within 1e-5 of
  its.
- ``GLIMS_P2_INTERLEAVE=0``: ``p2_dof_layout`` equal to the JAX
  package's, the quad forward within 1e-8.
- ``GLIMS_P2_HALO_CHUNK``: ``BellPlan(halo_chunk=4)``'s tables equal the
  JAX plan's and its applies the flat plan's within 1e-12; a quad forward
  at ``GLIMS_P2_HALO_CHUNK=4`` against the JAX package's default (no
  switch on its side); ``assemble_scalar_chunked`` bit-equal to
  ``plan.assemble``, and ``GLIMS_ASSEMBLE_CHUNK_SLOTS=1`` routing the P2
  assemblies through it (tests/test_p2_ell.py:167-190); two gloo ranks
  under ``mode="bell"`` with ``GLIMS_BELL_S=64`` and
  ``GLIMS_P2_HALO_CHUNK=4`` on the quad model, bit-equal across the ranks
  and within 1e-10 of the unsharded run.
"""

import os
import sys

import numpy as np
import pytest
import jax.numpy as jnp
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch_switch_cases as cases  # noqa: E402
import torch_switch_jax as J  # noqa: E402
from glimslib_tpu.core.mesh import Mesh as JaxMesh  # noqa: E402
from glimslib_tpu.core.mesh import box_mesh as jax_box_mesh  # noqa: E402
from glimslib_tpu.ops import bell as jbell  # noqa: E402
from glimslib_tpu.ops import p2 as jp2  # noqa: E402
from glimslib_tpu_torch.convert import _AUX_PLAN_TABLES  # noqa: E402
from glimslib_tpu_torch.core.mesh import Mesh, box_mesh  # noqa: E402
from glimslib_tpu_torch.ops import bell, p2, p2_ell  # noqa: E402
from glimslib_tpu_torch.parallel import run_ranks  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

rel = J.rel


PLAN_TABLES = ("nb", "s", "halo_chunk", "khe_rows", "Khe", "Kh", "ext_ids", "place")


def _same_plan(pt, pj):
    for k in PLAN_TABLES:
        assert np.array_equal(np.asarray(getattr(pt, k)), np.asarray(getattr(pj, k))), k


# -- the supernode sizes ----------------------------------------------------------------


@pytest.mark.parametrize("env", [{"GLIMS_BELL_S": "16"}, {"GLIMS_BELL_S": "64"},
                                 {"GLIMS_P2_S": "32"}],
                         ids=["bell_s16", "bell_s64", "p2_s32"])
def test_supernode_size_matches_jax(env, monkeypatch):
    """The plans at the switched s equal the JAX package's; the forward
    within 1e-8 of its."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    quad = "GLIMS_P2_S" in env
    monkeypatch.setenv("GLIMS_P2_HALO_CHUNK", "1")
    jsim, sim = J.box_brain(3 if quad else 4, quad=quad), cases.box_brain(3 if quad else 4,
                                                                           quad=quad)
    _same_plan(sim._get_bell_plan(), jsim._get_bell_plan())
    assert sim._get_bell_plan().s == int(env.get("GLIMS_BELL_S", "32"))
    if quad:
        _same_plan(sim._get_p2_plan(), jsim._get_p2_plan())
        assert sim._get_p2_plan().s == 32
    J.wire_rd_precond(jsim, monkeypatch)
    J.check_forward(cases.run(sim), J.jax_run(jsim, monkeypatch))


def test_bell_s_sets_the_p2_plan_where_p2_s_is_unset(monkeypatch):
    """GLIMS_BELL_S alone sizes a quad model's P2 plan too, as in the
    reference (base.py:506)."""
    monkeypatch.setenv("GLIMS_BELL_S", "16")
    monkeypatch.setenv("GLIMS_P2_HALO_CHUNK", "1")
    jsim, sim = J.box_brain(3, quad=True), cases.box_brain(3, quad=True)
    _same_plan(sim._get_p2_plan(), jsim._get_p2_plan())
    assert sim._get_p2_plan().s == 16
    monkeypatch.setenv("GLIMS_P2_S", "32")
    assert cases.box_brain(3, quad=True)._get_p2_plan().s == 32


# -- the two-level level ----------------------------------------------------------------


def test_twolevel_off_matches_jax(monkeypatch):
    """GLIMS_TWOLEVEL=0 on a mesh above GLIMS_TWOLEVEL_MIN_NODES: no coarse
    arrays; Newton and CG counts equal to the JAX package's."""
    monkeypatch.setenv("GLIMS_TWOLEVEL_MIN_NODES", "100")
    monkeypatch.setenv("GLIMS_TWOLEVEL", "0")
    jsim, sim = J.box_brain(4), cases.box_brain(4)
    assert sim.mesh.n_nodes >= 100 and sim._twolevel_aggplan() is None
    assert not any(k.startswith("_TL") for k in sim.runtime_aux())
    J.wire_rd_precond(jsim, monkeypatch)
    want = J.jax_run(jsim, monkeypatch)
    assert not any(k.startswith("_TL") for k in want["aux"])
    out = cases.run(sim)
    J.check_forward(out, want)
    assert out["counts"] == want["counts"], (out["counts"], want["counts"])


@pytest.mark.parametrize("case", ["agg32", "coarse_k0", "coarse_k10", "bf16_off",
                                  "bf16_on"])
def test_coarse_level_switches_match_jax(case, monkeypatch):
    """GLIMS_TWOLEVEL_AGG=32: the AggPlan equal; GLIMS_COARSE_K 0 and 10:
    the factors' widths equal; GLIMS_TWOLEVEL_BF16=0 at f32: f32 factors
    (bf16 where unset) on both sides.  On the node block-ELL lane, whose
    frozen state is the two-level level's alone: the level does not depend
    on the lane."""
    monkeypatch.setenv("GLIMS_TWOLEVEL_MIN_NODES", "100")
    monkeypatch.setenv("GLIMS_BELL", "0")
    f32 = case.startswith("bf16")
    if case == "agg32":
        monkeypatch.setenv("GLIMS_TWOLEVEL_AGG", "32")
    elif case.startswith("coarse_k"):
        monkeypatch.setenv("GLIMS_COARSE_K", case[len("coarse_k"):])
    elif case == "bf16_off":
        monkeypatch.setenv("GLIMS_TWOLEVEL_BF16", "0")
    jsim = J.box_brain(4, dtype=jnp.float32 if f32 else jnp.float64)
    sim = cases.box_brain(4)
    if f32:
        from glimslib_tpu_torch.examples import brain_sim

        sim = brain_sim(n=4, dtype=torch.float32, device="cpu", unstructured=True)
    at, aj = sim._twolevel_aggplan(), jsim._twolevel_aggplan()
    for k in ("n", "d", "m", "nagg", "n_pad", "q"):
        assert getattr(at, k) == getattr(aj, k), k
    for k in ("agg_of", "offsets"):
        assert np.array_equal(np.asarray(getattr(at, k)), np.asarray(getattr(aj, k))), k
    assert at.m == (32 if case == "agg32" else 64)
    if case == "agg32":
        return
    auxt, auxj = sim.runtime_aux(), jsim.runtime_aux()
    assert auxt["_TLCfac"].shape[0] > 10
    for k in ("_TLCfac", "_TLCfacS"):
        assert tuple(auxt[k].shape) == tuple(auxj[k].shape), k
        if case == "coarse_k10":
            # 10 columns where the coarse dimension is above 10, else all
            assert auxt[k].shape[1] == min(10, auxt[k].shape[0])
        elif case == "coarse_k0":
            assert auxt[k].shape[0] == auxt[k].shape[1]
        else:
            want = torch.float32 if case == "bf16_off" else torch.bfloat16
            assert auxt[k].dtype == want and str(auxj[k].dtype) == str(want).split(".")[1]


# -- the factored assembly ----------------------------------------------------------------


def test_factored_off_matches_factored_and_jax(monkeypatch):
    """GLIMS_FACTORED=0: no channel stacks; forward, J and the gradient
    within 1e-10 of the factored run and, on the targets of its forward,
    1e-8 of the JAX package's value_and_grad (and the forward inside it)."""
    fac = cases.box_brain(4)
    assert any(k.startswith("_F") for k in fac.runtime_aux())
    monkeypatch.setenv("GLIMS_FACTORED", "0")
    sim = cases.box_brain(4)
    assert not any(k.startswith("_F") for k in sim.runtime_aux())
    out = cases.run(sim, "own")
    jsim = J.box_brain(4)
    J.wire_rd_precond(jsim, monkeypatch)
    want = J.jax_vg(jsim, monkeypatch, out["targets"])
    assert not any(k.startswith("_F") for k in want["aux"])
    monkeypatch.delenv("GLIMS_FACTORED")
    ref = cases.run(fac, out["targets"])
    for k in ("u", "c"):
        assert np.abs(out[k] - ref[k]).max() <= 1e-10 * np.abs(ref[k]).max(), k
    assert abs(out["J"] - ref["J"]) <= 1e-10 * abs(ref["J"])
    assert rel(out["g"], ref["g"]) <= 1e-10
    J.check_forward(out["v0"], want)
    assert abs(out["J"] - want["J"]) <= 1e-8 * abs(want["J"])
    assert rel(out["g"], want["g"]) <= 1e-8


# -- the quad models' P2 switches ---------------------------------------------------------


def test_p2bell_off_matches_jax(monkeypatch):
    """GLIMS_P2BELL=0: the quad model's rd block on the jvp lane (no P2
    plan, no P2 state), its elasticity block on the supernode lane;
    value_and_grad (on the targets of the port's forward) and the forward
    inside it within 1e-8 of the JAX package's."""
    monkeypatch.setenv("GLIMS_P2BELL", "0")
    sim = cases.box_brain(3, quad=True)
    b = sim._bell_builders()
    assert b["rd_jacobian"] is None and b["el_operator"] is not None
    aux = sim.runtime_aux()
    assert "_BinvSN" in aux and not any(k.startswith(("_McSNP2", "_FP2")) for k in aux)
    out = cases.run(sim, "own")
    assert sim._p2_plan is None and not sim._warm_start_ok
    want = J.jax_vg(J.box_brain(3, quad=True), monkeypatch, out["targets"])
    assert sorted(aux) == [k for k in want["aux"] if k not in _AUX_PLAN_TABLES]
    J.check_forward(out["v0"], want)
    assert abs(out["J"] - want["J"]) <= 1e-8 * abs(want["J"])
    assert rel(out["g"], want["g"]) <= 1e-8


def test_p2bell_off_refined_f32_matches_jax(monkeypatch):
    """GLIMS_P2BELL=0 at f32 under both packages' default refined step (f64
    residuals around the jvp rd solves and the supernode elasticity solve,
    one correction solve a step) on the quad TumorGrowth of
    tests/test_torch_quad.py, the n = 4 Morton box: 2 steps within rel-L2
    1e-5 of the JAX package's."""
    import jax

    from glimslib_tpu.models.tumor_growth_quad import TumorGrowth as JaxQuad
    from glimslib_tpu_torch.models.tumor_growth_quad import TumorGrowth

    monkeypatch.setenv("GLIMS_P2BELL", "0")
    m, mj = box_mesh((0, 0, 0), (10, 10, 10), 4, 4, 4), jax_box_mesh((0, 0, 0), (10, 10, 10),
                                                                  4, 4, 4)
    jsim = cases.setup_quad(JaxQuad(JaxMesh.from_arrays(mj.points, mj.cells).reordered_morton(),
                                    dtype=jnp.float32), 2)
    sim = cases.setup_quad(TumorGrowth(Mesh.from_arrays(m.points, m.cells).reordered_morton(),
                                       dtype=torch.float32, device="cpu"), 2)
    assert jsim.step_config.refine_f64 and sim.step_config.refine_f64
    assert sim._bell_builders()["rd_jacobian"] is None
    theta = jsim.make_theta(jsim.params.as_dict())
    theta = {k: jnp.asarray(v, jnp.float32) if jnp.asarray(v).dtype.kind == "f" else v
             for k, v in theta.items()}
    iv = jsim.params.create_initial_value_function()
    aux = jsim.runtime_aux()
    u_j, c_j, ok_j, _ = jax.jit(jsim.build_simulate_fn(2, 1.0))(
        theta, jnp.asarray(iv[0], jnp.float32), jnp.asarray(iv[1], jnp.float32), aux or None)
    assert bool(np.asarray(ok_j).all())
    u, c, ok, _ = sim.build_simulate_fn(2, 1.0)(sim.make_theta(sim.params.as_dict()),
                                                *sim.initial_state())
    assert bool(ok.all()) and len(sim.solver_info["el_refine_cg_iters"]) == 2
    assert rel(c[-1], c_j[-1]) <= 1e-5, rel(c[-1], c_j[-1])
    assert rel(u[-1], u_j[-1]) <= 1e-5, rel(u[-1], u_j[-1])


def test_p2_interleave_off_matches_jax(monkeypatch):
    """GLIMS_P2_INTERLEAVE=0: the canonical P2 dof order, equal to the JAX
    package's layout, and the quad forward within 1e-8 of its."""
    monkeypatch.setenv("GLIMS_P2_INTERLEAVE", "0")
    monkeypatch.setenv("GLIMS_P2_HALO_CHUNK", "1")
    jsim, sim = J.box_brain(3, quad=True), cases.box_brain(3, quad=True)
    for a, b in zip(p2.p2_dof_layout(sim.mesh), jp2.p2_dof_layout(jsim.mesh)):
        assert np.array_equal(a, b)
    assert np.array_equal(sim.p2.dof_perm, np.arange(sim.p2.n_dofs))
    _same_plan(sim._get_p2_plan(), jsim._get_p2_plan())
    J.wire_rd_precond(jsim, monkeypatch)
    J.check_forward(cases.run(sim), J.jax_run(jsim, monkeypatch))


# -- the chunk-aligned P2 halo and the chunked assembly ------------------------------------


def _p2_space(n=3):
    m = box_mesh((0, 0, 0), (1, 1, 1), n, n, n)
    mj = jax_box_mesh((0, 0, 0), (1, 1, 1), n, n, n)
    mt = Mesh.from_arrays(m.points, m.cells).reordered_morton()
    mj = JaxMesh.from_arrays(mj.points, mj.cells).reordered_morton()
    return p2.P2Kernels(mt, dtype=torch.float64), jp2.P2Kernels(mj, dtype=jnp.float64)


def test_chunked_halo_plan_matches_jax_and_flat():
    """BellPlan(halo_chunk=4) over the P2 dofs: the JAX plan's tables; its
    vector, scalar, coupling and supernode-Jacobi applies equal the flat
    plan's within 1e-12 on the same assembled operator."""
    kt, kj = _p2_space()
    conn, n = np.asarray(kt.cell_dofs), kt.n_dofs
    assert np.array_equal(conn, np.asarray(kj.cell_dofs))
    flat = bell.BellPlan(conn=conn, n=n, s=16)
    ch = bell.BellPlan(conn=conn, n=n, s=16, halo_chunk=4)
    _same_plan(ch, jbell.BellPlan(conn=np.asarray(kj.cell_dofs), n=n, s=16, halo_chunk=4))
    assert ch.Khe == 4 * ch.khe_rows and ch.Kh > flat.Kh
    rng = np.random.default_rng(11)
    npe, nc, d = conn.shape[1], conn.shape[0], 3
    ent = torch.as_tensor(rng.standard_normal((npe, npe, nc, d, d)))
    ent_s = torch.as_tensor(rng.standard_normal((npe, npe, nc)))
    x = torch.as_tensor(rng.standard_normal((n, d)))
    xs = torch.as_tensor(rng.standard_normal(n))
    out = {}
    for name, plan in (("flat", flat), ("chunk", ch)):
        Wv = plan.assemble(ent).permute(0, 1, 3, 2, 4).contiguous()
        Ws = plan.assemble(ent_s)
        Wc = plan.assemble(ent[..., 0]).permute(0, 1, 3, 2).contiguous()
        Binv = bell.supernode_jacobi_inverse(
            plan, bell.extract_self_blocks_scalar(plan, Ws) + 10 * torch.eye(plan.s))
        out[name] = [bell.apply_bell_vector(plan, Wv, x), bell.apply_bell_scalar(plan, Ws, xs),
                     bell.apply_bell_coupling(plan, Wc, xs),
                     bell.apply_supernode_jacobi(plan, Binv, xs)]
    for a, b in zip(out["chunk"], out["flat"]):
        assert rel(a, b) <= 1e-12


def test_assemble_scalar_chunked_is_bit_equal(monkeypatch):
    """assemble_scalar_chunked == plan.assemble bit for bit (small chunks
    take every path), and GLIMS_ASSEMBLE_CHUNK_SLOTS=1 routes the P2
    assemblies through it; unset, nothing does."""
    kt, _ = _p2_space()
    plan = p2_ell.make_p2_plan(kt, s=16)
    rng = np.random.default_rng(7)
    D = torch.as_tensor(0.1 + 0.02 * rng.random(kt.n_cells))
    rho = torch.as_tensor(0.1 + 0.05 * rng.random(kt.n_cells))
    ent = p2_ell.const_entries(kt, D, rho, 0.7)
    want = plan.assemble(ent)
    assert torch.equal(bell.assemble_scalar_chunked(plan, ent, rows_per_chunk=100), want)
    calls = []
    chunked = bell.assemble_scalar_chunked
    monkeypatch.setattr(bell, "assemble_scalar_chunked",
                        lambda *a, **k: calls.append(1) or chunked(*a, **k))
    c = torch.as_tensor(rng.random(kt.n_dofs))
    wc = p2_ell.build_p2_rd_wc(plan, kt, c, rho, 0.7, 1.0)
    assert torch.equal(p2_ell.build_p2_rd_const(plan, kt, D, rho, 0.7), want)
    assert not calls
    monkeypatch.setenv("GLIMS_ASSEMBLE_CHUNK_SLOTS", "1")
    assert torch.equal(p2_ell.build_p2_rd_const(plan, kt, D, rho, 0.7), want)
    assert torch.equal(p2_ell.build_p2_rd_wc(plan, kt, c, rho, 0.7, 1.0), wc)
    assert len(calls) == 2


def test_quad_chunked_halo_matches_jax_default(monkeypatch):
    """The quad forward at GLIMS_P2_HALO_CHUNK=4 against the JAX package's
    default (no switch on its side): the same P2 plan and the forward
    within 1e-8."""
    monkeypatch.delenv("GLIMS_P2_HALO_CHUNK", raising=False)
    jsim = J.box_brain(3, quad=True)
    jplan = jsim._get_p2_plan()
    assert jplan.halo_chunk == 4
    J.wire_rd_precond(jsim, monkeypatch)
    want = J.jax_run(jsim, monkeypatch)
    monkeypatch.setenv("GLIMS_P2_HALO_CHUNK", "4")
    sim = cases.box_brain(3, quad=True)
    _same_plan(sim._get_p2_plan(), jplan)
    J.check_forward(cases.run(sim), want)


def test_chunked_halo_under_block_sharding(monkeypatch):
    """Two gloo ranks under mode="bell", GLIMS_BELL_S=64 and
    GLIMS_P2_HALO_CHUNK=4, the quad model: half the P2 blocks a rank, the
    ranks bit-equal, within 1e-10 of the unsharded run."""
    monkeypatch.setenv("GLIMS_BELL_S", "64")
    monkeypatch.setenv("GLIMS_P2_HALO_CHUNK", "4")
    ranks = run_ranks(cases.chunked_bell_rank, 2, "gloo", "cpu", timeout=300)
    ref = cases.run(cases.box_brain(3, quad=True), "own")
    r0 = ranks[0]
    assert r0["p2_chunk"] == 4 and r0["bell_s"] == 64 and r0["p2_sharded"]
    assert 2 * r0["p2_nb"][0] == r0["p2_nb"][1]
    for r in ranks[1:]:
        for k in ("u", "c", "g"):
            assert np.array_equal(r[k], r0[k]), k
        assert r["J"] == r0["J"]
    for k in ("u", "c"):
        assert np.abs(r0[k] - ref[k]).max() <= 1e-10 * np.abs(ref[k]).max(), k
    assert abs(r0["J"] - ref["J"]) <= 1e-10 * abs(ref["J"])
    assert rel(r0["g"], ref["g"]) <= 1e-10
