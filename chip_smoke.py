#!/usr/bin/env python3
"""Smoke run of the PyTorch port (glimslib_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on lines of their own:

1. The card (nvidia-smi name and power limit), the CUDA versions, and the
   build of the CUDA kernels from csrc/ (one nvcc per source, started
   together; seconds, ptxas report).
2. Every lattice kernel against its plain torch version on the card, at
   the N=32 shapes the lattice path gives it: stencil_apply for
   (d_out, d_in) = (1,1), (3,3), (3,1) (max rel error <= 1e-5, f32
   summation order) and stencil_pcg for d=1 and d=3 (|Δiters| <= 3 and max
   rel error of x <= 1e-4: reductions re-associate near the tolerance);
   each kernel's time beside the plain version's: the wrapper call
   (CUDA events over back-to-back calls, launch overhead included), the
   kernel alone on the device (torch.profiler), and the plain version.
3. The lattice path: TumorGrowthBrain on the N=32 brain box (35,937
   nodes, 196,608 tets), f32, the benchmark's StepConfig, 5 implicit-Euler
   steps through build_simulate_fn.  Every step must converge, every
   stencil kernel's launch count over that run must be above 0, and the
   final c and u must agree to rel-L2 <= 5e-5 with the port's plain path
   at f64 on the card with tight tolerances.  Prints steps/s (one run
   that counts launches, then 3 timed runs), Newton and CG iteration
   counts, peak memory, and the device time by kernel of one profiled run.
4. The lattice path at N=64 (274,625 nodes, 1,572,864 tets), f32, bench
   StepConfig, 2 steps: every step converges through stencil_pcg<3>
   (launches > 0), and one elasticity solve is held against the plain
   pcg (|Δiters| <= 3, max rel <= 1e-4), with its device time beside its
   per-iteration streaming bound.
5. bell_bmv against its plain version at the five shapes the unstructured
   flagship gives it (max rel <= 1e-5), each with the wrapper call time,
   the device time, the plain time, torch.bmm's time (a yardstick only,
   never called by the port), the bound and the share of the bound.
6. The unstructured path: TumorGrowthBrain on the same n=32 box with its
   lattice structure stripped and its nodes in Morton order, f32, the
   benchmark's unstructured StepConfig, 5 steps: set-up seconds (plans,
   frozen preconditioners), the first run, then the mean of 3 runs.  Every
   step must converge and bell_bmv must launch; prints Newton and CG
   counts, peak memory, the profiler breakdown and the device's idle
   share, and rel-L2 of the final c and u against the port's plain f64
   path on the card with tight tolerances (<= 1e-4).

Then one JSON line with every kernel's numbers, the card's line, and as
the last line {"ok": true, "device": {...}}.  Any failure raises (exit
code != 0).  Needs CUDA: without it the script exits non-zero and prints
no result.
"""

import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

N = 32
N64 = 64
N_STEPS = 5
N64_STEPS = 2
APPLY_RTOL = 1e-5
PCG_RTOL = 1e-4
PCG_DITERS = 3
SLICE_RTOL = 5e-5
UNSTRUCT_RTOL = 1e-4
BMV_RTOL = 1e-5
STENCIL_SRC = "glimslib_tpu_torch/csrc/stencil.cu"
BELL_SRC = "glimslib_tpu_torch/csrc/bell.cu"
# published H100 SXM peaks (NVIDIA data sheet, 700 W): HBM bytes/s and
# float32 operations/s outside the tensor cores
HBM_BPS = 3.35e12
F32_FLOPS = 67e12


def _rel_max(got, want):
    """(max |got - want|, that over max |want|)."""
    err = float((got.double() - want.double()).abs().max())
    return err, err / max(float(want.double().abs().max()), 1e-300)


def _rel_l2(got, want):
    d = (got.double() - want.double()).norm()
    return float(d / max(float(want.double().norm()), 1e-300))


def _bound(nbytes, flops):
    """(least time in ms, 'bytes' | 'operations') on the published peaks."""
    tb, to = nbytes / HBM_BPS * 1e3, flops / F32_FLOPS * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def _profile(torch, fn):
    """Run fn() once under torch.profiler (CPU + CUDA activity)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return prof


def _self_device_us(evt):
    return float(getattr(evt, "self_device_time_total", 0.0) or 0.0)


def _kernel_device_ms(torch, fn, reps, pattern):
    """Mean device time in ms of the kernels whose name matches
    ``pattern`` over ``reps`` calls of fn(), from the profiler; None when
    the profiler records no device time for them."""
    prof = _profile(torch, lambda: [fn() for _ in range(reps)])
    hits = [e for e in prof.key_averages() if re.search(pattern, e.key)]
    us = sum(_self_device_us(e) for e in hits)
    count = sum(e.count for e in hits)
    return us / count / 1e3 if count and us > 0 else None


def _fmt_ms(ms):
    return "not measured" if ms is None else f"{ms:.4f} ms"


def _time_ms(torch, fn, reps):
    """Mean time of fn() in ms over ``reps`` back-to-back calls, between
    two CUDA events (so host launch overhead counts where the host is
    slower than the device), after two warm-up runs."""
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _host_ms(torch, fn):
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    print(f"[1] nvidia-smi: {smi[0]}")
    from glimslib_tpu_torch import _build

    nvcc_v = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                            text=True, check=True).stdout.strip().splitlines()
    print(f"[1] torch {torch.__version__}, torch.version.cuda {torch.version.cuda}, "
          f"nvcc: {nvcc_v[-1]}")
    t0 = time.perf_counter()
    for name in _build.SOURCES:
        _build.load(name)
    print(f"[1] kernels built and loaded in {time.perf_counter() - t0:.2f} s "
          f"({', '.join(_build.library_path(n).name for n in _build.SOURCES)})")
    for name, log in _build.build_log.items():
        for line in log.splitlines():
            if "ptxas info" in line and ("Used" in line or "Compiling" in line):
                print(f"[1]   {name}: {line.strip()}")
    return smi[0]


def _pcg_work(n_off, d, n, iters):
    """(bytes once, operations) of a whole-solve stencil PCG: planes,
    preconditioner, b and x once; per iteration one plane apply, one
    preconditioner apply and ~12 n d vector operations."""
    m_len = d * d * n if d > 1 else n
    nbytes = 4 * (n_off * d * d * n + m_len + 2 * n * d)
    flops = (iters + 1) * (2 * n_off * d * d * n + 2 * m_len + 12 * n * d)
    return nbytes, flops


def phase_kernels(torch, sim, theta, dev):
    """Each lattice kernel vs its plain version at the N=32 shapes."""
    import numpy as np

    from glimslib_tpu_torch.ops import fused_cg as fc
    from glimslib_tpu_torch.ops import stencil_kernels as sk

    ops = sim._stencil_ops
    offs = ops.offsets
    n = sim.mesh.n_nodes
    mask_u, mask_c, _, _ = sim._bc_masks_and_values()
    rng = np.random.default_rng(0)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    v = f32(rng.standard_normal(n))
    u = f32(rng.standard_normal((n, 3)))
    results = []

    applies = [
        ("stencil_apply<1,1>", sk.apply_scalar, sk.apply_scalar_plain,
         theta["_Wrd_const"], v, "glimslib_tpu/ops/stencil_pallas.py:108"),
        ("stencil_apply<3,3>", sk.apply_vector, sk.apply_vector_plain,
         theta["_Wel"], u, "glimslib_tpu/ops/stencil_pallas.py:151"),
        ("stencil_apply<3,1>", sk.apply_coupling, sk.apply_coupling_plain,
         theta["_Cuc"], v, "glimslib_tpu/ops/stencil_pallas.py:151"),
    ]
    for name, kern, plain, W, x, replaces in applies:
        got = kern(offs, W, x)
        want = plain(offs, W, x)
        torch.cuda.synchronize()
        err, rel = _rel_max(got, want)
        if not bool(torch.isfinite(got).all()) or rel > APPLY_RTOL:
            raise AssertionError(f"{name}: rel err {rel:.3e} > {APPLY_RTOL}")
        ms = _time_ms(torch, lambda: kern(offs, W, x), 50)
        plain_ms = _time_ms(torch, lambda: plain(offs, W, x), 20)
        d_out, d_in = name[len("stencil_apply<"):-1].split(",")
        dev_ms = _kernel_device_ms(torch, lambda: kern(offs, W, x), 20,
                                   rf"stencil_apply_kernel<{d_out}, ?{d_in}>")
        bound_ms, bound_by = _bound(4 * (W.numel() + x.numel() + got.numel()),
                                    2 * W.numel())
        print(f"[2] {name}: shape W {tuple(W.shape)}, max abs err {err:.3e}, "
              f"max rel err {rel:.3e} (<= {APPLY_RTOL}); wrapper call "
              f"{ms:.4f} ms, kernel on device {_fmt_ms(dev_ms)}, plain "
              f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
        results.append(dict(name=name, route="cuda", source=STENCIL_SRC,
                            replaces=replaces, wrapper=kern, max_abs_err=err,
                            ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                            bound_by=bound_by, library_ms=None,
                            device_ms=dev_ms))

    cfg = sim.step_config
    c0 = sim.initial_state()[1]
    Wrd = theta["_Wrd_const"] + ops.build_rd_wc(c0, theta["rho"], theta["dt"])
    solves = [
        ("stencil_pcg<1>", fc.cg_scalar, fc.cg_scalar_plain,
         fc.fold_mask_scalar(offs, Wrd, mask_c), theta["_invdM"],
         torch.where(mask_c, 0.0, v), "glimslib_tpu/ops/pallas_cg.py:204"),
        ("stencil_pcg<3>", fc.cg_vector, fc.cg_vector_plain,
         theta["_WelM"], theta["_BinvM"], torch.where(mask_u, 0.0, u),
         "glimslib_tpu/ops/pallas_cg.py:315"),
    ]
    for name, kern, plain, Wm, Minv, b, replaces in solves:
        results.append(_check_pcg(torch, name, kern, plain, offs, Wm, Minv, b,
                                  cfg, replaces, "[2]"))
    return results


def _check_pcg(torch, name, kern, plain, offs, Wm, Minv, b, cfg, replaces, tag):
    """One whole solve of the kernel against the plain pcg, and its times."""
    args = (offs, Wm, Minv, b, cfg.cg_rtol, cfg.cg_atol, cfg.cg_maxiter)
    x_k, info_k = kern(*args)
    x_p, info_p = plain(*args)
    torch.cuda.synchronize()
    it_k, it_p = int(info_k["iters"]), int(info_p["iters"])
    err, rel = _rel_max(x_k, x_p)
    if (not bool(torch.isfinite(x_k).all()) or abs(it_k - it_p) > PCG_DITERS
            or rel > PCG_RTOL):
        raise AssertionError(f"{name}: iters {it_k} vs {it_p}, rel err {rel:.3e}")
    ms = _time_ms(torch, lambda: kern(*args), 3)
    dev_ms = _kernel_device_ms(torch, lambda: kern(*args), 2,
                               rf"stencil_pcg_kernel<{name[len('stencil_pcg<')]}>")
    plain_ms = _host_ms(torch, lambda: plain(*args))
    n_off, d, n = Wm.shape[0], b.shape[1] if b.dim() > 1 else 1, b.shape[0]
    bound_ms, bound_by = _bound(*_pcg_work(n_off, d, n, it_k))
    print(f"{tag} {name}: n={n}, iters kernel {it_k} / plain {it_p} "
          f"(|Δ| <= {PCG_DITERS}), resnorm {float(info_k['resnorm']):.3e} / "
          f"{float(info_p['resnorm']):.3e}, max abs err {err:.3e}, max rel "
          f"err {rel:.3e} (<= {PCG_RTOL}); wrapper call {ms:.4f} ms, "
          f"kernel on device {_fmt_ms(dev_ms)}, plain {plain_ms:.4f} ms "
          f"(host clock, syncs every iteration), bound {bound_ms:.4f} ms "
          f"({bound_by})")
    return dict(name=name, route="cuda", source=STENCIL_SRC, replaces=replaces,
                wrapper=kern, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                device_ms=dev_ms, iters=it_k)


def _print_breakdown(torch, run, run_ms, tag):
    """Device time by kernel over one profiled simulate, and the device's
    busy share: of the profiled run's wall time (the profiler adds host
    overhead) and of ``run_ms``, the unprofiled run's mean wall time."""
    from torch.autograd import DeviceType

    t0 = time.perf_counter()
    prof = _profile(torch, run)
    wall_ms = (time.perf_counter() - t0) * 1e3
    evts = [e for e in prof.key_averages()
            if getattr(e, "device_type", None) == DeviceType.CUDA]
    evts.sort(key=_self_device_us, reverse=True)
    busy_ms = sum(_self_device_us(e) for e in evts) / 1e3
    if busy_ms <= 0:
        print(f"{tag} device time breakdown: not measured (profiler recorded "
              "no device time)")
        return
    print(f"{tag} profiled run: device busy {busy_ms:.3f} ms = "
          f"{100 * busy_ms / wall_ms:.1f}% of its wall {wall_ms:.2f} ms; "
          f"{100 * busy_ms / run_ms:.1f}% of the unprofiled run's "
          f"{run_ms:.2f} ms, so the device idles "
          f"{100 * max(0.0, 1 - busy_ms / run_ms):.1f}% of it")
    for e in evts[:10]:
        us = _self_device_us(e)
        print(f"{tag}   {100 * us / 1e3 / busy_ms:5.1f}%  {us / 1e3:8.3f} ms  "
              f"x{e.count:<6d} {e.key[:90]}")


def _drive(torch, sim, simulate, args, wrappers, tag, n_steps):
    """One run of the path with every count set to 0 just before it:
    returns the trajectory, the launches by wrapper and the seconds."""
    for w in wrappers:
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    u_tr, c_tr, ok, newton = simulate(*args)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {w: w.launches for w in wrappers}
    rd_iters = [int(i) for i in sim.solver_info["rd_cg_iters"]]
    el_iters = [int(i) for i in sim.solver_info["el_cg_iters"]]
    print(f"{tag} {sim.mesh.n_nodes} nodes, {sim.mesh.n_cells} tets; first run "
          f"{first_s:.3f} s")
    print(f"{tag} converged per step {ok.tolist()}; Newton iterations per step "
          f"{newton.tolist()}; rd CG iterations per Newton solve {rd_iters}; "
          f"elasticity CG iterations per step {el_iters}")
    print(f"{tag} launches in that run: " + ", ".join(
        f"{w.__name__}={n}" for w, n in launches.items()))
    if not bool(ok.all()):
        raise AssertionError(f"{tag} a step did not converge")
    missing = [w.__name__ for w, n in launches.items() if n < 1]
    if missing:
        raise AssertionError(f"{tag} kernels not launched on the path: {missing}")
    if not (bool(torch.isfinite(u_tr).all()) and bool(torch.isfinite(c_tr).all())):
        raise AssertionError(f"{tag} non-finite state")
    assert tuple(u_tr.shape) == (n_steps, sim.mesh.n_nodes, 3)
    assert tuple(c_tr.shape) == (n_steps, sim.mesh.n_nodes)
    return (u_tr, c_tr), launches, first_s


def _time_runs(torch, simulate, args, dev, tag, n_steps):
    torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = simulate(*args)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated(dev)
    sps = n_steps / (sum(times) / len(times))
    if not bool(out[2].all()):
        raise AssertionError(f"{tag} a timed run did not converge")
    print(f"{tag} steps/s {sps:.4f} (3 runs of {n_steps} steps: "
          f"{', '.join(f'{t:.4f}' for t in times)} s); peak memory "
          f"{peak / 2**20:.1f} MiB")
    _print_breakdown(torch, lambda: simulate(*args),
                     1e3 * sum(times) / len(times), tag)
    return sps


def phase_slice(torch, sim, dev, kernels):
    from glimslib_tpu_torch.examples import brain_sim
    from glimslib_tpu_torch.solvers.coupled import StepConfig

    theta = sim.make_theta(sim.params.as_dict())
    u0, c0 = sim.initial_state()
    simulate = sim.build_simulate_fn(N_STEPS, 1.0)
    wrappers = [k["wrapper"] for k in kernels]
    (u_tr, c_tr), launches, _ = _drive(torch, sim, simulate, (theta, u0, c0),
                                       wrappers, f"[3] N={N}:", N_STEPS)
    for k in kernels:
        k["launches"] = launches[k["wrapper"]]
    _time_runs(torch, simulate, (theta, u0, c0), dev, "[3]", N_STEPS)

    ref = brain_sim(n=N, dtype=torch.float64, device=dev, plain=True)
    ref.step_config = StepConfig(newton_rtol=1e-10, newton_atol=1e-14,
                                 cg_rtol=1e-12, cg_maxiter=4000)
    t0 = time.perf_counter()
    u_r, c_r, ok_r, newton_r = ref.run()
    torch.cuda.synchronize()
    if not bool(ok_r.all()):
        raise AssertionError("f64 plain reference did not converge")
    rel_c = _rel_l2(c_tr[-1], c_r[-1])
    rel_u = _rel_l2(u_tr[-1], u_r[-1])
    print(f"[3] f64 plain reference on the card ({time.perf_counter() - t0:.1f} s, "
          f"Newton {newton_r.tolist()}): rel-L2 c {rel_c:.3e}, u {rel_u:.3e} "
          f"(<= {SLICE_RTOL})")
    if rel_c > SLICE_RTOL or rel_u > SLICE_RTOL:
        raise AssertionError(f"slice vs f64 reference: c {rel_c:.3e}, u {rel_u:.3e}")


def phase_lattice64(torch, dev):
    """K3c: the lattice path at N=64 through stencil_pcg<3>."""
    from glimslib_tpu_torch.examples import BENCH_STEP_CONFIG, brain_sim
    from glimslib_tpu_torch.ops import fused_cg as fc

    t0 = time.perf_counter()
    sim = brain_sim(n=N64, dtype=torch.float32, device=dev)
    sim.step_config = BENCH_STEP_CONFIG
    theta = sim.make_theta(sim.params.as_dict())
    u0, c0 = sim.initial_state()
    simulate = sim.build_simulate_fn(N64_STEPS, 1.0)
    torch.cuda.synchronize()
    print(f"[4] N={N64} model set-up {time.perf_counter() - t0:.1f} s")
    _, launches, _ = _drive(torch, sim, simulate, (theta, u0, c0),
                            [fc.cg_vector], f"[4] N={N64}:", N64_STEPS)

    aug = sim._augment_theta_with_operators(theta)
    mask_u = sim._bc_masks_and_values()[0]
    # the first step's elasticity system: the rhs of u from rest
    ru = sim.el_residual(torch.where(mask_u, 0.0, u0), c0, aug, 1.0)
    b = torch.where(mask_u, 0.0, -ru).contiguous()
    ops = sim._stencil_ops
    res = _check_pcg(torch, "stencil_pcg<3>", fc.cg_vector, fc.cg_vector_plain,
                     ops.offsets, aug["_WelM"], aug["_BinvM"], b,
                     sim.step_config, "glimslib_tpu/ops/pallas_cg.py:497", "[4]")
    n, n_off = sim.mesh.n_nodes, len(ops.offsets)
    per_iter = 4 * (n_off * 9 * n + 9 * n + 4 * 3 * n)
    stream_ms = per_iter * res["iters"] / HBM_BPS * 1e3
    # one launch a solve: the wrapper call's CUDA-event time is the
    # kernel's plus one launch
    print(f"[4] N={N64} elasticity solve: {res['iters']} iterations; planes, "
          f"Binv and four vector passes stream {per_iter / 1e6:.1f} MB an "
          f"iteration, {stream_ms:.3f} ms at 3.35 TB/s; kernel on device "
          f"{_fmt_ms(res['device_ms'])}, wrapper call {res['ms']:.4f} ms = "
          f"{1e3 * res['ms'] / res['iters']:.1f} us an iteration, "
          f"{100 * stream_ms / res['ms']:.1f}% of that streaming bound")
    res["name"] = "stencil_pcg<3>@N=64"
    res["launches"] = launches[fc.cg_vector]
    return res


def phase_bmv(torch, usim, theta, dev):
    """bell_bmv vs its plain version at the flagship's five shapes."""
    import numpy as np

    from glimslib_tpu_torch.ops import bell_kernels as bk

    plan = usim._get_bell_plan()
    nb, s, Kh, d = plan.nb, plan.s, plan.Kh, 3
    roles = [
        ("elasticity operator _BellWel", theta["_BellWel"].reshape(nb, s * d, Kh * d)),
        ("coupling _BellCuc", theta["_BellCuc"].reshape(nb, s * d, Kh)),
        ("elasticity supernode Jacobi _BinvSN", theta["_BinvSN"]),
        ("rd constant planes _BellWrdC", theta["_BellWrdC"]),
        ("rd supernode Jacobi _McSN", theta["_McSN"]),
    ]
    rng = np.random.default_rng(1)
    shapes = []
    for role, A in roles:
        B, M, K = A.shape
        x = torch.as_tensor(rng.standard_normal((B, K)), dtype=torch.float32,
                            device=dev)
        got = bk.batched_matvec(A, x)
        want = bk.batched_matvec_plain(A, x)
        torch.cuda.synchronize()
        err, rel = _rel_max(got, want)
        if not bool(torch.isfinite(got).all()) or rel > BMV_RTOL:
            raise AssertionError(f"bell_bmv {role}: rel err {rel:.3e} > {BMV_RTOL}")
        ms = _time_ms(torch, lambda: bk.batched_matvec(A, x), 50)
        dev_ms = _kernel_device_ms(torch, lambda: bk.batched_matvec(A, x), 20,
                                   r"bell_bmv_kernel")
        plain_ms = _time_ms(torch, lambda: bk.batched_matvec_plain(A, x), 20)
        lib_ms = _time_ms(torch, lambda: torch.bmm(A, x[:, :, None]), 50)
        bound_ms, bound_by = _bound(4 * (B * M * K + B * K + B * M), 2 * B * M * K)
        share = None if dev_ms is None else bound_ms / dev_ms
        print(f"[5] bell_bmv {role} (B, M, K) = {(B, M, K)}: max abs err "
              f"{err:.3e}, max rel err {rel:.3e} (<= {BMV_RTOL}); wrapper call "
              f"{ms:.4f} ms, kernel on device {_fmt_ms(dev_ms)}, plain "
              f"{plain_ms:.4f} ms, torch.bmm {lib_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}, {4 * B * M * K / 1e6:.1f} MB of "
              "table)"
              + ("" if share is None else f", {100 * share:.1f}% of the bound"))
        shapes.append(dict(role=role, shape=[B, M, K], max_abs_err=err, ms=ms,
                           device_ms=dev_ms, plain_ms=plain_ms, library_ms=lib_ms,
                           bound_ms=bound_ms, bound_by=bound_by))
    top = shapes[0]
    return dict(name="bell_bmv", route="cuda", source=BELL_SRC,
                replaces="glimslib_tpu/ops/bell_pallas.py:56", wrapper=bk.batched_matvec,
                max_abs_err=max(r["max_abs_err"] for r in shapes),
                ms=top["ms"], plain_ms=top["plain_ms"], bound_ms=top["bound_ms"],
                bound_by=top["bound_by"], library_ms=top["library_ms"],
                device_ms=top["device_ms"],
                also_replaces=["glimslib_tpu/ops/bell_pallas.py:199",
                               "glimslib_tpu/ops/bell_pallas.py:229"],
                shapes=shapes)


def phase_unstructured(torch, dev):
    """The unstructured path at n=32 (set-up, kernel checks, runs)."""
    from glimslib_tpu_torch.examples import UNSTRUCT_STEP_CONFIG, brain_sim
    from glimslib_tpu_torch.ops import bell_kernels as bk
    from glimslib_tpu_torch.solvers.coupled import StepConfig

    t0 = time.perf_counter()
    sim = brain_sim(n=N, dtype=torch.float32, device=dev, unstructured=True)
    assert sim.mesh.lattice_strides is None
    sim.step_config = UNSTRUCT_STEP_CONFIG
    model_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan = sim._get_bell_plan()
    plan_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    aux = sim.runtime_aux()
    torch.cuda.synchronize()
    aux_s = time.perf_counter() - t0
    print(f"[6] n={N} unstructured set-up: model {model_s:.2f} s, BellPlan "
          f"{plan_s:.2f} s (nb={plan.nb}, s={plan.s}, Kh={plan.Kh}), frozen "
          f"preconditioners {aux_s:.2f} s ("
          + ", ".join(f"{k} {v:.2f} s" for k, v in sim.setup_seconds.items())
          + f"); coarse factors {tuple(aux['_TLCfac'].shape)} and "
          f"{tuple(aux['_TLCfacS'].shape)}")
    theta = sim.make_theta(sim.params.as_dict())
    u0, c0 = sim.initial_state()
    sim._build_step()
    aug = sim._augment_theta_with_operators({**theta, **aux})
    kern = phase_bmv(torch, sim, aug, dev)
    del aug

    simulate = sim.build_simulate_fn(N_STEPS, 1.0)
    (u_tr, c_tr), launches, _ = _drive(torch, sim, simulate, (theta, u0, c0),
                                       [bk.batched_matvec], f"[6] n={N}:", N_STEPS)
    kern["launches"] = launches[bk.batched_matvec]
    _time_runs(torch, simulate, (theta, u0, c0), dev, "[6]", N_STEPS)

    ref = brain_sim(n=N, dtype=torch.float64, device=dev, plain=True,
                    unstructured=True)
    ref.step_config = StepConfig(newton_rtol=1e-10, newton_atol=1e-14,
                                 cg_rtol=1e-12, cg_maxiter=4000)
    # the frozen coarse factors carry over (a preconditioner changes
    # iteration counts only); the supernode inverses are rebuilt in f64
    aux64 = {k: v.double() for k, v in aux.items() if k.startswith("_TL")}
    t0 = time.perf_counter()
    theta64 = ref.make_theta(ref.params.as_dict())
    u0r, c0r = ref.initial_state()
    u_r, c_r, ok_r, newton_r = ref.build_simulate_fn(N_STEPS, 1.0)(
        theta64, u0r, c0r, aux64)
    torch.cuda.synchronize()
    if not bool(ok_r.all()):
        raise AssertionError("unstructured f64 plain reference did not converge")
    rel_c = _rel_l2(c_tr[-1], c_r[-1])
    rel_u = _rel_l2(u_tr[-1], u_r[-1])
    el_r = [int(i) for i in ref.solver_info["el_cg_iters"]]
    print(f"[6] f64 plain reference on the card ({time.perf_counter() - t0:.1f} s, "
          f"Newton {newton_r.tolist()}, elasticity CG {el_r}): rel-L2 c "
          f"{rel_c:.3e}, u {rel_u:.3e} (<= {UNSTRUCT_RTOL})")
    if rel_c > UNSTRUCT_RTOL or rel_u > UNSTRUCT_RTOL:
        raise AssertionError(
            f"unstructured slice vs f64 reference: c {rel_c:.3e}, u {rel_u:.3e}")
    return kern


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from glimslib_tpu_torch.examples import BENCH_STEP_CONFIG, brain_sim

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = phase_device(torch)

    t0 = time.perf_counter()
    sim = brain_sim(n=N, dtype=torch.float32, device=dev)
    sim.step_config = BENCH_STEP_CONFIG
    sim._build_step()
    theta = sim._augment_theta_with_operators(sim.make_theta(sim.params.as_dict()))
    torch.cuda.synchronize()
    print(f"[2] N={N} model set-up {time.perf_counter() - t0:.1f} s")
    kernels = phase_kernels(torch, sim, theta, dev)
    del theta
    phase_slice(torch, sim, dev, kernels)
    del sim

    kernels.append(phase_lattice64(torch, dev))
    torch.cuda.empty_cache()

    kernels.append(phase_unstructured(torch, dev))

    drop = ("wrapper", "iters")
    print(json.dumps({"kernels": [
        {k: v for k, v in kern.items() if k not in drop} for kern in kernels
    ]}))
    print(f"[7] total {time.perf_counter() - t_start:.1f} s")
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
