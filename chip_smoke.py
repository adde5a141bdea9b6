#!/usr/bin/env python3
"""Smoke run of the PyTorch port (glimslib_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on lines of their own:

1. The card (nvidia-smi name and power limit), the CUDA versions, and the
   build of the CUDA kernels from csrc/ (seconds, ptxas report).
2. Every kernel of the main path against its plain torch version on the
   card, at the N=32 shapes the main path gives it: stencil_apply for
   (d_out, d_in) = (1,1), (3,3), (3,1) (max rel error <= 1e-5, f32
   summation order) and stencil_pcg for d=1 and d=3 (|Δiters| <= 3 and max
   rel error of x <= 1e-4: reductions re-associate near the tolerance);
   each kernel's time beside the plain version's: the wrapper call
   (CUDA events over back-to-back calls, launch overhead included), the
   kernel alone on the device (torch.profiler), and the plain version.
3. The main path: TumorGrowthBrain on the N=32 brain box (35,937 nodes,
   196,608 tets), f32, the benchmark's StepConfig, 5 implicit-Euler steps
   through build_simulate_fn.  Every step must converge, every kernel's
   launch count over that run must be above 0, and the final c and u must
   agree to rel-L2 <= 5e-5 with the port's plain path at f64 on the card
   with tight tolerances (measured on an H100: c 1.3e-6, u 1.1e-5).
   Prints steps/s (one run that counts launches, then 3 timed runs),
   Newton and CG iteration counts, peak memory, and the device time by
   kernel of one profiled run.

Then one JSON line with every kernel's numbers, and as the last line
{"ok": true, "device": {...}}.  Any failure raises (exit code != 0).
Needs CUDA: without it the script exits non-zero and prints no result.
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

N = 32
N_STEPS = 5
APPLY_RTOL = 1e-5
PCG_RTOL = 1e-4
PCG_DITERS = 3
SLICE_RTOL = 5e-5
SOURCE = "glimslib_tpu_torch/csrc/stencil.cu"


def _rel_max(got, want):
    """(max |got - want|, that over max |want|)."""
    err = float((got.double() - want.double()).abs().max())
    return err, err / max(float(want.double().abs().max()), 1e-300)


def _rel_l2(got, want):
    d = (got.double() - want.double()).norm()
    return float(d / max(float(want.double().norm()), 1e-300))


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
    import re

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
    _build.load()
    print(f"[1] kernels built and loaded in {time.perf_counter() - t0:.2f} s "
          f"({_build.library_path().name})")
    for line in (_build.build_log or "").splitlines():
        if "ptxas info" in line and ("Used" in line or "Compiling" in line):
            print(f"[1]   {line.strip()}")
    return smi[0]


def phase_kernels(torch, sim, theta, dev):
    """Each kernel vs its plain version at the main path's N=32 shapes."""
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
         theta["_Wrd_const"], v, "glimslib_tpu/ops/stencil_pallas.py:107"),
        ("stencil_apply<3,3>", sk.apply_vector, sk.apply_vector_plain,
         theta["_Wel"], u, "glimslib_tpu/ops/stencil_pallas.py:150"),
        ("stencil_apply<3,1>", sk.apply_coupling, sk.apply_coupling_plain,
         theta["_Cuc"], v, "glimslib_tpu/ops/stencil_pallas.py:150"),
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
        print(f"[2] {name}: shape W {tuple(W.shape)}, max abs err {err:.3e}, "
              f"max rel err {rel:.3e} (<= {APPLY_RTOL}); wrapper call "
              f"{ms:.4f} ms, kernel on device {_fmt_ms(dev_ms)}, plain "
              f"{plain_ms:.4f} ms")
        results.append(dict(name=name, route="cuda", source=SOURCE,
                            replaces=replaces, wrapper=kern, max_abs_err=err,
                            ms=ms, plain_ms=plain_ms, device_ms=dev_ms))

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
        args = (offs, Wm, Minv, b, cfg.cg_rtol, cfg.cg_atol, cfg.cg_maxiter)
        x_k, info_k = kern(*args)
        x_p, info_p = plain(*args)
        torch.cuda.synchronize()
        it_k, it_p = int(info_k["iters"]), int(info_p["iters"])
        err, rel = _rel_max(x_k, x_p)
        if (not bool(torch.isfinite(x_k).all()) or abs(it_k - it_p) > PCG_DITERS
                or rel > PCG_RTOL):
            raise AssertionError(
                f"{name}: iters {it_k} vs {it_p}, rel err {rel:.3e}")
        ms = _time_ms(torch, lambda: kern(*args), 5)
        dev_ms = _kernel_device_ms(torch, lambda: kern(*args), 3,
                                   rf"stencil_pcg_kernel<{name[-2]}>")
        t0 = time.perf_counter()
        plain(*args)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        print(f"[2] {name}: n={n}, iters kernel {it_k} / plain {it_p} "
              f"(|Δ| <= {PCG_DITERS}), resnorm {float(info_k['resnorm']):.3e} / "
              f"{float(info_p['resnorm']):.3e}, max abs err {err:.3e}, max rel "
              f"err {rel:.3e} (<= {PCG_RTOL}); wrapper call {ms:.4f} ms, "
              f"kernel on device {_fmt_ms(dev_ms)}, plain {plain_ms:.4f} ms "
              f"(host clock, syncs every iteration)")
        results.append(dict(name=name, route="cuda", source=SOURCE,
                            replaces=replaces, wrapper=kern, max_abs_err=err,
                            ms=ms, plain_ms=plain_ms, device_ms=dev_ms))
    return results


def _print_breakdown(torch, run, run_ms):
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
        print("[3] device time breakdown: not measured (profiler recorded no "
              "device time)")
        return
    print(f"[3] profiled run: device busy {busy_ms:.3f} ms = "
          f"{100 * busy_ms / wall_ms:.1f}% of its wall {wall_ms:.2f} ms, "
          f"{100 * busy_ms / run_ms:.1f}% of the unprofiled run's "
          f"{run_ms:.2f} ms")
    for e in evts[:8]:
        us = _self_device_us(e)
        print(f"[3]   {100 * us / 1e3 / busy_ms:5.1f}%  {us / 1e3:8.3f} ms  "
              f"x{e.count:<5d} {e.key[:90]}")


def phase_slice(torch, sim, dev, kernels):
    from glimslib_tpu_torch.examples import brain_sim
    from glimslib_tpu_torch.solvers.coupled import StepConfig

    theta = sim.make_theta(sim.params.as_dict())
    u0, c0 = sim.initial_state()
    simulate = sim.build_simulate_fn(N_STEPS, 1.0)

    wrappers = [k["wrapper"] for k in kernels]
    for w in wrappers:
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    u_tr, c_tr, ok, newton = simulate(theta, u0, c0)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    for k in kernels:
        k["launches"] = k["wrapper"].launches
    rd_iters = [int(i) for i in sim.solver_info["rd_cg_iters"]]
    el_iters = [int(i) for i in sim.solver_info["el_cg_iters"]]
    print(f"[3] N={N}: {sim.mesh.n_nodes} nodes, {sim.mesh.n_cells} tets, "
          f"{len(sim._stencil_ops.offsets)} offsets; first run {first_s:.3f} s")
    print(f"[3] converged per step {ok.tolist()}; Newton iterations per step "
          f"{newton.tolist()}; rd CG iterations per Newton solve {rd_iters}; "
          f"elasticity CG iterations per step {el_iters}")
    print("[3] launches in that run: " + ", ".join(
        f"{k['name']}={k['launches']}" for k in kernels))
    if not bool(ok.all()):
        raise AssertionError("a step did not converge")
    missing = [k["name"] for k in kernels if k["launches"] < 1]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    if not (bool(torch.isfinite(u_tr).all()) and bool(torch.isfinite(c_tr).all())):
        raise AssertionError("non-finite state")
    assert tuple(u_tr.shape) == (N_STEPS, sim.mesh.n_nodes, 3)
    assert tuple(c_tr.shape) == (N_STEPS, sim.mesh.n_nodes)

    torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = simulate(theta, u0, c0)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated(dev)
    sps = N_STEPS / (sum(times) / len(times))
    if not bool(out[2].all()):
        raise AssertionError("a timed run did not converge")
    print(f"[3] steps/s {sps:.4f} (3 runs of {N_STEPS} steps: "
          f"{', '.join(f'{t:.4f}' for t in times)} s); peak memory "
          f"{peak / 2**20:.1f} MiB")
    _print_breakdown(torch, lambda: simulate(theta, u0, c0),
                     1e3 * sum(times) / len(times))

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
    return sps


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from glimslib_tpu_torch.examples import BENCH_STEP_CONFIG, brain_sim

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

    print(json.dumps({"kernels": [
        {k: v for k, v in kern.items() if k != "wrapper"} for kern in kernels
    ]}))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
