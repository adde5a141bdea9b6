#!/usr/bin/env python3
"""Smoke run of the PyTorch port (glimslib_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on lines of their own:

1. The card (nvidia-smi name and power limit), the CUDA versions, and the
   build of the CUDA kernels from csrc/ (one nvcc per source, started
   together; seconds, ptxas report).
2. Every lattice kernel against its plain torch version on the card, at
   the N=32 shapes the lattice path gives it: stencil_apply for
   (d_out, d_in) = (1,1), (3,3), (3,1) and the rd residual's three-term
   form <1,1,3> (max rel error <= 1e-5) and stencil_pcg for d=1 and d=3
   ([8] does the same for the 2D forms)
   (|Δiters| <= 3 and max rel error of x <= 1e-4: reductions re-associate
   near the tolerance).  Every stencil_apply form prints its device time
   L2-cold (before each single launch a 256 MB tensor is written and
   128 MB of another read, so the L2 holds neither input and no dirty
   line: the kernel's duration from torch.profiler is the JSON's ``ms``
   and the share of the bound is taken on it; CUDA events right around
   the launch, which add the launch's own latency, are printed beside
   it) and warm (torch.profiler over back-to-back calls on the same
   planes), the wrapper call (CUDA events over back-to-back calls, host
   overhead included) and its host cost by part, the plain version, and
   the same operator as one torch.sparse CSR matrix (int32 indices,
   built once outside the timing; cuSPARSE's matvec, cold and warm,
   ``library_ms`` the cold one: a yardstick the port never calls).  The
   rd residual in one launch is also timed against the three single
   launches and elementwise passes it replaces, in turns (3, 1, 1, 3).
   Every stencil_pcg launch also prints its mode (resident, streamed or
   streamed_global), iterations, device time from CUDA events right
   around single launches (the stream held busy first, so the host's work
   before the launch does not count), us an iteration, the bound (inputs
   once) and the
   per-iteration streaming figure (planes, preconditioner and four vector
   passes from HBM every iteration), each with its share of the time; the
   elasticity solve is also timed in every other mode that fits.
3. The lattice path: TumorGrowthBrain on the N=32 brain box (35,937
   nodes, 196,608 tets), f32, the benchmark's StepConfig, 5 implicit-Euler
   steps through build_simulate_fn.  Every step must converge, every
   stencil kernel's launch count over that run must be above 0, and the
   final c and u must agree to rel-L2 <= 5e-5 with the port's plain path
   at f64 on the card with tight tolerances.  Prints steps/s (one run
   that counts launches, then 3 timed runs), Newton and CG iteration
   counts, peak memory, and the device time by kernel of one profiled run
   (each stencil_apply kernel with its time a launch on the path).  K1's
   kernel runs on the path as the rd residual (apply_scalar_sum); its row
   counts the launches of both of its wrappers.
4. The lattice path at N=64 (274,625 nodes, 1,572,864 tets), f32, bench
   StepConfig, 2 steps: every step converges through the lattice kernels
   (launches > 0); every stencil_apply form is held against its plain
   version and timed as in [2]; one elasticity solve (stencil_pcg<3>, streamed;
   and again forced to streamed_global, the layout larger lattices or
   cards with fewer SMs take) and one rd solve (stencil_pcg<1>, resident)
   are held against the plain pcg (|Δiters| <= 3, max rel <= 1e-4) and
   timed as in [2].
5. bell_bmv against its plain version at the five shapes the unstructured
   flagship gives it (max rel <= 1e-5), each with its device time
   L2-cold (the JSON's ``ms``; flushed as in [2]) and warm, torch.bmm's
   device time the same two ways (a yardstick only, never called by the
   port; ``library_ms`` the cold one), the wrapper call time, the plain
   time, the bound, the share of the bound on the cold time and the
   launch plan (rows a span, staging mode, stages, lanes a row, blocks).
6. The unstructured path: TumorGrowthBrain on the same n=32 box with its
   lattice structure stripped and its nodes in Morton order, f32, the
   benchmark's unstructured StepConfig, 5 steps: set-up seconds (plans,
   frozen preconditioners), the first run, then the mean of 3 runs.  Every
   step must converge and bell_bmv must launch; prints its launches by
   shape and the share of the bound weighted by them (with [5]'s times),
   Newton and CG counts, peak memory, the profiler breakdown and the device's idle
   share, and rel-L2 of the final c and u against the port's plain f64
   path on the card with tight tolerances (<= 1e-4).
7. The adjoint: ``examples.adjoint_problem`` (the benchmark's adjoint
   cell: D_WM and rho_WM, targets from a forward run, 5 steps) on the
   sims of [3] and [6], one ``InverseProblem.value_and_grad`` after
   another.  Per lane: the first call, value_and_grad/s (the mean of 3
   calls), the forward and backward time of one call split by a CUDA
   event at the backward's start, the adjoint CG iterations, each
   kernel's launches in that call by forward and backward (every kernel
   of the lane must launch in the backward), peak memory, the profiler's
   breakdown and idle share, and the device time of the plain-torch VJP
   passes (dW outer products, dx = sum_m A y_bar, the assembly
   backward).  J and the f32 gradient are held against the port's plain
   f64 path on the card (the f64 models of [3] and [6]) with the f64
   default tolerances and the same targets: rel error of J <= 1e-4
   (lattice) and 5e-4 (unstructured), rel-L2 of the gradient <= 1e-3
   (lattice) and 1e-2 (unstructured); on the lattice one directional
   central difference of the f64 objective against its gradient, rel <=
   1e-5.  Each lane ends with its seconds by stage.

8. The 2D models (``examples.rect_sim`` and the two 2D inverse problems).
   Every kernel of the 2D lattice lane against its plain version and
   timed as in [2], at the 50 x 50 rectangle's shapes (2,601 nodes, 7
   offsets; stencil_apply <1,1>, <2,2>, <2,1>, <1,1,3>, stencil_pcg<1>
   and stencil_pcg<2>, the latter in every mode that fits and on 16 and 4
   blocks).  The 50 x 50 uniform (5 steps) and subdomains (10 steps)
   paths as in [3]: every step converges, every kernel launches, final c
   and u within rel-L2 5e-5 of the plain f64 path on the card, steps/s,
   Newton and CG counts and the idle share.  The 512 x 512 rectangle
   (263,169 nodes), 2 steps, as in [4]: stencil_pcg<2> runs streamed in
   the path, and every kernel is held and timed at its shapes (a solve of
   1,000 iterations or more to |Δiters| <= 20% of the plain count:
   PCG_DITERS_SHARE says why).  Then one
   value_and_grad of ``rect_adjoint_problem(50)`` (the lattice lane,
   limits and central difference as in [7]) and of ``atlas2d_problem()``
   (the reduced atlas slice on the unstructured lane, the unstructured
   limits), as in [7]; bell_bmv is held against its plain version and
   timed at the atlas's five shapes first, as in [5], and its launches in
   the value_and_grad weight them as in [6].  The 50 x 50 paths and both
   2D inverse problems take the models' f32 default step, which refines
   in f64: their forwards measure f64 gather residuals, so stencil_apply
   launches in the value_and_grad's backward (the 50 x 50 rows' launches
   come from there) and the forwards launch the two solves.
9. The reference's defaults on the flagship path, on [3]'s and [6]'s
   models.  [9a] REFINED_STEP_CONFIG (f32 solves, f64 residuals, one
   correction solve of the elasticity block a step) on the N=32 lattice
   and the n=32 unstructured box, 5 steps: every step converges with one
   correction solve, the solves' kernels launch, steps/s, device busy and
   idle share; final c and u below the lane's unrefined error in [3] /
   [6] and within rel-L2 1e-5 of the f64 plain path (the unstructured
   lane: in a second run at newton_atol 1e-7, REFINED_NEWTON_ATOL says
   why); then one
   value_and_grad a lane of [7]'s problem with refine_f64 on, J within
   1e-4 of the f64 J on both lanes and the gradient within [7]'s limits.
   [9b] the factored planes (the default: per-class channel stacks
   reduced per simulate) against the dense assembly (the same aux without
   the stacks), max rel 1e-5, with the assembly's device time and steps/s
   both ways.  [9c] the default bf16 coarse factors against f32 ones
   built from the same coarse matrices: CG iterations, the coarse
   products' device time in a profiled run (its aten::mm / aten::mv calls
   on the factors' shapes) and its matrix-product kernels, steps/s and
   idle share, final state within [6]'s limit.

10. The quad (P2-concentration) brain model on the n=32 Morton box, the
   benchmark's quad flagship (274,625 P2 dofs on a P2 supernode plan of
   nb=4,352, s=64, flat halo).  Set-up seconds by part (the P2 dof
   layout, the P2 plan, the factored P2 cache, ``_McSNP2``, the P1 plan,
   the coarse level) and the peak memory of the frozen state.  [10a]
   bell_bmv against its plain version at the P2 shapes, the rd constant
   plane (4352, 64, Kh) and the supernode Jacobi (4352, 64, 64), max rel
   1e-5, timed as in [5].  [10b] the
   forward, f32, the benchmark's unstructured StepConfig, 5 steps, as in
   [6]: every step converges, bell_bmv launches at the P2 shapes (its
   launches by shape and the share of the bound weighted by them),
   steps/s, the profiler breakdown and idle share; the final c and u
   within rel-L2 1e-4 of the plain f64 path on the card (where the
   operating point leaves more, the same run at newton_atol 1e-7 is held
   to it, as [9a] does).  [10c] the f32 default step (refine_f64) on the
   same model, 5 steps: one correction solve a step, steps/s and idle
   share; its final state below [10b]'s error, or, where newton_atol
   1e-5 stops Newton first, the same run at newton_atol 1e-7 below it
   and within 1e-5.  [10d] one value_and_grad of ``adjoint_problem`` on
   the quad model as in [7] (J within 5e-4 and the gradient within 1e-2
   of the plain f64 path), bell_bmv launching at the P2 shapes in the
   backward.

Then one JSON line with [10]'s numbers, one with [9]'s, one with [7]'s
and [8]'s value_and_grad numbers, one with
every kernel's numbers (each with its launches in the path and in one
value_and_grad by forward and backward: [7]'s for the 3D rows, [8]'s for
the 50 x 50 rows; bell_bmv's also at the P2 shapes with its launches in
[10b] and [10d]), the card's line, and as the last line {"ok": true,
"device": {...}}.  Any failure raises (exit code != 0).  Needs CUDA:
without it the script exits non-zero and prints no result.
"""

import json
import os
import re
import subprocess
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))

N = 32
N64 = 64
N_STEPS = 5
N64_STEPS = 2
APPLY_RTOL = 1e-5
# the CSR yardstick sums in cuSPARSE's order, with the planes of the rd
# residual's terms added into one matrix first: it must compute the same
# function, to f32 rounding
CSR_RTOL = 1e-4
# written between launches for L2-cold times: five times the H100's 50 MB L2
FLUSH_BYTES = 256 << 20
PCG_RTOL = 1e-4
PCG_DITERS = 3
# past some thousand iterations two f32 CG recurrences that sum in other
# orders drift apart, so the stop at rtol 1e-7 lands at other iterations:
# the 512 x 512 elasticity solve took 2,325 iterations in the kernel and
# 2,653 in the plain version, with x within 2.7e-5 (an NVIDIA H100).  The
# limit on |Δiters| of such a long solve is this share of the plain
# count; where they differ by more than PCG_DITERS the same solve
# in f64 is run and its count printed beside them.  Solves of fewer plain
# iterations than PCG_LONG keep PCG_DITERS.
PCG_DITERS_SHARE = 0.2
PCG_LONG = 1000
SLICE_RTOL = 5e-5
UNSTRUCT_RTOL = 1e-4
BMV_RTOL = 1e-5
# J's limit on the unstructured lane sits above the lattice's: its
# operating point (newton_rtol 1e-4, the chord method, rd forcing 1e-3)
# leaves c at ~6e-5 of the f64 state, and the threshold's slope (50 at
# the front) carries that into J at 1.5-1.9e-4 (n=6 to 32)
ADJ_J_RTOL = {"lattice": 1e-4, "unstructured": 5e-4}
ADJ_G_RTOL = {"lattice": 1e-3, "unstructured": 1e-2}
ADJ_FD_RTOL = 1e-5
ADJ_FD_EPS = 1e-5
ADJ_FD_DIR = (0.6, 0.8)
# [8]: the 2D models.  The 512 x 512 rectangle is the lattice of a 512^2
# image slice and the first past stencil_pcg<2>'s resident layout on 132
# SMs; its elasticity CG takes 2,664 and 2,886 iterations in the first two
# steps (f32 plain path on the CPU), so the benchmark's limit of 800 is
# raised for it.  The 2D adjoint has 3 parameters: a unit direction in R^3.
N2D = 50
N2D_BIG = 512
N2D_BIG_STEPS = 2
N2D_BIG_CG_MAXITER = 6000
ADJ_FD_DIR_2D = (0.48, 0.6, 0.64)
# torch.cuda._sleep's kernel, which opens a profiled window: not a kernel
# of the call timed in it
SLEEP_KERNEL = r"sleep|spin_kernel"
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


def _profile(torch, fn, cpu=True):
    """Run fn() once under torch.profiler (CPU + CUDA activity, or CUDA
    alone: the CPU events of a run of many torch ops take the profiler
    seconds to process)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    with profile(activities=activities) as prof:
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


def _device_ms(torch, fn, reps, pattern):
    """(device ms of one call of fn(), its source): the profiler's kernel
    time where it records one, else CUDA events around single calls."""
    ms = _kernel_device_ms(torch, fn, reps, pattern)
    if ms is not None:
        return ms, "profiler"
    return _launch_ms(torch, fn, reps), "CUDA events"


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


def _launch_ms(torch, fn, reps, prep=None):
    """Mean device time in ms of single calls of fn(), each bracketed by
    CUDA events right around it.  A sleep kernel holds the stream first
    (``prep()``, where given, ends with one), so the host's work inside
    fn() before its launch overlaps the sleep and is not counted."""
    fn()
    total = 0.0
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if prep is None:
            torch.cuda._sleep(4_000_000)
        else:
            prep()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def _cold_l2(torch, dev):
    """prep() for L2-cold timing: write FLUSH_BYTES (five times the L2; an
    in-place add, a kernel no timed call launches), read half as many of
    another tensor, so the L2 holds clean lines of neither input and a
    timed kernel pays no write-back of the flush's dirty lines, then hold
    the stream with a sleep kernel."""
    dirty = torch.zeros(FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    clean = torch.ones(FLUSH_BYTES // 8, dtype=torch.float32, device=dev)

    def prep():
        dirty.add_(1.0)
        clean.sum()
        torch.cuda._sleep(1_000_000)
    return prep


def _device_records(torch, run):
    """The profiler's device records of run(), in the order the device ran
    them.  A 1 ms sleep kernel opens the window: on this card the profiler
    drops the first records of a window now and then."""
    from torch.autograd import DeviceType

    def settled():
        torch.cuda._sleep(2_000_000)
        run()
    prof = _profile(torch, settled)
    return sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                  key=lambda e: e.time_range.start)


def _cold_device_ms(torch, fn, reps, prep, tries=3):
    """(mean device time in ms of one call of fn() after prep(), or None;
    why not), from the profiler: the kernels fn() launches and how often
    (a profile of ``reps`` calls alone), each kernel's mean duration over
    ``reps`` calls after prep(), summed.  Means of each kernel's records
    do not care for a dropped record; a window that lost every record of a
    kernel it needs (the flush's, the call's) is profiled again, up to
    ``tries`` times."""
    from collections import Counter

    def window(run, ok):
        for _ in range(tries):
            recs = _device_records(torch, run)
            if ok(recs):
                break
        return recs

    prep_names = {r.name for r in window(lambda: [prep() for _ in range(3)], bool)}
    if not prep_names:
        return None, "no records of the flush"

    def kernels(recs):  # of fn(), not the flush's or the window's opening sleep
        calls = Counter(r.name for r in recs)
        return {name: round(c / reps) for name, c in calls.items()
                if name not in prep_names and round(c / reps) > 0}
    mix = kernels(window(lambda: [fn() for _ in range(reps)], kernels))
    if not mix:
        return None, "no kernels of the call"
    recs = window(lambda: [(prep(), fn()) for _ in range(reps)],
                  lambda recs: set(mix) <= {r.name for r in recs})
    durations = {}
    for r in recs:
        if r.name in mix:
            durations.setdefault(r.name, []).append(r.time_range.elapsed_us())
    if set(durations) != set(mix):
        return None, f"no cold records of {sorted(set(mix) - set(durations))}"
    return sum(mix[k] * sum(d) / len(d) for k, d in durations.items()) / 1e3, ""


def _csr(torch, offsets, terms, n, d_out, d_in, n_cols):
    """The operator sum_k s_k A_k of stencil planes as one torch sparse CSR
    matrix (int32 indices, exact zeros dropped): term (W, s, col0) with W
    (n_off, d_out, d_in, n) puts s W[o, a, b, i] at row i d_out + a, column
    col0 + ((i + off_o) mod n) d_in + b.  A yardstick only: the port never
    calls it."""
    rows, cols, vals = [], [], []
    i = torch.arange(n, device=terms[0][0].device)
    for W, s, col0 in terms:
        for o, off in enumerate(offsets):
            j = (i + off) % n
            for a in range(d_out):
                for b in range(d_in):
                    w = W[o, a, b]
                    keep = w != 0
                    rows.append((i * d_out + a)[keep])
                    cols.append((col0 + j * d_in + b)[keep])
                    vals.append((s * w)[keep])
    with warnings.catch_warnings():  # torch's note that sparse CSR is beta
        warnings.simplefilter("ignore", UserWarning)
        coo = torch.sparse_coo_tensor(
            torch.stack([torch.cat(rows), torch.cat(cols)]), torch.cat(vals),
            (n * d_out, n_cols), check_invariants=False).coalesce()
        csr = coo.to_sparse_csr()
        return torch.sparse_csr_tensor(
            csr.crow_indices().int(), csr.col_indices().int(), csr.values(),
            csr.shape, check_invariants=False)


def _cold_ms(torch, fn, prep):
    """(L2-cold device ms of fn(), its source, the same by CUDA events
    right around single calls): the profiler's records
    (``_cold_device_ms``), else the events, which count the launch too."""
    events = _launch_ms(torch, fn, 30, prep)
    ms, why = _cold_device_ms(torch, fn, 20, prep)
    if ms is not None:
        return ms, "profiler", events
    return events, f"CUDA events; the profiler's records: {why}", events


def _apply_row(torch, name, kern, plain, args, lib_fn, lib_shape, wrappers,
               pattern, nbytes, flops, replaces, tag, cold):
    """One stencil_apply form against its plain version (max rel <=
    APPLY_RTOL) and its times: L2-cold and warm device time, the wrapper
    call, the plain version and the CSR matvec (cold and warm)."""
    got = kern(*args)
    want = plain(*args)
    lib = lib_fn().reshape(lib_shape)
    torch.cuda.synchronize()
    err, rel = _rel_max(got, want)
    if not bool(torch.isfinite(got).all()) or rel > APPLY_RTOL:
        raise AssertionError(f"{name}: rel err {rel:.3e} > {APPLY_RTOL}")
    _, lib_rel = _rel_max(lib, want)
    if lib_rel > CSR_RTOL:
        raise AssertionError(f"{name}: the CSR yardstick is off by {lib_rel:.3e}")
    call_ms = _time_ms(torch, lambda: kern(*args), 50)
    cold_ms, cold_src, cold_ev = _cold_ms(torch, lambda: kern(*args), cold)
    warm_ms, warm_src = _device_ms(torch, lambda: kern(*args), 20, pattern)
    plain_ms = _time_ms(torch, lambda: plain(*args), 10)
    lib_cold, lib_src, lib_cold_ev = _cold_ms(torch, lib_fn, cold)
    lib_warm = _launch_ms(torch, lib_fn, 30)
    bound_ms, bound_by = _bound(nbytes, flops)
    print(f"{tag} {name}: max abs err {err:.3e}, max rel err {rel:.3e} (<= "
          f"{APPLY_RTOL}); device L2-cold {cold_ms:.5f} ms ({cold_src}; CUDA events "
          f"around single launches {cold_ev:.5f}), warm {warm_ms:.5f} ms "
          f"({warm_src}); wrapper call {call_ms:.5f} ms; plain {plain_ms:.4f} ms; "
          f"bound {bound_ms:.5f} ms ({bound_by}) = {100 * bound_ms / cold_ms:.1f}% "
          f"of the cold time; torch.sparse CSR (int32) {lib_cold:.5f} ms cold "
          f"({lib_src}; events {lib_cold_ev:.5f}), {lib_warm:.5f} ms warm (events) = "
          f"{lib_cold / cold_ms:.2f}x the kernel's cold time")
    return dict(name=name, route="cuda", source=STENCIL_SRC, replaces=replaces,
                wrappers=wrappers, pattern=pattern, max_abs_err=err, ms=cold_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=lib_cold, cold_events_ms=cold_ev, call_ms=call_ms,
                warm_ms=warm_ms, library_cold_events_ms=lib_cold_ev,
                library_warm_ms=lib_warm)


def _wrapper_host_us(torch, offs, W, v, reps=400, rounds=5):
    """Host microseconds a call of each step of apply_scalar's launch path
    and of the whole wrapper: the least over ``rounds`` rounds of ``reps``
    calls by perf_counter (the host's neighbours make single rounds
    spread; the launches queue on the device, which keeps up)."""
    from glimslib_tpu_torch import _build
    from glimslib_tpu_torch.ops import stencil_kernels as sk

    n, dev = W.shape[-1], W.device
    y = torch.empty(n, dtype=torch.float32, device=dev)
    entry = sk._entry("glims_stencil_apply")
    pack = _build.pack_offsets(offs, n)[1]
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    ptrs = (W.data_ptr(), v.data_ptr(), y.data_ptr())
    parts = {
        "grad check": lambda: sk._needs_grad(W, v),
        "two tensor checks": lambda: (sk._check("W", W, (len(offs), n), dev),
                                      sk._check("v", v, (n,), dev)),
        "torch.empty_like": lambda: torch.empty_like(v),
        "pack_offsets": lambda: _build.pack_offsets(offs, n),
        "raw stream": lambda: torch._C._cuda_getCurrentRawStream(dev.index),
        "C entry (launch)": lambda: entry(1, 1, *ptrs, n, pack, stream),
        "launch path without the grad check": lambda: sk._scalar_raw(offs, W, v),
        "whole wrapper": lambda: sk.apply_scalar(offs, W, v),
    }
    us = {}
    for name, fn in parts.items():
        fn()
        best = float("inf")
        for _ in range(rounds):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            best = min(best, time.perf_counter() - t0)
        us[name] = best / reps * 1e6
        torch.cuda.synchronize()
    return us


def phase_applies(torch, offs, theta, wc, dev, tag, suffix=""):
    """Every stencil_apply form at one lattice's shapes (the path's planes,
    random vectors from a seed): K1 and K2 against their plain versions
    and the CSR matvec, then the rd residual in one launch against the
    three launches it replaces, both timed as the path calls them."""
    import numpy as np

    from glimslib_tpu_torch.ops import stencil_kernels as sk

    n, d = theta["_Wel"].shape[-1], theta["_Wel"].shape[1]
    rng = np.random.default_rng(0)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    v = f32(rng.standard_normal(n))
    v2 = f32(rng.standard_normal(n))
    u = f32(rng.standard_normal((n, d)))
    cold = _cold_l2(torch, dev)
    k1 = "glimslib_tpu/ops/stencil_pallas.py:108"
    k2 = "glimslib_tpu/ops/stencil_pallas.py:151"
    rows = []
    for name, kern, plain, W, x, d_out, d_in, replaces, wrappers in (
        ("stencil_apply<1,1>", sk.apply_scalar, sk.apply_scalar_plain,
         theta["_Wrd_const"], v, 1, 1, k1, (sk.apply_scalar, sk.apply_scalar_sum)),
        (f"stencil_apply<{d},{d}>", sk.apply_vector, sk.apply_vector_plain,
         theta["_Wel"], u, d, d, k2, (sk.apply_vector,)),
        (f"stencil_apply<{d},1>", sk.apply_coupling, sk.apply_coupling_plain,
         theta["_Cuc"], v, d, 1, k2, (sk.apply_coupling,)),
    ):
        W4 = W.reshape(len(offs), d_out, d_in, n)
        A = _csr(torch, offs, [(W4, 1.0, 0)], n, d_out, d_in, n * d_in)
        xf = x.reshape(-1)
        rows.append(_apply_row(
            torch, name + suffix, kern, plain, (offs, W, x),
            lambda A=A, xf=xf: torch.mv(A, xf), (n, d_out) if d_out > 1 else (n,),
            wrappers, rf"stencil_apply_kernel<{d_out}, ?{d_in}, ?1>",
            4 * (W.numel() + x.numel() + n * d_out), 2 * W.numel(), replaces,
            tag, cold))
        del A
    host = _wrapper_host_us(torch, offs, theta["_Wrd_const"], v)
    print(f"{tag} apply_scalar host cost a call, us (perf_counter, the least "
          "of 5 rounds of 400 calls): "
          + ", ".join(f"{k} {us:.2f}" for k, us in host.items()))
    rows[0]["host_us"] = host

    # the lattice rd residual: W_const c + wc c / 2 - M c_prev - load
    Wc, M, load = theta["_Wrd_const"], theta["_Mst"], theta["_rd_load"]
    terms = ((Wc, v, 1.0), (wc, v, 0.5), (M, v2, -1.0))
    A = _csr(torch, offs, [(Wc[:, None, None], 1.0, 0), (wc[:, None, None], 0.5, 0),
                           (M[:, None, None], -1.0, n)], n, 1, 1, 2 * n)
    x2 = torch.cat([v, v2])
    row = _apply_row(
        torch, "stencil_apply<1,1,3>" + suffix, sk.apply_scalar_sum,
        sk.apply_scalar_sum_plain, (offs, terms, load),
        lambda: torch.addmv(load, A, x2, beta=-1.0), (n,), (sk.apply_scalar_sum,),
        r"stencil_apply_kernel<1, ?1, ?3>", 4 * (3 * Wc.numel() + 4 * n),
        6 * Wc.numel() + 4 * n, k1, tag, cold)
    del A

    def three():
        return (sk.apply_scalar(offs, Wc, v) + 0.5 * sk.apply_scalar(offs, wc, v)
                - sk.apply_scalar(offs, M, v2) - load)

    def one():
        return sk.apply_scalar_sum(offs, terms, load)

    err, rel = _rel_max(one(), three())
    ab = {"3 launches": [], "1 launch": []}
    for label in ("3 launches", "1 launch", "1 launch", "3 launches"):
        fn = three if label == "3 launches" else one
        cold_ms, cold_src, cold_ev = _cold_ms(torch, fn, cold)
        ab[label].append((_time_ms(torch, fn, 50), cold_ms, cold_ev))
        if cold_src != "profiler":
            print(f"{tag} rd residual, {label}: L2-cold time from {cold_src}")
    print(f"{tag} rd residual, in-path A/B (turns 3, 1, 1, 3; ms: wrapper "
          "calls back to back / L2-cold device time of its kernels (profiler) / "
          "the same by CUDA events around the call): " + "; ".join(
              f"{k} " + ", ".join(f"{c:.5f} / {d:.5f} / {e:.5f}" for c, d, e in v_)
              for k, v_ in ab.items())
          + f"; one launch vs three max rel {rel:.3e}")
    row["ab_ms"] = {k: [list(p) for p in v_] for k, v_ in ab.items()}
    rows.append(row)
    return rows


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
    a = torch.ones((4, 3), dtype=torch.bfloat16, device="cuda")
    try:
        y = torch.mm(a, a.T, out_dtype=torch.float32)
        has = f"yes ({y.dtype}, {float(y[0, 0])})"
    except (TypeError, RuntimeError, NotImplementedError) as e:
        has = f"no ({type(e).__name__}: {e})"
    print(f"[1] torch.mm with out_dtype=float32 on bf16 CUDA operands (the bf16 "
          f"coarse factors' products): {has}")
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


def _pcg_stream_bytes(n_off, d, n):
    """Bytes an iteration if planes, preconditioner and four vector passes
    came from HBM every iteration (the streaming figure)."""
    return 4 * (n_off * d * d * n + d * d * n + 4 * n * d)


def phase_kernels(torch, sim, theta, dev, tag="[2]", suffix="", grids=()):
    """Each lattice kernel vs its plain version at the model's shapes (the
    path's planes, random vectors from a seed); the elasticity solve also
    in every other mode that fits, and on the plan's mode with ``grids``
    blocks (printed only)."""
    import numpy as np

    from glimslib_tpu_torch.ops import fused_cg as fc

    ops = sim._stencil_ops
    offs = ops.offsets
    n, d = sim.mesh.n_nodes, sim.mesh.dim
    mask_u, mask_c, _, _ = sim._bc_masks_and_values()
    c0 = sim.initial_state()[1]
    wc = ops.build_rd_wc(c0, theta["rho"], theta["dt"])
    results = phase_applies(torch, offs, theta, wc, dev, tag, suffix)

    rng = np.random.default_rng(0)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    v = f32(rng.standard_normal(n))
    u = f32(rng.standard_normal((n, d)))
    cfg = sim.step_config
    Wrd = theta["_Wrd_const"] + wc
    solves = [
        ("stencil_pcg<1>", fc.cg_scalar, fc.cg_scalar_plain,
         fc.fold_mask_scalar(offs, Wrd, mask_c), theta["_invdM"],
         torch.where(mask_c, 0.0, v), "glimslib_tpu/ops/pallas_cg.py:204"),
        (f"stencil_pcg<{d}>", fc.cg_vector, fc.cg_vector_plain,
         theta["_WelM"], theta["_BinvM"], torch.where(mask_u, 0.0, u),
         "glimslib_tpu/ops/pallas_cg.py:315"),
    ]
    for name, kern, plain, Wm, Minv, b, replaces in solves:
        row = _check_pcg(torch, name, kern, plain, offs, Wm, Minv, b, cfg,
                         replaces, tag)
        row["name"] += suffix
        results.append(row)
    name, kern, plain, Wm, Minv, b, replaces = solves[1]
    chosen = results[-1]["mode"]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for mode in fc.MODES:
        try:
            fc.launch_plan(n, d, len(offs), sms, mode)
        except ValueError:
            continue
        if mode != chosen:
            _check_pcg(torch, name, kern, plain, offs, Wm, Minv, b, cfg, replaces,
                       f"{tag} (forced {mode})", mode=mode)
    for blocks in grids:
        _check_pcg(torch, name, kern, plain, offs, Wm, Minv, b, cfg, replaces,
                   f"{tag} ({blocks} blocks)", blocks=blocks)
    return results


def _check_pcg(torch, name, kern, plain, offs, Wm, Minv, b, cfg, replaces, tag,
               mode=None, blocks=None):
    """One whole solve of the kernel against the plain pcg, and its times:
    through the wrapper ``kern`` as the path calls it, or with ``mode``
    forcing the launch plan's mode or ``blocks`` its grid."""
    from glimslib_tpu_torch.ops import fused_cg as fc

    args = (offs, Wm, Minv, b, cfg.cg_rtol, cfg.cg_atol, cfg.cg_maxiter)
    d = b.shape[1] if b.dim() > 1 else 1
    if mode is None and blocks is None:
        def call():
            x, info = kern(*args)
            return x, info, kern.last_plan
    else:
        W4 = Wm if d > 1 else Wm[:, None, None, :]

        def call():
            return fc._pcg_cuda(d, offs, W4, Minv, b, *args[4:], mode, blocks)
    x_k, info_k, plan = call()
    x_p, info_p = plain(*args)
    torch.cuda.synchronize()
    it_k, it_p = int(info_k["iters"]), int(info_p["iters"])
    err, rel = _rel_max(x_k, x_p)
    dit_max = PCG_DITERS if it_p < PCG_LONG else int(PCG_DITERS_SHARE * it_p)
    if (not bool(torch.isfinite(x_k).all()) or abs(it_k - it_p) > dit_max
            or rel > PCG_RTOL):
        raise AssertionError(f"{name}: iters {it_k} vs {it_p}, rel err {rel:.3e}")
    f64_iters = ""
    if abs(it_k - it_p) > PCG_DITERS:
        _, info64 = plain(*(a.double() if torch.is_tensor(a) else a for a in args))
        f64_iters = f"; the same solve in f64 (plain) takes {int(info64['iters'])}"
    ms = _time_ms(torch, call, 3)
    dev_ms = _launch_ms(torch, call, 3)
    prof_ms = _kernel_device_ms(torch, call, 2,
                                rf"stencil_pcg_kernel<{d}, ?{fc.MODES[plan.mode]}>")
    plain_ms = _host_ms(torch, lambda: plain(*args))
    n_off, n = Wm.shape[0], b.shape[0]
    bound_ms, bound_by = _bound(*_pcg_work(n_off, d, n, it_k))
    stream_it = _pcg_stream_bytes(n_off, d, n)
    stream_ms = stream_it * it_k / HBM_BPS * 1e3
    us_it = 1e3 * dev_ms / max(it_k, 1)
    print(f"{tag} {name}: n={n}, mode {plan.mode} ({plan.blocks} blocks of "
          f"{plan.nloc} nodes, {plan.stages} stage(s), {plan.smem_bytes} B of "
          f"shared memory a block), iters kernel {it_k} / plain {it_p} "
          f"(|Δ| <= {dit_max}{f64_iters}), resnorm {float(info_k['resnorm']):.3e} / "
          f"{float(info_p['resnorm']):.3e}, max abs err {err:.3e}, max rel "
          f"err {rel:.3e} (<= {PCG_RTOL})")
    print(f"{tag} {name}: kernel on device {dev_ms:.4f} ms (CUDA events, "
          "single launches"
          + ("" if prof_ms is None else f"; profiler {prof_ms:.4f} ms")
          + f") = {us_it:.2f} us an "
          f"iteration; wrapper call {ms:.4f} ms; plain {plain_ms:.4f} ms (host "
          f"clock, syncs every iteration); bound {bound_ms:.4f} ms ({bound_by}) "
          f"= {100 * bound_ms / dev_ms:.1f}% of the device time; streaming "
          f"figure {stream_it / 1e6:.1f} MB = {1e3 * stream_ms / max(it_k, 1):.2f} "
          f"us an iteration at 3.35 TB/s = {100 * stream_ms / dev_ms:.1f}% of it")
    return dict(name=name, route="cuda", source=STENCIL_SRC, replaces=replaces,
                wrappers=(kern,), max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                device_ms=dev_ms, profiler_ms=prof_ms, mode=plan.mode,
                us_per_iter=us_it, iters=it_k)


def _print_breakdown(torch, run, run_ms, tag, detail=None):
    """Device time by kernel over one profiled simulate, and the device's
    busy share: of the profiled run's wall time (the profiler adds host
    overhead) and of ``run_ms``, the unprofiled run's mean wall time.
    Kernels whose name matches ``detail`` are printed too, with their time
    a launch; returns ({name: ms a launch} for them, the device busy ms,
    the idle share of the unprofiled run)."""
    from torch.autograd import DeviceType

    t0 = time.perf_counter()
    prof = _profile(torch, run, cpu=False)
    wall_ms = (time.perf_counter() - t0) * 1e3
    evts = [e for e in prof.key_averages()
            if getattr(e, "device_type", None) == DeviceType.CUDA]
    evts.sort(key=_self_device_us, reverse=True)
    busy_ms = sum(_self_device_us(e) for e in evts) / 1e3
    if busy_ms <= 0:
        print(f"{tag} device time breakdown: none (the profiler recorded "
              "no device time)")
        return {}, None, None
    print(f"{tag} profiled run: device busy {busy_ms:.3f} ms = "
          f"{100 * busy_ms / wall_ms:.1f}% of its wall {wall_ms:.2f} ms; "
          f"{100 * busy_ms / run_ms:.1f}% of the unprofiled run's "
          f"{run_ms:.2f} ms, so the device idles "
          f"{100 * max(0.0, 1 - busy_ms / run_ms):.1f}% of it")
    per_launch = {}
    for k, e in enumerate(evts):
        us = _self_device_us(e)
        hit = detail is not None and re.search(detail, e.key)
        if k < 10 or hit:
            print(f"{tag}   {100 * us / 1e3 / busy_ms:5.1f}%  {us / 1e3:8.3f} ms  "
                  f"x{e.count:<6d} {e.key[:90]}"
                  + (f"  ({us / max(e.count, 1):.2f} us a launch)" if hit else ""))
        if hit:
            per_launch[e.key] = us / max(e.count, 1) / 1e3
    return per_launch, busy_ms, max(0.0, 1 - busy_ms / run_ms)


def _drive(torch, sim, simulate, args, groups, tag, n_steps, shown=()):
    """One run of the path with every count set to 0 just before it:
    returns the trajectory, the launches by wrapper and the seconds.
    ``groups`` holds one tuple of wrappers a kernel (the wrappers that
    launch it); each kernel must launch at least once.  ``shown``:
    wrappers whose launches are counted and printed too, without that
    demand."""
    wrappers = list(dict.fromkeys([w for g in groups for w in g] + list(shown)))
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
    fix_iters = [int(i) for i in sim.solver_info["el_refine_cg_iters"]]
    print(f"{tag} {sim.mesh.n_nodes} nodes, {sim.mesh.n_cells} cells; first run "
          f"{first_s:.3f} s")
    print(f"{tag} converged per step {ok.tolist()}; Newton iterations per step "
          f"{newton.tolist()}; rd CG iterations per Newton solve {rd_iters}; "
          f"elasticity CG iterations per step {el_iters}"
          + (f"; refinement correction solves (CG iterations) {fix_iters}"
             if fix_iters else ""))
    print(f"{tag} launches in that run: " + ", ".join(
        f"{w.__name__}={n}" for w, n in launches.items()))
    if not bool(ok.all()):
        raise AssertionError(f"{tag} a step did not converge")
    missing = [[w.__name__ for w in g] for g in groups
               if sum(launches[w] for w in g) < 1]
    if missing:
        raise AssertionError(f"{tag} kernels not launched on the path: {missing}")
    if not (bool(torch.isfinite(u_tr).all()) and bool(torch.isfinite(c_tr).all())):
        raise AssertionError(f"{tag} non-finite state")
    assert tuple(u_tr.shape) == (n_steps, sim.mesh.n_nodes, sim.mesh.dim)
    assert tuple(c_tr.shape) == (n_steps,) + tuple(args[2].shape)
    return (u_tr, c_tr), launches, first_s


def _time_runs(torch, simulate, args, dev, tag, n_steps, detail=None):
    """Steps/s over 3 runs, peak memory, and the breakdown of one profiled
    run; returns its ms a launch of the kernels matching ``detail``, and
    {steps_per_s, device_busy_ms, idle_share}."""
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
    per_launch, busy, idle = _print_breakdown(
        torch, lambda: simulate(*args), 1e3 * sum(times) / len(times), tag, detail)
    return per_launch, dict(steps_per_s=sps, device_busy_ms=busy, idle_share=idle)


def _set_launches(rows, launches, run=""):
    """Each row's launches on the path (``launches`` + ``run``): the sum
    over the wrappers that launch its kernel (K1's kernel is launched by
    apply_scalar and, as the rd residual, by apply_scalar_sum), with the
    split where there are two."""
    for k in rows:
        k["launches" + run] = sum(launches[w] for w in k["wrappers"])
        if len(k["wrappers"]) > 1:
            k["launches_by_wrapper" + run] = {
                w.__name__: launches[w] for w in k["wrappers"]}


def _forward_groups(sim, groups):
    """The kernels a lattice forward launches: all of ``groups``, or under
    refine_f64 those of the solves alone (Newton and the elasticity
    solve measure the f64 gather residuals, so the working residuals'
    stencil_apply runs only in a backward)."""
    from glimslib_tpu_torch.ops import stencil_kernels as sk

    if not sim.step_config.refine_f64:
        return groups
    applies = {sk.apply_scalar, sk.apply_scalar_sum, sk.apply_vector, sk.apply_coupling}
    return [g for g in groups if not set(g) <= applies]


def phase_slice(torch, sim, ref, dev, kernels, tag, n_steps, run=""):
    """A lattice path (``sim``, f32) through the kernels of ``kernels``
    (those a refined forward runs, where the model refines): one run with
    the counts at 0, 3 timed runs and a profiled one, then the final c and
    u against ``ref``, the same model on the plain path at f64 with tight
    tolerances; returns ``ref`` at its default tolerances, its final
    (u, c) and the f32 path's rel-L2 errors (c, u)."""
    from glimslib_tpu_torch.solvers.coupled import StepConfig

    theta = sim.make_theta(sim.params.as_dict())
    u0, c0 = sim.initial_state()
    simulate = sim.build_simulate_fn(n_steps, 1.0)
    groups = [k["wrappers"] for k in kernels]
    (u_tr, c_tr), launches, _ = _drive(
        torch, sim, simulate, (theta, u0, c0), _forward_groups(sim, groups),
        tag, n_steps, shown=[w for g in groups for w in g])
    _set_launches(kernels, launches, run)
    in_path, _ = _time_runs(torch, simulate, (theta, u0, c0), dev, tag, n_steps,
                            r"stencil_apply_kernel")
    for k in kernels:
        if "pattern" in k:
            k["in_path_ms" + run] = next((ms for key, ms in in_path.items()
                                          if re.search(k["pattern"], key)), None)

    f64_defaults = ref.step_config
    ref.step_config = StepConfig(newton_rtol=1e-10, newton_atol=1e-14,
                                 cg_rtol=1e-12, cg_maxiter=4000)
    t0 = time.perf_counter()
    u_r, c_r, ok_r, newton_r = ref.run()
    torch.cuda.synchronize()
    if not bool(ok_r.all()):
        raise AssertionError("f64 plain reference did not converge")
    rel_c = _rel_l2(c_tr[-1], c_r[-1])
    rel_u = _rel_l2(u_tr[-1], u_r[-1])
    print(f"{tag} f64 plain reference on the card ({time.perf_counter() - t0:.1f} s, "
          f"Newton {newton_r.tolist()}): rel-L2 c {rel_c:.3e}, u {rel_u:.3e} "
          f"(<= {SLICE_RTOL})")
    if rel_c > SLICE_RTOL or rel_u > SLICE_RTOL:
        raise AssertionError(f"{tag} slice vs f64 reference: c {rel_c:.3e}, u {rel_u:.3e}")
    # [7] takes the gradient of the same model at the f64 defaults
    ref.step_config = f64_defaults
    return ref, (u_r[-1], c_r[-1]), (rel_c, rel_u)


def phase_lattice_big(torch, dev, sim, tag, suffix, n_steps):
    """K3c: a lattice path past the resident layout (``sim``, f32; its
    model set-up timed by the caller), its elasticity solve streamed."""
    import numpy as np

    from glimslib_tpu_torch.ops import fused_cg as fc
    from glimslib_tpu_torch.ops import stencil_kernels as sk

    d = sim.mesh.dim
    theta = sim.make_theta(sim.params.as_dict())
    u0, c0 = sim.initial_state()
    simulate = sim.build_simulate_fn(n_steps, 1.0)
    groups = [(sk.apply_scalar, sk.apply_scalar_sum), (sk.apply_vector,),
              (sk.apply_coupling,), (sk.apply_scalar_sum,), (fc.cg_scalar,),
              (fc.cg_vector,)]
    _, launches, _ = _drive(torch, sim, simulate, (theta, u0, c0), groups,
                            f"{tag} {suffix[1:]}:", n_steps)
    path_mode = fc.cg_vector.last_plan.mode
    print(f"{tag} {suffix[1:]}: the path's elasticity solves ran stencil_pcg<{d}> "
          f"{path_mode}")
    if path_mode == "resident":
        raise AssertionError(f"{tag} the elasticity solve ran resident, not streamed")

    aug = sim._augment_theta_with_operators(theta)
    mask_u, mask_c, _, _ = sim._bc_masks_and_values()
    ops = sim._stencil_ops
    wc = ops.build_rd_wc(c0, aug["rho"], aug["dt"])
    applies = phase_applies(torch, ops.offsets, aug, wc, dev, tag, suffix)
    _set_launches(applies, launches)
    # the first step's elasticity system: the rhs of u from rest
    ru = sim.el_residual(torch.where(mask_u, 0.0, u0), c0, aug, 1.0)
    b = torch.where(mask_u, 0.0, -ru).contiguous()
    cfg = sim.step_config
    el = _check_pcg(torch, f"stencil_pcg<{d}>", fc.cg_vector, fc.cg_vector_plain,
                    ops.offsets, aug["_WelM"], aug["_BinvM"], b, cfg,
                    "glimslib_tpu/ops/pallas_cg.py:497", tag)
    el["name"] += suffix
    el["launches"] = launches[fc.cg_vector]
    # the same solve with x, r and Ap in global memory, the layout the plan
    # takes where they do not fit beside two ring stages (printed only)
    _check_pcg(torch, f"stencil_pcg<{d}>", fc.cg_vector, fc.cg_vector_plain,
               ops.offsets, aug["_WelM"], aug["_BinvM"], b, cfg,
               "glimslib_tpu/ops/pallas_cg.py:497", f"{tag} (forced streamed_global)",
               mode="streamed_global")
    # an rd Newton system of the first step, from the initial state
    Wrd = aug["_Wrd_const"] + wc
    v = torch.as_tensor(np.random.default_rng(2).standard_normal(sim.mesh.n_nodes),
                        dtype=torch.float32, device=dev)
    rd = _check_pcg(torch, "stencil_pcg<1>", fc.cg_scalar, fc.cg_scalar_plain,
                    ops.offsets, fc.fold_mask_scalar(ops.offsets, Wrd, mask_c),
                    aug["_invdM"], torch.where(mask_c, 0.0, v), cfg,
                    "glimslib_tpu/ops/pallas_cg.py:204", tag)
    rd["name"] += suffix
    rd["launches"] = launches[fc.cg_scalar]
    return applies + [el, rd]


def _bmv_shapes(torch, usim, theta, dev, tag):
    """bell_bmv vs its plain version at the five shapes an unstructured
    model's tables give it, each timed; returns one record a shape."""
    plan = usim._get_bell_plan()
    nb, s, Kh, d = plan.nb, plan.s, plan.Kh, usim.mesh.dim
    return _bmv_check(torch, [
        ("elasticity operator _BellWel", theta["_BellWel"].reshape(nb, s * d, Kh * d)),
        ("coupling _BellCuc", theta["_BellCuc"].reshape(nb, s * d, Kh)),
        ("elasticity supernode Jacobi _BinvSN", theta["_BinvSN"]),
        ("rd constant planes _BellWrdC", theta["_BellWrdC"]),
        ("rd supernode Jacobi _McSN", theta["_McSN"]),
    ], dev, tag)


def _bmv_check(torch, roles, dev, tag):
    """bell_bmv vs its plain version at each (role, A) of ``roles``, each
    timed as torch.bmm is timed beside it: device time L2-cold
    (``_cold_device_ms``, as [2] times stencil_apply; on the paths a table
    is read after others have evicted it) and warm (``_call_device_ms``),
    each time's source in the record's ``timing``; also prints the wrapper
    call, the plain version, the bound, the share and the launch plan
    (``plan_for``).  The cold time weights the bound in :func:`_bmv_split`.
    Returns one record a shape."""
    import numpy as np

    from glimslib_tpu_torch.ops import bell_kernels as bk

    prep = _cold_l2(torch, dev)
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
        kern = lambda: bk.batched_matvec(A, x)  # noqa: E731
        bmm = lambda: torch.bmm(A, x[:, :, None])  # noqa: E731
        ms = _time_ms(torch, kern, 50)
        t, src = {}, {}
        for who, fn in (("kernel", kern), ("torch.bmm", bmm)):
            cold, why = _cold_device_ms(torch, fn, 10, prep)
            if cold is None:
                cold = _launch_ms(torch, fn, 10, prep)
                why = f"CUDA events around single calls, launch included ({why})"
            warm, warm_src = _call_device_ms(torch, fn, 20)
            t[who] = cold, warm
            src[who] = dict(cold=why or "profiler", warm=warm_src)
        (dev_ms, warm_ms), (lib_ms, lib_warm) = t["kernel"], t["torch.bmm"]
        odd = {w: s for w, s in src.items() if s != dict(cold="profiler", warm="profiler")}
        if odd:
            print(f"{tag} bell_bmv {role}: not every time is the profiler's: {odd}")
        plain_ms = _time_ms(torch, lambda: bk.batched_matvec_plain(A, x), 20)
        bound_ms, bound_by = _bound(4 * (B * M * K + B * K + B * M), 2 * B * M * K)
        share = bound_ms / dev_ms
        plan = bk.plan_for(A)
        print(f"{tag} bell_bmv {role} (B, M, K) = {(B, M, K)}: max abs err "
              f"{err:.3e}, max rel err {rel:.3e} (<= {BMV_RTOL}); device L2-cold "
              f"{dev_ms:.5f} ms, warm {warm_ms:.5f} ms; torch.bmm L2-cold "
              f"{lib_ms:.5f} ms, warm {lib_warm:.5f} ms ({lib_ms / dev_ms:.2f}x the "
              f"kernel's cold time); wrapper call {ms:.4f} ms, plain {plain_ms:.4f} ms; "
              f"bound {bound_ms:.5f} ms ({bound_by}, {4 * B * M * K / 1e6:.1f} MB of "
              f"table) = {100 * share:.1f}% of the cold time; plan R "
              f"{plan.rows_per_span}, {plan.mode}, S {plan.stages}, G {plan.group}, "
              f"blocks {plan.blocks}")
        shapes.append(dict(role=role, shape=[B, M, K], max_abs_err=err, ms=ms,
                           device_ms=dev_ms, warm_device_ms=warm_ms, plain_ms=plain_ms,
                           library_ms=lib_ms, library_warm_ms=lib_warm,
                           bound_ms=bound_ms, bound_by=bound_by,
                           timing=src,
                           plan=dict(R=plan.rows_per_span, mode=plan.mode,
                                     S=plan.stages, G=plan.group, blocks=plan.blocks)))
    return shapes


def phase_bmv(torch, usim, theta, dev):
    """bell_bmv vs its plain version at the flagship's five shapes."""
    from glimslib_tpu_torch.ops import bell_kernels as bk

    shapes = _bmv_shapes(torch, usim, theta, dev, "[5]")
    top = shapes[0]
    return dict(name="bell_bmv", route="cuda", source=BELL_SRC,
                replaces="glimslib_tpu/ops/bell_pallas.py:56", wrappers=(bk.batched_matvec,),
                max_abs_err=max(r["max_abs_err"] for r in shapes),
                ms=top["device_ms"], plain_ms=top["plain_ms"], bound_ms=top["bound_ms"],
                bound_by=top["bound_by"], library_ms=top["library_ms"],
                call_ms=top["ms"],
                also_replaces=["glimslib_tpu/ops/bell_pallas.py:199",
                               "glimslib_tpu/ops/bell_pallas.py:229"],
                shapes=shapes)


def _bmv_split(kern, by_shape, tag="[6]", shapes="shapes", what="run"):
    """bell_bmv's launches on a path by (B, M, K), and the share of the
    bound weighted by them: sum of launches x bound over sum of launches x
    device time, with the times of each shape in ``kern[shapes]``."""
    times = {tuple(r["shape"]): r for r in kern[shapes]}
    timed = {s: c for s, c in by_shape.items() if s in times}
    bound = sum(c * times[s]["bound_ms"] for s, c in timed.items())
    device = sum(c * times[s]["device_ms"] for s, c in timed.items())
    share = bound / device if device > 0 else None
    print(f"{tag} bell_bmv launches in that {what} by (B, M, K): " + ", ".join(
        f"{s}: {c}" for s, c in sorted(by_shape.items(), key=lambda x: -x[1]))
        + (f"; weighted by them, the device time is {device:.3f} ms against a "
           f"bound of {bound:.3f} ms = {100 * share:.1f}% of the bound"
           if share is not None else "")
        + (f" (shapes not timed: {sorted(set(by_shape) - set(timed))})"
           if len(timed) < len(by_shape) else ""))
    return share


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
    bk.batched_matvec.launches_by_shape = {}
    (u_tr, c_tr), launches, _ = _drive(torch, sim, simulate, (theta, u0, c0),
                                       [(bk.batched_matvec,)], f"[6] n={N}:", N_STEPS)
    kern["launches"] = launches[bk.batched_matvec]
    by_shape = dict(bk.batched_matvec.launches_by_shape)
    kern["launches_by_shape"] = {"x".join(map(str, s)): c for s, c in by_shape.items()}
    kern["weighted_bound_share"] = _bmv_split(kern, by_shape)
    iters = {k: [int(i) for i in sim.solver_info[k]] for k in ("rd_cg_iters", "el_cg_iters")}
    _, run = _time_runs(torch, simulate, (theta, u0, c0), dev, "[6]", N_STEPS)

    ref = brain_sim(n=N, dtype=torch.float64, device=dev, plain=True,
                    unstructured=True)
    f64_defaults = ref.step_config
    ref.step_config = StepConfig(newton_rtol=1e-10, newton_atol=1e-14,
                                 cg_rtol=1e-12, cg_maxiter=4000)
    # the frozen coarse factors carry over (a preconditioner changes
    # iteration counts only); the supernode inverses are rebuilt in f64
    ref._aux_cache = {k: v.double() for k, v in aux.items() if k.startswith("_TL")}
    t0 = time.perf_counter()
    u_r, c_r, ok_r, newton_r = ref.build_simulate_fn(N_STEPS, 1.0)(
        ref.make_theta(ref.params.as_dict()), *ref.initial_state())
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
    ref.step_config = f64_defaults
    # what [9] holds its unstructured runs against
    base = dict(ref_traj=(u_r, c_r), rel=(rel_c, rel_u), iters=iters, run=run)
    return kern, sim, ref, base


def _call_device_ms(torch, fn, reps=3, tries=3):
    """(device ms of one call of fn(), its source): from the profiler over
    ``reps`` calls (after one warm-up; the window opened by a sleep kernel,
    which is not counted), each kernel's mean duration times how often a
    call launches it, summed, so a record the profiler drops (it does, in
    a long process) costs a sample, not the number; a window with fewer
    records than calls is profiled again, up to ``tries`` times.  Else
    CUDA events around single calls."""
    fn()
    for _ in range(tries):
        recs = [r for r in _device_records(torch, lambda: [fn() for _ in range(reps)])
                if not re.search(SLEEP_KERNEL, r.name)]
        if len(recs) >= reps:
            break
    if recs:
        us = {}
        for r in recs:
            us.setdefault(r.name, []).append(r.time_range.elapsed_us())
        return sum(max(1, round(len(d) / reps)) * sum(d) / len(d)
                   for d in us.values()) / 1e3, "profiler"
    return _launch_ms(torch, fn, reps), "CUDA events"


def _vjp_passes(torch, sim, c, lattice, tag):
    """Device ms a call of the plain-torch VJP passes the lane's backward
    runs, at the model's shapes (random cotangents from a seed; ``c`` the
    initial concentration): the reference's XLA VJPs, not kernel ports."""
    import numpy as np

    from glimslib_tpu_torch.ops import bell
    from glimslib_tpu_torch.ops import stencil_kernels as sk

    rng = np.random.default_rng(4)
    dev = sim.device
    f32 = lambda *s: torch.as_tensor(rng.standard_normal(s), dtype=torch.float32,  # noqa: E731
                                     device=dev)
    theta = sim.make_theta(sim.params.as_dict())
    n = sim.mesh.n_nodes
    D = theta["D"].detach().clone().requires_grad_()
    rho = theta["rho"].detach().clone().requires_grad_()
    passes = {}
    if lattice:
        ops = sim._stencil_ops
        offs = ops.offsets
        y, v = f32(n), f32(n)
        gW = f32(len(offs), n)
        passes[f"dW = y_bar (x) shifted v, ({len(offs)}, n)"] = lambda: sk.plane_grad(offs, y, v)
        passes["assembly backward: rd constant planes -> D, rho"] = lambda: torch.autograd.grad(
            ops.build_rd_jacobian_const(D, rho, theta["dt"]), (D, rho), gW)
        passes["assembly backward: rd logistic planes wc(c) -> rho"] = lambda: torch.autograd.grad(
            ops.build_rd_wc(c, rho, theta["dt"]), (rho,), gW)
    else:
        plan = sim._get_bell_plan()
        arrays = sim._mesh_arrays()
        nb, s, Kh, d = plan.nb, plan.s, plan.Kh, sim.mesh.dim
        A_c, A_r = f32(nb, d * s, Kh), f32(nb, s, Kh)
        y_c, y_r, x_r = f32(nb, d * s), f32(nb, s), f32(nb, Kh)
        gW = f32(nb, s, Kh)
        passes[f"dA = y_bar x^T, ({nb}, {s}, {Kh})"] = lambda: y_r[:, :, None] * x_r[:, None, :]
        passes[f"dx = sum_m A y_bar, coupling ({nb}, {d * s}, {Kh})"] = lambda: (
            A_c * y_c[:, :, None]).sum(1)
        passes[f"dx = sum_m A y_bar, mass ({nb}, {s}, {Kh})"] = lambda: (
            A_r * y_r[:, :, None]).sum(1)
        passes["assembly backward: rd constant planes -> D, rho"] = lambda: torch.autograd.grad(
            bell.build_bell_rd_const(plan, arrays, D, rho, theta["dt"], sim.kernels._m0),
            (D, rho), gW)
        passes["assembly backward: rd logistic planes wc(c) -> rho"] = lambda: torch.autograd.grad(
            bell.build_bell_rd_wc(plan, arrays, sim.kernels.cells_flat, c, rho,
                                  theta["dt"], sim.kernels._t0, 1.0), (rho,), gW)
    out = {name: _call_device_ms(torch, fn) for name, fn in passes.items()}
    print(f"{tag} plain-torch VJP passes, device ms a call (3 calls): "
          + "; ".join(f"{k} {ms:.4f} ({src})" for k, (ms, src) in out.items()))
    return {k: ms for k, (ms, _) in out.items()}


def _adjoint_lane(torch, sim, ref, lane, groups, tag, problem, fd_dir=None,
                  j_rtol=None, vjp_passes=True):
    """value_and_grad on one lane (module docstring, [7]) of the inverse
    problem ``problem(sim)`` gives; ``ref`` is the lane's plain f64 model
    at its default tolerances; ``fd_dir`` a direction for a central
    difference of the f64 objective; ``j_rtol`` J's limit where it is not
    the lane's; ``vjp_passes`` whether to time the plain VJP passes.
    Every kernel must launch in the backward, and in the forward those a
    forward of the problem's step runs (:func:`_forward_groups`).
    Returns the launches of the instrumented call by wrapper and
    direction, and the lane's numbers."""
    import numpy as np

    from glimslib_tpu_torch.ops import bell_kernels as bk

    dev = sim.device
    lattice = sim.mesh.lattice_strides is not None
    limit = "lattice" if lattice else "unstructured"
    t_lane = time.perf_counter()
    ip, v0 = problem(sim)
    t0 = time.perf_counter()
    J, g = ip.value_and_grad(v0)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    if not (np.isfinite(J) and np.isfinite(g).all()):
        raise AssertionError(f"{tag} J {J} or gradient {g} not finite")

    # one call with every count at 0, split at the backward's start
    wrappers = [w for grp in groups for w in grp]
    for w in wrappers:
        w.launches = 0
    bk.batched_matvec.launches_by_shape = {}
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    vt = ip._param(v0, True)
    torch.cuda.synchronize()
    h0 = time.perf_counter()
    ev[0].record()
    with torch.enable_grad():
        J_t = ip._objective(vt)
    ev[1].record()
    h1 = time.perf_counter()
    fwd = {w: w.launches for w in wrappers}
    fwd_by_shape = dict(bk.batched_matvec.launches_by_shape)
    (g_t,) = torch.autograd.grad(J_t, vt)
    ev[2].record()
    torch.cuda.synchronize()
    h2 = time.perf_counter()
    bwd = {w: w.launches - fwd[w] for w in wrappers}
    by_shape = dict(bk.batched_matvec.launches_by_shape)
    bwd_by_shape = {s_: c_ - fwd_by_shape.get(s_, 0) for s_, c_ in by_shape.items()
                    if c_ > fwd_by_shape.get(s_, 0)}
    fwd_ms, bwd_ms = ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])
    info = {k: [int(i) for i in v] for k, v in sim.solver_info.items()}
    print(f"{tag} {lane}: first value_and_grad {first_s:.3f} s; J {J:.6e}, "
          f"gradient {g.tolist()}")
    print(f"{tag} {lane}: one call, forward {fwd_ms:.3f} ms / backward {bwd_ms:.3f} "
          f"ms (CUDA events, split at the backward's start; host "
          f"{1e3 * (h1 - h0):.3f} / {1e3 * (h2 - h1):.3f} ms) = backward/forward "
          f"{bwd_ms / fwd_ms:.2f}; adjoint CG iterations rd {info['rd_adj_cg_iters']}, "
          f"elasticity {info['el_adj_cg_iters']} (forward rd {info['rd_cg_iters']}, "
          f"elasticity {info['el_cg_iters']})")
    print(f"{tag} {lane}: launches in that call, forward / backward: " + ", ".join(
        f"{w.__name__}={fwd[w]}/{bwd[w]}" for w in wrappers))
    if not lattice:
        print(f"{tag} {lane}: bell_bmv launches in that call by (B, M, K), forward / "
              "backward: " + ", ".join(
                  f"{s_}: {fwd_by_shape.get(s_, 0)}/{bwd_by_shape.get(s_, 0)}"
                  for s_, _ in sorted(by_shape.items(), key=lambda x: -x[1])))
    fwd_groups = _forward_groups(ip.sim, groups) if lattice else groups
    missing = [[w.__name__ for w in grp] for grp in groups
               if sum(bwd[w] for w in grp) < 1
               or (grp in fwd_groups and sum(fwd[w] for w in grp) < 1)]
    if missing:
        raise AssertionError(f"{tag} {lane}: kernels not launched in both the "
                             f"forward and the backward: {missing}")
    if abs(float(J_t.detach()) - J) > 1e-6 * abs(J) or not torch.isfinite(g_t).all():
        raise AssertionError(f"{tag} {lane}: the instrumented call differs")

    torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        ip.value_and_grad(v0)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated(dev)
    vgs = 1.0 / (sum(times) / len(times))
    print(f"{tag} {lane}: value_and_grad/s {vgs:.4f} (3 calls: "
          f"{', '.join(f'{t:.4f}' for t in times)} s); peak memory "
          f"{peak / 2**20:.1f} MiB")
    t_prof = time.perf_counter()
    _, busy, idle = _print_breakdown(torch, lambda: ip.value_and_grad(v0),
                                     1e3 * sum(times) / len(times), f"{tag} {lane}:")
    t_vjp = time.perf_counter()
    passes = (_vjp_passes(torch, sim, ip._c0, lattice, f"{tag} {lane}:")
              if vjp_passes else None)

    # the plain f64 path on the card ([3]'s or [6]'s model), the same targets
    t0 = time.perf_counter()
    ip64 = type(ip)(ref, ip.param_names, ip.targets, update_fn=ip.update_fn,
                    n_steps=ip.n_steps, dt=ip.dt)
    J64, g64 = ip64.value_and_grad(v0)
    rel_J = abs(J - J64) / abs(J64)
    rel_g = float(np.linalg.norm(g - g64) / np.linalg.norm(g64))
    j_lim = ADJ_J_RTOL[limit] if j_rtol is None else j_rtol
    line = (f"{tag} {lane}: f64 plain reference on the card: J {J64:.6e}, gradient "
            f"{g64.tolist()}; rel err J {rel_J:.3e} (<= {j_lim}), rel-L2 "
            f"gradient {rel_g:.3e} (<= {ADJ_G_RTOL[limit]})")
    rel_fd = None
    if fd_dir is not None:
        d = np.asarray(fd_dir)
        fd = (ip64.objective(v0 + ADJ_FD_EPS * d)
              - ip64.objective(v0 - ADJ_FD_EPS * d)) / (2 * ADJ_FD_EPS)
        rel_fd = abs(fd - float(g64 @ d)) / abs(float(g64 @ d))
        line += (f"; central difference along {fd_dir} (eps {ADJ_FD_EPS}) "
                 f"{fd:.9e} vs gradient {float(g64 @ d):.9e}, rel {rel_fd:.3e} "
                 f"(<= {ADJ_FD_RTOL})")
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    print(line + f" ({t_end - t0:.1f} s)")
    print(f"{tag} {lane}: seconds by stage: problem and calls {t_prof - t_lane:.1f}, "
          f"profiled call {t_vjp - t_prof:.1f}, VJP passes {t0 - t_vjp:.1f}, "
          f"f64 reference {t_end - t0:.1f}")
    if rel_J > j_lim or rel_g > ADJ_G_RTOL[limit] or (
            rel_fd is not None and rel_fd > ADJ_FD_RTOL):
        raise AssertionError(f"{tag} {lane}: against the f64 reference J {rel_J:.3e}, "
                             f"gradient {rel_g:.3e}, central difference {rel_fd}")
    return {"forward": fwd, "backward": bwd}, dict(
        value_and_grad_per_s=vgs, first_s=first_s, forward_ms=fwd_ms,
        backward_ms=bwd_ms, peak_mib=peak / 2**20, device_busy_ms=busy, idle_share=idle,
        refine_f64=ip.sim.step_config.refine_f64,
        adjoint_cg_iters={
            "rd": info["rd_adj_cg_iters"], "el": info["el_adj_cg_iters"]},
        rel_J=rel_J, rel_grad=rel_g, rel_fd=rel_fd, vjp_passes_ms=passes,
        bell_bmv_launches_by_shape={"x".join(map(str, s_)): c_
                                    for s_, c_ in by_shape.items()},
        bell_bmv_launches_by_shape_backward={"x".join(map(str, s_)): c_
                                             for s_, c_ in bwd_by_shape.items()})


def _lattice_groups():
    """The lattice lane's kernels for a value_and_grad, one group a form:
    stencil_apply <1,1> (either wrapper), <d,d> and <d,1>, stencil_pcg<1>
    and stencil_pcg<d>."""
    from glimslib_tpu_torch.ops import fused_cg as fc
    from glimslib_tpu_torch.ops import stencil_kernels as sk

    return [(sk.apply_scalar, sk.apply_scalar_sum), (sk.apply_vector,),
            (sk.apply_coupling,), (fc.cg_scalar,), (fc.cg_vector,)]


def phase_adjoint(torch, sim, usim, refs, kernels):
    """[7]: value_and_grad on both lanes; every kernel row gains its
    launches in one call, forward and backward."""
    from glimslib_tpu_torch.examples import adjoint_problem
    from glimslib_tpu_torch.ops import bell_kernels as bk

    t0 = time.perf_counter()
    problem = lambda s: adjoint_problem(sim=s)  # noqa: E731
    lat, lat_nums = _adjoint_lane(torch, sim, refs[0], "lattice", _lattice_groups(),
                                  "[7]", problem, ADJ_FD_DIR)
    uns, uns_nums = _adjoint_lane(torch, usim, refs[1], "unstructured",
                                  [(bk.batched_matvec,)], "[7]", problem)
    for k in kernels:
        if "@" in k["name"]:  # a row of another size
            continue
        counts = uns if k["name"] == "bell_bmv" else lat
        k["adjoint_launches"] = {
            way: sum(counts[way][w] for w in k["wrappers"]) for way in counts}
    print(f"[7] adjoint phase {time.perf_counter() - t0:.1f} s")
    return {"lattice": lat_nums, "unstructured": uns_nums}


def phase_2d(torch, dev):
    """[8]: the 2D models (module docstring).  Returns the kernel rows,
    the two lanes' value_and_grad numbers, and bell_bmv's launches in the
    atlas value_and_grad."""
    from glimslib_tpu_torch.examples import (
        BENCH_STEP_CONFIG, atlas2d_problem, atlas2d_sim, rect_adjoint_problem,
        rect_adjoint_sim, rect_sim,
    )
    from glimslib_tpu_torch.ops import bell_kernels as bk

    t_phase = time.perf_counter()
    f32, f64 = torch.float32, torch.float64
    size = f"@{N2D}x{N2D}"
    t0 = time.perf_counter()
    sim = rect_sim(n=N2D, dtype=f32, device=dev)
    sim._build_step()
    theta = sim._augment_theta_with_operators(sim.make_theta(sim.params.as_dict()))
    torch.cuda.synchronize()
    print(f"[8] {N2D}x{N2D} rectangle set-up {time.perf_counter() - t0:.1f} s "
          f"({sim.mesh.n_nodes} nodes, {len(sim._stencil_ops.offsets)} offsets)")
    rows = phase_kernels(torch, sim, theta, dev, "[8]", size, grids=(16, 4))
    del theta

    # the two 2D lattice paths, each with its own schedule
    for run, subdomains in (("", False), ("_subdomains", True)):
        s = rect_sim(n=N2D, subdomains=subdomains, dtype=f32, device=dev)
        ref = rect_sim(n=N2D, subdomains=subdomains, dtype=f64, device=dev, plain=True)
        n_steps = int(round(float(s.params.sim_time) / float(s.params.sim_time_step)))
        label = "subdomains" if subdomains else "uniform"
        phase_slice(torch, s, ref, dev, rows, f"[8] {N2D}x{N2D} {label}:", n_steps, run)
        del s, ref

    # the 512 x 512 rectangle: stencil_pcg<2> streamed inside the model
    t0 = time.perf_counter()
    big = rect_sim(n=N2D_BIG, dtype=f32, device=dev)
    big.step_config = BENCH_STEP_CONFIG._replace(cg_maxiter=N2D_BIG_CG_MAXITER)
    torch.cuda.synchronize()
    print(f"[8] {N2D_BIG}x{N2D_BIG} model set-up {time.perf_counter() - t0:.1f} s")
    rows += phase_lattice_big(torch, dev, big, "[8]", f"@{N2D_BIG}x{N2D_BIG}",
                              N2D_BIG_STEPS)
    del big
    torch.cuda.empty_cache()

    # the 2D inverse problems: the rectangle's (lattice) and the reduced
    # atlas's (unstructured lane, bell_bmv)
    lat, lat_nums = _adjoint_lane(
        torch, rect_adjoint_sim(n=N2D, dtype=f32, device=dev),
        rect_adjoint_sim(n=N2D, dtype=f64, device=dev, plain=True), "2D lattice",
        _lattice_groups(), "[8]", lambda s: rect_adjoint_problem(sim=s), ADJ_FD_DIR_2D)
    for k in rows:
        if k["name"].endswith(size):
            k["adjoint_launches"] = {
                way: sum(lat[way][w] for w in k["wrappers"]) for way in lat}
            if not k["launches"]:
                # the 50 x 50 paths refine (the f32 default): their forward
                # measures f64 gather residuals, and stencil_apply runs in
                # the value_and_grad's backward
                k["launches"] = sum(k["adjoint_launches"].values())
                k["launches_in"] = "value_and_grad of rect_adjoint_problem(50)"
    t0 = time.perf_counter()
    asim = atlas2d_sim(dtype=f32, device=dev)
    aref = atlas2d_sim(dtype=f64, device=dev, plain=True)
    asim._build_step()
    aug = asim._augment_theta_with_operators(
        {**asim.make_theta(asim.params.as_dict()), **asim.runtime_aux()})
    torch.cuda.synchronize()
    print(f"[8] 2D atlas: {asim.mesh.n_nodes} nodes, {asim.mesh.n_cells} triangles "
          f"(no lattice: {asim.mesh.lattice_strides is None}); two models and the "
          f"operators {time.perf_counter() - t0:.1f} s")
    bmv = {"shapes": _bmv_shapes(torch, asim, aug, dev, "[8] 2D atlas:")}
    del aug
    uns, uns_nums = _adjoint_lane(torch, asim, aref, "2D atlas", [(bk.batched_matvec,)],
                                  "[8]", lambda s: atlas2d_problem(sim=s))
    bmv.update({way: c[bk.batched_matvec] for way, c in uns.items()})
    by_shape = {tuple(int(x) for x in k.split("x")): c
                for k, c in uns_nums["bell_bmv_launches_by_shape"].items()}
    bmv["by_shape"] = uns_nums["bell_bmv_launches_by_shape"]
    bmv["weighted_bound_share"] = _bmv_split(bmv, by_shape, "[8] 2D atlas:",
                                             what="value_and_grad")
    print(f"[8] 2D phase {time.perf_counter() - t_phase:.1f} s")
    return rows, {"lattice_2d": lat_nums, "atlas_2d": uns_nums}, bmv


# [9]: the reference's defaults on the flagship path.  Refined runs hold
# their final state to REFINED_RTOL of the f64 path (and below the same
# lane's unrefined error) and J to REFINED_J_RTOL on both lanes; the
# factored planes equal the dense ones to FACTORED_RTOL at f32.
REFINED_RTOL = 1e-5
REFINED_J_RTOL = 1e-4
# On the unstructured lane REFINED_STEP_CONFIG's newton_atol (1e-5, an
# absolute residual norm) stops the warm-started Newton one iteration
# after its guess: at n=32 the refined state lands 3.0e-5 from the f64
# one, and 4.5e-7 at this newton_atol (an NVIDIA H100): the tolerance,
# not the residual's precision, sets that floor.  That run is held below
# the unrefined error; a second at this newton_atol is held to
# REFINED_RTOL.
REFINED_NEWTON_ATOL = 1e-7
FACTORED_RTOL = 1e-5


def _kernel_totals(torch, run, pattern):
    """{kernel name: (launches, device ms)} of the kernels whose name
    matches ``pattern`` in one profiled run()."""
    from torch.autograd import DeviceType

    prof = _profile(torch, run, cpu=False)
    return {e.key: (e.count, _self_device_us(e) / 1e3) for e in prof.key_averages()
            if getattr(e, "device_type", None) == DeviceType.CUDA
            and re.search(pattern, e.key)}


def _refined_problem(sim):
    """[7]'s inverse problem (adjoint_problem, the lane's benchmark step)
    with refine_f64 on, on the same targets."""
    from glimslib_tpu_torch.examples import adjoint_problem

    ip0, v0 = adjoint_problem(sim=sim)
    sim.step_config = sim.step_config._replace(refine_f64=True)
    return type(ip0)(sim, ip0.param_names, ip0.targets, update_fn=ip0.update_fn,
                     n_steps=ip0.n_steps, dt=ip0.dt), v0


def phase_refined(torch, dev, lanes):
    """[9a]: REFINED_STEP_CONFIG on both lanes, then value_and_grad with
    refine_f64 on.  ``lanes``: (name, model, its f64 plain model, the f64
    final (u, c), the unrefined rel-L2 (c, u), kernel groups).  The
    unstructured lane runs REFINED_STEP_CONFIG a second time with
    newton_atol REFINED_NEWTON_ATOL (REFINED_RTOL's check, module
    constants say why)."""
    from glimslib_tpu_torch.examples import REFINED_STEP_CONFIG
    from glimslib_tpu_torch.ops import fused_cg as fc

    out = {}
    for lane, sim, ref, (u_r, c_r), (rc0, ru0), groups in lanes:
        runs = [("", REFINED_STEP_CONFIG)]
        if lane == "unstructured":
            runs.append((f", newton_atol {REFINED_NEWTON_ATOL}",
                         REFINED_STEP_CONFIG._replace(newton_atol=REFINED_NEWTON_ATOL)))
        for i, (label, cfg) in enumerate(runs):
            tag = f"[9a] {lane} refined{label}:"
            sim.step_config = cfg
            theta = sim.make_theta(sim.params.as_dict())
            u0, c0 = sim.initial_state()
            simulate = sim.build_simulate_fn(N_STEPS, 1.0)
            shown = [w for g in groups for w in g]
            (u_tr, c_tr), launches, _ = _drive(torch, sim, simulate, (theta, u0, c0),
                                               _forward_groups(sim, groups), tag,
                                               N_STEPS, shown=shown)
            fix = len(sim.solver_info["el_refine_cg_iters"])
            if fix != N_STEPS:
                raise AssertionError(f"{tag} {fix} correction solves in {N_STEPS} steps")
            if fc.cg_vector in launches:
                print(f"{tag} stencil_pcg<3> launches {launches[fc.cg_vector]}: "
                      f"{launches[fc.cg_vector] - fix} elasticity solves and {fix} "
                      "correction solves at refine_cg_rtol "
                      f"{sim.step_config.refine_cg_rtol}")
            run = {}
            if i == 0:
                _, run = _time_runs(torch, simulate, (theta, u0, c0), dev, tag, N_STEPS)
            rel_c, rel_u = _rel_l2(c_tr[-1], c_r), _rel_l2(u_tr[-1], u_r)
            if lane == "unstructured" and i == 0:
                lim_c, lim_u, why = rc0, ru0, "the unrefined errors"
            else:
                lim_c, lim_u = min(REFINED_RTOL, rc0), min(REFINED_RTOL, ru0)
                why = f"{REFINED_RTOL} and the unrefined errors"
            print(f"{tag} against the f64 plain path: rel-L2 c {rel_c:.3e} (<= "
                  f"{lim_c:.3e}), u {rel_u:.3e} (<= {lim_u:.3e}): {why} "
                  f"{rc0:.3e}, {ru0:.3e}")
            if rel_c > lim_c or rel_u > lim_u:
                raise AssertionError(f"{tag} c {rel_c:.3e}, u {rel_u:.3e}")
            out[lane + label.replace(", ", "_").replace(" ", "_")] = dict(
                run, launches={w.__name__: n for w, n in launches.items()},
                correction_solves=fix, rel_c=rel_c, rel_u=rel_u, unrefined_rel=(rc0, ru0))
    for lane, sim, ref, _, _, groups in lanes:
        _, nums = _adjoint_lane(torch, sim, ref, f"{lane} refined", groups, "[9a]",
                                _refined_problem, j_rtol=REFINED_J_RTOL,
                                vjp_passes=False)
        out[lane]["value_and_grad"] = nums
    return out


def phase_factored(torch, dev, usim):
    """[9b]: the factored planes of the n=32 box against the dense ones (the
    same aux without the channel stacks, which assembles the planes from
    the cells), the per-simulate assembly's device time and steps/s both
    ways."""
    from glimslib_tpu_torch.examples import UNSTRUCT_STEP_CONFIG

    usim.step_config = UNSTRUCT_STEP_CONFIG
    aux = usim.runtime_aux()
    dense_aux = {k: v for k, v in aux.items() if not k.startswith("_F")}
    theta = usim.make_theta(usim.params.as_dict())
    u0, c0 = usim.initial_state()
    stack_mb = sum(v.numel() * v.element_size() for k, v in aux.items()
                   if k.startswith("_F") and v.is_floating_point()) / 2**20
    print(f"[9b] factored channel stacks: {', '.join(f'{k} {tuple(v.shape)}' for k, v in aux.items() if k.startswith('_FW') or k == '_FCuc')}; "
          f"{stack_mb:.1f} MiB, built in {usim.setup_seconds.get('factored', 0.0):.2f} s")
    out = {}
    planes = {}
    for way, a in (("factored", aux), ("dense", dense_aux)):
        aug = usim._augment_theta_with_operators({**theta, **a})
        planes[way] = {k: aug[k] for k in ("_BellWel", "_BellCuc", "_BellWrdC", "_BellMrd")}
        del aug
        ms, src = _call_device_ms(
            torch, lambda a=a: usim._augment_theta_with_operators({**theta, **a}))
        call = _host_ms(torch, lambda a=a: usim._augment_theta_with_operators({**theta, **a}))
        simulate = usim.build_simulate_fn(N_STEPS, 1.0)
        out[way] = dict(assembly_device_ms=ms, assembly_call_ms=call)
        print(f"[9b] {way}: per-simulate assembly device {ms:.3f} ms ({src}), call "
              f"{call:.3f} ms (host clock)")
        _, run = _time_runs(torch, simulate, (theta, u0, c0, a), dev, f"[9b] {way}:", N_STEPS)
        out[way].update(run)
    for k in planes["dense"]:
        err, rel = _rel_max(planes["factored"][k], planes["dense"][k])
        print(f"[9b] {k}: factored vs dense max abs {err:.3e}, max rel {rel:.3e} "
              f"(<= {FACTORED_RTOL})")
        out[k] = rel
        if rel > FACTORED_RTOL:
            raise AssertionError(f"[9b] {k} factored vs dense {rel:.3e}")
    return out


def _coarse_in_path(torch, run, aux):
    """{product: (calls, device ms)} of the coarse term's two matrix
    products in one profiled run(): the aten::mm (bf16) or aten::mv (f32)
    calls whose matrix has a coarse factor's shape or its transpose's,
    with the device time of their kernels."""
    from torch.profiler import ProfilerActivity, profile

    shapes = {}
    for key in ("_TLCfac", "_TLCfacS"):
        m, k = aux[key].shape
        shapes[(m, k)] = f"{key} w = B z"
        shapes[(k, m)] = f"{key} z = Bt rc"
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        run()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages(group_by_input_shape=True):
        if e.key in ("aten::mm", "aten::mv") and e.input_shapes:
            name = shapes.get(tuple(e.input_shapes[0]))
            if name is not None:
                c, ms = out.get(name, (0, 0.0))
                out[name] = (c + e.count, ms + e.device_time_total / 1e3)
    return out


def phase_bf16(torch, dev, usim, base6):
    """[9c]: the n=32 box's default bf16 coarse factors against f32 ones
    (the two-level arrays built again in the working dtype, without the
    model's bf16 cast)."""
    from glimslib_tpu_torch.examples import UNSTRUCT_STEP_CONFIG
    from glimslib_tpu_torch.ops import bell_kernels as bk

    usim.step_config = UNSTRUCT_STEP_CONFIG
    aux_b = usim.runtime_aux()
    theta = usim.make_theta(usim.params.as_dict())
    t0 = time.perf_counter()
    aux_f = {**aux_b, **usim._twolevel_aux(theta, {})}
    set_s = time.perf_counter() - t0
    print(f"[9c] factors {aux_b['_TLCfac'].dtype} {tuple(aux_b['_TLCfac'].shape)} / "
          f"{tuple(aux_b['_TLCfacS'].shape)} against {aux_f['_TLCfac'].dtype} (built "
          f"again in the working dtype in {set_s:.1f} s)")
    if aux_b["_TLCfac"].dtype != torch.bfloat16 or aux_f["_TLCfac"].dtype != torch.float32:
        raise AssertionError("[9c] the model's factors are not bf16")
    u0, c0 = usim.initial_state()
    u_r, c_r = (x[-1] for x in base6["ref_traj"])
    simulate = usim.build_simulate_fn(N_STEPS, 1.0)
    out = {}
    for way, a in (("bf16", aux_b), ("f32", aux_f)):
        tag = f"[9c] {way}:"
        (u_tr, c_tr), _, _ = _drive(torch, usim, simulate, (theta, u0, c0, a),
                                    [(bk.batched_matvec,)], tag, N_STEPS)
        it = {k: [int(i) for i in usim.solver_info[k]] for k in ("rd_cg_iters", "el_cg_iters")}
        applies = {"_TLCfac": sum(x + 1 for x in it["el_cg_iters"]),
                   "_TLCfacS": sum(x + 1 for x in it["rd_cg_iters"])}
        prods = _coarse_in_path(torch, lambda a=a: simulate(theta, u0, c0, a), a)
        coarse = sum(ms for _, ms in prods.values())
        gemv = _kernel_totals(torch, lambda a=a: simulate(theta, u0, c0, a),
                              r"gemv|gemm|nvjet|xmma|cutlass")
        _, run = _time_runs(torch, simulate, (theta, u0, c0, a), dev, tag, N_STEPS)
        rel_c, rel_u = _rel_l2(c_tr[-1], c_r), _rel_l2(u_tr[-1], u_r)
        print(f"{tag} CG iterations rd {sum(it['rd_cg_iters'])} (a Newton solve "
              f"{it['rd_cg_iters']}), elasticity {sum(it['el_cg_iters'])} (a step "
              f"{it['el_cg_iters']}); preconditioner applies {applies['_TLCfac']} "
              f"(vector) / {applies['_TLCfacS']} (scalar)")
        print(f"{tag} the coarse products in a profiled run, device ms: {coarse:.3f} ("
              + "; ".join(f"{k} x{c} {ms:.3f} ({1e3 * ms / max(c, 1):.1f} us a call)"
                          for k, (c, ms) in sorted(prods.items()))
              + "); its matrix-product kernels: " + "; ".join(
                  f"{k[:70]} x{c} {ms:.3f}" for k, (c, ms) in gemv.items()))
        print(f"{tag} against the f64 plain path: rel-L2 c {rel_c:.3e}, u {rel_u:.3e} "
              f"(<= {UNSTRUCT_RTOL})")
        if rel_c > UNSTRUCT_RTOL or rel_u > UNSTRUCT_RTOL:
            raise AssertionError(f"{tag} c {rel_c:.3e}, u {rel_u:.3e}")
        out[way] = dict(run, cg_iters=it, coarse_products={k: list(v) for k, v in prods.items()},
                        coarse_ms_a_run=coarse,
                        matrix_product_kernels={k: list(v) for k, v in gemv.items()},
                        rel_c=rel_c, rel_u=rel_u)
    del aux_f
    return out


def phase_defaults(torch, dev, lat, uns):
    """[9]: the reference's defaults on the flagship path (module
    docstring).  ``lat`` = ([3]'s model, its f64 plain model, its f64
    final (u, c), its rel-L2 (c, u)); ``uns`` = ([6]'s model, its f64
    plain model, [6]'s baseline)."""
    from glimslib_tpu_torch.ops import bell_kernels as bk

    t_phase = time.perf_counter()
    sim, ref, lat_state, lat_rel = lat
    usim, uref, base6 = uns
    u_r, c_r = base6["ref_traj"]
    out = {}
    t0 = time.perf_counter()
    out["refined"] = phase_refined(torch, dev, [
        ("lattice", sim, ref, lat_state, lat_rel, _lattice_groups()),
        ("unstructured", usim, uref, (u_r[-1], c_r[-1]), base6["rel"],
         [(bk.batched_matvec,)]),
    ])
    print(f"[9a] {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out["factored"] = phase_factored(torch, dev, usim)
    print(f"[9b] {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out["bf16"] = phase_bf16(torch, dev, usim, base6)
    print(f"[9c] {time.perf_counter() - t0:.1f} s")
    print(f"[9] defaults phase {time.perf_counter() - t_phase:.1f} s")
    return out


# [10]: the quad (P2-concentration) brain model on the n=32 Morton box,
# the benchmark's quad flagship (bench.py run_unstructured(quad=True)).
# Its final state is held to the unstructured limit against the plain f64
# path; where the operating point (rd forcing 1e-3, newton_atol 1e-5)
# leaves more, the run is repeated at QUAD_NEWTON_ATOL and that run is
# held to the limit (as [9a] does).
QUAD_RTOL = UNSTRUCT_RTOL
QUAD_NEWTON_ATOL = 1e-7


def _quad_vs_ref(torch, sim, final, args, ref_traj, tag):
    """rel-L2 (c, u) of a quad run's final state ``final`` (u, c) against
    the f64 plain path's; when above QUAD_RTOL, the same run at
    QUAD_NEWTON_ATOL too."""
    from glimslib_tpu_torch.solvers.coupled import StepConfig

    rel = (_rel_l2(final[1], ref_traj[1]), _rel_l2(final[0], ref_traj[0]))
    print(f"{tag} vs the f64 plain path: rel-L2 c {rel[0]:.3e}, u {rel[1]:.3e} "
          f"(<= {QUAD_RTOL})")
    if max(rel) <= QUAD_RTOL:
        return rel, None
    cfg = sim.step_config
    sim.step_config = StepConfig(**{**cfg._asdict(), "newton_atol": QUAD_NEWTON_ATOL})
    u_t, c_t, ok_t, newton = sim.build_simulate_fn(N_STEPS, 1.0)(*args)
    sim.step_config = cfg
    tight = (_rel_l2(c_t[-1], ref_traj[1]), _rel_l2(u_t[-1], ref_traj[0]))
    print(f"{tag} above the limit: at newton_atol {QUAD_NEWTON_ATOL} (Newton "
          f"{newton.tolist()}) rel-L2 c {tight[0]:.3e}, u {tight[1]:.3e} (<= {QUAD_RTOL})")
    if not bool(ok_t.all()) or max(tight) > QUAD_RTOL:
        raise AssertionError(f"{tag} vs the f64 plain path: {rel}, at newton_atol "
                             f"{QUAD_NEWTON_ATOL} {tight}")
    return rel, tight


def phase_quad(torch, dev, kern):
    """[10]: set-up by part, bell_bmv at the P2 shapes ([10a]), the
    forward at the benchmark's unstructured StepConfig ([10b]), the f32
    default refined step ([10c]) and one value_and_grad ([10d]); ``kern``
    (the bell_bmv row) gains the P2 shapes and their launches."""
    from glimslib_tpu_torch.core.mesh import Mesh
    from glimslib_tpu_torch.examples import UNSTRUCT_STEP_CONFIG, adjoint_problem, brain_sim
    from glimslib_tpu_torch.models.base import default_step_config
    from glimslib_tpu_torch.ops import bell_kernels as bk
    from glimslib_tpu_torch.ops.p2 import p2_dof_layout
    from glimslib_tpu_torch.solvers.coupled import StepConfig

    t_phase = time.perf_counter()
    tag = f"[10] quad n={N}:"
    t0 = time.perf_counter()
    sim = brain_sim(n=N, dtype=torch.float32, device=dev, unstructured=True, quad=True)
    model_s = time.perf_counter() - t0
    assert sim.step_config == UNSTRUCT_STEP_CONFIG
    t0 = time.perf_counter()
    p2_dof_layout(Mesh.from_arrays(sim.mesh.points, sim.mesh.cells))
    layout_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    aux = sim.runtime_aux()
    torch.cuda.synchronize()
    aux_s = time.perf_counter() - t0
    aux_peak = torch.cuda.max_memory_allocated(dev)
    t0 = time.perf_counter()
    u0, c0 = sim.initial_state()
    torch.cuda.synchronize()
    iv_s = time.perf_counter() - t0
    p2, pp, bp = sim.p2, sim._get_p2_plan(), sim._get_bell_plan()
    st = sim.setup_seconds
    slots = pp.nb * pp.s * pp.Kh
    print(f"{tag} {p2.n_dofs} P2 dofs ({sim.mesh.n_nodes} nodes + {p2.n_edges} "
          f"edges), {sim.mesh.n_cells} tets; P2 plan nb={pp.nb}, s={pp.s}, Kh={pp.Kh} "
          f"(Khe={pp.Khe}, flat halo): {slots} slots, {4 * slots / 1e6:.1f} MB a f32 "
          f"plane, placement index {8 * slots / 1e6:.1f} MB; P1 plan nb={bp.nb}, "
          f"s={bp.s}, Kh={bp.Kh}")
    print(f"{tag} set-up seconds: model {model_s:.2f} (of it the P2 dof layout "
          f"{layout_s:.2f}), P2 plan {st['p2_plan']:.2f}, factored P2 cache "
          f"{st['factored_p2']:.2f}, _McSNP2 {st['p2_supernode_jacobi']:.2f}, P1 plan "
          f"{st['bell_plan']:.2f}, P1 supernode Jacobi {st['supernode_jacobi']:.2f}, "
          f"factored P1 {st['factored']:.2f}, coarse level "
          f"{st.get('coarse_build', 0.0) + st.get('coarse_inverse', 0.0):.2f}; frozen "
          f"state {aux_s:.2f} s in all, peak memory {aux_peak / 2**20:.1f} MiB; IV "
          f"projection {iv_s:.2f} s; _FP2Wrd {tuple(aux['_FP2Wrd'].shape)}")
    if (p2.n_dofs, pp.nb, pp.s) != (274625, 4352, 64):
        raise AssertionError(f"{tag} flagship sizes {(p2.n_dofs, pp.nb, pp.s)}")

    # [10a] bell_bmv at the P2 shapes
    theta = sim.make_theta(sim.params.as_dict())
    sim._build_step()
    aug = sim._augment_theta_with_operators({**theta, **aux})
    shapes = _bmv_check(torch, [
        ("P2 rd constant plane _P2BWrdC", aug["_P2BWrdC"]),
        ("P2 supernode Jacobi _McSNP2", aug["_McSNP2"]),
    ], dev, "[10a]")
    del aug
    kern["p2_shapes"] = shapes
    p2_keys = [(pp.nb, pp.s, pp.Kh), (pp.nb, pp.s, pp.s)]

    # [10b] the forward at the benchmark's operating point
    simulate = sim.build_simulate_fn(N_STEPS, 1.0)
    args = (theta, u0, c0)
    bk.batched_matvec.launches_by_shape = {}
    (u_tr, c_tr), launches, first_s = _drive(torch, sim, simulate, args,
                                             [(bk.batched_matvec,)], "[10b]", N_STEPS)
    by_shape = dict(bk.batched_matvec.launches_by_shape)
    if any(by_shape.get(k, 0) < 1 for k in p2_keys):
        raise AssertionError(f"[10b] bell_bmv did not launch at the P2 shapes: {by_shape}")
    kern["quad_launches"] = launches[bk.batched_matvec]
    kern["quad_launches_by_shape"] = {"x".join(map(str, k)): c for k, c in by_shape.items()}
    share = _bmv_split({"shapes": kern["shapes"] + shapes}, by_shape, "[10b]")
    iters = {k: [int(i) for i in sim.solver_info[k]] for k in ("rd_cg_iters", "el_cg_iters")}
    _, run = _time_runs(torch, simulate, args, dev, "[10b]", N_STEPS)

    t0 = time.perf_counter()
    ref = brain_sim(n=N, dtype=torch.float64, device=dev, plain=True, unstructured=True,
                    quad=True)
    # the plans are the mesh's; the frozen coarse factors carry over (a
    # preconditioner changes iteration counts only), the supernode
    # inverses and the P2 planes are built in f64
    ref._bell_plan, ref._p2_plan = bp, pp
    ref._aux_cache = {k: v.double() for k, v in aux.items() if k.startswith("_TL")}
    f64_defaults = ref.step_config
    ref.step_config = StepConfig(newton_rtol=1e-10, newton_atol=1e-14, cg_rtol=1e-12,
                                 cg_maxiter=4000)
    u_r, c_r, ok_r, newton_r = ref.build_simulate_fn(N_STEPS, 1.0)(
        ref.make_theta(ref.params.as_dict()), *ref.initial_state())
    torch.cuda.synchronize()
    if not bool(ok_r.all()):
        raise AssertionError("[10b] quad f64 plain reference did not converge")
    print(f"[10b] f64 plain reference on the card ({time.perf_counter() - t0:.1f} s, "
          f"Newton {newton_r.tolist()}, rd CG {[int(i) for i in ref.solver_info['rd_cg_iters']]}, "
          f"elasticity CG {[int(i) for i in ref.solver_info['el_cg_iters']]})")
    ref_traj = (u_r[-1], c_r[-1])
    rel, rel_tight = _quad_vs_ref(torch, sim, (u_tr[-1], c_tr[-1]), args, ref_traj,
                                  "[10b]")
    ref.step_config = f64_defaults

    # [10c] the f32 default: refined in f64
    sim.step_config = default_step_config(torch.float32)
    assert sim.step_config.refine_f64
    simulate_r = sim.build_simulate_fn(N_STEPS, 1.0)
    (u_f, c_f), launches_r, _ = _drive(torch, sim, simulate_r, args,
                                       [(bk.batched_matvec,)], "[10c]", N_STEPS)
    n_fix = len(sim.solver_info["el_refine_cg_iters"])
    _, run_r = _time_runs(torch, simulate_r, args, dev, "[10c]", N_STEPS)
    rel_r = (_rel_l2(c_f[-1], c_r[-1]), _rel_l2(u_f[-1], u_r[-1]))
    below = rel_r[0] < rel[0] and rel_r[1] < rel[1]
    print(f"[10c] refined vs the f64 plain path: rel-L2 c {rel_r[0]:.3e}, u "
          f"{rel_r[1]:.3e} ([10b]: {rel[0]:.3e}, {rel[1]:.3e}; below it: {below}); "
          f"correction solves {n_fix} (one a step)")
    if n_fix != N_STEPS:
        raise AssertionError(f"[10c] refined: {n_fix} correction solves")
    rel_rt = None
    if not below:
        # the default's newton_atol (1e-5, absolute) stops Newton before the
        # f64 residual's precision shows; the same run at QUAD_NEWTON_ATOL
        # is held below [10b]'s error and to REFINED_RTOL
        sim.step_config = StepConfig(**{**sim.step_config._asdict(),
                                        "newton_atol": QUAD_NEWTON_ATOL})
        u_t, c_t, ok_t, newton_t = sim.build_simulate_fn(N_STEPS, 1.0)(*args)
        rel_rt = (_rel_l2(c_t[-1], c_r[-1]), _rel_l2(u_t[-1], u_r[-1]))
        print(f"[10c] refined at newton_atol {QUAD_NEWTON_ATOL} (Newton "
              f"{newton_t.tolist()}): rel-L2 c {rel_rt[0]:.3e}, u {rel_rt[1]:.3e} "
              f"(below [10b]'s and <= {REFINED_RTOL})")
        if not (bool(ok_t.all()) and rel_rt[0] < rel[0] and rel_rt[1] < rel[1]
                and max(rel_rt) <= REFINED_RTOL):
            raise AssertionError(f"[10c] refined at newton_atol {QUAD_NEWTON_ATOL}: "
                                 f"{rel_rt} against [10b]'s {rel}")
        del u_t, c_t
    sim.step_config = UNSTRUCT_STEP_CONFIG
    del u_tr, c_tr, u_f, c_f

    # [10d] one value_and_grad of the benchmark's adjoint cell on the quad model
    counts, nums = _adjoint_lane(torch, sim, ref, "quad unstructured",
                                 [(bk.batched_matvec,)], "[10d]",
                                 lambda s_: adjoint_problem(sim=s_), vjp_passes=False)
    bwd_p2 = {k: nums["bell_bmv_launches_by_shape_backward"].get("x".join(map(str, k)), 0)
              for k in p2_keys}
    if min(bwd_p2.values()) < 1:
        raise AssertionError(f"[10d] bell_bmv did not launch at the P2 shapes in the "
                             f"backward: {bwd_p2}")
    kern["quad_adjoint_launches"] = {way: c[bk.batched_matvec] for way, c in counts.items()}
    kern["quad_adjoint_launches_by_shape"] = {
        "total": nums["bell_bmv_launches_by_shape"],
        "backward": nums["bell_bmv_launches_by_shape_backward"]}
    print(f"[10] quad phase {time.perf_counter() - t_phase:.1f} s")
    return dict(
        p2_dofs=p2.n_dofs, plan=dict(nb=pp.nb, s=pp.s, Kh=pp.Kh, slots=slots),
        setup_s=dict(model=model_s, p2_layout=layout_s, iv_projection=iv_s, **st),
        forward=dict(first_s=first_s, rel_c=rel[0], rel_u=rel[1],
                     rel_tight=rel_tight, weighted_bound_share=share, **iters, **run),
        refined=dict(rel_c=rel_r[0], rel_u=rel_r[1], rel_tight=rel_rt, **run_r),
        adjoint=nums)


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
    ref, lat_state, lat_rel = phase_slice(
        torch, sim, brain_sim(n=N, dtype=torch.float64, device=dev, plain=True), dev,
        kernels, f"[3] N={N}:", N_STEPS)

    t0 = time.perf_counter()
    big = brain_sim(n=N64, dtype=torch.float32, device=dev)
    big.step_config = BENCH_STEP_CONFIG
    torch.cuda.synchronize()
    print(f"[4] N={N64} model set-up {time.perf_counter() - t0:.1f} s")
    kernels += phase_lattice_big(torch, dev, big, "[4]", f"@N={N64}", N64_STEPS)
    del big
    torch.cuda.empty_cache()

    kern, usim, uref, base6 = phase_unstructured(torch, dev)
    kernels.append(kern)

    adjoint = phase_adjoint(torch, sim, usim, (ref, uref), kernels)

    rows2d, adjoint2d, bmv2d = phase_2d(torch, dev)
    kernels += rows2d
    adjoint.update(adjoint2d)
    kern["atlas_2d_adjoint_launches"] = bmv2d

    defaults = phase_defaults(torch, dev, (sim, ref, lat_state, lat_rel),
                              (usim, uref, base6))
    del sim, usim, ref, uref, base6
    torch.cuda.empty_cache()

    quad = phase_quad(torch, dev, kern)
    torch.cuda.empty_cache()

    drop = ("wrappers", "pattern", "iters")
    print(json.dumps({"quad": quad}, default=str))
    print(json.dumps({"defaults": defaults}, default=str))
    print(json.dumps({"adjoint": adjoint}))
    print(json.dumps({"kernels": [
        {k: v for k, v in kern.items() if k not in drop} for kern in kernels
    ]}))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
