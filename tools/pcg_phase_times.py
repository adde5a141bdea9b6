#!/usr/bin/env python3
"""Where an iteration of the whole-solve stencil PCG spends its time, on
one NVIDIA GPU.

    python3 tools/pcg_phase_times.py [--n64]

Builds ``glimslib_tpu_torch/csrc/stencil.cu`` a second time with
``-DGLIMS_PCG_TIMING`` (block 0 sums its SM cycles by phase with
``clock64``) into ``build/kernels/`` and solves the lattice path's
systems of the brain box (the first step's rd Newton system, d=1, and
elasticity system, d=3) at N=32, and with ``--n64`` at N=64, through
that library in every mode of the launch plan that fits.  For each solve
it prints the device time from CUDA events around single launches, us an
iteration, and the share and us an iteration of each phase of block 0:
sweep A (the matvec), the two grid sums (block sums, grid barrier with
the wait for the slowest block, the read of every block's partials),
sweep B, and the p sweep (x += alpha p, p = z + beta p, with its grid
barrier).  The phase counters cost a few cycles a phase; the timed build
is used by nothing else.
"""

import argparse
import ctypes
import os
import subprocess
import sys
import time
from unittest import mock

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PHASES = ("sweep A", "grid sums", "sweep B", "p sweep")


def _build_timing_lib():
    from glimslib_tpu_torch import _build

    src = _build.SOURCES["stencil"]
    out = _build.library_path("stencil").with_name(
        _build.library_path("stencil").stem + "_timing.so")
    if not out.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-DGLIMS_PCG_TIMING",
               "-o", str(out), str(src)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    for fn, argtypes in _build._signatures()["stencil"].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.glims_pcg_cycles_take.argtypes = [ctypes.c_void_p]
    lib.glims_pcg_cycles_take.restype = ctypes.c_int
    return lib


def _take(lib):
    buf = (ctypes.c_ulonglong * 8)()
    if lib.glims_pcg_cycles_take(ctypes.addressof(buf)):
        raise RuntimeError("reading the phase counters failed")
    return list(buf)[:len(PHASES)]


def _systems(torch, n, dev):
    import numpy as np

    from glimslib_tpu_torch.examples import BENCH_STEP_CONFIG, brain_sim
    from glimslib_tpu_torch.ops import fused_cg as fc

    t0 = time.perf_counter()
    sim = brain_sim(n=n, dtype=torch.float32, device=dev)
    sim.step_config = BENCH_STEP_CONFIG
    sim._build_step()
    theta = sim.make_theta(sim.params.as_dict())
    aug = sim._augment_theta_with_operators(theta)
    u0, c0 = sim.initial_state()
    mask_u, mask_c, _, _ = sim._bc_masks_and_values()
    ops = sim._stencil_ops
    offs = ops.offsets
    ru = sim.el_residual(torch.where(mask_u, 0.0, u0), c0, aug, 1.0)
    b_u = torch.where(mask_u, 0.0, -ru).contiguous()
    Wrd = aug["_Wrd_const"] + ops.build_rd_wc(c0, aug["rho"], aug["dt"])
    v = torch.as_tensor(np.random.default_rng(2).standard_normal(sim.mesh.n_nodes),
                        dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    print(f"N={n}: set-up {time.perf_counter() - t0:.1f} s, {sim.mesh.n_nodes} nodes")
    cfg = sim.step_config
    tol = (cfg.cg_rtol, cfg.cg_atol, cfg.cg_maxiter)
    Wm_rd = fc.fold_mask_scalar(offs, Wrd, mask_c)
    return [
        ("stencil_pcg<1>", 1, (offs, Wm_rd[:, None, None, :], aug["_invdM"],
                               torch.where(mask_c, 0.0, v), *tol)),
        ("stencil_pcg<3>", 3, (offs, aug["_WelM"], aug["_BinvM"], b_u, *tol)),
    ]


def _report(torch, lib, name, n, d, args, mode):
    from glimslib_tpu_torch.ops import fused_cg as fc

    def call():
        return fc._pcg_cuda(d, *args, mode)

    x, info, plan = call()  # warm-up; also drops its counts
    torch.cuda.synchronize()
    _take(lib)
    reps = 3
    ms = 0.0
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(4_000_000)
        start.record()
        x, info, plan = call()
        end.record()
        torch.cuda.synchronize()
        ms += start.elapsed_time(end) / reps
    cycles = _take(lib)
    iters = int(info["iters"])
    us_it = 1e3 * ms / max(iters, 1)
    total = max(sum(cycles), 1)
    print(f"N={n} {name} {plan.mode} ({plan.stages} stage(s)): {iters} iterations, "
          f"{ms:.4f} ms = {us_it:.2f} us an iteration; block 0 at "
          f"{total / reps / (ms * 1e3):.0f} cycles/us")
    for ph, c in zip(PHASES, cycles):
        print(f"    {ph:14s} {100 * c / total:5.1f}%  {us_it * c / total:7.2f} us an iteration")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n64", action="store_true", help="also solve at N=64")
    a = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("pcg_phase_times: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from glimslib_tpu_torch import _build
    from glimslib_tpu_torch.ops import fused_cg as fc

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    lib = _build_timing_lib()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    # the kernel wrapper launches through the timed library in this scope only
    with mock.patch.object(_build, "load", lambda name: lib):
        for n in (32, 64) if a.n64 else (32,):
            for name, d, args in _systems(torch, n, dev):
                for mode in fc.MODES:
                    try:
                        fc.launch_plan((n + 1) ** 3, d, len(args[0]), sms, mode)
                    except ValueError:
                        continue
                    _report(torch, lib, name, n, d, args, mode)
    return 0


if __name__ == "__main__":
    sys.exit(main())
