#!/usr/bin/env python3
"""bell_bmv against another build of ``csrc/bell.cu``, L2-cold, on one
NVIDIA GPU.

    mkdir -p build/ab
    git show HEAD~1:glimslib_tpu_torch/csrc/bell.cu > build/ab/bell_parent.cu
    python3 tools/bmv_ab.py build/ab/bell_parent.cu

Builds the given source with the package's nvcc flags into ``build/ab/``
and times its kernel and the package's ``bell_bmv`` (``csrc/bell.cu``
through ``ops/bell_kernels.py``) at the twelve (B, M, K) shapes the
unstructured paths give the kernel (the n=32 brain box's five P1 tables,
the quad model's two P2 tables, the reduced 2D atlas's five), on random
tensors made from a seed.  Each is held against the plain version (max
rel 1e-5), the package's kernel is bit-equal across two launches, and
each is timed L2-cold (the profiler's kernel time after
``chip_smoke.py``'s flush) in turns: other, package, package, other.
``torch.bmm`` (a yardstick) is timed L2-cold and warm beside them, with
the bound (A, x and y once at 3.35 TB/s).  The other source takes the
C interface of the kernel before the launch plan,
``glims_bell_bmv(A, x, y, B, M, K, stream)``.  With ``--path`` it also
runs the n=32 unstructured forward (``chip_smoke.py`` [6]'s model, 5
steps) under the profiler with each kernel in turns (other, package,
package, other) and prints bell_bmv's device ms in that run, by shape,
beside the run's device busy ms.  Prints a line a shape; ``--json PATH``
also writes every number as JSON.  Nothing else runs this script.
"""

import argparse
import ctypes
import hashlib
import json
import os
import re
import subprocess
import sys
from unittest import mock

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# (role, (B, M, K)): [5]'s, [10a]'s and [8]'s shapes of chip_smoke.py
SHAPES = (
    ("P1 elasticity operator _BellWel", (1152, 96, 474)),
    ("P1 coupling _BellCuc", (1152, 96, 158)),
    ("P1 elasticity Jacobi _BinvSN", (1152, 96, 96)),
    ("P1 rd constant planes _BellWrdC", (1152, 32, 158)),
    ("P1 rd Jacobi _McSN", (1152, 32, 32)),
    ("P2 rd constant plane _P2BWrdC", (4352, 64, 353)),
    ("P2 Jacobi _McSNP2", (4352, 64, 64)),
    ("2D elasticity operator", (88, 64, 200)),
    ("2D elasticity Jacobi", (88, 64, 64)),
    ("2D rd constant planes", (88, 32, 100)),
    ("2D rd Jacobi", (88, 32, 32)),
    ("2D coupling", (88, 64, 100)),
)
RTOL = 1e-5


def _build_other(src):
    from glimslib_tpu_torch import _build

    text = open(src, "rb").read()
    h = hashlib.sha256(text + " ".join(_build.NVCC_FLAGS).encode()).hexdigest()[:16]
    out = os.path.join(ROOT, "build", "ab", f"libbell_other_{h}.so")
    if not os.path.exists(out):
        os.makedirs(os.path.dirname(out), exist_ok=True)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", out, src]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
        for line in (proc.stdout + proc.stderr).splitlines():
            if "ptxas info" in line and "Used" in line:
                print(f"other build: {line.strip()}")
    return ctypes.CDLL(out)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", help="a bell.cu to time against the package's")
    ap.add_argument("--path", action="store_true",
                    help="also the n=32 unstructured forward with each kernel in turns")
    ap.add_argument("--json", metavar="PATH", help="write every number here as JSON")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("bmv_ab: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from glimslib_tpu_torch import _build
    from glimslib_tpu_torch.ops import bell_kernels as bk

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    dev = torch.device("cuda", 0)
    _build.load("bell")
    for line in _build.build_log.get("bell", "").splitlines():
        if "ptxas info" in line and "Used" in line:
            print(f"package build: {line.strip()}")
    other = _build_other(args.other)
    fn = other.glims_bell_bmv
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]

    def run_other(A, x):
        B, M, K = A.shape
        y = torch.empty((B, M), dtype=torch.float32, device=dev)
        _build.check(fn(A.data_ptr(), x.data_ptr(), y.data_ptr(), B, M, K,
                        torch.cuda.current_stream(dev).cuda_stream),
                     "other bell_bmv launch")
        return y

    prep = cs._cold_l2(torch, dev)
    gen = torch.Generator(device=dev).manual_seed(11)
    rows = []
    for role, (B, M, K) in SHAPES:
        A = torch.randn((B, M, K), generator=gen, device=dev)
        x = torch.randn((B, K), generator=gen, device=dev)
        want = bk.batched_matvec_plain(A, x)
        new = lambda: bk.batched_matvec_cuda(A, x)  # noqa: E731
        old = lambda: run_other(A, x)  # noqa: E731
        y1, y2, y0 = new(), new(), old()
        torch.cuda.synchronize()
        rel_new, rel_old = cs._rel_max(y1, want)[1], cs._rel_max(y0, want)[1]
        if rel_new > RTOL or rel_old > RTOL or not torch.equal(y1, y2):
            raise AssertionError(f"{(B, M, K)}: max rel {rel_new:.3e} (package), "
                                 f"{rel_old:.3e} (other), bit-equal {torch.equal(y1, y2)}")

        def cold(f):
            ms, why = cs._cold_device_ms(torch, f, 10, prep)
            if ms is None:
                raise AssertionError(f"{(B, M, K)}: no L2-cold time ({why})")
            return ms
        turns = {"other": [], "package": []}
        for who in ("other", "package", "package", "other"):
            turns[who].append(cold(old if who == "other" else new))
        bmm = lambda: torch.bmm(A, x[:, :, None])  # noqa: E731
        bmm_cold = cold(bmm)
        bmm_warm = cs._call_device_ms(torch, bmm, 20)[0]
        new_warm = cs._call_device_ms(torch, new, 20)[0]
        bound, _ = cs._bound(4 * (B * M * K + B * K + B * M), 2 * B * M * K)
        p = bk.plan_for(A)
        row = dict(role=role, shape=[B, M, K], table_mb=4 * B * M * K / 1e6,
                   other_cold_ms=turns["other"], package_cold_ms=turns["package"],
                   package_warm_ms=new_warm, bmm_cold_ms=bmm_cold, bmm_warm_ms=bmm_warm,
                   bound_ms=bound, max_rel_package=rel_new, max_rel_other=rel_old,
                   plan=p._asdict())
        rows.append(row)
        pk, ot = min(turns["package"]), min(turns["other"])
        print(f"{(B, M, K)} {role} ({row['table_mb']:.1f} MB): L2-cold ms other "
              f"{turns['other'][0]:.5f} / {turns['other'][1]:.5f}, package "
              f"{turns['package'][0]:.5f} / {turns['package'][1]:.5f} "
              f"({ot / pk:.2f}x); package warm {new_warm:.5f}; torch.bmm cold "
              f"{bmm_cold:.5f}, warm {bmm_warm:.5f}; bound {bound:.5f} = "
              f"{100 * bound / pk:.1f}% of the package's, {100 * bound / ot:.1f}% of "
              f"the other's; max rel {rel_new:.2e} / {rel_old:.2e}; plan R "
              f"{p.rows_per_span}, {p.mode}, S {p.stages}, G {p.group}, blocks "
              f"{p.blocks}, smem {p.smem_bytes}, in flight {p.in_flight} B an SM")
        del A, x, want, y0, y1, y2
    path = _path_turns(torch, cs, bk, dev, run_other) if args.path else None
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(dict(card=smi, other=args.other, shapes=rows, path=path), f,
                      indent=1)
    print(json.dumps(dict(card=smi, n_shapes=len(rows))))
    return 0


def _path_turns(torch, cs, bk, dev, run_other):
    """bell_bmv's device ms in one profiled 5-step forward of the n=32
    unstructured model, with the other kernel and the package's in turns;
    returns one record a turn."""
    from glimslib_tpu_torch.examples import UNSTRUCT_STEP_CONFIG, brain_sim

    sim = brain_sim(n=32, dtype=torch.float32, device=dev, unstructured=True)
    sim.step_config = UNSTRUCT_STEP_CONFIG
    theta = sim.make_theta(sim.params.as_dict())
    u0, c0 = sim.initial_state()
    simulate = sim.build_simulate_fn(5, 1.0)
    simulate(theta, u0, c0)  # builds the frozen state
    torch.cuda.synchronize()
    turns = []
    for who in ("other", "package", "package", "other"):
        kernel = run_other if who == "other" else bk.batched_matvec_cuda
        with mock.patch.object(bk, "batched_matvec_cuda", kernel):
            bk.batched_matvec.launches_by_shape = {}
            simulate(theta, u0, c0)
            by_shape = dict(bk.batched_matvec.launches_by_shape)
            recs = [r for r in cs._device_records(torch, lambda: simulate(theta, u0, c0))
                    if not re.search(cs.SLEEP_KERNEL, r.name)]
        bmv = [r.time_range.elapsed_us() for r in recs if "bell_bmv_kernel" in r.name]
        by_kernel = {}  # the package's template instances stand for shapes
        for r in recs:
            name = re.search(r"bell_bmv_kernel(<[^>]*>)?", r.name)
            if name:
                ms, n = by_kernel.get(name.group(0), (0.0, 0))
                by_kernel[name.group(0)] = (ms + r.time_range.elapsed_us() / 1e3, n + 1)
        busy = sum(r.time_range.elapsed_us() for r in recs) / 1e3
        turns.append(dict(who=who, bell_bmv_ms=sum(bmv) / 1e3, bell_bmv_records=len(bmv),
                          by_kernel=by_kernel,
                          launches_by_shape={"x".join(map(str, k)): c
                                             for k, c in by_shape.items()},
                          device_busy_ms=busy))
        print(f"path (n=32 unstructured forward, 5 steps) with the {who} kernel: "
              f"bell_bmv {sum(bmv) / 1e3:.3f} ms in {len(bmv)} records "
              f"({sum(by_shape.values())} launches), device busy {busy:.3f} ms; "
              + ", ".join(f"{k} {ms:.3f} ms x{n}" for k, (ms, n) in by_kernel.items()))
    return turns


if __name__ == "__main__":
    sys.exit(main())
