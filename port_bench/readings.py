"""The readings that a cell's limits are set from, many seeds in one
process: the numbers that decide ``correct``, of units of work run on the
timed path at the cell's own size, each against the plain reference.

    python3 port_bench/readings.py --workload <name> --seeds 1,2,3 [--control]

``--control`` runs the port without its float64 refinement
(``GLIMS_REFINE_F64=0``): float32 residuals and solves throughout, the
precision below the configuration's.  The set-up is paid once, then each
seed's inputs are taken (``loadgen.Design``), the units that a run of
that seed would check (``Design.sample``) are run and compared.  One JSON
object a seed goes to standard output, and the largest reading of each
number last.  Not a measurement: nothing here is timed against a bound.
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def readings(workload, seeds, device, cfg_override=None, units=1, log=print):
    """{seed: {number: value}}: the largest of each number over the
    ``units`` checked units of each seed's inputs."""
    import torch

    from port_bench import harness, loadgen, spec
    from port_bench.reference.model import Reference

    bench = spec.load(ROOT)
    wl = spec.workload(bench, workload)
    cfg = {**spec.config(bench, wl["config"], ROOT), **(cfg_override or {})}
    traffic = spec.traffic(wl["traffic"], ROOT)
    device = torch.device(device)
    work = harness.WORK[traffic["call"]](cfg, traffic, device)
    ref = Reference(cfg, device)
    out = {}
    for seed in seeds:
        design = loadgen.Design(traffic, seed)
        work.use(design)
        work.records.clear()
        got = {}
        for i in design.sample(len(design.units))[:units]:
            t0 = time.perf_counter()
            rec = work.run_unit(i)
            if not rec.ok:
                got["failed"] = got.get("failed", 0) + 1
            for name, value in work.check(ref, rec).items():
                got[name] = max(got.get(name, 0.0), value)
            got["seconds"] = time.perf_counter() - t0
        out[seed] = got
        log(json.dumps({"workload": workload, "seed": seed, **got}), flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--units", type=int, default=1)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    if args.control:
        # read by the port when it is imported, which comes later
        os.environ["GLIMS_REFINE_F64"] = "0"
    import torch

    if not torch.cuda.is_available():
        print("no card: readings are taken on the card", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",")]
    got = readings(args.workload, seeds, "cuda", units=args.units)
    worst = {}
    for r in got.values():
        for k, v in r.items():
            worst[k] = max(worst.get(k, 0.0), v)
    print(json.dumps({"workload": args.workload, "control": args.control,
                      "seeds": len(seeds), "largest": worst}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
