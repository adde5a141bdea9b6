#!/usr/bin/env python3
"""Where the test suite's time goes, by what each test waits on.

As a pytest plugin (with ``tools/`` on ``PYTHONPATH``), it samples the
main thread's stack of every ``pytest -n`` worker each 20 ms while a test
runs and appends one JSON line a test to ``$SAMPLER_OUT`` (default
``test_time_samples.jsonl`` in the working directory): the seconds by
category, the innermost that applies of

- ``ranks``: waiting on the ranks of ``glimslib_tpu_torch.parallel.run_ranks``;
- ``once_wait``: waiting on another worker's reference (tests/torch_once.py);
- ``jax_compile``: inside ``jax/_src/compiler.py`` (XLA compiles);
- ``jax``: inside JAX or the JAX package (tracing, dispatch, eager ops);
- ``port``: inside torch or glimslib_tpu_torch;
- ``other``: numpy, scipy, the tests' own code.

    PYTHONPATH=tools python -m pytest tests/ -n 6 -p test_time_sampler ...
    python3 tools/test_time_sampler.py test_time_samples.jsonl

The second command sums the categories over the port's test files
(``test_torch_*``) and prints them by file.  The sampler thread's own
cost shows in the tests' wall time.
"""

import collections
import json
import os
import sys
import threading
import time

DT = 0.02
CATEGORIES = ("jax_compile", "jax", "port", "ranks", "once_wait", "other")

_current = {"id": None}
_counts = collections.defaultdict(collections.Counter)


def _classify(frame):
    files = []
    while frame is not None:
        files.append((frame.f_code.co_filename, frame.f_code.co_name))
        frame = frame.f_back
    if any("parallel/shard.py" in f and name == "run_ranks" for f, name in files):
        return "ranks"
    if files and "torch_once.py" in files[0][0]:
        return "once_wait"
    if any("jax/_src/compiler.py" in f for f, _ in files):
        return "jax_compile"
    if any("/jax/" in f or "/jaxlib/" in f or "/glimslib_tpu/" in f for f, _ in files):
        return "jax"
    if any("glimslib_tpu_torch" in f or "/torch/" in f for f, _ in files):
        return "port"
    return "other"


def _sample(main):
    while True:
        time.sleep(DT)
        test = _current["id"]
        frame = sys._current_frames().get(main)
        if test is not None and frame is not None:
            _counts[test][_classify(frame)] += 1


def pytest_configure(config):
    if os.environ.get("PYTEST_XDIST_WORKER"):
        main = threading.main_thread().ident
        threading.Thread(target=_sample, args=(main,), daemon=True).start()


def pytest_runtest_logstart(nodeid, location):
    if os.environ.get("PYTEST_XDIST_WORKER"):
        _current["id"] = nodeid


def pytest_runtest_logfinish(nodeid, location):
    if not os.environ.get("PYTEST_XDIST_WORKER"):
        return
    _current["id"] = None
    counts = _counts.pop(nodeid, {})
    with open(os.environ.get("SAMPLER_OUT", "test_time_samples.jsonl"), "a") as out:
        out.write(json.dumps({"id": nodeid, **{k: v * DT for k, v in counts.items()}})
                  + "\n")


def main(path):
    by_file = collections.defaultdict(collections.Counter)
    for line in open(path):
        row = json.loads(line)
        name = row["id"].split("::")[0].rsplit("/", 1)[-1]
        if name.startswith("test_torch"):
            by_file[name].update({k: row.get(k, 0.0) for k in CATEGORIES})
    total = sum(by_file.values(), collections.Counter())
    whole = sum(total.values()) or 1.0
    print("port files: " + ", ".join(
        f"{k} {total[k]:.0f} s ({100 * total[k] / whole:.1f}%)" for k in CATEGORIES))
    for name, c in sorted(by_file.items(), key=lambda x: -sum(x[1].values())):
        print(f"{name:36s} {sum(c.values()):7.0f} s  " + ", ".join(
            f"{k} {c[k]:.0f}" for k in CATEGORIES if c[k] >= 1))


if __name__ == "__main__":
    main(sys.argv[1])
