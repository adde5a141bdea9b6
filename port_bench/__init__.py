"""The benchmark of ``glimslib_tpu_torch`` on one NVIDIA H100.

``run.py`` is the command; ``BENCHMARK.json`` at the repository root names
the cells.  Everything that belongs to one configuration, one traffic mix
or one per-layer metric sits in a file of its own, found by its name:
``configs/<config>.json``, ``traffic/<mix>.json``, ``metrics/<metric>.py``
and ``limits/<workload>.json``.  ``reference/`` is the plain PyTorch
reference that decides ``correct``; it imports nothing of the port.
"""
