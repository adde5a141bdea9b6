"""GlimSLib in PyTorch: the port of ``glimslib_tpu`` to PyTorch and CUDA.

Module paths mirror ``glimslib_tpu/``.  The port runs the P1 forward step
of :class:`~glimslib_tpu_torch.models.tumor_growth_brain.TumorGrowthBrain`
end to end on both operator lanes: on lattice meshes, offset-stencil
operators (``ops/stencil.py``) with stencil matvecs and whole-solve PCG as
hand-written CUDA kernels for Hopper (``csrc/stencil.cu``, bound in
``ops/stencil_kernels.py`` and ``ops/fused_cg.py``); on unstructured
meshes, supernode halo-ELL operators (``ops/bell.py``) whose batched
contractions run in the CUDA kernel of ``csrc/bell.cu``
(``ops/bell_kernels.py``), with supernode block-Jacobi plus two-level
preconditioning (``solvers/twolevel.py``); geometric multigrid on
lattices (``solvers/multigrid.py``: its level applies launch the stencil
kernel) is wired to no model, as in the JAX package.  Both lanes feed the
block-triangular Newton-CG step (``solvers/coupled.py``) and the
implicit-Euler time loop (``models/base.py``), on the card unless the
caller asks for the CPU.  Above them: the adjoint inverse problem
(``optimize/``), ``run()``'s recording and file output
(``core/results.py``), post-processing (``postprocess.py``), the
image-based optimization workflow (``workflow/``), plotting
(``visualisation/``: matplotlib imported only when a plot is drawn),
tracing and profiling (``utils/profiling.py``: ``Tracer``, ``run_stats``,
``device_trace`` on ``torch.profiler``), the reference's module names
(``simulation/``, ``simulation_helpers/``) and its example scripts
(``example_scripts/``, ``python -m glimslib_tpu_torch.example_scripts``).
What is not ported raises ``NotImplementedError``.

The package imports ``torch`` and never ``jax``.
"""

from glimslib_tpu_torch import config

__version__ = "0.1.0"

__all__ = ["config", "__version__"]
